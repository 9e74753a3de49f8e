"""Fused Monte Carlo integration kernel (Pallas, Triton route).

The per-thread design of the reference's workgroup sweep
(src/shader_gen.rs:45-128), written for a GPU block: one program owns
``loops`` consecutive blocks of ``block`` samples.  For each block it
draws counter-based PCG bits in registers, maps them through the
family's transform, evaluates all K traced integrands on the SAME
samples (multi-function fusion) and adds them into K per-thread
partial-sum vectors carried through an in-program ``fori_loop``.  Each
program writes one (K,) row of partial sums; the jitted wrapper sums
the rows and divides by the processed sample count.  Disjoint writes,
no atomics: race-free by construction, like the reference's per-thread
accumulators.

RNG: :class:`CounterRng`, the reference's stateless-counter idea
(``pcg_hash(seed + idx*7199369 + iter*15485863)``,
src/distribution.rs:62-73) keyed by (seed, program, block, position).
The same function drives the kernel and its plain-jnp reference
(``reference=True``), so the two see identical draws and differ only in
summation order and in the math library (libdevice vs XLA).

CUSTOM (table) distributions sample through host-built stratified
inverse-CDF tables with indexed loads (see
:func:`prep_inv_table_stratified`).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu
from jax.sharding import PartitionSpec as P

from ..sampling import DistKind
from ..utils.dispatch import IntegratePlan
from .qmc import _pcg_mix

__all__ = [
    "CounterRng",
    "build_integrate_fn_pallas",
    "interpret_mode",
    "pallas_supports",
    "pick_block",
    "plan_pallas_grid",
]

# Samples per block (one fori_loop iteration of one program).  A block
# is spread over NUM_WARPS * 32 threads, so each thread carries
# ``block / 128`` elements of every accumulator in registers.
MAX_BLOCK = 1024
MIN_BLOCK = 128
# Accumulator elements per program (K * block, doubled with error bars):
# 64 float32 registers per thread at 4 warps.  Larger K shrinks the block
# instead of spilling.
ACC_BUDGET = 8192
MAX_LOOPS_PER_PROGRAM = 512
# Programs the planner aims for before it lengthens their loops: several
# per SM of a 132-SM H100, so modest sample counts still fill the card.
TARGET_PROGRAMS = 1024
# Integrands fused into one pass; more chain passes over the same stream.
MAX_FUSED = 64
NUM_WARPS = 4
# Knots per inverse-CDF stratum of the CUSTOM sampler.
STRATUM_KNOTS = 128

_INV_2POW24 = np.float32(1.0 / (1 << 24))


def interpret_mode() -> bool:
    """Whether Pallas kernels run in the interpreter: on the CPU (the test
    tier) they do, on the GPU they compile through Triton, and any other
    platform is refused rather than silently interpreted."""
    backend = jax.default_backend()
    if backend == "gpu":
        return False
    if backend == "cpu":
        return True
    raise RuntimeError(
        f"Pallas kernels support the 'gpu' and 'cpu' platforms, not "
        f"{backend!r}; use backend='xla'"
    )


def compiler_params(num_warps: int = NUM_WARPS):
    return plgpu.CompilerParams(num_warps=num_warps, num_stages=1)


def pallas_supports(kind: DistKind) -> bool:
    from ..sampling import ANALYTIC_KINDS

    return kind == DistKind.CUSTOM or kind in ANALYTIC_KINDS


def pick_block(k: int, with_stderr: bool = False) -> int:
    """Largest power-of-two block keeping the K carried accumulators (2K
    with error bars) within the per-program register budget."""
    n_acc = max(1, k * (2 if with_stderr else 1))
    block = MAX_BLOCK
    while block > MIN_BLOCK and n_acc * block > ACC_BUDGET:
        block //= 2
    return block


def plan_pallas_grid(n_samples: int, block: int = MAX_BLOCK):
    """(num_programs, loops_per_program, actual_samples) with
    actual >= n_samples — the rounded-up equal-weight semantics of the
    reference dispatch planner (src/engine.rs:157-181)."""
    total_blocks = -(-n_samples // block)
    loops = max(1, min(MAX_LOOPS_PER_PROGRAM,
                       -(-total_blocks // TARGET_PROGRAMS)))
    programs = -(-total_blocks // loops)
    return programs, loops, programs * loops * block


def strata_for(block: int, m: Optional[int] = None) -> int:
    """Strata of the stratified CUSTOM sampler: a power of two dividing
    the block, at most 32 and at most one per 8 block samples.  Plain
    tables take at most ``m // STRATUM_KNOTS`` (no stratum finer than
    the table); gap-respecting tables always take the maximum, since
    their host builder resolves each gap at a stratum knot."""
    cap = min(32, block // 8)
    if m is not None:
        cap = max(1, min(cap, m // STRATUM_KNOTS))
    return 1 << (cap.bit_length() - 1)


class CounterRng:
    """Counter-based PCG-hash stream: the bits are a pure function of the
    seed words, a counter, a tag and the element position, so any
    element of any block can be regenerated anywhere (the reference's
    ``pcg_hash(seed + idx*7199369 + iter*15485863)``,
    src/distribution.rs:62-73)."""

    def __init__(self, *words):
        s = jnp.uint32(0x9E3779B9)
        for w in words:
            s = _pcg_mix(s ^ jnp.asarray(w).astype(jnp.uint32))
        self.state = s

    def bits(self, pos, counter, tag: int = 0):
        """uint32 bits for the uint32 positions ``pos`` of block
        ``counter``; ``tag`` separates draws that share a counter."""
        base = _pcg_mix(
            self.state
            + jnp.asarray(counter).astype(jnp.uint32) * jnp.uint32(15485863)
            + jnp.uint32((tag * 7199369) & 0xFFFFFFFF)
        )
        return _pcg_mix(base + pos * jnp.uint32(2654435761))


def _mantissa(bits):
    """Top 24 bits as int32 (exact after the shift)."""
    return jax.lax.bitcast_convert_type(bits >> 8, jnp.int32)


def u01_halfopen(bits):
    """[0, 1) uniforms from uint32 bits."""
    return _mantissa(bits).astype(jnp.float32) * _INV_2POW24


def u01_open(bits):
    """(0, 1] uniforms from uint32 bits (for log-consuming transforms)."""
    return (_mantissa(bits) + 1).astype(jnp.float32) * _INV_2POW24


def positions(block: int):
    """uint32 positions 0..block-1 of a block."""
    return jax.lax.broadcasted_iota(jnp.int32, (block,), 0).astype(
        jnp.uint32
    )


def table_value(x, vals, grid, outside):
    """Interpolated lookup of ``x`` in a uniform-x-grid table:
    ``vals`` (n,) and ``grid`` = (x0, step, x_max, 0), either arrays or
    kernel refs (indexed loads in the kernel, gathers in jnp).
    ``outside`` outside [x0, x_max] (0.0 for PDFs, -100 for log-PDFs —
    reference conventions, src/distribution.rs:173-281, 367-475)."""
    x0 = grid[0]
    step = grid[1]
    x_max = grid[2]
    n = vals.shape[0]
    pos = jnp.clip((x - x0) / step, 0.0, np.float32(n - 1))
    i0 = jnp.minimum(pos.astype(jnp.int32), n - 2)
    frac = jnp.clip(pos - i0.astype(jnp.float32), 0.0, 1.0)
    v0 = vals[i0]
    val = v0 + frac * (vals[i0 + 1] - v0)
    inside = jnp.logical_and(x >= x0, x <= x_max)
    return jnp.where(inside, val, outside)


def table_slope(x, vals, grid):
    """d/dx of :func:`table_value`'s piecewise-linear interpolant inside
    [x0, x_max], 0.0 outside — ``jax.grad`` of the XLA backend's interp
    lookup of the same table, so both backends follow one gradient
    field."""
    x0 = grid[0]
    step = grid[1]
    x_max = grid[2]
    n = vals.shape[0]
    pos = jnp.clip((x - x0) / step, 0.0, np.float32(n - 1))
    i0 = jnp.minimum(pos.astype(jnp.int32), n - 2)
    inside = jnp.logical_and(x >= x0, x <= x_max)
    return jnp.where(inside, (vals[i0 + 1] - vals[i0]) / step, 0.0)


def uniform_table(xs, values):
    """(values (n,), grid (4,) = [x0, step, x_max, 0]) for
    :func:`table_value` from a uniform x grid."""
    xs = jnp.asarray(xs, jnp.float32)
    values = jnp.asarray(values, jnp.float32)
    n = values.shape[0]
    x0 = xs[0]
    x_max = xs[n - 1]
    step = (x_max - x0) / jnp.float32(n - 1)
    return values, jnp.stack([x0, step, x_max, jnp.float32(0.0)])


def prep_inv_table_stratified(x_table, strata: int, with_pdf: bool = False):
    """Stratified inverse-CDF tables for the integrate kernel.

    u-space splits into S equal-mass strata; sample position e of every
    block is statically assigned stratum ``e // (block / S)`` and draws u
    uniformly within it.  Each stratum gets the same number of samples,
    so the block mean stays unbiased (proportional allocation) with
    variance at most the i.i.d. sampler's, and a draw costs one indexed
    load pair instead of a search.

    Returns flat (S * 128,) tables (ts, dts): per-stratum 128-knot
    resamplings of the piecewise-linear inverse CDF and their forward
    differences.  ``with_pdf=True`` adds ``qs``: the exact density of
    THIS sampler on each knot segment, ``du/dx = 1 / (S * 127 * dts)`` —
    loaded with the draw's own index it is the importance-sampling
    denominator q(x), with no x-space lookup (this keeps irregular-grid
    VEGAS proposals, adaptive.py, in-kernel)."""
    t = jnp.asarray(x_table, jnp.float32)
    m = t.shape[0]
    if m < 2:
        raise ValueError("inverse-CDF table needs at least 2 knots")
    knots = STRATUM_KNOTS
    j = jnp.arange(knots, dtype=jnp.float32) / jnp.float32(knots - 1)
    s = jnp.arange(strata, dtype=jnp.float32).reshape(strata, 1)
    u = (s + j) / jnp.float32(strata)
    pos = u * jnp.float32(m - 1)
    i0 = jnp.clip(pos.astype(jnp.int32), 0, m - 2)
    frac = pos - i0.astype(jnp.float32)
    t0 = jnp.take(t, i0)
    ts = t0 + frac * (jnp.take(t, i0 + 1) - t0)
    dts = jnp.concatenate(
        [ts[:, 1:] - ts[:, :-1], jnp.zeros((strata, 1), jnp.float32)],
        axis=1,
    )
    if with_pdf:
        inv_c = jnp.float32(1.0 / (strata * (knots - 1)))
        qs = jnp.where(dts > 0, inv_c / jnp.maximum(dts, 1e-38), 0.0)
        return ts.reshape(-1), dts.reshape(-1), qs.reshape(-1)
    return ts.reshape(-1), dts.reshape(-1)


def _stratified_draw(tables, w, strat_base):
    """Stratified inverse-CDF draw from within-stratum uniforms ``w``;
    ``strat_base`` is each position's stratum offset into the flat
    tables.  Returns (x, q) with q the sampler's density when a qs table
    rides along, else None."""
    pos = w * jnp.float32(STRATUM_KNOTS - 1)
    j = pos.astype(jnp.int32)
    frac = pos - j.astype(jnp.float32)
    idx = strat_base + j
    x = tables[0][idx] + frac * tables[1][idx]
    q = tables[2][idx] if len(tables) > 2 else None
    return x, q


def transform(kind: DistKind, u, p1, p2):
    """Inverse-transform samples of an analytic family from uniforms
    ``u`` ((0, 1] for EXPONENTIAL, [0, 1) otherwise)."""
    if kind == DistKind.UNIFORM:
        from ..sampling import next_below_f32

        x = p1 + u * (p2 - p1)
        # f32 rounding may land on the half-open boundary.
        return jnp.where(x >= p2, next_below_f32(p2), x)
    if kind == DistKind.NORMAL:
        from ..sampling import normal_from_u01

        return p1 + p2 * normal_from_u01(u)
    if kind == DistKind.EXPONENTIAL:
        return -jnp.log(jnp.maximum(u, 1e-7)) / p1
    from ..sampling import ANALYTIC_EXT

    ext = ANALYTIC_EXT.get(kind)
    if ext is None:
        raise ValueError(f"Pallas kernel does not support {kind}")
    return ext.inv_cdf(u, p1, p2).astype(jnp.float32)


def _draws(kind, u, p1, p2, tables, strat_base, anti):
    """[(x, q)] for one block of uniforms: one pair, or the pair at u and
    its antithetic mirror 1 - u (NORMAL reflects about the mean, the
    exact mirror of the monotone inverse CDF without a second erf_inv;
    CUSTOM mirrors within each stratum, which keeps the stratification)."""
    if kind == DistKind.CUSTOM:
        out = [_stratified_draw(tables, u, strat_base)]
        if anti:
            out.append(_stratified_draw(tables, 1.0 - u, strat_base))
        return out
    if anti and kind == DistKind.NORMAL:
        from ..sampling import normal_from_u01

        z = normal_from_u01(u)
        return [(p1 + p2 * z, None), (p1 - p2 * z, None)]
    out = [(transform(kind, u, p1, p2), None)]
    if anti:
        out.append((transform(kind, 1.0 - u, p1, p2), None))
    return out


class _Sweep:
    """Static description of one fused sweep, shared by the kernel and
    its jnp reference: every draw and every accumulation goes through
    :meth:`program_sums`, so both see identical samples."""

    def __init__(self, eval_fns, kind, block, loops, method,
                 is_weight, with_stderr, qmc_seg_bits):
        self.eval_fns = tuple(eval_fns)
        self.k = len(eval_fns)
        self.kind = kind
        self.block = block
        self.loops = loops
        self.method = method
        self.anti = method == "antithetic"
        self.with_stderr = with_stderr
        self.qmc_seg_bits = qmc_seg_bits
        p_mode, q_mode = is_weight if is_weight is not None else (None, None)
        self.weighted = is_weight is not None
        self.p_mode, self.q_mode = p_mode, q_mode
        self.p_table = p_mode == "table"
        self.q_table = q_mode == "table"
        # "sampler": the IS denominator is the CUSTOM proposal's own
        # sampling density, loaded from the qs table with the draw.
        self.q_sampler = q_mode == "sampler"

    @property
    def n_sample_tables(self) -> int:
        """CUSTOM sampling tables: values, slopes (+ the sampler's pdf)."""
        if self.kind != DistKind.CUSTOM:
            return 0
        return 3 if self.q_sampler else 2

    @property
    def n_tables(self) -> int:
        return self.n_sample_tables + 2 * (
            int(self.p_table) + int(self.q_table)
        )

    def _weight(self, x, q_samp, p_tab, q_tab):
        if not self.weighted:
            return None
        p_val = (
            table_value(x, *p_tab, 0.0)
            if self.p_table
            else self.p_mode(x).astype(jnp.float32)
        )
        if self.q_sampler:
            q_val = q_samp
        elif self.q_table:
            q_val = table_value(x, *q_tab, 0.0)
        else:
            q_val = self.q_mode(x).astype(jnp.float32)
        # A rounding-edge sample with zero proposal density would poison
        # the mean with inf/NaN (zero-mass points, so weight 0 is exact).
        safe_q = jnp.where(q_val > 0, q_val, 1.0)
        return jnp.where(q_val > 0, p_val / safe_q, 0.0)

    def program_sums(self, seed_word, program, p1, p2, tables, pilots):
        """Per-function sums (and pilot-shifted square sums) over one
        program's ``loops`` blocks; ``program`` is the global program
        index.  ``tables`` are kernel refs or arrays alike."""
        tables = list(tables)
        samp_tabs = tuple(tables[:self.n_sample_tables])
        rest = tables[self.n_sample_tables:]
        p_tab = (rest.pop(0), rest.pop(0)) if self.p_table else None
        q_tab = (rest.pop(0), rest.pop(0)) if self.q_table else None
        block, k = self.block, self.k
        pos = positions(block)
        strat_base = None
        if self.kind == DistKind.CUSTOM:
            # The flat sampling tables hold STRATUM_KNOTS knots per stratum.
            per = block // (samp_tabs[0].shape[0] // STRATUM_KNOTS)
            strat_base = (
                jax.lax.broadcasted_iota(jnp.int32, (block,), 0)
                // jnp.int32(per)
            ) * jnp.int32(STRATUM_KNOTS)
        use_open = self.kind == DistKind.EXPONENTIAL
        if self.method == "qmc":
            from .qmc import (
                derive_segment_shift,
                derive_shift,
                qmc_u01_halfopen,
                qmc_u01_open,
            )

            shift = derive_shift(seed_word, 1)
        else:
            rng = CounterRng(seed_word, program)

        def uniforms(i):
            if self.method != "qmc":
                bits = rng.bits(pos, i)
                return u01_open(bits) if use_open else u01_halfopen(bits)
            b = program * jnp.int32(self.loops) + i
            shift_b = shift
            if self.qmc_seg_bits is not None:
                # Runs past one 2^32-point cycle split into segments, each
                # under its own seed-derived rotation.
                seg = b >> self.qmc_seg_bits
                b = b & ((1 << self.qmc_seg_bits) - 1)
                shift_b = derive_segment_shift(shift, seg)
            g = b.astype(jnp.uint32) * jnp.uint32(block) + pos
            return (
                qmc_u01_open(g, shift_b) if use_open
                else qmc_u01_halfopen(g, shift_b)
            )

        def body(i, carry):
            accs, sqs = list(carry[0]), list(carry[1])
            draws = _draws(
                self.kind, uniforms(i), p1, p2, samp_tabs, strat_base,
                self.anti,
            )
            vals = []
            for x, q in draws:
                w = self._weight(x, q, p_tab, q_tab)
                vs = []
                for f in self.eval_fns:
                    v = f(x).astype(jnp.float32)
                    vs.append(v if w is None else v * w)
                vals.append(vs)
            for j in range(k):
                for vs in vals:
                    accs[j] = accs[j] + vs[j]
                if self.with_stderr:
                    # Antithetic squares are of the PAIR MEAN (the
                    # estimator's iid unit), so the error bar sees the
                    # negative within-pair covariance.
                    if self.anti:
                        d = 0.5 * (vals[0][j] + vals[1][j]) - pilots[j]
                        sqs[j] = sqs[j] + d * d
                    else:
                        for vs in vals:
                            d = vs[j] - pilots[j]
                            sqs[j] = sqs[j] + d * d
            return tuple(accs), tuple(sqs)

        zero = jnp.zeros((block,), jnp.float32)
        init = ((zero,) * k, (zero,) * (k if self.with_stderr else 0))
        accs, sqs = jax.lax.fori_loop(0, self.loops, body, init)
        return [jnp.sum(a) for a in accs], [jnp.sum(s) for s in sqs]


def _row(values, width: int):
    """Scalars -> one (width,) row (zeros past the values)."""
    col = jax.lax.broadcasted_iota(jnp.int32, (width,), 0)
    row = jnp.zeros((width,), jnp.float32)
    for i, v in enumerate(values):
        row = jnp.where(col == i, v, row)
    return row


def _pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def build_integrate_fn_pallas(
    eval_fns: Sequence[Callable],
    kind: DistKind,
    plan: IntegratePlan,
    mesh: Optional[jax.sharding.Mesh] = None,
    axis_name: str = "mc",
    interpret: Optional[bool] = None,
    is_weight=None,
    gapped_tables: bool = False,
    seed_batch: int = 1,
    method: str = "mc",
    param_batch: bool = False,
    with_stderr: bool = False,
    block: Optional[int] = None,
    reference: bool = False,
):
    """Build a jitted ``(seed, params, x_table, cdf_table[, p_x, p_pdf]
    [, q_x, q_pdf]) -> (K,) float32`` program running the fused kernel.
    The cdf_table arg is accepted for signature parity with the XLA
    backend and unused (except as the slope table of gapped tables).
    With a mesh, programs split across devices and partial sums combine
    with psum.

    ``interpret``: None picks :func:`interpret_mode` from the platform.

    ``reference=True``: the same program computed by the plain-jnp
    reference instead of the kernel — every program's
    :meth:`_Sweep.program_sums` vectorised by XLA over the grid, with
    the same counter stream, so kernel and reference differ only in
    summation order and math-library rounding (single device only).

    ``is_weight``: optional importance-sampling weight descriptor
    ``(p_mode, q_mode)``, each a traced scalar pdf callable or
    ``"table"`` (appends uniform-grid (x_grid, pdf_values) runtime args,
    evaluated in-kernel with the 0-outside-support convention, reference
    src/distribution.rs:173-281); ``q_mode="sampler"`` takes the CUSTOM
    proposal's own sampling density.  The weight multiplies every
    integrand, so all K functions see identical weights on shared
    samples (reference __init__.py:893-905).

    ``gapped_tables``: the x_table/cdf_table args are host-built
    (strata, 128) stratified (value, slope) tables from
    ``tables.gapped_stratified_tables`` at ``run.strata`` strata — the
    decoupled slope table jumps each zero-density gap exactly at a knot,
    so no sample lands inside a gap.

    ``seed_batch=R``: the seed arg becomes an (R,) vector and the program
    returns (R, K) — R independent sweeps as a leading grid dimension,
    each seeded exactly like the unbatched program.  ``param_batch``:
    params become (R, 2), one family-parameter row per batch element
    (analytic families, no IS weights).

    ``method="qmc"``: uniforms come from the seed-rotated radical inverse
    of the global sample index (ops/qmc.py); ``"antithetic"``: each draw
    is used at u and 1 - u.

    ``with_stderr=True``: the kernel also sums pilot-shifted squares
    ``(f(x) - pilot)^2`` and the program returns ``(means, stderrs)``.
    The pilot is a per-function mean over a deterministic quantile grid
    of the sampling distribution, computed outside the kernel; any fixed
    shift c keeps ``Var[f] = E[(f-c)^2] - (mean-c)^2`` exact and a pilot
    near the mean avoids float32 cancellation.  Value sums are
    untouched, so means equal the plain kernel's."""
    if method not in ("mc", "qmc", "antithetic"):
        raise ValueError(
            f"method must be 'mc', 'qmc' or 'antithetic', got {method!r}"
        )
    anti = method == "antithetic"
    if param_batch:
        from ..sampling import ensure_param_batch_family

        ensure_param_batch_family(kind)
        if is_weight is not None:
            raise ValueError(
                "param_batch is not supported with importance-sampling "
                "weights (weight closures bake distribution parameters)"
            )
    k = len(eval_fns)
    if k > MAX_FUSED:
        raise ValueError(f"at most {MAX_FUSED} fused functions supported")
    if not pallas_supports(kind):
        raise ValueError(f"Pallas backend does not support {kind}")
    is_custom = kind == DistKind.CUSTOM
    if is_weight is not None and is_weight[1] == "sampler" and (
        not is_custom or gapped_tables
    ):
        raise ValueError(
            "sampler-mode IS weights need a non-gapped CUSTOM proposal"
        )
    if reference and mesh is not None:
        raise ValueError("the jnp reference runs on a single device")
    if interpret is None and not reference:
        interpret = interpret_mode()

    n_dev = 1 if mesh is None else mesh.size
    if block is None:
        block = pick_block(k, with_stderr)
    # Antithetic blocks yield 2x samples, so the grid plans over half.
    grid_samples = -(-plan.actual_samples // 2) if anti else plan.actual_samples
    programs, loops, _ = plan_pallas_grid(grid_samples, block)
    programs = -(-programs // n_dev) * n_dev
    actual = programs * loops * block * (2 if anti else 1)
    local_programs = programs // n_dev

    qmc_seg_bits = None
    if method == "qmc":
        from . import qmc as _qmc

        total_blocks = programs * loops
        if total_blocks >= 1 << 31:
            raise ValueError(
                "QMC block counter exceeds int32; reduce n_samples "
                f"(requested {actual} samples in {total_blocks} blocks)"
            )
        if actual >= _qmc.QMC_MAX_SAMPLES:
            # Block b maps to segment b >> bits and local block
            # b & (2^bits - 1): each segment is one full 2^32-point cycle.
            qmc_seg_bits = max(
                0, (_qmc.QMC_MAX_SAMPLES // block).bit_length() - 1
            )

    sweep = _Sweep(
        eval_fns, kind, block, loops, method, is_weight, with_stderr,
        qmc_seg_bits,
    )
    width = _pow2(k)

    def kernel(seed_ref, params_ref, base_ref, *rest):
        rest = list(rest)
        pilot_ref = rest.pop(0) if with_stderr else None
        tables = rest[: sweep.n_tables]
        outs = rest[sweep.n_tables:]
        rep = pl.program_id(0)
        pid = pl.program_id(1)
        prow = rep if param_batch else 0
        pilots = (
            [pilot_ref[prow, j] for j in range(k)] if with_stderr else None
        )
        sums, sqs = sweep.program_sums(
            seed_ref[rep], base_ref[0] + pid,
            params_ref[prow, 0], params_ref[prow, 1], tables, pilots,
        )
        outs[0][...] = _row(sums, width)
        if with_stderr:
            outs[1][...] = _row(sqs, width)

    def whole(a):
        return pl.BlockSpec(a.shape, lambda r, i, nd=a.ndim: (0,) * nd)

    def pallas_sweep(seed, params, base, *tables):
        """(R, K) sums (and square sums) over this device's programs."""
        in_specs = [whole(a) for a in (seed, params, base, *tables)]
        row_spec = pl.BlockSpec((None, None, width), lambda r, i: (r, i, 0))
        shape = jax.ShapeDtypeStruct(
            (seed_batch, local_programs, width), jnp.float32
        )
        n_out = 2 if with_stderr else 1
        outs = pl.pallas_call(
            kernel,
            grid=(seed_batch, local_programs),
            in_specs=in_specs,
            out_specs=[row_spec] * n_out,
            out_shape=[shape] * n_out,
            interpret=interpret,
            backend="triton",
            compiler_params=compiler_params(),
            name="mc_integrate",
        )(seed, params, base, *tables)
        return tuple(jnp.sum(o[:, :, :k], axis=1) for o in outs)

    def reference_sweep(seed, params, base, *tables):
        """The same sums, computed by XLA from the same program_sums."""
        pilot = tables[0] if with_stderr else None
        tables = tables[1:] if with_stderr else tables

        def one(rep):
            prow = rep if param_batch else 0
            pilots = (
                [pilot[prow, j] for j in range(k)] if with_stderr else None
            )

            def prog(pid):
                s, q = sweep.program_sums(
                    seed[rep], base[0] + pid, params[prow, 0],
                    params[prow, 1], tables, pilots,
                )
                return jnp.stack(s), (jnp.stack(q) if q else jnp.zeros(0))

            s, q = jax.vmap(prog)(jnp.arange(local_programs, dtype=jnp.int32))
            return jnp.sum(s, axis=0), jnp.sum(q, axis=0)

        s, q = jax.vmap(one)(jnp.arange(seed_batch, dtype=jnp.int32))
        return (s, q) if with_stderr else (s,)

    sweep_fn = reference_sweep if reference else pallas_sweep

    def _prep(seed, params):
        seed_arr = jnp.asarray(seed).astype(jnp.int32).reshape(seed_batch)
        params_arr = jnp.asarray(params, jnp.float32).reshape(
            (seed_batch, 2) if param_batch else (1, 2)
        )
        return seed_arr, params_arr

    def _shape_result(sums):
        # Single-seed programs keep the (K,) shape; param-batched programs
        # always return the (R, K) batch.
        if param_batch:
            return sums
        return sums[0] if seed_batch == 1 else sums

    def _pilot_weight(x, weight_tables, q_pilot_val=None):
        """Pilot-grid IS weight p(x)/q(x) outside the kernel.  The pilot
        is an arbitrary fixed shift — only determinism across devices
        matters — so this plain lookup need not match the kernel's."""
        if is_weight is None:
            return None
        wt = list(weight_tables)

        def mode_val(mode, is_table):
            if not is_table:
                return mode(x).astype(jnp.float32)
            xs = jnp.asarray(wt.pop(0), jnp.float32)
            vals = jnp.asarray(wt.pop(0), jnp.float32)
            v = jnp.interp(x, xs, vals)
            inside = jnp.logical_and(x >= xs[0], x <= xs[-1])
            return jnp.where(inside, v, 0.0).astype(jnp.float32)

        p_val = mode_val(sweep.p_mode, sweep.p_table)
        if sweep.q_sampler:
            q_val = q_pilot_val
        else:
            q_val = mode_val(sweep.q_mode, sweep.q_table)
        safe_q = jnp.where(q_val > 0, q_val, 1.0)
        return jnp.where(q_val > 0, p_val / safe_q, 0.0)

    def _pilot_vals(p1, p2, prepped, weight_tables):
        """(K,) per-function means over a deterministic quantile grid of
        the sampling distribution (for CUSTOM families the stratified
        inverse table itself is an equal-mass quantile grid).  With IS
        weights the grid evaluations carry the weight."""
        if is_custom:
            x = prepped[0]
        else:
            n_p = 1024
            u = (
                jnp.arange(n_p, dtype=jnp.float32) + jnp.float32(0.5)
            ) / jnp.float32(n_p)
            x = transform(kind, u, p1, p2)
        w = _pilot_weight(
            x, weight_tables, prepped[2] if sweep.q_sampler else None
        )

        def f_val(f):
            v = f(x).astype(jnp.float32)
            return v if w is None else v * w

        return jnp.stack([jnp.mean(f_val(f)) for f in eval_fns])

    def _pilot_of(params_arr, prepped, weight_tables=()):
        """(rows, K) pilot table: one row per param-batch rep, a single
        shared row otherwise — identical on every device."""
        if param_batch:
            return jax.vmap(
                lambda p: _pilot_vals(p[0], p[1], prepped, weight_tables)
            )(params_arr)
        return _pilot_vals(
            params_arr[0, 0], params_arr[0, 1], prepped, weight_tables
        )[None, :]

    def _finish_stderr(sums, sqs, pilot):
        n = jnp.float32(actual)
        # Antithetic squares are of pair means: the iid unit is the pair.
        n_units = jnp.float32(actual // 2 if anti else actual)
        mean = sums / n
        d = mean - pilot
        var = jnp.maximum(sqs / n_units - d * d, 0.0)
        se = jnp.sqrt(var / n_units)
        if seed_batch == 1 and not param_batch:
            return mean[0], se[0]
        return mean, se

    def _prep_tables(x_table, cdf_table, weight_tables):
        prepped = []
        if is_custom:
            if gapped_tables:
                prepped += [
                    jnp.asarray(x_table, jnp.float32).reshape(-1),
                    jnp.asarray(cdf_table, jnp.float32).reshape(-1),
                ]
            else:
                strata = strata_for(block, int(jnp.shape(x_table)[0]))
                prepped += list(
                    prep_inv_table_stratified(
                        x_table, strata, with_pdf=sweep.q_sampler
                    )
                )
        wt = list(weight_tables)
        for flag in (sweep.p_table, sweep.q_table):
            if flag:
                prepped += list(uniform_table(wt.pop(0), wt.pop(0)))
        return tuple(prepped)

    def _finish(sums_sqs, pilot):
        if with_stderr:
            return _finish_stderr(sums_sqs[0], sums_sqs[1], pilot)
        return _shape_result(sums_sqs[0] / jnp.float32(actual))

    if mesh is None:

        @jax.jit
        def run(seed, params, x_table, cdf_table, *weight_tables):
            seed_arr, params_arr = _prep(seed, params)
            base = jnp.zeros((1,), jnp.int32)
            prepped = _prep_tables(x_table, cdf_table, weight_tables)
            pilot = None
            extra = ()
            if with_stderr:
                pilot = _pilot_of(params_arr, prepped, weight_tables)
                extra = (pilot,)
            out = sweep_fn(seed_arr, params_arr, base, *extra, *prepped)
            return _finish(out, pilot)

    else:
        replicated = P()

        def sharded_body(seed_arr, params_arr, *tables):
            d = jax.lax.axis_index(axis_name)
            base = (d * local_programs).astype(jnp.int32).reshape(1)
            out = pallas_sweep(seed_arr, params_arr, base, *tables)
            out = tuple(jax.lax.psum(o, axis_name) for o in out)
            return _finish(out, tables[0] if with_stderr else None)

        def shard_mapped(seed_arr, params_arr, *tables):
            return jax.shard_map(
                sharded_body,
                mesh=mesh,
                in_specs=(replicated,) * (2 + len(tables)),
                out_specs=(
                    (replicated, replicated) if with_stderr else replicated
                ),
                check_vma=False,
            )(seed_arr, params_arr, *tables)

        @jax.jit
        def run(seed, params, x_table, cdf_table, *weight_tables):
            seed_arr, params_arr = _prep(seed, params)
            prepped = _prep_tables(x_table, cdf_table, weight_tables)
            if with_stderr:
                pilot = _pilot_of(params_arr, prepped, weight_tables)
                return shard_mapped(seed_arr, params_arr, pilot, *prepped)
            return shard_mapped(seed_arr, params_arr, *prepped)

    # The device executes this many samples per batch element (the grid
    # re-rounds plan.actual_samples); throughput divides by this.
    run.actual_samples = actual
    # Gap-respecting callers build their host tables at this many strata.
    run.strata = strata_for(block)
    return run
