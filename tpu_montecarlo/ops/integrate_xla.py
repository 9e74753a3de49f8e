"""Fused Monte Carlo integration sweep (XLA backend).

One jitted program generates sample blocks from counter-based streams,
evaluates all K integrands on the *same* samples (multi-function fusion,
like the reference's K register accumulators, src/shader_gen.rs:264-303),
and accumulates per-function partial sums with Kahan compensation.  The
final reduction happens on-device — replacing the reference's CPU mean over
65,536 thread partials (src/lib.rs:129-140) with an in-register tree
reduction plus (on a mesh) a psum across devices.

Sample-count semantics match the reference: the processed count is the
plan's rounded-up ``actual_samples >= n_samples`` with equal weighting
(src/engine.rs:172-173).

Reproducibility: streams are keyed by (seed, global chunk index), so results
are independent of the device-mesh size for a fixed plan.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from ..sampling import (
    DistKind,
    sample_block,
    sample_block_antithetic,
    transform_from_u,
)
from ..utils.dispatch import IntegratePlan

__all__ = ["build_integrate_fn"]


def _kahan_add(sums, comps, vals):
    y = vals - comps
    t = sums + y
    comps = (t - sums) - y
    return t, comps


def _qmc_sample_chunk(
    chunk_idx, chunk_elems, kind, params, x_table, cdf_table,
    exact_inverse, shift,
):
    """Sample one chunk from the rotated radical-inverse stream
    (ops/qmc.py) — the XLA-backend counterpart of the Pallas kernel's
    _sample_subblocks_qmc, with identical transforms (NORMAL inverts the
    CDF of the 1-D stream via sampling.normal_from_u01 — monotone, so
    the low-discrepancy structure carries to the normals exactly)."""
    from .qmc import qmc_u01_halfopen, qmc_u01_open

    s1 = shift
    g = (
        chunk_idx.astype(jnp.uint32) * jnp.uint32(chunk_elems)
        + jnp.arange(chunk_elems, dtype=jnp.int32).astype(jnp.uint32)
    )
    if kind == DistKind.NORMAL:
        from ..sampling import normal_from_u01

        return params[0] + params[1] * normal_from_u01(
            qmc_u01_halfopen(g, s1)
        )
    # (0, 1] for the log-consuming transform, [0, 1) otherwise; the
    # u -> x tail is shared with sample_block so MC and QMC sampling
    # semantics stay identical by construction.
    u = (
        qmc_u01_open(g, s1)
        if kind == DistKind.EXPONENTIAL
        else qmc_u01_halfopen(g, s1)
    )
    return transform_from_u(u, kind, params, x_table, cdf_table, exact_inverse)


def build_integrate_fn(
    eval_fns: Sequence[Callable],
    kind: DistKind,
    plan: IntegratePlan,
    mesh: Optional[jax.sharding.Mesh] = None,
    axis_name: str = "mc",
    exact_inverse: bool = False,
    method: str = "mc",
    with_stderr: bool = False,
):
    """Build a jitted ``(seed, params, x_table, cdf_table) -> (K,) float32``
    integration program.  ``eval_fns`` are traced scalar functions; they are
    vmapped over the sample block and all evaluated on shared samples.

    With a ``mesh``, the chunk range is split across devices (pure data
    parallelism over the sample axis) and partial sums are combined with
    ``psum`` — the multi-chip axis the single-device reference lacks
    (SURVEY.md §2.4).

    ``with_stderr=True``: the program additionally Kahan-accumulates
    per-function sums of squares and returns ``(means, stderrs)`` with
    ``stderr_i = sqrt(max(E[f_i^2] - E[f_i]^2, 0) / N)`` — the standard
    Monte Carlo error estimate (an addition over the reference, which
    returns point estimates only).  For QMC the same formula is an
    MC-SCALE REFERENCE ONLY, not an estimate of the QMC integration
    error: a fixed rotation is deterministic, so the iid variance
    formula neither tracks nor bounds its error.  For a real QMC error
    bar, run R independent seed rotations (seed-batched handles) and
    take the spread of the R estimates.

    ``method="antithetic"``: each uniform draw is used at ``u`` AND its
    mirror ``1 - u`` through the monotone inverse-CDF transforms
    (NORMAL reflects z about the mean) — classic antithetic variates,
    unbiased with variance at most iid MC for monotone integrands and
    EXACT cancellation for odd ones.  Error bars treat the pair mean as
    the iid unit, so ``return_stderr`` reports the antithetic
    estimator's true (reduced) error.
    """
    if method not in ("mc", "qmc", "antithetic"):
        raise ValueError(
            f"method must be 'mc', 'qmc' or 'antithetic', got {method!r}"
        )
    anti = method == "antithetic"
    if anti and plan.chunk_elems % 2 != 0:
        raise ValueError(
            "antithetic sampling pairs draws; the plan's chunk size "
            f"must be even (got {plan.chunk_elems})"
        )
    k = len(eval_fns)
    vfns = [jax.vmap(f) for f in eval_fns]
    n_dev = 1 if mesh is None else mesh.size

    if plan.n_chunks % n_dev != 0:
        raise ValueError(
            f"plan.n_chunks ({plan.n_chunks}) must divide evenly over "
            f"{n_dev} devices; pad the plan first"
        )
    local_chunks = plan.n_chunks // n_dev
    qmc_chunks_per_seg = None
    if method == "qmc":
        from . import qmc as _qmc

        if plan.actual_samples >= _qmc.QMC_MAX_SAMPLES:
            # Auto-split past one 2^32-point vdc cycle: chunks are
            # grouped into segments of <= 2^32 samples, each under its
            # own seed-derived rotation (qmc.derive_segment_shift), so
            # a single call scales to any sample count with no user
            # seed management.
            qmc_chunks_per_seg = max(
                1, _qmc.QMC_MAX_SAMPLES // plan.chunk_elems
            )

    def _sweep(seed, params, x_table, cdf_table, chunk_start):
        if method == "qmc":
            from .qmc import derive_shift

            shift = derive_shift(seed, 1)
        else:
            key = jax.random.PRNGKey(seed)

        def draw(i):
            if method == "qmc":
                if qmc_chunks_per_seg is not None:
                    from .qmc import derive_segment_shift

                    cps = jnp.int32(qmc_chunks_per_seg)
                    seg = i // cps
                    i = i - seg * cps
                    shift_i = derive_segment_shift(shift, seg)
                else:
                    shift_i = shift
                return _qmc_sample_chunk(
                    i, plan.chunk_elems, kind, params,
                    x_table, cdf_table, exact_inverse, shift_i,
                )
            ck = jax.random.fold_in(key, i)
            if anti:
                # Half the draws, each used at u AND its mirror 1-u:
                # the chunk keeps its sample count, the pair elements
                # are exact antithetic partners (variance reduction for
                # monotone integrands, exact cancellation for odd ones).
                return sample_block_antithetic(
                    ck, (plan.chunk_elems // 2,), kind, params, x_table,
                    cdf_table, exact_inverse=exact_inverse,
                )
            return sample_block(
                ck, (plan.chunk_elems,), kind, params, x_table,
                cdf_table, exact_inverse=exact_inverse,
            )

        if with_stderr:
            # Variance pilot: every device re-evaluates GLOBAL chunk 0 and
            # centers the square accumulation on its per-function means —
            # the one-pass E[f^2] - mean^2 formula cancels catastrophically
            # in float32 when |mean| >> std (measured stderr=0 at
            # N(1e4, 1)).  The pilot is identical on all devices (same
            # stream), so the shifted partials psum consistently; the raw
            # VALUE sums stay unshifted, bit-equal to the plain program.
            x0 = draw(jnp.int32(0))
            if anti:
                pilot = jnp.stack([
                    0.5 * (
                        jnp.mean(vf(x0[0]).astype(jnp.float32))
                        + jnp.mean(vf(x0[1]).astype(jnp.float32))
                    )
                    for vf in vfns
                ])
            else:
                pilot = jnp.stack(
                    [jnp.mean(vf(x0).astype(jnp.float32)) for vf in vfns]
                )

        def body(carry, i):
            x = draw(chunk_start + i)
            if with_stderr:
                sums, comps, sq_sums, sq_comps = carry
                if anti:
                    ys1 = [vf(x[0]).astype(jnp.float32) for vf in vfns]
                    ys2 = [vf(x[1]).astype(jnp.float32) for vf in vfns]
                    vals = jnp.stack(
                        [jnp.sum(a) + jnp.sum(b) for a, b in zip(ys1, ys2)]
                    )
                    # Squares of PAIR MEANS: the pair is the iid unit of
                    # the antithetic estimator — individual-eval squares
                    # would ignore the (negative) within-pair covariance
                    # the method exists to exploit.
                    sq_vals = jnp.stack([
                        jnp.sum(
                            (0.5 * (a + b) - c) * (0.5 * (a + b) - c)
                        )
                        for a, b, c in zip(ys1, ys2, pilot)
                    ])
                else:
                    ys = [vf(x).astype(jnp.float32) for vf in vfns]
                    vals = jnp.stack([jnp.sum(y) for y in ys])
                    sq_vals = jnp.stack(
                        [
                            jnp.sum((y - c) * (y - c))
                            for y, c in zip(ys, pilot)
                        ]
                    )
                return (
                    _kahan_add(sums, comps, vals)
                    + _kahan_add(sq_sums, sq_comps, sq_vals)
                ), None
            sums, comps = carry
            if anti:
                vals = jnp.stack(
                    [jnp.sum(vf(x[0])) + jnp.sum(vf(x[1])) for vf in vfns]
                )
            else:
                vals = jnp.stack([jnp.sum(vf(x)) for vf in vfns])
            return _kahan_add(sums, comps, vals), None

        n_acc = 4 if with_stderr else 2
        init = tuple(jnp.zeros(k, jnp.float32) for _ in range(n_acc))
        carry, _ = jax.lax.scan(
            body, init, jnp.arange(local_chunks, dtype=jnp.int32)
        )
        if with_stderr:
            return carry[0], carry[2], pilot
        return carry[0]

    n_f32 = jnp.float32(plan.actual_samples)
    # Antithetic error bars count PAIRS as the iid unit (the squares
    # accumulated above are of pair means): var(pair mean) / n_pairs.
    n_units = jnp.float32(
        plan.actual_samples // 2 if anti else plan.actual_samples
    )

    def _finish(sums, sq_sums=None, pilot=None):
        mean = sums / n_f32
        if sq_sums is None:
            return mean
        # Var[f] = E[(f - c)^2] - (mean - c)^2 for any shift c; with the
        # pilot c ~ mean both terms are O(std^2), so no cancellation.
        d = mean - pilot
        var = jnp.maximum(sq_sums / n_units - d * d, 0.0)
        return mean, jnp.sqrt(var / n_units)

    # Tables are always passed as arrays; analytic families get 1-element
    # dummies (the reference does the same with dummy GPU buffers,
    # src/engine.rs:250-264) so the call signature stays uniform.
    if mesh is None:

        @jax.jit
        def run(seed, params, x_table, cdf_table):
            out = _sweep(seed, params, x_table, cdf_table, 0)
            if with_stderr:
                return _finish(*out)
            return _finish(out)

        return run

    replicated = P()

    def sharded_body(seed, params, x_table, cdf_table):
        d = jax.lax.axis_index(axis_name)
        out = _sweep(seed, params, x_table, cdf_table, d * local_chunks)
        if with_stderr:
            sums, sq_sums, pilot = out
            return _finish(
                jax.lax.psum(sums, axis_name),
                jax.lax.psum(sq_sums, axis_name),
                pilot,
            )
        return _finish(jax.lax.psum(out, axis_name))

    shard_mapped = jax.shard_map(
        sharded_body,
        mesh=mesh,
        in_specs=(replicated, replicated, replicated, replicated),
        out_specs=(replicated, replicated) if with_stderr else replicated,
        check_vma=False,
    )

    @jax.jit
    def run(seed, params, x_table, cdf_table):
        return shard_mapped(seed, params, x_table, cdf_table)

    return run
