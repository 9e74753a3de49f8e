"""Metropolis-Hastings chain kernel (Pallas, Triton route).

Each program holds a tile of chains, one per thread, in registers for
the whole run: a ``fori_loop`` over ``n_burnin + n_steps`` iterations
carries (x, log_p, log_q, K accumulators, accept count) — the
reference's per-thread ``var<private>`` chain state and sequential MH
loop (src/shader_gen.rs:312-442), with no launch between steps.
Semantics preserved (see ops/mcmc_xla.py for the full list): acceptance
``log u < log_p(x') + log_q(x) - log_p(x) - log_q(x')``, burn-in
advanced but not accumulated, f(current_x) added every sampling step,
per-chain mean ``/n_steps`` then unweighted chain average.

Analytic families use closed-form log-PDFs (src/shader_gen.rs:543-571);
CUSTOM families run in-kernel too: proposal sampling through the
uniform-u inverse-CDF table and log-PDF evaluation through the
uniform-grid log table (-100 floor outside support,
src/distribution.rs:367-475), both by indexed loads.  Requires uniform
log-pdf x-grids (tables built by this library always are; non-uniform
user grids route to the XLA backend).

RNG: :class:`~.integrate_pallas.CounterRng` keyed by (seed, program,
step, purpose) — the reference's counter-offset stream separation
(src/shader_gen.rs:477-536).  The kernel and its plain-jnp reference
(``reference=True``) run the same :func:`_chain_program`, so they see
the same draws.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.sharding import PartitionSpec as P

from ..sampling import DistKind
from ..tables import LOG_PDF_FLOOR
from .integrate_pallas import (
    CounterRng,
    _pow2,
    _row,
    compiler_params,
    interpret_mode,
    positions,
    table_slope,
    table_value,
    transform,
    u01_halfopen,
    u01_open,
    uniform_table,
)

__all__ = [
    "build_mcmc_fn_pallas",
    "mcmc_pallas_supports",
    "plan_mcmc_grid",
    "plan_state_chains",
]

MIN_CHAINS_PER_PROGRAM = 32
MAX_CHAINS_PER_PROGRAM = 128
# Programs the planner aims for before it widens the chain tile: enough
# to put a program on most of an H100's 132 SMs at the 4096-chain shape.
TARGET_PROGRAMS = 128


def mcmc_pallas_supports(proposal_kind: DistKind, target_kind: DistKind) -> bool:
    """Every family runs in-kernel — analytic families (including the
    extended closed-form registry) via their transforms/log densities,
    CUSTOM via table lookups; callers must additionally ensure CUSTOM
    log-pdf x-grids are uniform."""
    from ..sampling import ANALYTIC_KINDS

    kinds = ANALYTIC_KINDS + (DistKind.CUSTOM,)
    return proposal_kind in kinds and target_kind in kinds


def plan_mcmc_grid(total_chains: int):
    """(num_programs, chains_per_program, chains_actual): chains per
    program are a power of two between 32 (one warp) and 128, wide
    enough to keep about TARGET_PROGRAMS programs; all rounded-up chains
    run and enter the final average (the reference's
    round-up-and-run-everything semantics, src/engine.rs:860-871)."""
    want = max(1, total_chains // TARGET_PROGRAMS)
    c = 1 << (want.bit_length() - 1)
    c = max(MIN_CHAINS_PER_PROGRAM, min(MAX_CHAINS_PER_PROGRAM, c))
    programs = -(-total_chains // c)
    return programs, c, programs * c


def plan_state_chains(total_chains: int, n_dev: int = 1) -> int:
    """Chain count carried by the kernel's state buffers: the
    plan_mcmc_grid round-up with programs padded to a device multiple —
    the count ``McmcState`` must have to resume on this backend."""
    programs, c, _ = plan_mcmc_grid(total_chains)
    programs = -(-programs // n_dev) * n_dev
    return programs * c


# Odd 32-bit mix constant folded into the seed word per resume segment so
# continuations draw fresh streams; segment 0 leaves the seed unchanged so
# a fresh stateful run reproduces the stateless kernel bit-for-bit.
_SEGMENT_MIX = np.int32(0x9E3779B1 - (1 << 32))  # 0x9E3779B1 as int32

# Adaptive random-walk log-step clamp (same bounds as the XLA backend):
# steps outside [1e-6, 1e6] mean the adaptation diverged; the clamp keeps
# exp(log_step) finite rather than silently freezing the chain.
_RW_LS_MIN = -13.815511  # log(1e-6)
_RW_LS_MAX = 13.815511  # log(1e6)


def _fori(lo, hi, body, carry):
    """``fori_loop`` over [lo, hi) that skips empty static ranges."""
    if isinstance(lo, int) and isinstance(hi, int) and hi <= lo:
        return carry
    return jax.lax.fori_loop(lo, hi, body, carry)


def _splithalf_add(i, halves, vals, n_burnin: int, n1: int):
    """Split-half sums and squares update (pilot-shifted ``vals`` —
    variances are shift-invariant): the XLA backend's split-R-hat
    ingredients (ops/mcmc_xla.py), gated by the iteration index."""
    acc1, sq1, acc2, sq2 = halves
    h1 = jnp.logical_and(i >= n_burnin, i < n_burnin + n1)
    h2 = jnp.logical_and(i >= n_burnin + n1, i < n_burnin + 2 * n1)
    acc1 = tuple(a + jnp.where(h1, v, 0.0) for a, v in zip(acc1, vals))
    sq1 = tuple(a + jnp.where(h1, v * v, 0.0) for a, v in zip(sq1, vals))
    acc2 = tuple(a + jnp.where(h2, v, 0.0) for a, v in zip(acc2, vals))
    sq2 = tuple(a + jnp.where(h2, v * v, 0.0) for a, v in zip(sq2, vals))
    return (acc1, sq1, acc2, sq2)


def _diag_stats(halves, pilots, k: int, n1: int, n_block):
    """Per-program split-half sequence statistics as four lists of K
    scalars: sequence-mean sums (pilot-restored), SS around the
    program's sequence centroid, the centroid, and the summed
    within-sequence variance — Chan-recombined across programs/devices
    by :func:`_diag_combine` like the chain-mean stats."""
    acc1, sq1, acc2, sq2 = halves
    n1f = jnp.float32(max(n1, 1))
    inv_n1 = jnp.float32(1.0) / n1f
    denom_w = jnp.float32(max(n1 - 1, 1))
    seq_sum, seq_ss, seq_mb, w_sum = [], [], [], []
    for i in range(k):
        m1 = acc1[i] * inv_n1
        m2 = acc2[i] * inv_n1
        s_m = jnp.sum(m1) + jnp.sum(m2)
        s_msq = jnp.sum(m1 * m1) + jnp.sum(m2 * m2)
        w = (jnp.sum(sq1[i]) + jnp.sum(sq2[i]) - n1f * s_msq) / denom_w
        mbs = s_m / (2.0 * n_block)
        seq_ss.append(jnp.maximum(s_msq - 2.0 * n_block * mbs * mbs, 0.0))
        mb_seq = mbs + pilots[i]
        seq_sum.append(2.0 * n_block * mb_seq)
        seq_mb.append(mb_seq)
        w_sum.append(w)
    return [seq_sum, seq_ss, seq_mb, w_sum]


def _diag_combine(
    seq_sums, seq_ss, seq_mb, w_sums,
    chains_f, block_f, chains_actual: int, n_steps: int, psum=None,
):
    """Split-R-hat/ESS from the per-program sequence stats: Chan-recombine
    the 2*block_f sequence means per program around the global sequence
    mean, then the XLA backend's split_rhat_ess on the totals.
    ``psum``: the cross-device reducer on a mesh (identity off-mesh)."""
    from .mcmc_xla import split_rhat_ess

    if psum is None:
        psum = lambda v: v  # noqa: E731
    m_seq = psum(seq_sums) / (2.0 * chains_f)  # (R, K) global mean
    corr = (2.0 * block_f) * (seq_mb - m_seq[:, None, :]) ** 2
    ss_tot = psum(jnp.sum(seq_ss + corr, axis=1))
    w_tot = psum(w_sums)
    return split_rhat_ess(
        w_tot[0], ss_tot[0], 2 * chains_actual, n_steps // 2
    )


class _Chains:
    """Static description of one MH run, shared by the kernel and its
    jnp reference."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def log_pdf(self, kind, p1, p2, x, tab):
        if kind == DistKind.CUSTOM:
            return table_value(x, *tab, LOG_PDF_FLOOR)
        from ..sampling import analytic_log_pdf

        return analytic_log_pdf(kind, p1, p2, x)

    def log_pdf_grad(self, p1, p2, x, tab):
        """d/dx of the target log-density — the HMC position gradient:
        ``jax.grad`` of the closed form for analytic families, the log
        table interpolant's slope for CUSTOM targets (the gradient field
        the XLA backend's autodiff follows)."""
        if self.target_kind == DistKind.CUSTOM:
            return table_slope(x, *tab)
        from ..sampling import analytic_log_pdf

        kind = self.target_kind
        return jax.grad(
            lambda v: jnp.sum(analytic_log_pdf(kind, p1, p2, v))
        )(x)

    def propose(self, rng, pos, counter, q1, q2, inv):
        """Independence proposal block: x, or (x, logq) in sampler mode,
        where logq is the EXACT log-density of the piecewise-linear-in-u
        table sampler at the draw, ``-log((m-1) * dx_i)`` — its slope is
        already loaded for the draw, so the proposal density costs one
        log instead of an x-space table lookup, and the chain stays
        exactly invariant for the target at any table resolution."""
        kind = self.proposal_kind
        bits = rng.bits(pos, counter)
        if kind != DistKind.CUSTOM:
            u = u01_open(bits) if kind == DistKind.EXPONENTIAL else (
                u01_halfopen(bits)
            )
            return transform(kind, u, q1, q2)
        inv_t, inv_dx = inv
        m = inv_t.shape[0]
        pos_u = u01_halfopen(bits) * jnp.float32(m - 1)
        i0 = jnp.clip(pos_u.astype(jnp.int32), 0, m - 2)
        frac = pos_u - i0.astype(jnp.float32)
        dx = inv_dx[i0]
        x = inv_t[i0] + frac * dx
        if self.sampler_logq:
            # A zero slope would be an atom: clamp to a large finite logq.
            logq = -jnp.log(jnp.maximum(dx, jnp.float32(1e-30))) - (
                jnp.float32(np.log(float(m - 1)))
            )
            return x, logq
        return x


def _chain_program(cfg, seed_word, program, prop, targ, tables, state,
                   emit=None):
    """One program's chain tile, start to finish.

    ``prop``/``targ``: scalar parameter rows (proposal row is (step,
    init_lo, init_hi, target_accept) for a random walk); ``tables``: the
    flat CUSTOM tables (kernel refs or arrays); ``state``: (x0, logp0)
    or None.  ``emit(j, x)`` receives thinned draws.  Returns (rows,
    x_final, logp_final) where rows are lists of scalars: the output
    stat rows of this program."""
    c, k = cfg.chains, cfg.k
    pos = positions(c)
    rng = CounterRng(seed_word, program)
    tables = list(tables)
    inv = (tables.pop(0), tables.pop(0)) if cfg.prop_custom else None
    targ_tab = (tables.pop(0), tables.pop(0)) if cfg.targ_custom else None
    prop_tab = (
        (tables.pop(0), tables.pop(0))
        if cfg.prop_custom and not cfg.sampler_logq
        else None
    )
    q1, q2 = prop[0], prop[1]
    t1, t2 = targ[0], targ[1]
    n_burnin, n_steps = cfg.n_burnin, cfg.n_steps
    n_iters = n_burnin + n_steps

    def lp_t(v):
        return cfg.log_pdf(cfg.target_kind, t1, t2, v, targ_tab)

    def lp_q(v):
        return cfg.log_pdf(cfg.proposal_kind, q1, q2, v, prop_tab)

    def sample(counter):
        return cfg.propose(rng, pos, counter, q1, q2, inv)

    logq0 = None
    if state is not None:
        x0, logp0 = state
    elif cfg.random_walk:
        # Overdispersed uniform init over (init_lo, init_hi): there is no
        # proposal distribution to draw a start from.
        x0 = prop[1] + u01_halfopen(rng.bits(pos, 0)) * (prop[2] - prop[1])
        logp0 = lp_t(x0)
    elif cfg.sampler_logq:
        x0, logq0 = sample(0)
        logp0 = lp_t(x0)
    else:
        x0 = sample(0)
        logp0 = lp_t(x0)
    if not cfg.random_walk and not cfg.sampler_logq:
        logq0 = lp_q(x0)

    n_block = jnp.float32(c)
    stat_mode = cfg.with_stderr or cfg.with_diagnostics
    n1 = n_steps // 2  # split-half length (odd last step excluded)
    pilots = None
    if stat_mode:
        # Accumulation pilot per program: f at the init draw is on the
        # right scale, and shifting the accumulators by it keeps the
        # between-chain signal out of the f32 ulp of a large |E[f]|.
        # Per-program pilots recombine exactly via Chan's formula.
        pilots = [
            jnp.sum(f(x0).astype(jnp.float32)) / n_block
            for f in cfg.eval_fns
        ]

    def accumulate(i, accs, halves, x):
        vals = [f(x).astype(jnp.float32) for f in cfg.eval_fns]
        if stat_mode:
            vals = [v - p for v, p in zip(vals, pilots)]
        accs = tuple(a + v for a, v in zip(accs, vals))
        if cfg.with_diagnostics:
            halves = _splithalf_add(i, halves, vals, n_burnin, n1)
        return accs, halves

    def run_sampling(body, carry0):
        """The sampling-phase loop; thinned-draw runs split it into m
        segments, each emitting the post-step state of its first step.
        Step indices and op order are those of the plain loop."""
        if not cfg.with_samples:
            return _fori(n_burnin, n_iters, body, carry0)
        stride = cfg.sample_stride

        def seg(j, cc):
            base = jnp.int32(n_burnin) + j * jnp.int32(stride)
            cc = body(base, cc)
            emit(j, cc[0])
            return jax.lax.fori_loop(
                0, stride - 1, lambda t, c2: body(base + 1 + t, c2), cc
            )

        carry = jax.lax.fori_loop(0, cfg.with_samples, seg, carry0)
        done = n_burnin + cfg.with_samples * stride
        return _fori(done, n_iters, body, carry)

    zero = jnp.zeros((c,), jnp.float32)
    zero_accs = (zero,) * k
    zero_halves = (zero_accs,) * 4 if cfg.with_diagnostics else ()

    # Burn-in advances the chains WITHOUT evaluating the K integrands or
    # the accept counter (the reference's burn-in loop runs only
    # mcmc_step, shader_gen.rs:409-411); the iteration index runs through
    # both phases and each draws the same counters per iteration.
    if cfg.random_walk:
        from ..sampling import normal_from_u01

        if cfg.hmc_leapfrog:

            def move(i, x, logp, step_sz):
                # L kick-drift-kick leapfrog steps from a fresh momentum,
                # then the exact energy-corrected accept.
                p0 = normal_from_u01(u01_halfopen(rng.bits(pos, 3 * i + 1)))
                xq, p, g = x, p0, cfg.log_pdf_grad(t1, t2, x, targ_tab)
                for _ in range(cfg.hmc_leapfrog):
                    p = p + 0.5 * step_sz * g
                    xq = xq + step_sz * p
                    g = cfg.log_pdf_grad(t1, t2, xq, targ_tab)
                    p = p + 0.5 * step_sz * g
                logp_prop = lp_t(xq)
                log_alpha = (logp_prop - 0.5 * p * p) - (logp - 0.5 * p0 * p0)
                # Diverged trajectories (inf - inf) must reject, not
                # NaN-poison the adaptation.
                log_alpha = jnp.where(
                    log_alpha != log_alpha, jnp.float32(-3.0e38), log_alpha
                )
                u2 = u01_open(rng.bits(pos, 3 * i + 2))
                accept = jnp.log(u2) < log_alpha
                x = jnp.where(accept, xq, x)
                logp = jnp.where(accept, logp_prop, logp)
                return x, logp, accept, log_alpha

        else:

            def move(i, x, logp, step_sz):
                # Symmetric Gaussian step: the q terms cancel.
                xp = x + step_sz * normal_from_u01(
                    u01_halfopen(rng.bits(pos, 3 * i + 1))
                )
                logp_prop = lp_t(xp)
                log_alpha = logp_prop - logp
                u2 = u01_open(rng.bits(pos, 3 * i + 2))
                accept = jnp.log(u2) < log_alpha
                x = jnp.where(accept, xp, x)
                logp = jnp.where(accept, logp_prop, logp)
                return x, logp, accept, log_alpha

        rw_step = prop[0]
        if cfg.rw_adapt:
            # Per-chain Robbins-Monro on the log step, burn-in only
            # (frozen for sampling, so the sampling chain is exact MH).
            rw_target = prop[3]

            def burn_body(i, carry):
                x, logp, ls = carry
                x, logp, _, log_alpha = move(i, x, logp, jnp.exp(ls))
                alpha_p = jnp.exp(jnp.minimum(log_alpha, 0.0))
                gamma = jnp.exp(
                    jnp.float32(-0.6)
                    * jnp.log((i + 1).astype(jnp.float32))
                )
                ls = jnp.clip(
                    ls + gamma * (alpha_p - rw_target), _RW_LS_MIN, _RW_LS_MAX
                )
                return (x, logp, ls)

            x0, logp0, ls_f = _fori(
                0, n_burnin, burn_body, (x0, logp0, jnp.log(rw_step) + zero)
            )
            step_fin = jnp.exp(ls_f)
        else:

            def burn_body(i, carry):
                x, logp, _, _ = move(i, carry[0], carry[1], rw_step)
                return (x, logp)

            x0, logp0 = _fori(0, n_burnin, burn_body, (x0, logp0))
            step_fin = rw_step

        def body(i, carry):
            x, logp, accs, halves, n_acc = carry
            x, logp, accept, _ = move(i, x, logp, step_fin)
            accs, halves = accumulate(i, accs, halves, x)
            return (x, logp, accs, halves, n_acc + accept.astype(jnp.float32))

        x_f, logp_f, accs, halves, n_acc = run_sampling(
            body, (x0, logp0, zero_accs, zero_halves, zero)
        )
    else:

        def move(i, x, logp, logq):
            # The chain's own log-densities are carried (they change only
            # on acceptance).  Distinct counters per draw purpose.
            if cfg.sampler_logq:
                xp, logq_prop = sample(3 * i + 1)
            else:
                xp = sample(3 * i + 1)
                logq_prop = lp_q(xp)
            logp_prop = lp_t(xp)
            log_alpha = logp_prop + logq - logp - logq_prop
            u = u01_open(rng.bits(pos, 3 * i + 2))
            accept = jnp.log(u) < log_alpha
            x = jnp.where(accept, xp, x)
            logp = jnp.where(accept, logp_prop, logp)
            logq = jnp.where(accept, logq_prop, logq)
            return x, logp, logq, accept

        def burn_body(i, carry):
            x, logp, logq, _ = move(i, *carry)
            return (x, logp, logq)

        x0, logp0, logq0 = _fori(0, n_burnin, burn_body, (x0, logp0, logq0))

        def body(i, carry):
            x, logp, logq, accs, halves, n_acc = carry
            x, logp, logq, accept = move(i, x, logp, logq)
            accs, halves = accumulate(i, accs, halves, x)
            return (
                x, logp, logq, accs, halves,
                n_acc + accept.astype(jnp.float32),
            )

        x_f, logp_f, _, accs, halves, n_acc = run_sampling(
            body, (x0, logp0, logq0, zero_accs, zero_halves, zero)
        )

    acc_total = jnp.sum(n_acc)
    if not stat_mode:
        return [[jnp.sum(a) for a in accs] + [acc_total]], x_f, logp_f
    # Per-program between-chain statistics from the pilot-shifted
    # accumulators: the sums row carries CHAIN-MEAN sums (n_block *
    # centroid) and the accept count, then the SS values around the
    # program centroid, then the centroids; the wrapper recombines
    # programs with Chan's formula around the global mean.
    inv_steps = jnp.float32(1.0) / jnp.float32(max(n_steps, 1))
    sums, sss, mbs_row = [], [], []
    for i, acc in enumerate(accs):
        cm = acc * inv_steps
        s1 = jnp.sum(cm)
        s2 = jnp.sum(cm * cm)
        mbs = s1 / n_block
        # Shifted-data SS: cm is pilot-shifted, so mbs is near zero.
        sss.append(jnp.maximum(s2 - n_block * mbs * mbs, 0.0))
        mb = mbs + pilots[i]
        sums.append(n_block * mb)
        mbs_row.append(mb)
    rows = [sums + [acc_total], sss, mbs_row]
    if cfg.with_diagnostics:
        rows += _diag_stats(halves, pilots, k, n1, n_block)
    return rows, x_f, logp_f


def build_mcmc_fn_pallas(
    eval_fns: Sequence[Callable],
    proposal_kind: DistKind,
    target_kind: DistKind,
    n_steps: int,
    n_burnin: int,
    total_chains: int,
    mesh: Optional[jax.sharding.Mesh] = None,
    axis_name: str = "mc",
    interpret: Optional[bool] = None,
    with_state: bool = False,
    use_init_state: bool = False,
    prop_gapped: bool = False,
    seed_batch: int = 1,
    param_batch: bool = False,
    with_stderr: bool = False,
    random_walk: bool = False,
    rw_adapt: bool = False,
    hmc_leapfrog: int = 0,
    with_diagnostics: bool = False,
    with_samples: int = 0,
    reference: bool = False,
):
    """Build a jitted MH program.

    Signature of the returned function (matches the XLA backend)::

        (seed, proposal_params, target_params,
         prop_inv_cdf_table, prop_cdf_table(gapped slope table when
         prop_gapped=True, unused otherwise),
         targ_logpdf_x, targ_logpdf, prop_logpdf_x, prop_logpdf)
        -> ((K,) float32 estimates, () float32 acceptance_rate)

    Analytic families ignore their tables (dummy 1-element arrays).  CUSTOM
    log-pdf x-grids must be uniform (the host-built ones are).

    ``interpret``: None picks the platform's mode
    (integrate_pallas.interpret_mode).  ``reference=True``: the same
    program computed by the plain-jnp reference — every program's chain
    tile vectorised by XLA, with the same counter stream (single device,
    no ``with_samples``).

    ``with_state=True`` appends trailing args ``(x0, logp0, segment)`` —
    per-chain state of shape (plan_state_chains(total_chains),) plus an
    int32 segment counter mixed into the seed word so continuations draw
    fresh streams — and returns ``(values, acceptance, x_final,
    logp_final)``.  Chain state stays in registers for the whole sweep
    (as the reference's GPU threads hold it, src/shader_gen.rs:390-392);
    only the final (x, log_p) are written out.  The incoming state is
    consumed when ``use_init_state=True``; logq at the resume point is
    recomputed from x.

    ``prop_gapped=True``: the (prop_inv_cdf_table, prop_cdf_table) args
    are host-built gap-respecting (value, slope) tables from
    ``tables.gapped_inverse_tables``, so a zero-density-span proposal
    never lands inside a gap.

    ``seed_batch=R`` (stateless only): the seed arg becomes an (R,) vector
    and the program returns ((R, K), (R,)) — R independent runs as a
    leading grid dimension, each seeded exactly like its unbatched call.
    ``param_batch=True`` (stateless, analytic target; analytic or
    random-walk proposal): the params args become (R, 2) — or (R, 4) walk
    rows — one (proposal, target) pair per batch element.

    ``random_walk=True``: random-walk MH (distributions.RandomWalk).  The
    proposal params become ``(step, init_lo, init_hi, target_accept)``;
    ``rw_adapt=True`` Robbins-Monro-adapts a per-chain log step toward
    ``target_accept`` during burn-in (``gamma_i = i^-0.6``) and freezes
    it for sampling.  ``hmc_leapfrog=L`` (with ``random_walk=True``;
    distributions.HMC) makes the step an L-step leapfrog trajectory
    through ``H(x, p) = -log p(x) + p^2/2`` with the exact energy
    correction.

    ``with_stderr=True`` (stateless): the program returns ``(values,
    acceptance, stderrs)`` from the BETWEEN-CHAIN variance of per-chain
    means; accumulators are pilot-shifted and programs recombine exactly
    via Chan's parallel-variance formula around the global mean.

    ``with_samples=m`` (stateless; ``1 <= m <= n_steps``): the program
    additionally returns — LAST — an ``(m, chains_actual)`` array of
    thinned post-burn-in draws (``(R, m, chains_actual)`` when batched),
    the states at sampling steps ``n_burnin + j * (n_steps // m)`` (the
    XLA backend's thinning grid).  Each draw is stored from registers;
    the chain loop and the estimates are unchanged.

    ``with_diagnostics=True`` (stateless, unbatched): the program
    additionally returns ``(r_hat, ess)`` split-half diagnostics (the XLA
    backend's split-R-hat semantics, ops/mcmc_xla.split_rhat_ess).
    """
    if seed_batch != 1 and with_state:
        raise ValueError("seed_batch applies to stateless MCMC programs only")
    if with_stderr and with_state:
        raise ValueError(
            "with_stderr applies to stateless MCMC programs only"
        )
    if use_init_state and not with_state:
        raise ValueError(
            "use_init_state requires with_state=True (the stateless "
            "program has no state inputs)"
        )
    if with_diagnostics and (
        with_state or seed_batch != 1 or param_batch
    ):
        raise ValueError(
            "with_diagnostics applies to stateless unbatched MCMC "
            "programs only"
        )
    if with_diagnostics and n_steps < 4:
        raise ValueError("with_diagnostics needs n_steps >= 4")
    if with_samples:
        if with_state:
            raise ValueError(
                "with_samples applies to stateless MCMC programs only"
            )
        if not 1 <= int(with_samples) <= n_steps:
            raise ValueError(
                f"with_samples must be in [1, n_steps={n_steps}], got "
                f"{with_samples}"
            )
        if reference:
            raise ValueError("the jnp reference does not return draws")
    if param_batch:
        from ..sampling import ensure_param_batch_family

        if with_state:
            raise ValueError(
                "param_batch applies to stateless MCMC programs only"
            )
        if not random_walk:
            ensure_param_batch_family(proposal_kind, "proposal")
        ensure_param_batch_family(target_kind, "target")
    if random_walk and use_init_state and rw_adapt:
        raise ValueError("rw_adapt is stateless-only (steps not resumable)")
    k = len(eval_fns)
    if hmc_leapfrog and not random_walk:
        raise ValueError("hmc_leapfrog requires random_walk=True")
    if random_walk:
        if not mcmc_pallas_supports(target_kind, target_kind):
            raise ValueError(
                "Unsupported target distribution family for Pallas MCMC"
            )
    elif not mcmc_pallas_supports(proposal_kind, target_kind):
        raise ValueError("Unsupported distribution family for Pallas MCMC")
    if reference and mesh is not None:
        raise ValueError("the jnp reference runs on a single device")
    if interpret is None and not reference:
        interpret = interpret_mode()
    prop_custom = (not random_walk) and proposal_kind == DistKind.CUSTOM
    targ_custom = target_kind == DistKind.CUSTOM
    # Sampler-mode proposal log-density (stateless CUSTOM proposals,
    # non-gapped tables): logq comes from the draw's own slope.  Stateful
    # runs keep the table path: a resumed chain recomputes logq from x
    # alone, which must match how the minting program computed it.
    sampler_logq = prop_custom and not prop_gapped and not (
        with_state or use_init_state
    )

    n_dev = 1 if mesh is None else mesh.size
    programs, chains, _ = plan_mcmc_grid(total_chains)
    programs = -(-programs // n_dev) * n_dev
    chains_actual = programs * chains
    local_programs = programs // n_dev
    stat_mode = with_stderr or with_diagnostics
    n_rows = (7 if with_diagnostics else 3) if stat_mode else 1
    width = _pow2(k + 1)
    cfg = _Chains(
        eval_fns=tuple(eval_fns), k=k, chains=chains,
        proposal_kind=proposal_kind, target_kind=target_kind,
        n_steps=n_steps, n_burnin=n_burnin,
        prop_custom=prop_custom, targ_custom=targ_custom,
        sampler_logq=sampler_logq, random_walk=random_walk,
        rw_adapt=rw_adapt, hmc_leapfrog=hmc_leapfrog,
        with_stderr=with_stderr, with_diagnostics=with_diagnostics,
        with_samples=int(with_samples),
        sample_stride=n_steps // with_samples if with_samples else 0,
    )
    n_tables = (
        (2 if sampler_logq else 4) if prop_custom else 0
    ) + (2 if targ_custom else 0)

    def seed_word_of(seed, rep, seg):
        # Distinguish the MCMC stream family from the integrate kernel's.
        w = seed[rep] ^ 0x5BD1E995
        if with_state:
            # Segment 0 multiplies to 0: a fresh stateful run reproduces
            # the stateless kernel's streams exactly.
            w = w ^ (seg[0] * _SEGMENT_MIX)
        return w

    def kernel(seed_ref, prop_ref, targ_ref, base_ref, *rest):
        rest = list(rest)
        seg_ref = rest.pop(0) if with_state else None
        tables = [rest.pop(0) for _ in range(n_tables)]
        state = (rest.pop(0)[...], rest.pop(0)[...]) if use_init_state else None
        out_ref = rest.pop(0)
        rep = pl.program_id(0)
        pid = pl.program_id(1)
        prow = rep if param_batch else 0
        pw = 4 if random_walk else 2
        emit = None
        if with_samples:
            samp_ref = rest.pop(0)

            def emit(j, x):
                samp_ref[j, :] = x

        rows, x_f, logp_f = _chain_program(
            cfg, seed_word_of(seed_ref, rep, seg_ref), base_ref[0] + pid,
            [prop_ref[prow, j] for j in range(pw)],
            [targ_ref[prow, 0], targ_ref[prow, 1]],
            tables, state, emit,
        )
        if stat_mode:
            for r, vals in enumerate(rows):
                out_ref[r, :] = _row(vals, width)
        else:
            out_ref[...] = _row(rows[0], width)
        if with_state:
            rest[0][...] = x_f
            rest[1][...] = logp_f

    def whole(a):
        return pl.BlockSpec(a.shape, lambda r, i, nd=a.ndim: (0,) * nd)

    def pallas_sweep(seed, prop, targ, base, *rest):
        """(R, P, n_rows, width) stat rows [, x_f, logp_f][, draws]."""
        n_in = (1 if with_state else 0) + n_tables
        in_specs = [whole(a) for a in (seed, prop, targ, base, *rest[:n_in])]
        chain_spec = pl.BlockSpec((chains,), lambda r, i: (i,))
        if use_init_state:
            in_specs += [chain_spec, chain_spec]
        if stat_mode:
            out_specs = [pl.BlockSpec(
                (None, None, n_rows, width), lambda r, i: (r, i, 0, 0)
            )]
            out_shape = [jax.ShapeDtypeStruct(
                (seed_batch, local_programs, n_rows, width), jnp.float32
            )]
        else:
            out_specs = [pl.BlockSpec(
                (None, None, width), lambda r, i: (r, i, 0)
            )]
            out_shape = [jax.ShapeDtypeStruct(
                (seed_batch, local_programs, width), jnp.float32
            )]
        local_chains = local_programs * chains
        if with_samples:
            out_specs.append(pl.BlockSpec(
                (None, with_samples, chains), lambda r, i: (r, 0, i)
            ))
            out_shape.append(jax.ShapeDtypeStruct(
                (seed_batch, with_samples, local_chains), jnp.float32
            ))
        if with_state:
            out_specs += [chain_spec, chain_spec]
            out_shape += [
                jax.ShapeDtypeStruct((local_chains,), jnp.float32)
            ] * 2
        out = pl.pallas_call(
            kernel,
            grid=(seed_batch, local_programs),
            in_specs=in_specs,
            out_specs=out_specs,
            out_shape=out_shape,
            interpret=interpret,
            backend="triton",
            compiler_params=compiler_params(max(1, chains // 32)),
            name="mc_mcmc",
        )(seed, prop, targ, base, *rest)
        stats = out[0]
        if not stat_mode:
            stats = stats[:, :, None, :]
        return stats, out[1:]

    def reference_sweep(seed, prop, targ, base, *rest):
        """The same stat rows, computed by XLA from _chain_program."""
        rest = list(rest)
        seg = rest.pop(0) if with_state else None
        tables = rest[:n_tables]
        state = rest[n_tables:] if use_init_state else None
        pw = 4 if random_walk else 2

        def one(rep):
            prow = rep if param_batch else 0

            def prog(pid):
                st = None
                if state is not None:
                    st = tuple(
                        jax.lax.dynamic_slice(s, (pid * chains,), (chains,))
                        for s in state
                    )
                rows, x_f, logp_f = _chain_program(
                    cfg, seed_word_of(seed, rep, seg), base[0] + pid,
                    [prop[prow, j] for j in range(pw)],
                    [targ[prow, 0], targ[prow, 1]], tables, st,
                )
                rows = jnp.stack([_row(r, width) for r in rows])
                return rows, x_f, logp_f

            rows, x_f, logp_f = jax.vmap(prog)(
                jnp.arange(local_programs, dtype=jnp.int32)
            )
            return rows, x_f.reshape(-1), logp_f.reshape(-1)

        rows, x_f, logp_f = jax.vmap(one)(
            jnp.arange(seed_batch, dtype=jnp.int32)
        )
        return rows, ((x_f[0], logp_f[0]) if with_state else ())

    sweep_fn = reference_sweep if reference else pallas_sweep

    denom_vals = jnp.float32(chains_actual) * jnp.float32(n_steps)
    denom_acc = jnp.float32(chains_actual) * jnp.float32(max(n_steps, 1))
    chains_f = jnp.float32(chains_actual)
    block_f = jnp.float32(chains)  # chains per program

    def _stderr_of(ss_total):
        # Standard error of the mean of chains_actual independent chains
        # (ddof=1; matches the XLA backend's convention).
        var = ss_total / jnp.maximum(chains_f - 1.0, 1.0)
        return jnp.sqrt(var / chains_f)

    def _chan_combine(values, ss, mb):
        # Total SS around the global mean M over this device's programs:
        # sum_p [SS_p + n_p (mb_p - M)^2]; values (R, K), ss/mb (R, P, K).
        corr = block_f * (mb - values[:, None, :]) ** 2
        return jnp.sum(ss + corr, axis=1)

    single = seed_batch == 1 and not param_batch

    def _finish(stats, extra, psum):
        """Wrapper-side reductions of the (R, P, n_rows, width) stats."""
        totals = psum(jnp.sum(stats[:, :, 0, :], axis=1))  # (R, width)
        n_acc = totals[:, k] / denom_acc
        if not stat_mode:
            vals = totals[:, :k] / denom_vals
            if with_state:
                return (vals[0], n_acc[0]) + tuple(extra)
            res = (vals[0], n_acc[0]) if single else (vals, n_acc)
            return res + tuple(extra)
        values = totals[:, :k] / chains_f  # chain-MEAN sums in stat mode
        ss, mb = stats[:, :, 1, :k], stats[:, :, 2, :k]
        res = (values, n_acc)
        if with_stderr:
            res = res + (_stderr_of(psum(_chan_combine(values, ss, mb))),)
        if single:
            res = tuple(r[0] for r in res)
        if with_diagnostics:
            res = res + _diag_combine(
                jnp.sum(stats[:, :, 3, :k], axis=1),
                stats[:, :, 4, :k], stats[:, :, 5, :k],
                jnp.sum(stats[:, :, 6, :k], axis=1),
                chains_f, block_f, chains_actual, n_steps, psum=psum,
            )
        return res + tuple(extra)

    def _prep(seed, prop_params, targ_params, tables):
        (prop_inv, prop_cdf, targ_lx, targ_lp, prop_lx, prop_lp) = tables
        prepped = []
        if prop_custom:
            t = jnp.asarray(prop_inv, jnp.float32).reshape(-1)
            if prop_gapped:
                # (value, slope) pair built host-side with gap jumps
                # snapped to knots; the second slot carries the slope.
                dt = jnp.asarray(prop_cdf, jnp.float32).reshape(-1)
            else:
                dt = jnp.concatenate([t[1:] - t[:-1], jnp.zeros(1, jnp.float32)])
            prepped += [t, dt]
        if targ_custom:
            prepped += list(uniform_table(targ_lx, targ_lp))
        if prop_custom and not sampler_logq:
            prepped += list(uniform_table(prop_lx, prop_lp))
        pw = 4 if random_walk else 2
        rows = seed_batch if param_batch else 1
        return (
            jnp.asarray(seed).astype(jnp.int32).reshape(seed_batch),
            jnp.asarray(prop_params, jnp.float32).reshape(rows, pw),
            jnp.asarray(targ_params, jnp.float32).reshape(rows, 2),
            tuple(prepped),
        )

    def _state_args(state_args):
        x0, logp0, segment = state_args
        pre = (jnp.asarray(segment, jnp.int32).reshape(1),)
        post = ()
        if use_init_state:
            post = (
                jnp.asarray(x0, jnp.float32).reshape(-1),
                jnp.asarray(logp0, jnp.float32).reshape(-1),
            )
        return pre, post

    def _reshape_draws(extra):
        if not with_samples:
            return extra
        (draws,) = extra
        return (draws[0],) if single else (draws,)

    if mesh is None:

        @jax.jit
        def run(seed, prop_params, targ_params, *tables_state):
            tables = tables_state[:-3] if with_state else tables_state
            pre = post = ()
            if with_state:
                pre, post = _state_args(tables_state[-3:])
            seed_a, prop_a, targ_a, prepped = _prep(
                seed, prop_params, targ_params, tables
            )
            base = jnp.zeros((1,), jnp.int32)
            stats, extra = sweep_fn(
                seed_a, prop_a, targ_a, base, *pre, *prepped, *post
            )
            return _finish(stats, _reshape_draws(extra), lambda v: v)

        return run

    replicated = P()
    sharded = P(axis_name)

    def sharded_body(seed_a, prop_a, targ_a, *rest):
        d = jax.lax.axis_index(axis_name)
        base = (d * local_programs).astype(jnp.int32).reshape(1)
        stats, extra = pallas_sweep(seed_a, prop_a, targ_a, base, *rest)
        return _finish(
            stats, _reshape_draws(extra),
            lambda v: jax.lax.psum(v, axis_name),
        )

    body_in = (replicated,) * (3 + n_tables + (1 if with_state else 0))
    if use_init_state:
        body_in = body_in + (sharded, sharded)
    body_out = (replicated, replicated)
    if with_stderr:
        body_out = body_out + (replicated,)
    if with_diagnostics:
        body_out = body_out + (replicated, replicated)
    if with_samples:
        # Thinned draws are chain-sharded on the last axis.
        body_out = body_out + (
            P(None, axis_name)
            if seed_batch == 1 and not param_batch
            else P(None, None, axis_name),
        )
    if with_state:
        body_out = body_out + (sharded, sharded)

    shard_mapped = jax.shard_map(
        sharded_body, mesh=mesh, in_specs=body_in, out_specs=body_out,
        check_vma=False,
    )

    @jax.jit
    def run(seed, prop_params, targ_params, *tables_state):
        tables = tables_state[:-3] if with_state else tables_state
        pre = post = ()
        if with_state:
            pre, post = _state_args(tables_state[-3:])
        seed_a, prop_a, targ_a, prepped = _prep(
            seed, prop_params, targ_params, tables
        )
        return shard_mapped(seed_a, prop_a, targ_a, *pre, *prepped, *post)

    return run
