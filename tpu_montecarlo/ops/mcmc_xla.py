"""Massively parallel independence-sampler Metropolis-Hastings (XLA backend).

One chain per lane; a ``lax.scan`` over ``n_burnin + n_steps`` iterations
carries (x, log_p, K accumulators) per chain — the JAX analog of the
reference's per-thread ``var<private>`` chain state and sequential MH loop
(src/shader_gen.rs:312-442).  Semantics preserved:

  * independence proposal; acceptance
    ``log u < log_p(x') + log_q(x) - log_p(x) - log_q(x')``
    (src/shader_gen.rs:525-534),
  * distinct random streams for chain init, proposals and accept draws
    (the reference offsets counters by +1000000 / +999999,
    src/shader_gen.rs:477-536; here: distinct fold_in tags),
  * burn-in steps advance the chain but are not accumulated,
  * the accumulator adds f(current_x) every sampling step whether or not
    the step accepted (correct MH),
  * per-chain output is ``acc / n_steps``; chains are averaged unweighted
    (src/shader_gen.rs:574-579, src/lib.rs:419-431),
  * closed-form log-PDFs for analytic families, table lookup with the -100
    floor for CUSTOM (src/shader_gen.rs:543-571).

As a new observability feature over the reference, the sampling-phase
acceptance rate is returned alongside the estimates.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from ..sampling import DistKind, log_pdf, sample_block
from ..utils.dispatch import round_up

__all__ = ["build_mcmc_fn", "plan_chains", "split_rhat_ess"]

# fold_in stream tags
_STREAM_INIT = 0
_STREAM_PROPOSAL = 1
_STREAM_ACCEPT = 2

# Adaptive random-walk log-step clamp: steps outside [1e-6, 1e6] mean the
# adaptation diverged (e.g. a target whose log-pdf never varies); clamping
# keeps exp(log_step) finite rather than silently freezing the chain.
_RW_LOG_STEP_MIN = jnp.float32(-13.815511)  # log(1e-6)
_RW_LOG_STEP_MAX = jnp.float32(13.815511)  # log(1e6)


def split_rhat_ess(w_tot, ss_tot, m_total, n1):
    """Split-R-hat + ESS from reduced split-half statistics.

    ``w_tot`` = sum over the m_total sequences of within-sequence
    variances; ``ss_tot`` = total SS of sequence means around the global
    mean; ``n1`` = draws per sequence.  R-hat = sqrt(var+/W) with
    var+ = (n1-1)/n1 W + var(seq_means).  ESS is the classic
    m*n*var+/B form, capped at the diagnostic draw count.

    Degenerate W == 0 splits two ways: sequences frozen at DIFFERENT
    values (var_means > 0) is the worst divergence — R-hat = +inf, not
    1; everything frozen at ONE value is the constant case — R-hat = 1.
    """
    m_total = jnp.float32(m_total)
    w = w_tot / m_total
    var_means = ss_tot / jnp.maximum(m_total - 1.0, 1.0)
    n1f = jnp.float32(max(int(n1), 1))
    var_plus = (n1f - 1.0) / n1f * w + var_means
    r = jnp.sqrt(var_plus / jnp.maximum(w, 1e-30))
    r = jnp.where(
        w > 0,
        r,
        jnp.where(
            var_means > 0, jnp.float32(float("inf")), jnp.float32(1.0)
        ),
    )
    total_draws = m_total * n1f
    ess = m_total * var_plus / jnp.maximum(var_means, 1e-30)
    ess = jnp.where(
        var_means > 0, jnp.minimum(ess, total_draws), total_draws
    )
    return r, ess


def plan_chains(
    n_chains: int, target_threads: Optional[int], n_dev: int = 1
) -> int:
    """Total chain count: ``target_threads`` overrides ``n_chains`` when
    given (reference quirk, src/engine.rs:860), rounded up to a common
    multiple of 256 and the device count (a plain max() would break meshes
    whose size doesn't divide 256, e.g. 3 devices); ALL rounded-up chains
    run and enter the final average (src/engine.rs:864-871)."""
    import math as _math

    chains = target_threads if target_threads is not None else n_chains
    return round_up(max(int(chains), 1), _math.lcm(256, max(int(n_dev), 1)))


def build_mcmc_fn(
    eval_fns: Sequence[Callable],
    proposal_kind: DistKind,
    target_kind: DistKind,
    n_steps: int,
    n_burnin: int,
    total_chains: int,
    mesh: Optional[jax.sharding.Mesh] = None,
    axis_name: str = "mc",
    with_state: bool = False,
    use_init_state: bool = False,
    targ_table_uniform: bool = False,
    prop_table_uniform: bool = False,
    prop_exact_inverse: bool = False,
    with_stderr: bool = False,
    with_diagnostics: bool = False,
    random_walk: bool = False,
    rw_adapt: bool = False,
    with_samples: int = 0,
    hmc_leapfrog: int = 0,
):
    """Build a jitted MH program.

    Signature of the returned function::

        (seed, proposal_params, target_params,
         prop_x_table, prop_cdf_table,          # proposal sampling tables
         targ_logpdf_x, targ_logpdf,            # target log-pdf table
         prop_logpdf_x, prop_logpdf)            # proposal log-pdf table
        -> ((K,) float32 estimates, () float32 acceptance_rate)

    Analytic families ignore their tables (dummy 1-element arrays).

    With ``with_state=True`` (a checkpoint/resume capability the stateless
    one-shot reference lacks, SURVEY.md §5) the function takes three extra
    trailing args ``(x0, logp0, segment)`` — chain state of shape
    (total_chains,) plus an int32 segment counter folded into the RNG key so
    resumed segments draw fresh streams — and additionally returns the final
    ``(x, logp)`` so chains can be extended across calls; the initial state
    is consumed only when ``use_init_state=True`` (otherwise a fresh
    proposal draw initialises the chains and the state args are ignored —
    pass zeros).

    ``with_stderr=True`` (stateless only): the program returns a third
    ``(K,)`` array of standard errors estimated from the BETWEEN-CHAIN
    variance of the per-chain means — chains draw independent streams, so
    ``stderr_i = sqrt(Var[chain_means_i] / n_chains)`` is a valid Monte
    Carlo error bar that automatically accounts for within-chain
    autocorrelation (an addition over the reference).  Squares are
    accumulated around per-device chain-mean centroids and recombined
    with the global mean, so no float32 cancellation at any offset.

    ``random_walk=True`` (a proposal family beyond the reference's
    independence-only sampler, see distributions.RandomWalk): the
    proposal becomes ``x' = x + step * z`` with ``z ~ N(0, 1)`` and the
    symmetric density cancels from the acceptance ratio (``log u <
    log_p(x') - log_p(x)``).  ``proposal_params`` is then the (4,) row
    ``(step, init_lo, init_hi, target_accept)``; the proposal-side
    tables and ``proposal_kind`` are ignored (pass dummies), and fresh
    chains initialise uniformly over (init_lo, init_hi).  With
    ``rw_adapt=True`` each chain Robbins-Monro-tunes its own log step
    toward ``target_accept`` during burn-in (``gamma_i = i^-0.6``) and
    freezes it for the sampling phase.

    ``hmc_leapfrog=L`` (with ``random_walk=True``; see
    distributions.HMC): the proposal becomes an L-step leapfrog
    trajectory through the Hamiltonian ``H(x, p) = -log p(x) + p^2/2``
    with a fresh per-chain momentum ``p ~ N(0, 1)`` each iteration and
    the exact Metropolis energy correction in the acceptance.  The
    position gradient is JAX autodiff of the target log-density (the
    interpolant slope for table targets).  Step adaptation, init, and
    the parameter row are exactly the random walk's.

    ``with_samples=m`` (stateless only, ``1 <= m <= n_steps``): the
    program additionally returns an ``(m, total_chains)`` float32 array
    of thinned post-burn-in draws — the chain states at sampling steps
    ``n_burnin + j * (n_steps // m)`` (the same states the accumulators
    integrate), written into a carried buffer so memory stays at the
    user-chosen m regardless of n_steps.  On a mesh the buffer is
    sharded over the chain axis.  A raw-draw surface the
    expectations-only reference lacks (its chains never leave the
    device, src/shader_gen.rs:390-392).

    ``with_diagnostics=True`` (stateless only, ``n_steps >= 4``): the
    program additionally returns two ``(K,)`` arrays — split-R-hat and
    ESS.  R-hat is the Gelman-Rubin potential-scale-reduction statistic
    computed by splitting every chain's sampling phase into two equal
    halves (2 * n_chains sequences of n_steps // 2 draws; an odd final
    step is excluded from the diagnostic only): near 1 indicates the
    chains mixed; well above 1 flags a slow-mixing proposal/target
    pairing.  ESS is the classic ``m*n*var+ / B`` effective sample size
    (capped at the diagnostic draw count).  Accumulation is
    pilot-shifted like the stderr path; cross-device recombination uses
    Chan's formula.
    """
    if with_stderr and with_state:
        raise ValueError("with_stderr applies to stateless MCMC programs only")
    if with_diagnostics and with_state:
        raise ValueError(
            "with_diagnostics applies to stateless MCMC programs only"
        )
    if with_samples:
        # Thinned post-burn-in draws: a carried (m, local_chains) buffer
        # written every `stride` sampling steps (a capability beyond the
        # expectations-only reference — raw chain output for downstream
        # inference, at user-bounded memory).
        if with_state:
            raise ValueError(
                "with_samples applies to stateless MCMC programs only"
            )
        if not 1 <= int(with_samples) <= n_steps:
            raise ValueError(
                f"with_samples must be in [1, n_steps={n_steps}], got "
                f"{with_samples}"
            )
    sample_stride = n_steps // with_samples if with_samples else 0
    if with_diagnostics and n_steps < 4:
        # Each half-sequence needs >= 2 draws: at n1 = 1 the within-half
        # variance is identically zero and R-hat would be meaningless.
        raise ValueError("with_diagnostics needs n_steps >= 4")
    k = len(eval_fns)
    vfns = [jax.vmap(f) for f in eval_fns]
    n_dev = 1 if mesh is None else mesh.size
    if total_chains % n_dev != 0:
        raise ValueError("total_chains must divide evenly over devices")
    local_chains = total_chains // n_dev
    n_iters = n_burnin + n_steps

    def _chain_sweep(
        seed,
        prop_params,
        targ_params,
        prop_x_table,
        prop_cdf_table,
        targ_lx,
        targ_lp,
        prop_lx,
        prop_lp,
        device_idx,
        init_x=None,
        init_logp=None,
        segment=None,
    ):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), device_idx)
        if segment is not None:
            # Resumed segments must draw FRESH streams: without this fold a
            # same-seed continuation would replay the original segment's
            # proposals/accepts exactly (the independence sampler then
            # resynchronises onto the old trajectory).  Segment 0 (a fresh
            # stateful run) skips the fold so merely enabling
            # return_state=True reproduces the stateless run's estimates.
            key = jnp.where(
                segment == 0, key, jax.random.fold_in(key, segment)
            )
        key_init = jax.random.fold_in(key, _STREAM_INIT)
        key_prop = jax.random.fold_in(key, _STREAM_PROPOSAL)
        key_acc = jax.random.fold_in(key, _STREAM_ACCEPT)

        def target_log_pdf(x):
            return log_pdf(
                target_kind, targ_params, x, targ_lx, targ_lp,
                uniform=targ_table_uniform,
            )

        def proposal_log_pdf(x):
            return log_pdf(
                proposal_kind, prop_params, x, prop_lx, prop_lp,
                uniform=prop_table_uniform,
            )

        if random_walk:
            rw_step = prop_params[0]
            rw_lo, rw_hi = prop_params[1], prop_params[2]
            rw_target = prop_params[3]

        if init_x is not None:
            x0, logp0 = init_x, init_logp
        elif random_walk:
            # Overdispersed uniform init over the caller-chosen range
            # (default: the target's central 98% interval) — there is no
            # proposal distribution to draw a start from.
            u0 = jax.random.uniform(
                key_init, (local_chains,), jnp.float32
            )
            x0 = rw_lo + u0 * (rw_hi - rw_lo)
            logp0 = target_log_pdf(x0)
        else:
            x0 = sample_block(
                key_init,
                (local_chains,),
                proposal_kind,
                prop_params,
                prop_x_table,
                prop_cdf_table,
                exact_inverse=prop_exact_inverse,
            )
            logp0 = target_log_pdf(x0)
        # The carried third slot: the chain's own proposal log-density
        # for the independence sampler (it only changes on acceptance),
        # the per-chain log step for the random walk (it only changes
        # while adapting during burn-in).
        if random_walk:
            aux0 = jnp.full(
                (local_chains,), jnp.log(rw_step), jnp.float32
            )
        else:
            aux0 = proposal_log_pdf(x0)

        shift_needed = with_stderr or with_diagnostics
        if shift_needed:
            # Accumulation pilot: without a shift the per-chain f32
            # accumulator swamps the between-chain signal when
            # |E[f]| >> std (acc ~ n_steps*E[f], ulp >> chain spread).
            # f evaluated at the init draw is on the right scale; the
            # shift is added back exactly once per chain at the end.
            pilot = jnp.stack(
                [jnp.mean(vf(x0).astype(jnp.float32)) for vf in vfns]
            )

        n1 = n_steps // 2  # split-half length (odd last step excluded)

        def step(carry, i):
            if with_samples:
                carry, buf = carry[:-1], carry[-1]
            if with_diagnostics:
                x, logp, aux, acc, n_accept, halves = carry
            else:
                x, logp, aux, acc, n_accept = carry
            if random_walk:
                z = jax.random.normal(
                    jax.random.fold_in(key_prop, i),
                    (local_chains,),
                    jnp.float32,
                )
                step_sz = jnp.exp(aux) if rw_adapt else rw_step
                if hmc_leapfrog:
                    # Leapfrog trajectory from a fresh momentum (z), as
                    # L kick-drift-kick steps carrying the gradient so
                    # each step costs ONE grad eval.  NaNs from leaving
                    # the support reject naturally (NaN log_alpha
                    # compares False).
                    grad_logp = jax.grad(
                        lambda xv: jnp.sum(target_log_pdf(xv))
                    )
                    eps = step_sz

                    def leap(_, c):
                        xq, p, g = c
                        p = p + 0.5 * eps * g
                        xq = xq + eps * p
                        g = grad_logp(xq)
                        p = p + 0.5 * eps * g
                        return xq, p, g

                    xp, pf, _ = jax.lax.fori_loop(
                        0, hmc_leapfrog, leap, (x, z, grad_logp(x))
                    )
                    logp_prop = target_log_pdf(xp)
                    # Exact Metropolis energy correction: the kinetic
                    # terms join the density ratio.
                    log_alpha = (
                        logp_prop - 0.5 * pf * pf
                    ) - (logp - 0.5 * z * z)
                    # A diverged trajectory (f32 overflow -> inf - inf)
                    # must reject, not NaN-poison the step adaptation.
                    log_alpha = jnp.where(
                        jnp.isnan(log_alpha), -jnp.inf, log_alpha
                    )
                else:
                    xp = x + step_sz * z
                    logp_prop = target_log_pdf(xp)
                    # Symmetric proposal: the q terms cancel.
                    log_alpha = logp_prop - logp
            else:
                xp = sample_block(
                    jax.random.fold_in(key_prop, i),
                    (local_chains,),
                    proposal_kind,
                    prop_params,
                    prop_x_table,
                    prop_cdf_table,
                    exact_inverse=prop_exact_inverse,
                )
                logp_prop = target_log_pdf(xp)
                logq_prop = proposal_log_pdf(xp)
                log_alpha = logp_prop + aux - logp - logq_prop
            u = jax.random.uniform(
                jax.random.fold_in(key_acc, i), (local_chains,), jnp.float32
            )
            accept = jnp.log(jnp.maximum(u, 1e-38)) < log_alpha
            x = jnp.where(accept, xp, x)
            logp = jnp.where(accept, logp_prop, logp)
            if random_walk:
                if rw_adapt:
                    # Robbins-Monro on the log step, burn-in only: the
                    # step's acceptance PROBABILITY (not the noisy
                    # indicator) drives the update; gamma_i = i^-0.6.
                    alpha_p = jnp.exp(jnp.minimum(log_alpha, 0.0))
                    gamma = jnp.exp(
                        jnp.float32(-0.6)
                        * jnp.log((i + 1).astype(jnp.float32))
                    )
                    aux = jnp.where(
                        i < n_burnin,
                        jnp.clip(
                            aux + gamma * (alpha_p - rw_target),
                            _RW_LOG_STEP_MIN,
                            _RW_LOG_STEP_MAX,
                        ),
                        aux,
                    )
            else:
                aux = jnp.where(accept, logq_prop, aux)

            collect = i >= n_burnin
            ys = jnp.stack(
                [vf(x) for vf in vfns]
            ).astype(jnp.float32)  # (K, chains)
            if shift_needed:
                sv = ys - pilot[:, None]
            vals = sv if with_stderr else ys
            acc = acc + jnp.where(collect, vals, 0.0)
            n_accept = n_accept + jnp.where(
                collect, jnp.sum(accept.astype(jnp.float32)), 0.0
            )
            if with_samples:
                # Thinned draw: record the post-step state at sampling
                # steps n_burnin + j*stride (the same states the
                # accumulators integrate).
                j = (i - jnp.int32(n_burnin)) // jnp.int32(sample_stride)
                on_grid = (
                    i - jnp.int32(n_burnin)
                ) % jnp.int32(sample_stride) == 0
                hit = jnp.logical_and(
                    i >= n_burnin,
                    jnp.logical_and(on_grid, j < with_samples),
                )
                pos = jnp.clip(j, 0, with_samples - 1)
                cur = jax.lax.dynamic_index_in_dim(
                    buf, pos, 0, keepdims=False
                )
                buf = jax.lax.dynamic_update_index_in_dim(
                    buf, jnp.where(hit, x, cur), pos, 0
                )
            samp = (buf,) if with_samples else ()
            if with_diagnostics:
                acc1, sq1, acc2, sq2 = halves
                h1 = jnp.logical_and(i >= n_burnin, i < n_burnin + n1)
                h2 = jnp.logical_and(
                    i >= n_burnin + n1, i < n_burnin + 2 * n1
                )
                acc1 = acc1 + jnp.where(h1, sv, 0.0)
                sq1 = sq1 + jnp.where(h1, sv * sv, 0.0)
                acc2 = acc2 + jnp.where(h2, sv, 0.0)
                sq2 = sq2 + jnp.where(h2, sv * sv, 0.0)
                return (
                    x, logp, aux, acc, n_accept, (acc1, sq1, acc2, sq2)
                ) + samp, None
            return (x, logp, aux, acc, n_accept) + samp, None

        zk = lambda: jnp.zeros((k, local_chains), jnp.float32)  # noqa: E731
        init = (x0, logp0, aux0, zk(), jnp.float32(0.0))
        if with_diagnostics:
            init = init + ((zk(), zk(), zk(), zk()),)
        if with_samples:
            init = init + (
                jnp.zeros((with_samples, local_chains), jnp.float32),
            )
        carry, _ = jax.lax.scan(
            step, init, jnp.arange(n_iters, dtype=jnp.int32)
        )
        samples_buf = ()
        if with_samples:
            carry, samples_buf = carry[:-1], (carry[-1],)
        if with_diagnostics:
            x_f, logp_f, _, acc, n_accept, halves = carry
        else:
            x_f, logp_f, _, acc, n_accept = carry

        diag = ()
        if with_diagnostics:
            # Split-R-hat ingredients: per-sequence (= half-chain) means
            # and within-sequence variances, reduced locally to (k,)
            # sums + (centroid, SS) pairs for Chan recombination.  All
            # in pilot-shifted space (variances are shift-invariant; the
            # centroid is restored for the cross-device mean).
            acc1, sq1, acc2, sq2 = halves
            n1f = jnp.float32(max(n1, 1))
            mh = [acc1 / n1f, acc2 / n1f]
            within = [
                (sq - n1f * m * m) / jnp.float32(max(n1 - 1, 1))
                for sq, m in zip((sq1, sq2), mh)
            ]
            w_sum = jnp.sum(within[0] + within[1], axis=1)
            seq = jnp.concatenate(mh, axis=1)  # (k, 2*local_chains)
            mb_d = jnp.mean(seq, axis=1)
            ss_d = jnp.sum((seq - mb_d[:, None]) ** 2, axis=1)
            diag = ((w_sum, mb_d + pilot, ss_d),)

        # Per-chain means, summed over local chains (global divide later).
        chain_means = acc / jnp.float32(n_steps)
        if with_stderr:
            # chain_means here are pilot-SHIFTED: squares center on the
            # shifted local centroid (the shift cancels inside the
            # differences), and the shift is restored exactly once per
            # chain in the sums/centroid the wrapper recombines with
            # (Chan's formula around the global mean).
            mb_s = jnp.mean(chain_means, axis=1)
            ss = jnp.sum((chain_means - mb_s[:, None]) ** 2, axis=1)
            sums = (
                jnp.sum(chain_means, axis=1)
                + jnp.float32(local_chains) * pilot
            )
            return (
                (sums, n_accept, x_f, logp_f, ss, mb_s + pilot)
                + diag + samples_buf
            )
        return (
            (jnp.sum(chain_means, axis=1), n_accept, x_f, logp_f)
            + diag + samples_buf
        )

    denom_vals = jnp.float32(total_chains)
    denom_acc = jnp.float32(total_chains) * jnp.float32(max(n_steps, 1))

    def _stderr_of(ss_total):
        # Standard error of the mean of total_chains independent chains
        # (ddof=1; a single chain yields stderr 0 rather than div-0).
        var = ss_total / jnp.maximum(denom_vals - 1.0, 1.0)
        return jnp.sqrt(var / denom_vals)

    m_total = jnp.float32(2 * total_chains)  # split-half sequence count

    def _rhat_of(w_tot, ss_tot):
        return split_rhat_ess(w_tot, ss_tot, m_total, n_steps // 2)

    if mesh is None:
        if with_state:

            @jax.jit
            def run(seed, prop_params, targ_params, *tables_state_segment):
                tables = tables_state_segment[:-3]
                x0, logp0, segment = tables_state_segment[-3:]
                sums, n_accept, x_f, logp_f = _chain_sweep(
                    seed, prop_params, targ_params, *tables, jnp.int32(0),
                    init_x=x0 if use_init_state else None,
                    init_logp=logp0 if use_init_state else None,
                    segment=segment,
                )
                return (
                    sums / denom_vals, n_accept / denom_acc, x_f, logp_f
                )

            return run

        if with_stderr or with_diagnostics or with_samples:

            @jax.jit
            def run(seed, prop_params, targ_params, *tables):
                out = _chain_sweep(
                    seed, prop_params, targ_params, *tables, jnp.int32(0)
                )
                sums, n_accept = out[0], out[1]
                res = (sums / denom_vals, n_accept / denom_acc)
                pos = 6 if with_stderr else 4
                if with_stderr:
                    # Single device: the local centroid IS the global mean.
                    res = res + (_stderr_of(out[4]),)
                if with_diagnostics:
                    w_sum, _, ss_d = out[pos]
                    pos += 1
                    res = res + _rhat_of(w_sum, ss_d)  # (r_hat, ess)
                if with_samples:
                    res = res + (out[pos],)  # (m, total_chains) draws
                return res

            return run

        @jax.jit
        def run(seed, prop_params, targ_params, *tables):
            sums, n_accept, _, _ = _chain_sweep(
                seed, prop_params, targ_params, *tables, jnp.int32(0)
            )
            return sums / denom_vals, n_accept / denom_acc

        return run

    replicated = P()
    sharded = P(axis_name)

    def sharded_body(seed, prop_params, targ_params, *tables_and_state):
        d = jax.lax.axis_index(axis_name)
        if with_state:
            tables = tables_and_state[:-3]
            x0, logp0, segment = tables_and_state[-3:]
            sums, n_accept, x_f, logp_f = _chain_sweep(
                seed, prop_params, targ_params, *tables, d,
                init_x=x0 if use_init_state else None,
                init_logp=logp0 if use_init_state else None,
                segment=segment,
            )
        else:
            sweep_out = _chain_sweep(
                seed, prop_params, targ_params, *tables_and_state, d
            )
            if with_stderr:
                sums, n_accept, x_f, logp_f, ss, mb = sweep_out[:6]
            else:
                sums, n_accept, x_f, logp_f = sweep_out[:4]
        sums = jax.lax.psum(sums, axis_name)
        n_accept = jax.lax.psum(n_accept, axis_name)
        out = (sums / denom_vals, n_accept / denom_acc)
        if with_stderr:
            # Chan's recombination: total SS around the global mean M is
            # sum_d [SS_d + n_d (centroid_d - M)^2].
            m_global = sums / denom_vals
            corr = jnp.float32(local_chains) * (mb - m_global) ** 2
            ss_total = jax.lax.psum(ss + corr, axis_name)
            out = out + (_stderr_of(ss_total),)
        pos = 6 if with_stderr else 4
        if with_diagnostics:
            # Same Chan pattern over the 2x split-half sequences.
            w_sum, mb_d, ss_d = sweep_out[pos]
            pos += 1
            n_loc = jnp.float32(2 * local_chains)
            m_seq = jax.lax.psum(n_loc * mb_d, axis_name) / m_total
            ss_tot = jax.lax.psum(
                ss_d + n_loc * (mb_d - m_seq) ** 2, axis_name
            )
            w_tot = jax.lax.psum(w_sum, axis_name)
            out = out + _rhat_of(w_tot, ss_tot)  # (r_hat, ess)
        if with_samples:
            # Per-device (m, local_chains) buffers concatenate along the
            # chain axis via the sharded out_spec.
            out = out + (sweep_out[pos],)
        if with_state:
            out = out + (x_f, logp_f)
        return out

    n_table_args = 9
    in_specs = (replicated,) * n_table_args
    out_specs = (replicated, replicated)
    if with_stderr:
        out_specs = out_specs + (replicated,)
    if with_diagnostics:
        out_specs = out_specs + (replicated, replicated)
    if with_samples:
        # (m, total_chains): thinned draws sharded over the chain axis.
        out_specs = out_specs + (P(None, axis_name),)
    if with_state:
        in_specs = in_specs + (sharded, sharded, replicated)
        out_specs = out_specs + (sharded, sharded)

    shard_mapped = jax.shard_map(
        sharded_body,
        mesh=mesh,
        in_specs=in_specs,
        out_specs=out_specs,
        check_vma=False,
    )

    @jax.jit
    def run(seed, prop_params, targ_params, *rest):
        return shard_mapped(seed, prop_params, targ_params, *rest)

    return run
