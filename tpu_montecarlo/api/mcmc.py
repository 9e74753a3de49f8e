"""Scalar-chain MCMC: integrate_mcmc / compile_mcmc, checkpoint and
resume, and the Pallas/XLA MCMC program builders with their
eligibility gates."""

from __future__ import annotations

import hashlib
from typing import Callable, List, Optional, Union

import numpy as np

import jax
import jax.numpy as jnp

from ..distributions import Distribution, HMC, RandomWalk
from ..ops.integrate_xla import build_integrate_fn
from ..ops.mcmc_xla import build_mcmc_fn, plan_chains
from ..sampling import (
    DistKind,
    dist_spec_of,
    ensure_param_batch_family,
    pdf_from_table,
)
from ..tables import is_uniform_grid
from ..tracing import TraceError, trace_function
from ..utils.dispatch import make_integrate_plan
from ..wgsl_frontend import trace_wgsl_function

from .batching import (
    _check_param_batch_args,
    _check_random_walk_args,
    _checked_batch_prog,
    _nd_mcmc_param_map_adapter,
    _nd_mcmc_param_prog,
    _nd_param_map_adapter,
    _nd_param_prog,
    _target_arity,
)
from .cache import (
    _GLOBAL_CACHE,
    _ProgramCache,
    _block_traceable,
    _fn_key,
    _fns_key,
    _mesh_key,
    _resolve_mesh,
    _tag_native_batch,
)
from .device import (
    _device_args_of,
    _device_gapped_tables,
    _device_log_tables_of,
    _device_mode_tables,
    _device_uniform_log_tables,
    _mcmc_prop_inverse,
    _proposal_kernel_log_tables,
    _table_shapes,
    _tbl,
    _uniform_log_tables,
    _uniform_table_mode,
)
from .results import (
    IntegrationResult,
    McmcState,
    _unit_integrand,
    _weight_diagnostics,
)


class _McmcMixin:
    # ------------------------------------------------------------------
    # MCMC
    # ------------------------------------------------------------------

    def integrate_mcmc(
        self,
        functions: List[Union[Callable, str]],
        target_distribution: Distribution,
        proposal_distribution: Union[Distribution, RandomWalk],
        n_steps: int = 10_000,
        n_chains: int = 1024,
        n_burnin: int = 1_000,
        seed: int = 42,
        initial_state: Optional[McmcState] = None,
        return_state: bool = False,
        return_stderr: bool = False,
        return_diagnostics: bool = False,
        return_samples: Optional[int] = None,
        temperatures: Optional[List[float]] = None,
    ) -> IntegrationResult:
        """Compute E_p[f(X)] with parallel independence-sampler
        Metropolis-Hastings chains (one chain per device thread).

        ``temperatures=[1.0, T_2, ..., T_R]`` (ascending, first entry
        1.0; takes a :class:`RandomWalk` / :class:`HMC` proposal or a
        proposal ``Distribution`` — the independence sampler tempers
        too, with the state-independent log-q terms untempered in the
        acceptance) switches on PARALLEL TEMPERING: every chain is
        replicated at
        each temperature against ``p(x)^(1/T)``, adjacent rungs
        exchange states through the replica-exchange acceptance rule
        every step, and the estimates come from the T=1 rung — the hot
        rungs cross energy barriers the cold sampler cannot, so
        multimodal targets mix (see ops/mcmc_pt.py).  Tempered results
        always carry ``result.diagnostics["swap_rate"]`` (accepted /
        attempted exchanges — ~0 means the ladder's rungs don't
        overlap, near 1 means rungs are redundant; healthy is roughly
        0.2-0.6).  Composes with ``return_stderr``,
        ``return_diagnostics`` and ``return_samples`` (cold-rung
        draws); stateless runs only; XLA backend.

        ``return_samples=m`` (stateless runs, ``1 <= m <= n_steps``):
        ``result.samples`` holds (m, n_chains) float32 thinned
        post-burn-in draws — the chain states every ``n_steps // m``
        sampling steps — raw chain output for downstream inference
        (histograms, quantiles, posterior predictive) at user-bounded
        memory; a surface the expectations-only reference lacks (its
        chains never leave the device, src/shader_gen.rs:390-392).
        Rides the Pallas kernel on eligible workloads (draw rows are
        stored from registers; estimates bit-identical to the
        samples-free run), the XLA backend otherwise.

        Passing :class:`RandomWalk` as ``proposal_distribution`` switches
        to random-walk MH — ``x' = x + step * N(0, 1)``, acceptance
        ``log u < log p(x') - log p(x)`` — a proposal family beyond the
        reference's independence-only sampler; use it whenever no
        analytic family envelopes the target well (the independence
        chain's acceptance collapses there, the random walk still mixes).
        ``RandomWalk(adapt=True)`` tunes the step per chain during
        burn-in toward ``target_accept``; adaptive runs are
        stateless-only (the tuned steps are not checkpointed).

        Passing :class:`HMC` switches to Hamiltonian Monte Carlo:
        each iteration draws a fresh momentum, runs ``n_leapfrog``
        leapfrog steps guided by the autodiff gradient of the target's
        log-density, and applies the exact Metropolis energy
        correction — trajectories cross the target in a few steps where
        a random walk diffuses, so the effective sample size per step
        is far higher on smooth targets.  Works with analytic, table
        (piecewise-linear gradient), and joint log-density targets;
        ``adapt=True`` tunes the step toward ``target_accept=0.8``
        during burn-in exactly as the random walk does.

        ``return_state=True`` attaches the final per-chain state to the
        result; passing it back as ``initial_state`` resumes those chains
        (skipping the fresh proposal-draw initialisation; burn-in still
        runs as requested).

        ``return_stderr=True`` (stateless runs only): ``result.stderr``
        estimates the standard error of each value from the BETWEEN-CHAIN
        variance of the per-chain means — chains are independent, so this
        is a valid MCMC error bar that automatically accounts for
        within-chain autocorrelation (an addition over the reference).
        Error bars ride the Pallas kernel whenever the plain run would
        (pilot-shifted per-program squares, Chan-recombined).

        ``return_diagnostics=True`` (stateless runs, ``n_steps >= 4``):
        ``result.diagnostics["r_hat"]`` is the split-R-hat
        potential-scale-reduction statistic per function — each chain's
        sampling phase is split into two halves and the between- vs
        within-sequence variances compared; values near 1 indicate
        mixing, values well above 1 flag a proposal that explores the
        target too slowly.  ``result.diagnostics["ess"]`` is the
        matching effective sample size (m*n*var+/B, capped at the
        diagnostic draw count): how many INDEPENDENT draws the
        correlated chains are worth.  Diagnostics ride the Pallas
        kernel whenever the plain run would.
        """
        if len(functions) == 0:
            raise ValueError("At least one function is required")
        if n_steps <= 0:
            raise ValueError("n_steps must be positive")
        if n_chains <= 0:
            raise ValueError("n_chains must be positive")
        if n_burnin < 0:
            raise ValueError("n_burnin must be non-negative")
        if return_stderr and (return_state or initial_state is not None):
            raise ValueError(
                "return_stderr applies to stateless MCMC runs only "
                "(resumed segments' between-chain variance reflects the "
                "segment, not the combined run)"
            )
        if return_diagnostics and (
            return_state or initial_state is not None
        ):
            raise ValueError(
                "return_diagnostics applies to stateless MCMC runs only"
            )
        if return_samples is not None:
            m_samp = int(return_samples)
            if return_state or initial_state is not None:
                raise ValueError(
                    "return_samples applies to stateless MCMC runs only"
                )
            if not 1 <= m_samp <= n_steps:
                raise ValueError(
                    f"return_samples must be in [1, n_steps={n_steps}], "
                    f"got {return_samples}"
                )
        else:
            m_samp = 0
        if temperatures is not None:
            return self._integrate_mcmc_pt(
                functions, target_distribution, proposal_distribution,
                temperatures, n_steps, n_chains, n_burnin, seed,
                initial_state, return_state, return_stderr,
                return_diagnostics, m_samp,
            )
        if isinstance(proposal_distribution, RandomWalk):
            _check_random_walk_args(
                proposal_distribution, n_burnin,
                return_state or initial_state is not None,
            )

        p_seq = isinstance(proposal_distribution, (list, tuple))
        t_dist = isinstance(target_distribution, Distribution)
        if p_seq or isinstance(target_distribution, (list, tuple)) or (
            not t_dist and (
                callable(target_distribution)
                or isinstance(target_distribution, str)
            )
        ):
            # Multi-dimensional MCMC (and 1-D custom joint log-density
            # targets, the d=1 case of the same machinery).
            return self._integrate_mcmc_nd(
                functions, target_distribution, proposal_distribution,
                n_steps, n_chains, n_burnin, seed,
                initial_state=initial_state, return_state=return_state,
                return_stderr=return_stderr,
                return_diagnostics=return_diagnostics,
                return_samples=m_samp,
            )

        traced = self._trace_user_functions(functions)

        want_state = return_state or initial_state is not None

        if not want_state:
            stateless, _ = self._get_mcmc_program(
                traced,
                target_distribution,
                proposal_distribution,
                n_steps,
                n_chains,
                n_burnin,
                with_stderr=return_stderr,
                with_diagnostics=return_diagnostics,
                with_samples=m_samp,
            )
            outs = stateless(seed)
            values, acc_rate = outs[0], outs[1]
            idx = 2
            stderr = None
            diagnostics = None
            samples = None
            if return_stderr:
                stderr = outs[idx]
                idx += 1
            if return_diagnostics:
                diagnostics = {
                    "r_hat": np.array(outs[idx], dtype=np.float64),
                    "ess": np.array(outs[idx + 1], dtype=np.float64),
                }
                idx += 2
            if m_samp:
                samples = np.asarray(outs[idx])
            return IntegrationResult(
                values=values,
                n_samples=n_chains * n_steps,
                n_functions=len(functions),
                acceptance_rate=float(acc_rate),
                stderr=stderr,
                diagnostics=diagnostics,
                samples=samples,
            )

        # Checkpoint/resume: both backends surface chain state (the Pallas
        # kernel carries it in registers for the whole sweep and writes the
        # final (x, log_p) blocks; reference bar: state never leaves the
        # device, src/shader_gen.rs:390-392).  The backends plan chain
        # counts differently, so a resume state minted on one routes back
        # to it via its chain count.
        use_init = initial_state is not None
        prog, state_chains = self._get_mcmc_program(
            traced,
            target_distribution,
            proposal_distribution,
            n_steps,
            n_chains,
            n_burnin,
            with_state=True,
            use_init_state=use_init,
            initial_chains=initial_state.n_chains if use_init else None,
        )
        if use_init and initial_state.n_chains != state_chains:
            raise ValueError(
                f"initial_state has {initial_state.n_chains} chains but "
                f"this run plans {state_chains}; pass the state back with "
                "the same n_chains/target_threads (and the backend that "
                "produced it)"
            )
        if use_init:
            x0 = jnp.asarray(initial_state.x, jnp.float32)
            logp0 = jnp.asarray(initial_state.log_p, jnp.float32)
            segment = initial_state.segment + 1
        else:
            x0 = jnp.zeros(state_chains, jnp.float32)
            logp0 = jnp.zeros(state_chains, jnp.float32)
            segment = 0
        values, acc_rate, x_f, logp_f = prog(
            seed, x0, logp0, jnp.int32(segment)
        )
        chain_state = McmcState(
            np.asarray(x_f), np.asarray(logp_f), segment=segment
        )

        total_samples = n_chains * n_steps
        return IntegrationResult(
            values=values,
            n_samples=total_samples,
            n_functions=len(functions),
            acceptance_rate=float(acc_rate),
            chain_state=chain_state if return_state else None,
        )

    def compile_mcmc(
        self,
        functions: List[Union[Callable, str]],
        target_distribution: Distribution,
        proposal_distribution: Union[Distribution, RandomWalk],
        n_steps: int = 10_000,
        n_chains: int = 1024,
        n_burnin: int = 1_000,
        seed_batch: int = 1,
        param_batch: bool = False,
        return_stderr: bool = False,
        temperatures: Optional[List[float]] = None,
        return_samples: Optional[int] = None,
    ) -> Callable:
        """Ahead-of-time MCMC handle for serving: ``prog(seed) ->
        ((K,) jax.Array, acceptance jax scalar)`` — tracing, compilation and
        uploads done once; each call is one device dispatch.  With
        ``seed_batch=R``: ``prog(seeds) -> ((R, K), (R,))`` in one dispatch
        (see compile_integrate).

        ``return_samples=m`` (untempered 1-D handles): the handle
        additionally returns — LAST — the (m, chains) thinned
        post-burn-in draws (see :meth:`integrate_mcmc`); rides the
        Pallas kernel's in-register draw output on eligible workloads.
        Composes with ``seed_batch``/``param_batch``: each batch rep
        streams its own draw slab, returned as (R, m, chains).

        ``return_stderr=True``: the handle returns ``(values,
        acceptance, stderrs)`` — with a seed or param batch,
        per-element between-chain error bars ride the same batched
        kernel grid (each rep's in-kernel pilot comes from its own
        init draw).

        ``param_batch=True`` additionally makes both distributions'
        parameters runtime batch inputs: ``prog(seeds, target_params,
        proposal_params) -> ((R, K), (R,))`` with each params arg an
        (R, 2) float32 array (:func:`pack_param_batch`; R =
        ``seed_batch``) — one compiled program serves a whole
        posterior/proposal sweep per dispatch.  Analytic families only.
        With a :class:`RandomWalk` proposal the proposal-params slot
        instead takes (R, 4) walk rows (:func:`pack_random_walk_batch`;
        (R, d, 4) via :func:`pack_random_walk_batch_nd` for nd runs) —
        one program serves a step-size/adaptation sweep, e.g. for
        calibrating the walk against a batch of tempered targets."""
        if len(functions) == 0:
            raise ValueError("At least one function is required")
        if n_steps <= 0:
            raise ValueError("n_steps must be positive")
        if n_chains <= 0:
            raise ValueError("n_chains must be positive")
        if n_burnin < 0:
            raise ValueError("n_burnin must be non-negative")
        if return_samples is not None:
            m_samp = int(return_samples)
            if not 1 <= m_samp <= n_steps:
                raise ValueError(
                    f"return_samples must be in [1, n_steps={n_steps}], "
                    f"got {return_samples}"
                )
            if temperatures is not None:
                raise ValueError(
                    "compile_mcmc(return_samples=...) supports untempered "
                    "handles only (tempered cold-rung draws ride "
                    "integrate_mcmc)"
                )
        else:
            m_samp = 0
        if temperatures is not None:
            # Tempered serving handle: prog(seed[s]) -> (values,
            # acceptance, swap_rate) triples; rides the tempering
            # kernel's batch grid when eligible (see _compile_mcmc_pt).
            return self._compile_mcmc_pt(
                functions, target_distribution, proposal_distribution,
                temperatures, n_steps, n_chains, n_burnin, seed_batch,
                param_batch, return_stderr,
            )
        p_seq = isinstance(proposal_distribution, (list, tuple))
        t_dist = isinstance(target_distribution, Distribution)
        if p_seq or isinstance(target_distribution, (list, tuple)) or (
            not t_dist and (
                callable(target_distribution)
                or isinstance(target_distribution, str)
            )
        ):
            if m_samp and param_batch:
                raise ValueError(
                    "compile_mcmc(return_samples=...) does not compose "
                    "with nd param_batch"
                )
            return self._compile_mcmc_nd(
                functions, target_distribution, proposal_distribution,
                n_steps, n_chains, n_burnin, seed_batch, param_batch,
                return_stderr, return_samples=m_samp,
            )
        if isinstance(proposal_distribution, RandomWalk):
            _check_random_walk_args(
                proposal_distribution, n_burnin, False
            )
            if param_batch:
                # The proposal-params slot takes (R, 4) RandomWalk rows
                # (pack_random_walk_batch); only the target's family is
                # gated to the analytic, runtime-parameterizable set.
                ensure_param_batch_family(
                    dist_spec_of(target_distribution).kind, "target"
                )
        elif param_batch:
            for role, d in (
                ("target", target_distribution),
                ("proposal", proposal_distribution),
            ):
                ensure_param_batch_family(dist_spec_of(d).kind, role)
        traced = self._trace_user_functions(functions)
        prog, _ = self._get_mcmc_program(
            traced,
            target_distribution,
            proposal_distribution,
            n_steps,
            n_chains,
            n_burnin,
            seed_batch=seed_batch,
            param_batch=param_batch,
            with_stderr=return_stderr,
            with_samples=m_samp,
        )
        return prog

    def _mcmc_pallas_ok(
        self, traced, prop_spec, targ_spec,
        target_distribution, proposal_distribution,
        random_walk: bool = False,
        stateful: bool = False,
    ) -> bool:
        """Pallas-kernel eligibility for an MCMC workload: CUSTOM families
        need uniform log-pdf x-grids (host-built ones are) for the
        in-kernel lookups, and K stays under 128 so each thread's K
        accumulators fit in registers.  Anything else routes to the XLA
        backend.
        ``random_walk=True`` (prop_spec is None): the proposal is a
        tableless symmetric Gaussian step, so only the target-side checks
        apply."""
        probe_kind = targ_spec.kind if random_walk else prop_spec.kind
        if not self._use_pallas(probe_kind):
            return False
        from ..ops.mcmc_pallas import mcmc_pallas_supports

        ok = (
            mcmc_pallas_supports(probe_kind, targ_spec.kind)
            and len(traced) < 128
            and _block_traceable(traced)
        )
        if ok and targ_spec.kind == DistKind.CUSTOM:
            ok = _uniform_log_tables(target_distribution) is not None
        if ok and not random_walk and prop_spec.kind == DistKind.CUSTOM:
            # exact_inverse proposals sample through host-built
            # gap-respecting tables.  STATELESS
            # non-gapped proposals run sampler-mode logq (the draw's
            # own slope is the exact proposal density), so they need no
            # q-table fidelity pipeline at all; gapped and stateful
            # runs evaluate the q-table per step and must pass it.
            needs_q_table = stateful or prop_spec.exact_inverse
            ok = not prop_spec.heavy_tail and (
                prop_spec.exact_inverse
                or (
                    prop_spec.x_table is not None
                    and prop_spec.x_table.shape[0] >= 2
                )
            )
            if ok and needs_q_table:
                ok = (
                    _proposal_kernel_log_tables(proposal_distribution)
                    is not None
                )
        return ok

    def _get_mcmc_program(
        self,
        traced,
        target_distribution,
        proposal_distribution,
        n_steps,
        n_chains,
        n_burnin,
        with_state: bool = False,
        use_init_state: bool = False,
        initial_chains: Optional[int] = None,
        seed_batch: int = 1,
        param_batch: bool = False,
        with_stderr: bool = False,
        with_diagnostics: bool = False,
        with_samples: int = 0,
    ):
        """MCMC program + the chain count its state carries.

        Stateless: ``prog(seed) -> (values, acceptance)``.  With
        ``with_state=True``: ``prog(seed, x0, logp0, segment) -> (values,
        acceptance, x_final, logp_final)``; ``initial_chains`` (the resume
        state's chain count, if resuming) steers routing — a state minted
        by the XLA backend keeps routing there when its count doesn't fit
        the Pallas plan."""
        if with_state and seed_batch != 1:
            raise ValueError(
                "seed_batch applies to stateless MCMC programs only"
            )
        if with_state and param_batch:
            raise ValueError(
                "param_batch applies to stateless MCMC programs only"
            )
        if with_stderr and with_state:
            raise ValueError(
                "with_stderr applies to stateless MCMC programs only"
            )
        if with_diagnostics:
            if with_state:
                raise ValueError(
                    "with_diagnostics applies to stateless MCMC programs "
                    "only"
                )
            if seed_batch != 1 or param_batch:
                raise ValueError(
                    "with_diagnostics is not supported on batched programs"
                )
        if with_samples and with_state:
            raise ValueError(
                "return_samples applies to stateless MCMC runs only"
            )
        random_walk = isinstance(proposal_distribution, RandomWalk)
        rw_adapt = random_walk and proposal_distribution.adapt
        hmc_L = (
            proposal_distribution.n_leapfrog
            if isinstance(proposal_distribution, HMC)
            else 0
        )
        prop_spec = (
            None if random_walk else dist_spec_of(proposal_distribution)
        )
        targ_spec = dist_spec_of(target_distribution)
        mesh = self._mesh
        n_dev = 1 if mesh is None else mesh.size
        total_chains = plan_chains(n_chains, self._target_threads, n_dev)

        # (HMC rides the kernel on CUSTOM table targets too: the
        # position gradient is the log-table interpolant's gathered
        # slope, not a gather-VJP scatter — see _Chains.log_pdf_grad.
        # Raw draws ride the kernel as well: thinned states are stored
        # from registers, so the loop and estimates are bit-identical to
        # the samples-free kernel.)
        pallas_ok = self._mcmc_pallas_ok(
            traced, prop_spec, targ_spec,
            target_distribution, proposal_distribution,
            random_walk=random_walk,
            stateful=with_state or use_init_state,
        )
        if pallas_ok and with_state:
            from ..ops.mcmc_pallas import plan_state_chains

            pallas_state_chains = plan_state_chains(total_chains, n_dev)
            if (
                initial_chains is not None
                and initial_chains != pallas_state_chains
                and initial_chains == total_chains
            ):
                pallas_ok = False  # state minted by the XLA backend
        if not pallas_ok:
            self._no_kernel("this MCMC workload is not Pallas-eligible")
        if pallas_ok:
            from ..ops.mcmc_pallas import build_mcmc_fn_pallas

            prop_gapped = (
                not random_walk
                and prop_spec.kind == DistKind.CUSTOM
                and prop_spec.exact_inverse
            )
            # Sampler-mode logq (the kernel's stateless CUSTOM-proposal
            # path) permits an error-bounded coarser inverse table — the
            # draw's own slope supplies the exact proposal density at
            # any resolution (see device._mcmc_prop_inverse).  The
            # downsampled size is per-Distribution, so it joins the
            # program cache key.
            prop_inv_ds = None
            if (
                not random_walk
                and prop_spec.kind == DistKind.CUSTOM
                and not prop_gapped
                and not (with_state or use_init_state)
            ):
                prop_inv_ds = _mcmc_prop_inverse(
                    proposal_distribution, prop_spec
                )
            key = (
                "mcmc_pallas",
                None if prop_inv_ds is None else prop_inv_ds.shape,
                _fns_key(traced),
                (
                    (("hmc", hmc_L, rw_adapt) if hmc_L else ("rw", rw_adapt))
                    if random_walk
                    else prop_spec.kind
                ),
                targ_spec.kind,
                n_steps,
                n_burnin,
                total_chains,
                None if random_walk else _table_shapes(prop_spec),
                _mesh_key(mesh),
                (with_state, use_init_state, prop_gapped),
                seed_batch,
                param_batch,
                with_stderr,
                with_diagnostics,
                with_samples,
            )
            native_batch = seed_batch
            run = self._cache.get_or_build(
                key,
                lambda: _tag_native_batch(
                    build_mcmc_fn_pallas(
                        traced,
                        targ_spec.kind if random_walk else prop_spec.kind,
                        targ_spec.kind,
                        n_steps,
                        n_burnin,
                        total_chains,
                        mesh=mesh,
                        with_state=with_state,
                        use_init_state=use_init_state,
                        prop_gapped=prop_gapped,
                        seed_batch=native_batch,
                        param_batch=param_batch,
                        with_stderr=with_stderr,
                        random_walk=random_walk,
                        rw_adapt=rw_adapt,
                        hmc_leapfrog=hmc_L,
                        with_diagnostics=with_diagnostics,
                        with_samples=with_samples,
                    ),
                    native_batch,
                    param_batch=param_batch,
                ),
            )
            dummy = _tbl(None)
            if random_walk:
                # (step, init_lo, init_hi, target_accept) row; the
                # proposal-side table slots carry dummies (the kernel
                # never reads them for a random walk).
                prop_dev = (
                    jnp.asarray(
                        proposal_distribution.pack_params(
                            target_distribution
                        )
                    ),
                    dummy,
                    dummy,
                )
            elif prop_gapped:
                t, dt = _device_gapped_tables(
                    proposal_distribution, prop_spec, stratified=False
                )
                prop_dev = (
                    _device_args_of(proposal_distribution, prop_spec)[0],
                    t,
                    dt,
                )
            else:
                prop_dev = _device_args_of(
                    proposal_distribution, prop_spec
                )
                if prop_inv_ds is not None:
                    prop_dev = (prop_dev[0], prop_inv_ds, prop_dev[2])
            targ_dev = _device_args_of(target_distribution, targ_spec)
            targ_log_dev = (
                _device_uniform_log_tables(target_distribution)
                if targ_spec.kind == DistKind.CUSTOM
                else (dummy, dummy)
            )
            prop_log_dev = (
                _device_uniform_log_tables(proposal_distribution, "proposal")
                if not random_walk
                and prop_spec.kind == DistKind.CUSTOM
                and prop_inv_ds is None
                else (dummy, dummy)
            )
            static_args = (
                prop_dev[0],
                targ_dev[0],
                prop_dev[1],
                prop_dev[2],
                *targ_log_dev,
                *prop_log_dev,
            )

            if with_state:

                def prog(seed, x0, logp0, segment):
                    return run(np.uint32(seed), *static_args, x0, logp0, segment)

                return prog, pallas_state_chains

            return (
                self._finalize_mcmc_prog(
                    run, static_args, seed_batch, param_batch,
                    (
                        ("rw_adapt" if rw_adapt else "rw", targ_spec.kind)
                        if random_walk
                        else (prop_spec.kind, targ_spec.kind)
                    ),
                ),
                total_chains,
            )

        # Log-pdf tables are fetched for both distributions (reference
        # __init__.py:1077-1081) but only consulted for CUSTOM families —
        # analytic ones use closed forms (shader_gen.rs:543-571).  A
        # random-walk proposal has no density of its own: its table slots
        # carry dummies and its params row is (step, init_lo, init_hi,
        # target_accept).
        targ_lx, targ_lp = target_distribution.get_log_pdf_table()
        targ_uniform = is_uniform_grid(targ_lx)
        if random_walk:
            prop_lx = np.zeros(1, np.float32)
            prop_uniform = False
            prop_kind_key = (
                ("hmc", hmc_L, rw_adapt) if hmc_L else ("rw", rw_adapt)
            )
            prop_kind = DistKind.NORMAL  # ignored by the builder
            prop_exact_inverse = False
            prop_table_key = None
        else:
            prop_lx, prop_lp = proposal_distribution.get_log_pdf_table()
            prop_uniform = is_uniform_grid(prop_lx)
            prop_kind_key = prop_spec.kind
            prop_kind = prop_spec.kind
            prop_exact_inverse = prop_spec.exact_inverse
            prop_table_key = _table_shapes(prop_spec)
        key = (
            "mcmc_xla",
            _fns_key(traced),
            prop_kind_key,
            targ_spec.kind,
            n_steps,
            n_burnin,
            total_chains,
            prop_table_key,
            (targ_lx.shape, prop_lx.shape),
            _mesh_key(mesh),
            (with_state, use_init_state, targ_uniform, prop_uniform),
            with_stderr,
            with_diagnostics,
            with_samples,
        )
        run = self._cache.get_or_build(
            key,
            lambda: build_mcmc_fn(
                traced,
                prop_kind,
                targ_spec.kind,
                n_steps,
                n_burnin,
                total_chains,
                mesh=mesh,
                with_state=with_state,
                use_init_state=use_init_state,
                targ_table_uniform=targ_uniform,
                prop_table_uniform=prop_uniform,
                prop_exact_inverse=prop_exact_inverse,
                with_stderr=with_stderr,
                with_diagnostics=with_diagnostics,
                random_walk=random_walk,
                rw_adapt=rw_adapt,
                with_samples=with_samples,
                hmc_leapfrog=hmc_L,
            ),
        )
        use_targ_table = targ_spec.kind == DistKind.CUSTOM
        use_prop_table = (
            not random_walk and prop_spec.kind == DistKind.CUSTOM
        )
        dummy = _tbl(None)
        if random_walk:
            prop_dev = (
                jnp.asarray(
                    proposal_distribution.pack_params(target_distribution)
                ),
                dummy,
                dummy,
            )
        else:
            prop_dev = _device_args_of(proposal_distribution, prop_spec)
        targ_dev = _device_args_of(target_distribution, targ_spec)
        targ_log_dev = (
            _device_log_tables_of(target_distribution)
            if use_targ_table
            else (dummy, dummy)
        )
        prop_log_dev = (
            _device_log_tables_of(proposal_distribution, "proposal")
            if use_prop_table
            else (dummy, dummy)
        )
        static_args = (
            prop_dev[0],
            targ_dev[0],
            prop_dev[1],
            prop_dev[2],
            *targ_log_dev,
            *prop_log_dev,
        )

        if with_state:

            def prog(seed, x0, logp0, segment):
                return run(np.uint32(seed), *static_args, x0, logp0, segment)

            return prog, total_chains

        return (
            self._finalize_mcmc_prog(
                run, static_args, seed_batch, param_batch,
                (
                    ("rw_adapt" if rw_adapt else "rw", targ_spec.kind)
                    if random_walk
                    else (prop_spec.kind, targ_spec.kind)
                ),
            ),
            total_chains,
        )

    def _finalize_mcmc_prog(
        self, run, static_args, seed_batch: int, param_batch: bool,
        param_kinds=(),
    ) -> Callable:
        """Finalize a stateless MCMC program.  The internal run signature
        leads with (proposal_params, target_params); the param-batched
        user handle mirrors compile_mcmc's (target, proposal) arg order."""
        inner = self._finalize_prog(
            run, static_args, seed_batch, param_batch=param_batch,
            n_param_args=2, param_kinds=param_kinds,
        )
        if not param_batch:
            return inner

        def prog(seeds, target_params, proposal_params):
            return inner(seeds, proposal_params, target_params)

        return prog
