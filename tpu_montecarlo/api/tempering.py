"""Parallel tempering (replica-exchange MCMC): ladder validation and
the tempered program builder (see ops/mcmc_pt.py for the device
design)."""

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


class _PtMixin:
    def _integrate_mcmc_pt(
        self, functions, target, proposal, temperatures, n_steps,
        n_chains, n_burnin, seed, initial_state, return_state,
        return_stderr, return_diagnostics, return_samples,
    ) -> IntegrationResult:
        """Parallel tempering (replica exchange): T replicas of every
        chain run against ``pi^(1/T_t)`` and adjacent temperature rungs
        periodically exchange states, so the cold (T=1) chains — the
        only ones that enter the estimates — mix across modes that trap
        a plain local sampler (see ops/mcmc_pt.py).  A capability beyond
        the reference's independence-only sampler
        (src/shader_gen.rs:466-539)."""
        temps = [float(t) for t in temperatures]
        if len(temps) < 2:
            raise ValueError(
                "temperatures needs >= 2 rungs (the first is the "
                f"target itself), got {temps}"
            )
        if temps[0] != 1.0:
            raise ValueError(
                f"temperatures must start at 1.0 (the true target), "
                f"got {temps}"
            )
        if any(
            not np.isfinite(t) or t2 <= t1
            for t, (t1, t2) in zip(temps[1:], zip(temps, temps[1:]))
        ):
            raise ValueError(
                f"temperatures must be finite and strictly increasing, "
                f"got {temps}"
            )
        if return_state or initial_state is not None:
            raise ValueError(
                "temperatures applies to stateless MCMC runs only "
                "(the ladder state is not checkpointed)"
            )
        if return_samples and not 1 <= int(return_samples) <= n_steps:
            raise ValueError(
                f"return_samples must be in [1, n_steps={n_steps}], "
                f"got {return_samples}"
            )
        if return_diagnostics and n_steps < 4:
            raise ValueError("return_diagnostics needs n_steps >= 4")
        if isinstance(proposal, RandomWalk):
            _check_random_walk_args(proposal, n_burnin, False)
        betas = tuple(1.0 / t for t in temps)
        # RandomWalk/HMC proposals return proposals=None; a Distribution
        # (or sequence) switches on tempered INDEPENDENCE sampling — the
        # reference's native proposal family, tempered (round 5).
        proposals, targets, target_fn, d = self._parse_nd_mcmc_args(
            target, proposal
        )
        traced = self._trace_user_functions(functions, n_args=d)
        mesh = self._mesh
        n_dev = 1 if mesh is None else mesh.size
        total_chains = plan_chains(n_chains, self._target_threads, n_dev)
        self._warn_no_kernel("tempered MCMC")
        run, dev_args = self._pt_mcmc_program(
            traced, targets, target_fn, betas, proposal, d,
            n_steps, n_burnin, total_chains, return_stderr,
            return_diagnostics,
            with_samples=int(return_samples or 0),
            proposals=proposals,
        )
        out = run(np.uint32(seed), *dev_args)
        values, acc_rate, swap_rate = out[0], out[1], out[2]
        idx = 3
        stderr = None
        samples = None
        # Tempered runs always surface the swap rate — THE ladder-tuning
        # diagnostic (~0: rungs don't overlap, add rungs; ~1: rungs
        # redundant, spread them).
        diagnostics = {"swap_rate": float(swap_rate)}
        if return_stderr:
            stderr = out[idx]
            idx += 1
        if return_diagnostics:
            diagnostics["r_hat"] = np.array(out[idx], dtype=np.float64)
            diagnostics["ess"] = np.array(out[idx + 1], dtype=np.float64)
            idx += 2
        if return_samples:
            # Builder buffer is (m, d, total_chains); surface the
            # family's conventions — (m, n_chains) for a 1-D
            # Distribution target, (m, n_chains, d) otherwise.
            arr = np.transpose(np.asarray(out[idx]), (0, 2, 1))
            samples = (
                arr[:, :, 0] if (d == 1 and target_fn is None) else arr
            )
        return IntegrationResult(
            values=values,
            n_samples=n_chains * n_steps,
            n_functions=len(functions),
            acceptance_rate=float(acc_rate),
            stderr=stderr,
            diagnostics=diagnostics,
            samples=samples,
        )

    def _pt_mcmc_program(
        self, traced, targets, target_fn, betas, proposal_rw, d,
        n_steps, n_burnin, total_chains, return_stderr,
        with_diagnostics, with_samples: int = 0, proposals=None,
    ):
        """Cached parallel-tempering program + its device args.  The
        walk rows (or the independence proposals' family words) ride as
        runtime args; the ladder itself (betas), the adapt mode and the
        leapfrog length are compile-time.  ``proposals``: per-dimension
        proposal Distributions — switches the sweep to tempered
        INDEPENDENCE sampling (any family; tables ride the nd builder's
        slots)."""
        from ..ops.mcmc_pt import build_pt_mcmc_fn

        mesh = self._mesh
        dummy = _tbl(None)
        independence = proposals is not None
        hmc_L = (
            proposal_rw.n_leapfrog
            if isinstance(proposal_rw, HMC)
            else 0
        )
        if independence:
            prop_specs = [dist_spec_of(p) for p in proposals]
            prop_kinds = tuple(s.kind for s in prop_specs)
            prop_exact = tuple(s.exact_inverse for s in prop_specs)
            prop_dev = [
                _device_args_of(p, s)
                for p, s in zip(proposals, prop_specs)
            ]
            prop_log_dev = []
            prop_uniform = []
            for p, s in zip(proposals, prop_specs):
                if s.kind == DistKind.CUSTOM:
                    lx, lp = _device_log_tables_of(p, "proposal")
                    prop_log_dev.append((lx, lp))
                    prop_uniform.append(
                        bool(is_uniform_grid(np.asarray(lx)))
                    )
                else:
                    prop_log_dev.append((dummy, dummy))
                    prop_uniform.append(False)
            prop_params_t = tuple(p[0] for p in prop_dev)
            prop_key = (
                "ind", prop_kinds, tuple(prop_uniform), prop_exact,
                tuple(_table_shapes(s) for s in prop_specs),
            )
            adapt_key = False
        else:
            prop_kinds = None
            prop_uniform = ()
            prop_exact = ()
            rows = proposal_rw.pack_params_nd(targets, d)
            prop_params_t = tuple(jnp.asarray(rows[j]) for j in range(d))
            prop_key = ("hmc", hmc_L) if hmc_L else ("rw",)
            adapt_key = proposal_rw.adapt
        if target_fn is not None:
            targ_kinds = None
            targ_uniform = ()
            targ_params_t = ()
            targ_lx_t = ()
            targ_lp_t = ()
            targ_key = ("fn", _fn_key(target_fn))
            targ_shapes = ()
        else:
            targ_specs = [dist_spec_of(t) for t in targets]
            targ_kinds = tuple(s.kind for s in targ_specs)
            targ_params_t = tuple(
                _device_args_of(t, s)[0]
                for t, s in zip(targets, targ_specs)
            )
            targ_log_dev = []
            targ_uniform = []
            for t, s in zip(targets, targ_specs):
                if s.kind == DistKind.CUSTOM:
                    lx, lp = _device_log_tables_of(t)
                    targ_log_dev.append((lx, lp))
                    targ_uniform.append(
                        bool(is_uniform_grid(np.asarray(lx)))
                    )
                else:
                    targ_log_dev.append((dummy, dummy))
                    targ_uniform.append(False)
            targ_uniform = tuple(targ_uniform)
            targ_lx_t = tuple(t[0] for t in targ_log_dev)
            targ_lp_t = tuple(t[1] for t in targ_log_dev)
            targ_key = (
                "kinds", targ_kinds, targ_uniform,
                tuple(a.shape for a in targ_lx_t),
            )
            targ_shapes = tuple(_table_shapes(s) for s in targ_specs)

        key = (
            "mcmc_pt",
            _fns_key(traced),
            betas,
            prop_key,
            adapt_key,
            targ_key,
            n_steps,
            n_burnin,
            total_chains,
            targ_shapes,
            _mesh_key(mesh),
            return_stderr,
            with_diagnostics,
            with_samples,
        )
        run = self._cache.get_or_build(
            key,
            lambda: build_pt_mcmc_fn(
                traced, d, betas, n_steps, n_burnin, total_chains,
                targ_kinds=targ_kinds, target_logpdf_fn=target_fn,
                targ_uniform=targ_uniform, mesh=mesh,
                with_stderr=return_stderr,
                with_diagnostics=with_diagnostics,
                rw_adapt=False if independence else proposal_rw.adapt,
                hmc_leapfrog=hmc_L,
                with_samples=with_samples,
                prop_kinds=prop_kinds,
                prop_uniform=tuple(prop_uniform),
                prop_exact_inverses=tuple(prop_exact),
            ),
        )
        if independence:
            dev_args = (
                prop_params_t,
                targ_params_t,
                tuple(p[1] for p in prop_dev),
                tuple(p[2] for p in prop_dev),
                targ_lx_t,
                targ_lp_t,
                tuple(t[0] for t in prop_log_dev),
                tuple(t[1] for t in prop_log_dev),
            )
        else:
            dev_args = (
                prop_params_t, targ_params_t, targ_lx_t, targ_lp_t
            )
        return run, dev_args

    def _compile_mcmc_pt(
        self, functions, target, proposal, temperatures, n_steps,
        n_chains, n_burnin, seed_batch, param_batch, return_stderr,
    ) -> Callable:
        """AOT handle for tempered MCMC: ``prog(seed) -> ((K,) values,
        () acceptance, () swap_rate)``, batched ``prog(seeds) ->
        ((R, K), (R,), (R,))`` with ``seed_batch=R`` — R tempered runs
        ride the kernel's grid dimension when eligible, else a traced
        lax.map over the XLA tempering program.  ``return_stderr``
        appends a stderr output (XLA path).  The serving tier for the
        multimodal capability — one compiled ladder, one dispatch per
        seed batch."""
        if param_batch:
            raise ValueError(
                "param_batch is not supported with temperatures (the "
                "ladder is compile-time; batch seeds instead)"
            )
        temps = [float(t) for t in temperatures]
        if (
            len(temps) < 2
            or temps[0] != 1.0
            or any(
                not np.isfinite(t) or t2 <= t1
                for t, (t1, t2) in zip(
                    temps[1:], zip(temps, temps[1:])
                )
            )
        ):
            raise ValueError(
                "temperatures must be finite, strictly increasing and "
                f"start at 1.0, got {temps}"
            )
        if isinstance(proposal, RandomWalk):
            _check_random_walk_args(proposal, n_burnin, False)
        betas = tuple(1.0 / t for t in temps)
        proposals, targets, target_fn, d = self._parse_nd_mcmc_args(
            target, proposal
        )
        traced = self._trace_user_functions(functions, n_args=d)
        mesh = self._mesh
        n_dev = 1 if mesh is None else mesh.size
        total_chains = plan_chains(n_chains, self._target_threads, n_dev)
        self._warn_no_kernel("tempered MCMC")
        run, dev_args = self._pt_mcmc_program(
            traced, targets, target_fn, betas, proposal, d,
            n_steps, n_burnin, total_chains, return_stderr,
            False, proposals=proposals,
        )
        return self._finalize_prog(
            run, dev_args, seed_batch, n_param_args=0
        )
