"""Multi-dimensional MCMC: argument parsing (product vs joint-fn
targets, RandomWalk/HMC proposals), the nd kernel and XLA program
builders, and the nd AOT/batched handles."""

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


class _McmcNdMixin:
    def _parse_nd_mcmc_args(self, target, proposal):
        """Validate and normalise the nd MCMC argument surface: returns
        ``(proposals, targets, target_fn, d)`` with exactly one of
        ``targets`` (per-dim product) / ``target_fn`` (traced joint
        log-density) set.  A :class:`RandomWalk` proposal returns
        ``proposals=None`` (the walk carries no per-dimension proposal
        distributions); ``d`` then comes from the target — the sequence
        length, or a joint log-density's own arity."""
        if isinstance(proposal, RandomWalk):
            proposals = None
            d = None  # fixed by the target below
        elif isinstance(proposal, Distribution):
            proposals = [proposal]
        elif isinstance(proposal, (list, tuple)):
            proposals = list(proposal)
        else:
            raise TypeError(
                "proposal must be a Distribution, a sequence of "
                f"Distributions, or a RandomWalk, got {type(proposal)}"
            )
        if proposals is not None:
            if not proposals or not all(
                isinstance(p, Distribution) for p in proposals
            ):
                raise TypeError(
                    "proposal sequence must be a non-empty list of "
                    "Distribution objects"
                )
            d = len(proposals)

        target_fn = None
        targets = None
        if isinstance(target, (list, tuple)):
            targets = list(target)
            if d is None:
                d = len(targets)
            if len(targets) != d or not all(
                isinstance(t, Distribution) for t in targets
            ):
                raise TypeError(
                    "target sequence must be a non-empty list of "
                    f"Distribution objects matching the {d} "
                    "proposal dimension(s)"
                )
            if not targets:
                raise TypeError(
                    "target sequence must be a non-empty list of "
                    "Distribution objects"
                )
        elif isinstance(target, Distribution):
            if d not in (None, 1):
                raise TypeError(
                    "multi-dimensional MCMC needs the target as a "
                    f"sequence of {d} Distributions or a {d}-ary "
                    "log-density function"
                )
            d = 1
            targets = [target]
        elif callable(target) or isinstance(target, str):
            # Joint log-density (up to an additive constant).  With a
            # RandomWalk proposal the dimension count comes from the
            # density's own arity.
            if d is None:
                d = _target_arity(target)
            target_fn = self._trace_user_functions([target], n_args=d)[0]
        else:
            raise TypeError(
                f"Unsupported target type for MCMC: {type(target)}"
            )
        return proposals, targets, target_fn, d

    def _integrate_mcmc_nd(
        self, functions, target, proposal, n_steps, n_chains, n_burnin,
        seed, initial_state, return_state, return_stderr,
        return_diagnostics, return_samples: int = 0,
    ) -> IntegrationResult:
        """Multi-dimensional MH: per-dimension proposal distributions with
        either a product-of-Distributions target or a user JOINT
        log-density callable/WGSL string of d arguments — the latter is a
        capability the strictly 1-D reference cannot express
        (src/shader_gen.rs:496-509 binds one target per program)."""
        want_state = return_state or initial_state is not None
        if return_diagnostics and n_steps < 4:
            raise ValueError("return_diagnostics needs n_steps >= 4")
        proposals, targets, target_fn, d = self._parse_nd_mcmc_args(
            target, proposal
        )

        if d == 1 and target_fn is None:
            # Pure 1-D in disguise: take the scalar path (full feature
            # surface incl. resume/diagnostics/Pallas kernel).
            return self.integrate_mcmc(
                functions, targets[0],
                proposal if proposals is None else proposals[0],
                n_steps=n_steps,
                n_chains=n_chains, n_burnin=n_burnin, seed=seed,
                initial_state=initial_state, return_state=return_state,
                return_stderr=return_stderr,
                return_diagnostics=return_diagnostics,
                return_samples=return_samples or None,
            )

        random_walk = proposals is None
        traced = self._trace_user_functions(functions, n_args=d)
        prop_specs = (
            None if random_walk else [dist_spec_of(p) for p in proposals]
        )
        mesh = self._mesh
        n_dev = 1 if mesh is None else mesh.size
        total_chains = plan_chains(n_chains, self._target_threads, n_dev)

        self._warn_no_kernel("nd MCMC")

        use_init = initial_state is not None
        run, dev_args = self._nd_mcmc_xla_program(
            traced, proposals, prop_specs, targets, target_fn,
            n_steps, n_burnin, total_chains, return_stderr,
            with_diagnostics=return_diagnostics,
            with_state=want_state, use_init_state=use_init,
            proposal_rw=proposal if random_walk else None, d=d,
            with_samples=return_samples,
        )
        if want_state:
            if use_init:
                xs = np.asarray(initial_state.x, np.float32)
                if xs.ndim != 2 or xs.shape != (d, total_chains):
                    raise ValueError(
                        f"initial_state carries x of shape {xs.shape} "
                        f"but this nd run plans ({d}, {total_chains}); "
                        "pass the state back with the same dimensions "
                        "and n_chains/target_threads"
                    )
                x0 = jnp.asarray(xs)
                logp0 = jnp.asarray(initial_state.log_p, jnp.float32)
                segment = initial_state.segment + 1
            else:
                x0 = jnp.zeros((d, total_chains), jnp.float32)
                logp0 = jnp.zeros(total_chains, jnp.float32)
                segment = 0
            out = run(
                np.uint32(seed), *dev_args, x0, logp0, jnp.int32(segment)
            )
            values, acc_rate, x_f, logp_f = out
            chain_state = McmcState(
                np.asarray(x_f), np.asarray(logp_f), segment=segment
            )
            return IntegrationResult(
                values=values,
                n_samples=n_chains * n_steps,
                n_functions=len(functions),
                acceptance_rate=float(acc_rate),
                chain_state=chain_state if return_state else None,
            )
        out = run(np.uint32(seed), *dev_args)
        values, acc_rate = out[0], out[1]
        idx = 2
        stderr = None
        diagnostics = None
        samples = None
        if return_stderr:
            stderr = out[idx]
            idx += 1
        if return_diagnostics:
            diagnostics = {
                "r_hat": np.array(out[idx], dtype=np.float64),
                "ess": np.array(out[idx + 1], dtype=np.float64),
            }
            idx += 2
        if return_samples:
            # Builder buffer is (m, d, total_chains); surface as
            # (m, n_chains, d) draws.
            samples = np.transpose(np.asarray(out[idx]), (0, 2, 1))
        return IntegrationResult(
            values=values,
            n_samples=n_chains * n_steps,
            n_functions=len(functions),
            acceptance_rate=float(acc_rate),
            stderr=stderr,
            diagnostics=diagnostics,
            samples=samples,
        )

    def _nd_mcmc_xla_program(
        self, traced, proposals, prop_specs, targets, target_fn,
        n_steps, n_burnin, total_chains, return_stderr,
        with_diagnostics: bool = False,
        with_state: bool = False, use_init_state: bool = False,
        proposal_rw=None, d: int = 0, with_samples: int = 0,
    ):
        """Cached XLA nd MH program (any family mix) + its device args
        (the 8 per-dimension param/table tuples).  ``proposal_rw``: a
        RandomWalk proposal — the program then runs random-walk MH with
        per-dimension (4,) parameter rows in the params slots and
        dummies in every proposal table slot (``d`` required then)."""
        from ..ops.mcmc_nd import build_mcmc_nd_fn

        mesh = self._mesh
        dummy = _tbl(None)
        random_walk = proposal_rw is not None
        hmc_L = (
            proposal_rw.n_leapfrog
            if isinstance(proposal_rw, HMC)
            else 0
        )
        if random_walk:
            rows = proposal_rw.pack_params_nd(targets, d)
            prop_kinds = (DistKind.NORMAL,) * d  # ignored by the builder
            prop_exact = (False,) * d
            prop_dev = [
                (jnp.asarray(rows[j]), dummy, dummy) for j in range(d)
            ]
            prop_log_dev = [(dummy, dummy)] * d
            prop_uniform = [False] * d
            prop_key = (
                ("hmc", hmc_L, proposal_rw.adapt)
                if hmc_L
                else ("rw", proposal_rw.adapt)
            )
        else:
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
            prop_key = prop_kinds

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
            "mcmc_nd",
            _fns_key(traced),
            prop_key,
            prop_exact,
            tuple(prop_uniform),
            targ_key,
            n_steps,
            n_burnin,
            total_chains,
            (
                None
                if random_walk
                else tuple(_table_shapes(s) for s in prop_specs)
            ),
            targ_shapes,
            tuple(t[0].shape for t in prop_log_dev),
            _mesh_key(mesh),
            return_stderr,
            with_diagnostics,
            with_state,
            use_init_state,
            with_samples,
        )
        run = self._cache.get_or_build(
            key,
            lambda: build_mcmc_nd_fn(
                traced, prop_kinds, n_steps, n_burnin, total_chains,
                targ_kinds=targ_kinds, target_logpdf_fn=target_fn,
                targ_uniform=targ_uniform,
                prop_uniform=tuple(prop_uniform),
                prop_exact_inverses=prop_exact,
                mesh=mesh, with_stderr=return_stderr,
                with_diagnostics=with_diagnostics,
                with_state=with_state, use_init_state=use_init_state,
                random_walk=random_walk,
                rw_adapt=random_walk and proposal_rw.adapt,
                with_samples=with_samples,
                hmc_leapfrog=hmc_L,
            ),
        )
        dev_args = (
            tuple(p[0] for p in prop_dev),
            targ_params_t,
            tuple(p[1] for p in prop_dev),
            tuple(p[2] for p in prop_dev),
            targ_lx_t,
            targ_lp_t,
            tuple(t[0] for t in prop_log_dev),
            tuple(t[1] for t in prop_log_dev),
        )
        return run, dev_args

    def _compile_mcmc_nd(
        self, functions, target, proposal, n_steps, n_chains, n_burnin,
        seed_batch, param_batch, return_stderr,
        return_samples: int = 0,
    ) -> Callable:
        """AOT handle for multi-dimensional MCMC: ``prog(seed) ->
        ((K,), acceptance[, (K,) stderr])``, or batched ``prog(seeds)``
        with ``seed_batch=R`` — R runs ride the nd kernel's grid
        dimension when eligible (analytic dims), else a traced lax.map
        over the XLA nd program.  ``param_batch=True`` (product-analytic
        targets): ``prog(seeds, target_params, proposal_params)`` with
        each params arg an (R, d, 2) array (pack_param_batch_nd) — one
        program serves a d-dimensional posterior/tempering sweep per
        dispatch."""
        proposals, targets, target_fn, d = self._parse_nd_mcmc_args(
            target, proposal
        )
        if d == 1 and target_fn is None:
            return self.compile_mcmc(
                functions, targets[0],
                proposal if proposals is None else proposals[0],
                n_steps=n_steps,
                n_chains=n_chains, n_burnin=n_burnin,
                seed_batch=seed_batch, param_batch=param_batch,
                return_stderr=return_stderr,
                return_samples=return_samples or None,
            )
        if param_batch and target_fn is not None:
            raise ValueError(
                "param_batch needs a product-of-Distributions target "
                "(a joint log-density function carries no runtime "
                "parameters)"
            )
        random_walk = proposals is None
        if random_walk:
            # With param_batch the proposal slot takes (R, d, 4)
            # RandomWalk rows (pack_random_walk_batch_nd); the target's
            # analytic-family gate below still applies.
            _check_random_walk_args(proposal, n_burnin, False)
        traced = self._trace_user_functions(functions, n_args=d)
        prop_specs = (
            None if random_walk else [dist_spec_of(p) for p in proposals]
        )
        mesh = self._mesh
        n_dev = 1 if mesh is None else mesh.size
        total_chains = plan_chains(n_chains, self._target_threads, n_dev)
        prop_kinds = (
            () if random_walk else tuple(s.kind for s in prop_specs)
        )
        targ_kinds = (
            None
            if target_fn is not None
            else tuple(dist_spec_of(t).kind for t in targets)
        )
        if param_batch:
            for kk in prop_kinds:
                ensure_param_batch_family(kk, "proposal")
            for kk in targ_kinds:
                ensure_param_batch_family(kk, "target")
        self._warn_no_kernel("nd MCMC")
        run, dev_args = self._nd_mcmc_xla_program(
            traced, proposals, prop_specs, targets, target_fn,
            n_steps, n_burnin, total_chains, return_stderr,
            proposal_rw=proposal if random_walk else None, d=d,
            with_samples=return_samples,
        )
        if param_batch:
            run = _nd_mcmc_param_map_adapter(run, d, dev_args[2:])
            return _nd_mcmc_param_prog(
                run, seed_batch, d, targ_kinds, prop_kinds,
                random_walk=random_walk,
                rw_adapt=random_walk and proposal.adapt,
            )
        inner = self._finalize_prog(
            run, dev_args, seed_batch, n_param_args=0
        )
        if not return_samples:
            return inner

        def prog(seeds):
            # Builder draw layout is (..., m, d, chains); surface the
            # integrate_mcmc orientation (..., m, chains, d).
            out = inner(seeds)
            return out[:-1] + (jnp.swapaxes(out[-1], -1, -2),)

        return prog
