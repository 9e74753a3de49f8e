"""Importance sampling: weight folding (traced and table PDFs), the
traceability probe driving the closed-form vs table routing, and
the 1-D / nd IS entry points."""

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


class _ImportanceMixin:
    # ------------------------------------------------------------------
    # importance sampling
    # ------------------------------------------------------------------

    def integrate_importance_sampling(
        self,
        functions: List[Union[Callable, str]],
        target_distribution: Distribution,
        proposal_distribution: Distribution,
        n_samples: int = 1_000_000,
        seed: int = 42,
        method: str = "mc",
        return_stderr: bool = False,
        qmc_rotations: int = 8,
        return_diagnostics: bool = False,
    ) -> IntegrationResult:
        """Compute E_p[f(X)] sampling from q with weights p(x)/q(x).

        All K functions share samples and see identical weights (the weight
        is folded into each integrand, reference __init__.py:893-905).  PDFs
        that fail tracing fall back to interpolated table lookups with the
        0-outside-support convention (reference distribution.rs:186-190).

        ``return_stderr=True``: ``result.stderr`` estimates the standard
        error of each weighted estimator f_i(X) p(X)/q(X) — the quantity
        that tells you whether the proposal is any good (see integrate).
        Error bars stay in-kernel on BOTH routes: traced PDFs fold the
        weight into each integrand, table PDFs accumulate pilot-shifted
        squares of the in-kernel table-weighted values (the pilot mean
        is weighted on the same quantile grid).  Under ``method="qmc"``
        error bars come from ``qmc_rotations`` independent rotations in
        one seed-batched dispatch (randomized QMC — see
        :meth:`integrate`).

        ``return_diagnostics=True``: ``result.diagnostics`` reports
        proposal quality from the weight moments — ``"ess"`` (Kish
        effective sample size (Σw)²/Σw²: how many iid target draws the
        weighted sample is worth), ``"mean_weight"`` (≈1 when both
        densities are normalized — a consistency check), and
        ``"weight_cv"`` (weight coefficient of variation;
        ess = n / (1 + cv²)).  Computed IN-KERNEL by folding a
        constant-1 integrand through the same weight machinery (its
        weighted value IS w) and reading the weight's mean and second
        moment from the stderr accumulators — no extra dispatch.
        ``method="mc"`` only (the per-sample weight variance is an iid
        quantity)."""
        t_seq = isinstance(target_distribution, (list, tuple))
        q_seq = isinstance(proposal_distribution, (list, tuple))
        if t_seq or q_seq:
            if not (t_seq and q_seq):
                raise TypeError(
                    "multi-dimensional importance sampling needs BOTH "
                    "target and proposal as sequences of Distributions"
                )
            targets = list(target_distribution)
            proposals = list(proposal_distribution)
            if (
                not targets
                or len(targets) != len(proposals)
                or not all(
                    isinstance(dd, Distribution)
                    for dd in targets + proposals
                )
            ):
                raise TypeError(
                    "target/proposal sequences must be equal-length "
                    "non-empty lists of Distribution objects"
                )
            if len(targets) > 1:
                return self._integrate_is_nd(
                    functions, targets, proposals, n_samples, seed,
                    method, return_stderr, qmc_rotations,
                    return_diagnostics=return_diagnostics,
                )
            target_distribution = targets[0]
            proposal_distribution = proposals[0]
        if return_diagnostics:
            if method != "mc":
                raise ValueError(
                    "return_diagnostics estimates the per-sample weight "
                    "variance, an iid quantity; use method='mc' (got "
                    f"method={method!r})"
                )
            prog = self._get_is_program(
                list(functions) + [_unit_integrand()],
                target_distribution, proposal_distribution, n_samples,
                method=method, with_stderr=True,
            )
            values, stderr = prog(seed)
            v = np.asarray(values, np.float64)
            s = np.asarray(stderr, np.float64)
            return IntegrationResult(
                values=v[:-1], n_samples=n_samples,
                n_functions=len(functions),
                stderr=s[:-1] if return_stderr else None,
                diagnostics=_weight_diagnostics(v[-1], s[-1], n_samples),
            )
        if return_stderr and method == "qmc":
            if qmc_rotations < 2:
                raise ValueError(
                    "qmc_rotations must be >= 2 to estimate an rQMC "
                    f"error bar (got {qmc_rotations})"
                )
            r = qmc_rotations
            prog = self.compile_importance_sampling(
                functions, target_distribution, proposal_distribution,
                n_samples=-(-n_samples // r), seed_batch=r, method="qmc",
            )
            seeds = np.uint32(seed) + np.uint32(0x9E3779B9) * np.arange(
                r, dtype=np.uint32
            )
            vals = np.asarray(prog(seeds), dtype=np.float64)  # (r, K)
            return IntegrationResult(
                values=vals.mean(axis=0),
                n_samples=n_samples,
                n_functions=len(functions),
                stderr=vals.std(axis=0, ddof=1) / np.sqrt(r),
            )
        prog = self._get_is_program(
            functions, target_distribution, proposal_distribution, n_samples,
            method=method, with_stderr=return_stderr,
        )
        if return_stderr:
            values, stderr = prog(seed)
            return IntegrationResult(
                values=values, n_samples=n_samples,
                n_functions=len(functions), stderr=stderr,
            )
        values = prog(seed)
        return IntegrationResult(
            values=values, n_samples=n_samples, n_functions=len(functions)
        )

    def compile_importance_sampling(
        self,
        functions: List[Union[Callable, str]],
        target_distribution: Distribution,
        proposal_distribution: Distribution,
        n_samples: int = 1_000_000,
        seed_batch: int = 1,
        method: str = "mc",
        return_stderr: bool = False,
    ) -> Callable:
        """Ahead-of-time IS handle: ``prog(seed) -> jax.Array (K,)``; with
        ``seed_batch=R``, ``prog(seeds) -> (R, K)`` in one dispatch (see
        compile_integrate).  ``return_stderr=True``: the handle returns
        ``(values, stderrs)`` pairs (per batch element with a seed
        batch)."""
        return self._get_is_program(
            functions, target_distribution, proposal_distribution, n_samples,
            seed_batch=seed_batch, method=method,
            with_stderr=return_stderr,
        )

    def _get_is_program(
        self, functions, target_distribution, proposal_distribution,
        n_samples, seed_batch: int = 1, method: str = "mc",
        with_stderr: bool = False,
    ) -> Callable:
        """IS program: ``prog(seed) -> (K,) jax.Array`` — or, with
        ``with_stderr=True``, ``prog(seed) -> ((K,) values, (K,) stderrs)``
        on the XLA sweep.

        Both PDFs traceable -> closed-form weight folded into each integrand
        (the weighted closures lower into the Pallas kernel as-is).  Any
        table PDF -> in-kernel uniform-grid table weights on the GPU
        kernel when eligible, else the XLA sweep with interpolating closures.
        """
        if len(functions) == 0:
            raise ValueError("At least one function is required")
        traced = self._trace_user_functions(functions)
        p_mode = self._pdf_mode(target_distribution)
        q_mode = self._pdf_mode(proposal_distribution)

        if p_mode[0] == "traced" and q_mode[0] == "traced":
            weighted_fns = self._weighted_fns(traced, p_mode[1], q_mode[1])
            run, dev_args = self._get_integrate_program(
                weighted_fns, proposal_distribution, n_samples,
                seed_batch=seed_batch, method=method,
                with_stderr=with_stderr,
            )
            return self._finalize_prog(run, dev_args, seed_batch)

        spec = dist_spec_of(proposal_distribution)
        mesh = self._mesh
        n_dev = 1 if mesh is None else mesh.size

        pallas_ok = False
        if self._use_pallas(spec.kind):
            from ..ops.integrate_pallas import build_integrate_fn_pallas

            plan = make_integrate_plan(
                n_samples, self._target_threads, n_dev=n_dev
            )
            pallas_ok = self._pallas_eligible(spec, traced)
            was_eligible = pallas_ok
            # Table PDFs need uniform x-grids for in-kernel lookup —
            # irregular user grids are resampled host-side (error-bounded)
            # to stay in-kernel; traced PDFs must evaluate on a lane block
            # like the integrands.
            p_mode_k = _uniform_table_mode(target_distribution, p_mode)
            q_mode_k = _uniform_table_mode(
                proposal_distribution, q_mode, "proposal"
            )
            if (
                pallas_ok
                and q_mode_k is None
                and spec.kind == DistKind.CUSTOM
                and not spec.exact_inverse
            ):
                # The denominator table's x-grid is too irregular to
                # resample (e.g. a paired-knot VEGAS proposal from
                # adapt_proposal) but the proposal is kernel-SAMPLED —
                # so take q from the sampler itself: the stratified
                # inverse tables' reciprocal slope IS the density the
                # samples are drawn from (one extra gather, exact for
                # the resampled inverse).  Safe only when the user's
                # pdf table is self-normalized — otherwise reference
                # face-value semantics (weights scaled by the user's
                # normalization) would silently change; those rare
                # unnormalized-irregular tables keep the XLA path.
                x_t = np.asarray(q_mode[1], np.float64)
                v_t = np.asarray(q_mode[2], np.float64)
                if abs(np.trapezoid(v_t, x_t) - 1.0) <= 1e-3:
                    q_mode_k = ("sampler",)
            for mode in (p_mode_k, q_mode_k):
                if not pallas_ok:
                    break
                if mode is None:
                    pallas_ok = False
                elif mode[0] not in ("table", "sampler"):
                    pallas_ok = _block_traceable((mode[1],))
            if was_eligible and not pallas_ok:
                self._no_kernel(
                    "an IS weight PDF is not kernel-eligible (a table "
                    "x-grid too irregular to resample within error "
                    "bounds, or a PDF that does not evaluate on a lane "
                    "block)"
                )

        if pallas_ok:
            def mode_arg(mode):
                if mode[0] in ("table", "sampler"):
                    return mode[0]
                return mode[1]

            def mode_key(mode, dist):
                if mode[0] == "sampler":
                    return ("sampler",)
                if mode[0] == "table":
                    return (
                        "pdf_table",
                        hashlib.sha1(
                            np.ascontiguousarray(mode[1])
                        ).hexdigest(),
                        hashlib.sha1(
                            np.ascontiguousarray(mode[2])
                        ).hexdigest(),
                    )
                return _fn_key(mode[1])

            gapped = spec.kind == DistKind.CUSTOM and spec.exact_inverse
            key = (
                "is_pallas",
                _fns_key(traced),
                spec.kind,
                plan,
                _table_shapes(spec),
                mode_key(p_mode_k, target_distribution),
                mode_key(q_mode_k, proposal_distribution),
                _mesh_key(mesh),
                gapped,
                seed_batch,
                method,
                with_stderr,
            )
            run = self._cache.get_or_build(
                key,
                lambda: _tag_native_batch(
                    build_integrate_fn_pallas(
                        traced,
                        spec.kind,
                        plan,
                        mesh=mesh,
                        is_weight=(mode_arg(p_mode_k), mode_arg(q_mode_k)),
                        gapped_tables=gapped,
                        seed_batch=seed_batch,
                        method=method,
                        with_stderr=with_stderr,
                    ),
                    seed_batch,
                ),
            )
            if gapped:
                ts, dts = _device_gapped_tables(
                    proposal_distribution, spec, stratified=True,
                    segments=run.strata,
                )
                dev_args = [
                    _device_args_of(proposal_distribution, spec)[0], ts, dts,
                ]
            else:
                dev_args = list(
                    _device_args_of(proposal_distribution, spec)
                )
            if p_mode_k[0] == "table":
                dev_args += list(
                    _device_mode_tables(target_distribution, p_mode_k)
                )
            if q_mode_k[0] == "table":
                dev_args += list(
                    _device_mode_tables(
                        proposal_distribution, q_mode_k, "proposal"
                    )
                )
            return self._finalize_prog(run, dev_args, seed_batch)

        weighted_fns = self._weighted_fns(
            traced,
            self._mode_evaluator(p_mode),
            self._mode_evaluator(q_mode),
        )
        run, dev_args = self._get_integrate_program(
            weighted_fns, proposal_distribution, n_samples,
            seed_batch=seed_batch, method=method, with_stderr=with_stderr,
        )
        return self._finalize_prog(run, dev_args, seed_batch)

    def _pdf_mode(self, dist: Distribution):
        """("traced", fn) when the PDF traces, else ("table", x, pdf) —
        the traceability probe driving the closed-form vs table routing
        (reference __init__.py:826-838)."""
        try:
            return ("traced", trace_function(dist._pdf_func))
        except (TraceError, TypeError):
            pass
        x_table, pdf_table = dist.get_or_compute_pdf_table()
        return ("table", x_table, pdf_table)

    @staticmethod
    def _mode_evaluator(mode) -> Callable:
        """Scalar pdf evaluator for a _pdf_mode result: the traced callable,
        or an interpolating closure over the tables (0 outside support,
        reference distribution.rs:186-190)."""
        if mode[0] == "traced":
            return mode[1]
        x_table, pdf_table = mode[1], mode[2]
        xt = jnp.asarray(x_table)
        pt = jnp.asarray(pdf_table)
        uniform = is_uniform_grid(x_table)

        def table_pdf(x):
            return pdf_from_table(x, xt, pt, uniform=uniform)

        # Table lookups need gathers the Pallas integrate kernel does not
        # lower; integrands carrying this closure stay on the XLA sweep.
        table_pdf.__tpu_mc_no_pallas__ = True
        table_pdf.__tpu_mc_traced__ = True
        table_pdf.__tpu_mc_key__ = (
            "pdf_table",
            hashlib.sha1(np.ascontiguousarray(x_table)).hexdigest(),
            hashlib.sha1(np.ascontiguousarray(pdf_table)).hexdigest(),
        )
        return table_pdf

    def _weighted_fns(self, traced, p_eval, q_eval) -> tuple:
        def weighted(f):
            def wf(x):
                # Guard q(x) > 0: rounding can put a sample exactly on a
                # point of zero proposal density (table edge), and one
                # inf/NaN weight would poison the whole mean.  Such points
                # carry zero probability mass, so weight 0 is exact.
                q = q_eval(x)
                safe_q = jnp.where(q > 0, q, 1.0)
                return jnp.where(q > 0, f(x) * p_eval(x) / safe_q, 0.0)

            wf.__tpu_mc_no_pallas__ = any(
                getattr(g, "__tpu_mc_no_pallas__", False)
                for g in (f, p_eval, q_eval)
            )
            wf.__tpu_mc_traced__ = True
            wf.__tpu_mc_key__ = (
                "is_weight",
                _fn_key(f),
                _fn_key(p_eval),
                _fn_key(q_eval),
            )
            return wf

        return tuple(weighted(f) for f in traced)

    def _pdf_evaluator(self, dist: Distribution) -> Callable:
        """Closed-form traced PDF when traceable, else table interpolation
        — the traceability probe that mirrors the reference's
        try-transpile/except routing (__init__.py:826-838)."""
        return self._mode_evaluator(self._pdf_mode(dist))

    def _weighted_fns_nd(self, traced, p_evals, q_evals) -> tuple:
        """d-dimensional IS weight folding: w(x_1..x_d) = prod_j
        p_j(x_j)/q_j(x_j) under independence, with the same
        zero-proposal-density guard as the 1-D wrapper applied to every
        dimension (one zero q_j carries zero probability mass, so the
        whole weight is exactly 0)."""

        def weighted(f):
            def wf(*xs):
                qs = [qe(x) for qe, x in zip(q_evals, xs)]
                ps = [pe(x) for pe, x in zip(p_evals, xs)]
                ok = qs[0] > 0
                for q in qs[1:]:
                    ok = jnp.logical_and(ok, q > 0)
                q_prod = qs[0]
                for q in qs[1:]:
                    q_prod = q_prod * q
                p_prod = ps[0]
                for p in ps[1:]:
                    p_prod = p_prod * p
                safe_q = jnp.where(ok, q_prod, 1.0)
                return jnp.where(ok, f(*xs) * p_prod / safe_q, 0.0)

            wf.__tpu_mc_no_pallas__ = any(
                getattr(g, "__tpu_mc_no_pallas__", False)
                for g in (f, *p_evals, *q_evals)
            )
            wf.__tpu_mc_traced__ = True
            wf.__tpu_mc_key__ = (
                "is_weight_nd",
                _fn_key(f),
                tuple(_fn_key(p) for p in p_evals),
                tuple(_fn_key(q) for q in q_evals),
            )
            return wf

        return tuple(weighted(f) for f in traced)

    def _integrate_is_nd(
        self, functions, targets, proposals, n_samples, seed, method,
        return_stderr, qmc_rotations, return_diagnostics=False,
    ) -> IntegrationResult:
        """Multi-dimensional importance sampling: sample each dimension
        from its proposal, fold the product weight into every integrand,
        and run the nd sweep (an extension beyond the strictly 1-D
        reference).  ``return_diagnostics``: same weight-column trick as
        the 1-D path — a constant-1 integrand rides the product-weight
        wrappers, and its mean/second moment give ESS / weight CV."""
        d = len(targets)
        traced = self._trace_user_functions(functions, n_args=d)
        if return_diagnostics:
            if method != "mc":
                raise ValueError(
                    "return_diagnostics estimates the per-sample weight "
                    "variance, an iid quantity; use method='mc' (got "
                    f"method={method!r})"
                )
            traced = traced + (_unit_integrand(d),)
        p_evals = [self._pdf_evaluator(t) for t in targets]
        q_evals = [self._pdf_evaluator(q) for q in proposals]
        weighted = self._weighted_fns_nd(traced, p_evals, q_evals)
        out = self._integrate_nd(
            weighted, proposals, n_samples, seed, method,
            return_stderr or return_diagnostics, qmc_rotations,
        )
        if not return_diagnostics:
            # _integrate_nd counted the weighted tuple; same length as
            # the input.
            return out
        v = np.asarray(out.values, np.float64)
        s = np.asarray(out.stderr, np.float64)
        return IntegrationResult(
            values=v[:-1], n_samples=n_samples,
            n_functions=len(functions),
            stderr=s[:-1] if return_stderr else None,
            diagnostics=_weight_diagnostics(v[-1], s[-1], n_samples),
        )
