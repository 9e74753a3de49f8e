"""Plain Monte Carlo integration: integrate / compile_integrate /
expectation_fn, control variates, the nd sweep, and the program
builders behind them (XLA and Pallas, incl. the K>128 multi-pass
driver)."""

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


class _IntegrateMixin:
    # ------------------------------------------------------------------
    # integrate
    # ------------------------------------------------------------------

    def integrate(
        self,
        functions: List[Union[Callable, str]],
        distribution: Distribution,
        n_samples: int = 1_000_000,
        seed: int = 42,
        method: str = "mc",
        return_stderr: bool = False,
        qmc_rotations: int = 8,
        control_variates=None,
    ) -> IntegrationResult:
        """Compute E[f_i(X)] for all functions on shared samples.

        ``control_variates=[(g, E[g]), ...]``: control-variate variance
        reduction (beyond the reference) — each estimate is corrected by
        the regression-optimal combination of the controls' deviations
        from their KNOWN means, ``theta_i = mean(f_i) - c_i^T (mean(g) -
        E[g])``; all moments fuse into one program on shared samples
        (both backends), and ``return_stderr`` reports the REDUCED
        residual error.  ``method='mc'`` only.

        ``method="qmc"`` draws a seed-rotated low-discrepancy point set
        instead of pseudo-random samples (ops/qmc.py): identical sampling
        semantics per family, ~O(log N / N) convergence on smooth
        integrands — a capability beyond the plain-MC reference.

        ``method="antithetic"`` uses each uniform draw at ``u`` AND its
        mirror ``1 - u`` through the monotone inverse-CDF transforms
        (classic antithetic variates, also beyond the reference):
        unbiased, same sample count, half the RNG draws, variance at
        most iid MC for integrands monotone in x — and EXACT
        cancellation for odd integrands under symmetric distributions.
        ``return_stderr`` treats the pair mean as the iid unit, so the
        error bar reports the antithetic estimator's true (reduced)
        error.  Multi-dimensional runs mirror the uniform vector
        componentwise (XLA path).

        ``return_stderr=True`` additionally estimates the Monte Carlo
        standard error per function (``result.stderr``, an addition over
        the point-estimates-only reference): stderr_i =
        sqrt(Var[f_i(X)] / N).  Error bars ride the fused Pallas kernel
        whenever the plain run would (pilot-shifted sum-of-squares
        accumulators).

        Under ``method="qmc"`` error bars come from RANDOMIZED QMC
        instead (the iid variance formula neither tracks nor bounds the
        error of a deterministic point set): the sample budget splits
        across ``qmc_rotations`` independent seed-derived rotations —
        one seed-batched device program, all rotations in one dispatch —
        and the result is their mean with stderr = spread /
        sqrt(rotations), an honest estimate of the returned value's
        rQMC error.  Each rotation keeps the full low-discrepancy
        structure, so the composite estimate converges at the QMC rate
        while the spread tracks it.

        Tail note: the kernel normal sampler inverts the CDF from a
        24-bit uniform, truncating at ~5.2 sigma; ``backend="xla"``
        draws untruncated normals.  Integrands concentrated beyond
        ~5 sigma should force ``backend="xla"`` (or use importance
        sampling with a shifted proposal, which is also how the
        reference's ~5.77-sigma Box-Muller truncation was worked
        around)."""
        if control_variates is not None:
            return self._integrate_with_cv(
                functions, distribution, n_samples, seed, method,
                return_stderr, control_variates,
            )
        if isinstance(distribution, (list, tuple)):
            dists = list(distribution)
            if not dists or not all(
                isinstance(dd, Distribution) for dd in dists
            ):
                raise TypeError(
                    "a distribution sequence must be a non-empty list of "
                    "Distribution objects (one per integrand argument)"
                )
            if len(dists) > 1:
                return self._integrate_nd(
                    functions, dists, n_samples, seed, method,
                    return_stderr, qmc_rotations,
                )
            distribution = dists[0]  # 1-element sequence == scalar path
        traced = self._trace_user_functions(functions)
        if return_stderr and method == "qmc":
            if qmc_rotations < 2:
                raise ValueError(
                    "qmc_rotations must be >= 2 to estimate an rQMC "
                    f"error bar (got {qmc_rotations})"
                )
            r = qmc_rotations
            prog = self.compile_integrate(
                functions, distribution,
                n_samples=-(-n_samples // r), seed_batch=r, method="qmc",
            )
            # Distinct seed words -> independent hash-derived rotations
            # (ops/qmc.derive_shift); golden-ratio stride keeps them
            # well-separated for consecutive user seeds too.
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
        if return_stderr:
            values, stderr = self._run_integrate(
                traced, distribution, n_samples, seed, method=method,
                with_stderr=True,
            )
            return IntegrationResult(
                values=values, n_samples=n_samples,
                n_functions=len(functions), stderr=stderr,
            )
        values = self._run_integrate(
            traced, distribution, n_samples, seed, method=method
        )
        return IntegrationResult(
            values=values, n_samples=n_samples, n_functions=len(functions)
        )

    def compile_integrate(
        self,
        functions: List[Union[Callable, str]],
        distribution: Distribution,
        n_samples: int = 1_000_000,
        seed_batch: int = 1,
        method: str = "mc",
        param_batch: bool = False,
        return_stderr: bool = False,
    ) -> Callable:
        """Ahead-of-time handle for serving: returns ``prog(seed) ->
        jax.Array (K,)`` with tracing, compilation, and device uploads done
        once.  Repeat calls cost one dispatch — no per-call host work and no
        host round-trips beyond the result fetch the caller chooses to do.
        (A capability the reference lacks: it re-generated and re-compiled
        its shader on every call, SURVEY.md §3.2.)

        ``seed_batch=R`` returns ``prog(seeds) -> jax.Array (R, K)``
        instead: R independent n_samples-integrations (one per seed) run
        back-to-back inside ONE device program, so per-dispatch host/link
        latency amortises over the batch — the serving-throughput mode.

        ``param_batch=True`` additionally makes the distribution's
        parameters a runtime batch input: ``prog(seeds, params) ->
        jax.Array (R, K)`` with ``params`` an (R, 2) float32 array of
        family parameter pairs (build it with :func:`pack_param_batch`;
        R = ``seed_batch``).  One compiled program then serves an entire
        parameter sweep — e.g. a volatility surface — in a single
        dispatch, with each batch element exactly equal to an unbatched
        call with that (seed, distribution).  Analytic families only
        (uniform / normal / exponential); ``distribution`` supplies the
        family and the compile-time shape.

        ``return_stderr=True``: the handle returns ``(values, stderrs)``
        — with a seed batch, two (R, K) arrays, each element bit-equal
        to its unbatched error-bar call (the in-kernel pilot-shifted
        squares ride the same batched grid; param batches get one pilot
        row per rep).  Serving a whole parameter sweep WITH per-job
        error bars costs one dispatch.

        One-dimensional handles carry ``actual_samples``: the samples
        each integration draws (``n_samples`` rounded up to the plan's,
        or the kernel grid's, whole blocks).

        ``distribution`` may be a SEQUENCE of per-dimension Distributions
        (d-ary functions): the handle serves the multi-dimensional
        integrate family, with ``seed_batch`` riding the nd kernel's
        batch grid dimension.  ``param_batch=True`` then takes ``params``
        as an (R, d, 2) array — one :func:`pack_param_batch` row per
        dimension — so a single compiled nd program serves a
        d-dimensional parameter sweep.
        """
        if isinstance(distribution, (list, tuple)):
            dists = list(distribution)
            if not dists or not all(
                isinstance(dd, Distribution) for dd in dists
            ):
                raise TypeError(
                    "a distribution sequence must be a non-empty list "
                    "of Distribution objects"
                )
            if len(dists) > 1:
                d = len(dists)
                traced = self._trace_user_functions(functions, n_args=d)
                if param_batch:
                    kinds = []
                    for dd in dists:
                        kk = dist_spec_of(dd).kind
                        ensure_param_batch_family(kk)
                        kinds.append(kk)
                    run, dev_args = self._nd_program(
                        traced, dists, n_samples, method,
                        with_stderr=return_stderr,
                    )
                    run = _nd_param_map_adapter(run, d)
                    return _nd_param_prog(
                        run, dev_args, seed_batch, d, tuple(kinds)
                    )
                run, dev_args = self._nd_program(
                    traced, dists, n_samples, method,
                    with_stderr=return_stderr,
                )
                return self._finalize_prog(
                    run, dev_args, seed_batch, n_param_args=0
                )
            distribution = dists[0]
        traced = self._trace_user_functions(functions)
        spec = dist_spec_of(distribution)
        if param_batch:
            ensure_param_batch_family(spec.kind)
        run, dev_args = self._get_integrate_program(
            traced, distribution, n_samples, seed_batch=seed_batch,
            method=method, param_batch=param_batch,
            with_stderr=return_stderr,
        )
        prog = self._finalize_prog(
            run, dev_args, seed_batch, param_batch=param_batch,
            param_kinds=(spec.kind,),
        )
        n_dev = 1 if self._mesh is None else self._mesh.size
        prog.actual_samples = getattr(
            run, "actual_samples",
            make_integrate_plan(
                n_samples, self._target_threads, n_dev=n_dev
            ).actual_samples,
        )
        return prog

    def expectation_fn(
        self,
        functions: List[Union[Callable, str]],
        distribution: Distribution,
        n_samples: int = 1_000_000,
        method: str = "mc",
    ) -> Callable:
        """Differentiable expectation estimator — a capability outside the
        reference's codegen design: returns ``est(params, seed=42) ->
        (K,) jnp.float32`` computing E[f_i(X_params)] with exactly the
        ``integrate`` XLA-path sampling semantics, as a pure jittable JAX
        function of the family parameters.

        Gradients are pathwise (reparameterization): the underlying
        uniform/normal draws are parameter-independent and every analytic
        transform is differentiable in its parameters, so ``jax.grad(est)``
        is an unbiased gradient estimator for a.e.-differentiable
        integrands (indicator integrands get zero pathwise gradient —
        use a smooth surrogate).  ``jax.jit``, ``jax.vmap`` (parameter
        sweeps), and higher-order ``jax.grad`` all compose; with
        ``mesh=...`` the gradient rides the same psum as the value.

        ``params`` packs as in :func:`pack_param_batch`: uniform ->
        (min, max), normal -> (mean, std), exponential -> (lambda,
        ignored).  Analytic families only: CUSTOM distributions sample
        through host-built tables whose construction is not traced.
        ``distribution`` supplies the family and default packing shape.
        """
        # AD needs the pure-JAX sweep: the Pallas kernels have no
        # gradient path.
        self._no_kernel(
            "expectation_fn always runs the XLA sweep (the "
            "differentiable path); the Pallas kernels cannot be "
            "differentiated",
            stacklevel=2,
        )
        if isinstance(distribution, (list, tuple)):
            dists = list(distribution)
            if not dists or not all(
                isinstance(dd, Distribution) for dd in dists
            ):
                raise TypeError(
                    "a distribution sequence must be a non-empty list of "
                    "Distribution objects"
                )
            if len(dists) > 1:
                # Multi-dimensional differentiable expectation:
                # est(params) takes a (d, 2) array of per-dimension
                # family parameter rows.
                d = len(dists)
                for dd in dists:
                    ensure_param_batch_family(
                        dist_spec_of(dd).kind, feature="expectation_fn"
                    )
                traced_nd = self._trace_user_functions(
                    functions, n_args=d
                )
                run_nd, dev_args_nd = self._nd_program(
                    traced_nd, dists, n_samples, method, warn=False
                )
                _, xt_t, ct_t = dev_args_nd

                def est_nd(params, seed: int = 42):
                    arr = jnp.asarray(params, jnp.float32)
                    if arr.shape != (d, 2):
                        raise ValueError(
                            f"expected a ({d}, 2) params array (one "
                            "pack_param_batch row per dimension), got "
                            f"shape {arr.shape}"
                        )
                    params_t = tuple(arr[j] for j in range(d))
                    return run_nd(jnp.uint32(seed), params_t, xt_t, ct_t)

                return est_nd
            distribution = dists[0]
        spec = dist_spec_of(distribution)
        ensure_param_batch_family(spec.kind, feature="expectation_fn")
        traced = self._trace_user_functions(functions)
        mesh = self._mesh
        n_dev = 1 if mesh is None else mesh.size
        plan = make_integrate_plan(
            n_samples, self._target_threads, n_dev=n_dev
        )
        # Always the XLA sweep (shared program cache with backend="xla"):
        # it is pure JAX end-to-end, so AD traverses it.
        run = self._xla_integrate_program(traced, spec, plan, method)
        dummy = _tbl(None)

        def est(params, seed: int = 42):
            params_arr = jnp.asarray(params, jnp.float32)
            if params_arr.shape != (2,):
                # JAX's clamped gather would silently misread a
                # wrong-shaped array (e.g. params[1] of a (1,) array
                # clamps to params[0]).
                raise ValueError(
                    f"expected a (2,) params array (pack as "
                    f"pack_param_batch does), got shape {params_arr.shape}"
                )
            return run(jnp.uint32(seed), params_arr, dummy, dummy)

        return est

    def _xla_integrate_program(
        self, traced, spec, plan, method: str, with_stderr: bool = False
    ):
        """The cached XLA integrate program for (fns, spec, plan, method,
        with_stderr) — the single builder behind the backend='xla'
        integrate path, expectation_fn, and return_stderr runs, so the
        shared cache key can never go out of sync with the build
        arguments."""
        mesh = self._mesh
        key = (
            "integrate_xla",
            _fns_key(traced),
            spec.kind,
            plan,
            _table_shapes(spec),
            _mesh_key(mesh),
            method,
            with_stderr,
        )
        return self._cache.get_or_build(
            key,
            lambda: build_integrate_fn(
                traced, spec.kind, plan, mesh=mesh,
                exact_inverse=spec.exact_inverse, method=method,
                with_stderr=with_stderr,
            ),
        )

    def _batched_prog(self, run, dev_args, seed_batch: int) -> Callable:
        """One-RPC seed-batched dispatch for programs without native grid
        batching (the XLA paths) — the zero-param-args case of
        _param_batched_prog: prog(seeds)[i] equals prog(seeds[i]) of the
        unbatched handle bit-for-bit."""
        return self._param_batched_prog(
            run, dev_args, seed_batch, n_param_args=0
        )

    def _param_batched_prog(
        self, run, dev_args, seed_batch: int, n_param_args: int = 1,
        param_kinds=(),
    ) -> Callable:
        """(seed, params...)-tuple batching for programs without native
        grid batching (the XLA paths): ``lax.map`` sweeps the R tuples
        through the single-job program inside one jit — traced once, so
        program size is independent of R, and each element keeps its exact
        single-job semantics and streams.  ``n_param_args``: leading param
        arrays batched alongside the seed (0 = seed-only batching, 1 for
        integrate, 2 for MCMC's proposal+target pair)."""
        if seed_batch < 1:
            raise ValueError("seed_batch must be >= 1")
        # The batched wrapper is cached ON the run object itself (not in
        # the global LRU keyed by id(run): after an LRU eviction CPython
        # may reuse the id for a different program, and the stale lookup
        # would silently dispatch the wrong workload).  The wrapper's
        # lifetime is then exactly its program's.
        wrappers = getattr(run, "__batched_wrappers__", None)
        if wrappers is None:
            wrappers = {}
            try:
                run.__batched_wrappers__ = wrappers
            except (AttributeError, TypeError):
                pass  # unattachable run: build fresh below (correct, slower)
        wkey = (seed_batch, n_param_args)
        batched = wrappers.get(wkey)
        if batched is None:
            batched = jax.jit(
                lambda seeds, params, *args: jax.lax.map(
                    lambda sp: run(sp[0], *sp[1], *args), (seeds, params)
                )
            )
            wrappers[wkey] = batched
        return _checked_batch_prog(
            lambda seeds_arr, params_arrs, rest: batched(
                seeds_arr, params_arrs, *rest
            ),
            dev_args, seed_batch, n_param_args, param_kinds,
        )

    def _finalize_prog(
        self, run, dev_args, seed_batch: int, param_batch: bool = False,
        n_param_args: int = 1, param_kinds=(),
    ) -> Callable:
        if param_batch:
            if seed_batch < 1:
                raise ValueError("seed_batch must be >= 1")
            if getattr(run, "__native_param_batch__", 0) == seed_batch:
                # Pallas path: params ride the kernel's batch grid
                # dimension (one params row per rep).
                return _checked_batch_prog(
                    lambda seeds_arr, params_arrs, rest: run(
                        seeds_arr, *params_arrs, *rest
                    ),
                    dev_args, seed_batch, n_param_args, param_kinds,
                )
            return self._param_batched_prog(
                run, tuple(dev_args), seed_batch, n_param_args, param_kinds
            )
        if seed_batch != 1:
            if getattr(run, "__native_seed_batch__", 1) == seed_batch:
                # The program batches R sweeps as a grid dimension itself
                # (Pallas path) — pass the seed vector straight through.
                def prog(seeds):
                    seeds_arr = np.asarray(seeds, np.uint32)
                    if seeds_arr.shape != (seed_batch,):
                        raise ValueError(
                            f"expected {seed_batch} seeds, got shape "
                            f"{seeds_arr.shape}"
                        )
                    return run(seeds_arr, *dev_args)

                return prog
            return self._batched_prog(run, tuple(dev_args), seed_batch)

        def prog(seed):
            return run(np.uint32(seed), *dev_args)

        return prog

    def _run_integrate(
        self, traced, distribution, n_samples, seed, method: str = "mc",
        with_stderr: bool = False,
    ):
        run, dev_args = self._get_integrate_program(
            traced, distribution, n_samples, method=method,
            with_stderr=with_stderr,
        )
        return run(np.uint32(seed), *dev_args)

    def _integrate_with_cv(
        self, functions, distribution, n_samples, seed, method,
        return_stderr, control_variates,
    ) -> IntegrationResult:
        """Control-variate integration (variance reduction beyond the
        reference): ``theta_i = mean(f_i) - c_i^T (mean(g) - E[g])``
        with the regression-optimal ``c_i = Cov(g)^-1 Cov(g, f_i)``,
        for user controls ``g_j`` of KNOWN means.

        Every needed moment is itself a plain integrand: the
        pilot-shifted products ``(f_i - a_i)(g_j - b_j)``,
        ``(g_j - b_j)(g_l - b_l)`` and squares compose over the traced
        user functions and fuse into ONE standard program on shared
        samples — so the whole estimator rides either backend (Pallas
        kernel included), sharding, and the K>128 multi-pass driver,
        with no new device machinery.  Pilots ``a, b`` are the
        functions' values at the distribution median: arbitrary fixed
        shifts that keep ``E[XY] - E[X]E[Y]`` away from float32
        catastrophic cancellation (the same trick as the stderr
        accumulators).  Coefficients are the classic same-run plug-in
        (O(1/n) bias — negligible at MC sample counts; Glasserman,
        "Monte Carlo Methods in Financial Engineering" §4.1).  stderr
        (when asked) is the per-function regression residual,
        ``sqrt((Var f - cov^T Cov(g)^-1 cov) / n)`` — the reduced error
        the corrected estimator actually has."""
        if method != "mc":
            raise ValueError(
                "control_variates supports method='mc' only "
                "(coefficients and residual variances are iid-sample "
                f"estimates); got method={method!r}"
            )
        pairs = list(control_variates)
        if not pairs:
            raise ValueError(
                "control_variates must be a non-empty list of "
                "(function, known_mean) pairs"
            )
        g_fns, g_means = [], []
        for p in pairs:
            if not (isinstance(p, (list, tuple)) and len(p) == 2):
                raise TypeError(
                    "each control variate is a (function, known_mean) "
                    f"pair, got {p!r}"
                )
            g_fns.append(p[0])
            g_means.append(float(p[1]))
        if isinstance(distribution, (list, tuple)):
            dists = list(distribution)
            if not dists or not all(
                isinstance(dd, Distribution) for dd in dists
            ):
                raise TypeError(
                    "a distribution sequence must be a non-empty list "
                    "of Distribution objects"
                )
        else:
            dists = [distribution]
        d = len(dists)
        k = len(functions)
        n_cv = len(g_fns)
        traced_f = self._trace_user_functions(functions, n_args=d)
        traced_g = self._trace_user_functions(g_fns, n_args=d)

        # Median-point pilots: one block evaluation per function on the
        # host path; any fixed constant works, a near-center one keeps
        # the product moments at O(spread^2) instead of O(mean^2).
        meds = [
            jnp.full((8, 128), float(dd.quantile(0.5)), jnp.float32)
            for dd in dists
        ]

        def _pilot(t):
            return float(np.asarray(jnp.mean(t(*meds))))

        a = np.array([_pilot(t) for t in traced_f])
        b = np.array([_pilot(t) for t in traced_g])

        def _shift(t, s):
            def fn(*xs, _t=t, _s=np.float32(s)):
                return _t(*xs) - _s

            return fn

        def _prod(ta, tb):
            def fn(*xs, _a=ta, _b=tb):
                return _a(*xs) * _b(*xs)

            return fn

        sf = [_shift(t, ai) for t, ai in zip(traced_f, a)]
        sg = [_shift(t, bj) for t, bj in zip(traced_g, b)]
        composed = list(traced_f) + list(traced_g)
        for i in range(k):
            for j in range(n_cv):
                composed.append(_prod(sf[i], sg[j]))
        for j in range(n_cv):
            for l in range(j, n_cv):
                composed.append(_prod(sg[j], sg[l]))
        if return_stderr:
            composed += [_prod(sf[i], sf[i]) for i in range(k)]
        composed = tuple(composed)

        n_dev = 1 if self._mesh is None else self._mesh.size
        n_act = make_integrate_plan(
            n_samples, self._target_threads, n_dev=n_dev
        ).actual_samples
        if d > 1:
            run, dev_args = self._nd_program(composed, dists, n_samples, "mc")
        else:
            run, dev_args = self._get_integrate_program(
                composed, dists[0], n_samples, method="mc"
            )
        # The kernel grid may re-round the plan's count.
        n_act = getattr(run, "actual_samples", n_act)
        out = np.asarray(run(np.uint32(seed), *dev_args), np.float64)

        m_f = out[:k]
        m_g = out[k:k + n_cv]
        pos = k + n_cv
        fg = out[pos:pos + k * n_cv].reshape(k, n_cv)
        pos += k * n_cv
        # Cov(f_i, g_j) = E[(f-a)(g-b)] - (m_f - a)(m_g - b).
        cov_fg = fg - np.outer(m_f - a, m_g - b)
        gram = np.zeros((n_cv, n_cv))
        for j in range(n_cv):
            for l in range(j, n_cv):
                v = out[pos] - (m_g[j] - b[j]) * (m_g[l] - b[l])
                gram[j, l] = gram[l, j] = v
                pos += 1
        # lstsq tolerates degenerate controls (a constant g has zero
        # variance AND zero covariance, so its coefficient is free —
        # the minimum-norm solution sets it to 0).
        coef = np.linalg.lstsq(gram, cov_fg.T, rcond=None)[0]  # (C, K)
        theta = m_f - coef.T.dot(m_g - np.array(g_means))
        stderr = None
        if return_stderr:
            ff = out[pos:pos + k]
            var_f = np.maximum(ff - (m_f - a) ** 2, 0.0)
            explained = np.sum(cov_fg * coef.T, axis=1)
            resid = np.maximum(var_f - explained, 0.0)
            stderr = np.sqrt(resid / float(n_act))
        return IntegrationResult(
            values=theta, n_samples=n_samples, n_functions=k,
            stderr=stderr,
        )

    # ------------------------------------------------------------------
    # multi-dimensional integrate (capability extension: the reference's
    # device layer binds exactly one distribution per program,
    # src/engine.rs:250-264 — here E[f(X_1..X_d)] runs over independent
    # per-dimension distributions on the XLA backend)
    # ------------------------------------------------------------------

    def _integrate_nd(
        self, functions, dists, n_samples, seed, method,
        return_stderr, qmc_rotations,
    ) -> IntegrationResult:
        d = len(dists)
        traced = self._trace_user_functions(functions, n_args=d)
        if return_stderr and method == "qmc":
            # Randomized QMC, as in 1-D: independent seed-derived
            # rotations of the d-dimensional digital net; here the
            # rotations run as R program calls (the nd path has no grid
            # batching yet — R is small).
            if qmc_rotations < 2:
                raise ValueError(
                    "qmc_rotations must be >= 2 to estimate an rQMC "
                    f"error bar (got {qmc_rotations})"
                )
            r = qmc_rotations
            run, dev_args = self._nd_program(
                traced, dists, -(-n_samples // r), method
            )
            seeds = np.uint32(seed) + np.uint32(0x9E3779B9) * np.arange(
                r, dtype=np.uint32
            )
            vals = np.stack(
                [np.asarray(run(np.uint32(s), *dev_args)) for s in seeds]
            ).astype(np.float64)
            return IntegrationResult(
                values=vals.mean(axis=0),
                n_samples=n_samples,
                n_functions=len(functions),
                stderr=vals.std(axis=0, ddof=1) / np.sqrt(r),
            )
        run, dev_args = self._nd_program(
            traced, dists, n_samples, method, with_stderr=return_stderr
        )
        out = run(np.uint32(seed), *dev_args)
        if return_stderr:
            values, stderr = out
            return IntegrationResult(
                values=values, n_samples=n_samples,
                n_functions=len(functions), stderr=stderr,
            )
        return IntegrationResult(
            values=out, n_samples=n_samples, n_functions=len(functions)
        )

    def _nd_program(
        self, traced, dists, n_samples, method, with_stderr: bool = False,
        warn: bool = True,
    ):
        from ..ops.integrate_nd import build_integrate_nd_fn

        specs = [dist_spec_of(dd) for dd in dists]
        mesh = self._mesh
        n_dev = 1 if mesh is None else mesh.size
        plan = make_integrate_plan(
            n_samples, self._target_threads, n_dev=n_dev
        )
        kinds = tuple(s.kind for s in specs)
        exact_inverses = tuple(s.exact_inverse for s in specs)
        if warn:
            self._warn_no_kernel("multi-dimensional integration")
        key = (
            "integrate_nd",
            _fns_key(traced),
            kinds,
            exact_inverses,
            plan,
            tuple(_table_shapes(s) for s in specs),
            _mesh_key(mesh),
            method,
            with_stderr,
        )
        run = self._cache.get_or_build(
            key,
            lambda: build_integrate_nd_fn(
                traced, kinds, plan, mesh=mesh,
                exact_inverses=exact_inverses, method=method,
                with_stderr=with_stderr,
            ),
        )
        per = [
            _device_args_of(dd, s) for dd, s in zip(dists, specs)
        ]
        dev_args = (
            tuple(p[0] for p in per),
            tuple(p[1] for p in per),
            tuple(p[2] for p in per),
        )
        return run, dev_args

    def _get_integrate_program(
        self, traced, distribution, n_samples, seed_batch: int = 1,
        method: str = "mc", param_batch: bool = False,
        with_stderr: bool = False,
    ):
        if method not in ("mc", "qmc", "antithetic"):
            raise ValueError(
                f"method must be 'mc', 'qmc' or 'antithetic', got {method!r}"
            )
        spec = dist_spec_of(distribution)
        mesh = self._mesh
        n_dev = 1 if mesh is None else mesh.size

        from ..ops.integrate_pallas import MAX_FUSED

        if (
            len(traced) > MAX_FUSED
            and not param_batch
            and self._use_pallas(spec.kind)
        ):
            multi = self._multi_pass_integrate_program(
                traced, distribution, spec, n_samples, method,
                seed_batch=seed_batch, with_stderr=with_stderr,
            )
            if multi is not None:
                return multi

        if self._use_pallas(spec.kind):
            from ..ops.integrate_pallas import build_integrate_fn_pallas

            plan = make_integrate_plan(
                n_samples, self._target_threads, n_dev=n_dev
            )
            if self._pallas_eligible(spec, traced):
                gapped = spec.kind == DistKind.CUSTOM and spec.exact_inverse
                key = (
                    "integrate_pallas",
                    _fns_key(traced),
                    spec.kind,
                    plan,
                    _table_shapes(spec),
                    _mesh_key(mesh),
                    gapped,
                    seed_batch,
                    method,
                    param_batch,
                    with_stderr,
                )
                run = self._cache.get_or_build(
                    key,
                    lambda: _tag_native_batch(
                        build_integrate_fn_pallas(
                            traced, spec.kind, plan, mesh=mesh,
                            gapped_tables=gapped,
                            seed_batch=seed_batch, method=method,
                            param_batch=param_batch,
                            with_stderr=with_stderr,
                        ),
                        seed_batch,
                        param_batch=param_batch,
                    ),
                )
                if gapped:
                    params_dev = _device_args_of(distribution, spec)[0]
                    ts, dts = _device_gapped_tables(
                        distribution, spec, stratified=True,
                        segments=run.strata,
                    )
                    return run, (params_dev, ts, dts)
                return run, _device_args_of(distribution, spec)

        plan = make_integrate_plan(n_samples, self._target_threads, n_dev=n_dev)
        run = self._xla_integrate_program(
            traced, spec, plan, method, with_stderr=with_stderr
        )
        return run, _device_args_of(distribution, spec)

    def _multi_pass_integrate_program(
        self, traced, distribution, spec, n_samples, method,
        seed_batch: int = 1, with_stderr: bool = False,
    ):
        """K > MAX_FUSED workloads: chain ceil(K / MAX_FUSED) kernel passes
        over IDENTICAL sample streams — each pass re-generates the same
        counter-keyed stream (same seed words, same grid, same pinned
        block), so all K integrands still share samples.  This is the
        reference's any-K accumulator semantics
        (src/shader_gen.rs:264-282) with each pass's accumulators kept
        within the kernel's register budget.  Returns (run, dev_args), or
        None when the passes cannot ride the kernel (callers fall to
        XLA)."""
        from ..ops.integrate_pallas import (
            MAX_FUSED,
            build_integrate_fn_pallas,
            pick_block,
        )

        mesh = self._mesh
        n_dev = 1 if mesh is None else mesh.size
        plan = make_integrate_plan(
            n_samples, self._target_threads, n_dev=n_dev
        )
        n_groups = -(-len(traced) // MAX_FUSED)
        gsize = -(-len(traced) // n_groups)
        groups = [
            tuple(traced[i : i + gsize])
            for i in range(0, len(traced), gsize)
        ]
        gapped = spec.kind == DistKind.CUSTOM and spec.exact_inverse
        block = pick_block(gsize, with_stderr)
        for g in groups:
            if not self._pallas_eligible(spec, g):
                return None
        runs = []
        for g in groups:
            key = (
                "integrate_pallas",
                _fns_key(g),
                spec.kind,
                plan,
                _table_shapes(spec),
                _mesh_key(mesh),
                gapped,
                seed_batch,
                method,
                False,
                with_stderr,
                ("block", block),
            )
            runs.append(
                self._cache.get_or_build(
                    key,
                    lambda g=g: build_integrate_fn_pallas(
                        g, spec.kind, plan, mesh=mesh,
                        gapped_tables=gapped,
                        method=method, block=block,
                        seed_batch=seed_batch, with_stderr=with_stderr,
                    ),
                )
            )
        if gapped:
            params_dev = _device_args_of(distribution, spec)[0]
            ts, dts = _device_gapped_tables(
                distribution, spec, stratified=True,
                segments=runs[0].strata,
            )
            dev_args = (params_dev, ts, dts)
        else:
            dev_args = _device_args_of(distribution, spec)

        # Batched results are (R, K_g) per pass (concat on the function
        # axis); unbatched are (K_g,).
        cat_axis = 1 if seed_batch != 1 else 0

        def run_multi(seed, *args):
            outs = [r(seed, *args) for r in runs]
            if with_stderr:
                return (
                    jnp.concatenate([o[0] for o in outs], axis=cat_axis),
                    jnp.concatenate([o[1] for o in outs], axis=cat_axis),
                )
            return jnp.concatenate(outs, axis=cat_axis)

        run_multi.actual_samples = runs[0].actual_samples
        run_multi.strata = runs[0].strata
        run_multi = _tag_native_batch(run_multi, seed_batch)
        return run_multi, dev_args
