"""Round-2 regression tests: Pallas routing probe, find_support expand
parity, stateful-run reproducibility, IS table-grid resampling."""

import math
import warnings

import numpy as np
import pytest

from tpu_montecarlo import (
    Distribution,
    MonteCarloIntegrator,
    integrate,
    integrate_importance_sampling,
)


def _while_fn(x):
    v = x * x + 2.0
    while v > 1.0:
        v = v * 0.5
    return v


class TestBlockTraceabilityProbe:
    """A sample-dependent ``while`` traces as a scalar program but its
    vector cond cannot lower inside a Pallas kernel; the eligibility gate
    must route it to the XLA sweep instead of crashing (round-1 confirmed
    crash on the kernel default path)."""

    def test_block_traceable_rejects_while(self):
        from tpu_montecarlo.api import _block_traceable
        from tpu_montecarlo.tracing import trace_function

        good = trace_function(lambda x: x * x)
        bad = trace_function(_while_fn)
        assert _block_traceable((good,))
        assert not _block_traceable((bad,))
        assert not _block_traceable((good, bad))
        # Cached on the function object after the first probe.
        assert bad.__tpu_mc_block_ok__ is False

    def test_forced_pallas_falls_back_and_matches_xla(self):
        d = Distribution.normal(0.0, 1.0)
        ref = integrate([_while_fn], d, n_samples=50_000, backend="xla")
        with pytest.warns(UserWarning, match="not\\s+Pallas-eligible"):
            got = integrate(
                [_while_fn], d, n_samples=50_000, backend="pallas"
            )
        assert np.array_equal(ref.values, got.values)

    def test_auto_backend_integrates_while_fn(self):
        d = Distribution.uniform(0.0, 1.0)
        r = integrate([_while_fn], d, n_samples=200_000)
        # E[(x^2+2)/4] over U(0,1) = (1/3 + 2) / 4 = 7/12.
        assert abs(r.values[0] - 7.0 / 12.0) < 0.01

    def test_mcmc_while_fn_falls_back(self):
        from tpu_montecarlo import integrate_mcmc

        d = Distribution.normal(0.0, 1.0)
        integ = MonteCarloIntegrator(backend="pallas")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            r = integ.integrate_mcmc(
                [_while_fn], d, d, n_steps=300, n_chains=256, n_burnin=50
            )
        assert np.isfinite(r.values[0])

    def test_is_traced_pdf_with_while_falls_back(self):
        """A weight PDF that only evaluates scalar-wise must push IS off the
        kernel path without crashing."""

        def weird_pdf(x):
            v = x * x + 2.0
            while v > 1.0:
                v = v * 0.5
            return v * 0.0 + 0.39894228 * math.e ** (-0.5 * x * x)

        p = Distribution.from_pdf(weird_pdf, support=(-7.0, 7.0))
        q = Distribution.normal(0.0, 1.2)
        r = integrate_importance_sampling(
            [lambda x: x * x], p, q, n_samples=100_000
        )
        assert abs(r.values[0] - 1.0) < 0.05


class TestFindSupportExpandParity:
    def test_raising_pdf_breaks_without_extending(self):
        """A PDF that raises during the expand walk stops the walk at the
        current bound (reference __init__.py:182-204); a zero return takes
        one final step first."""
        from tpu_montecarlo.tables import find_support

        def pdf(x):
            if abs(x) > 5.0:
                raise ValueError("outside domain")
            return math.exp(-x * x)

        x_min, x_max = find_support(pdf)
        # Expand probes -6.3 after reaching -3.1; the raise must NOT extend.
        assert abs(x_min + 3.1) < 1e-9
        assert abs(x_max - 3.1) < 1e-9

    def test_zero_pdf_still_extends_one_step(self):
        from tpu_montecarlo.tables import find_support

        def pdf(x):
            return math.exp(-x * x) if abs(x) <= 5.0 else 0.0

        x_min, x_max = find_support(pdf)
        # Zero density at -6.3 takes the step before breaking.
        assert abs(x_min + 6.3) < 1e-9
        assert abs(x_max - 6.3) < 1e-9


class TestStatefulReproducibility:
    def test_return_state_reproduces_stateless_run(self, integrator):
        """Merely enabling return_state=True must not change same-seed
        estimates (segment 0 skips the RNG fold)."""
        d = Distribution.normal(0.0, 1.0)
        r_plain = integrator.integrate_mcmc(
            [lambda x: x, lambda x: x * x], d, d,
            n_steps=200, n_chains=256, n_burnin=20, seed=9,
        )
        r_state = integrator.integrate_mcmc(
            [lambda x: x, lambda x: x * x], d, d,
            n_steps=200, n_chains=256, n_burnin=20, seed=9,
            return_state=True,
        )
        assert np.array_equal(r_plain.values, r_state.values)
        assert r_state.chain_state is not None


class TestUniformResampling:
    def test_resample_uniform_table_roundtrip(self):
        from tpu_montecarlo.tables import (
            is_uniform_grid,
            resample_uniform_table,
        )

        x = np.concatenate(
            [np.linspace(0.0, 1.0, 200, endpoint=False), np.linspace(1.0, 2.0, 700)]
        )
        v = np.where(x < 1.0, x, 2.0 - x)
        out = resample_uniform_table(x, v)
        assert out is not None
        xu, vu = out
        assert is_uniform_grid(xu)
        probe = np.linspace(0.0, 2.0, 1777)
        err = np.max(np.abs(np.interp(probe, xu, vu) - np.interp(probe, x, v)))
        assert err <= 1e-3 * np.max(np.abs(v)) + 1e-7

    def test_resample_gives_up_on_pathological_grid(self):
        from tpu_montecarlo.tables import resample_uniform_table

        x = np.array([0.0, 1e-9, 1.0])
        v = np.array([0.0, 1.0, 0.0])
        assert resample_uniform_table(x, v, max_points=65_536) is None

    def test_is_irregular_grid_routes_in_kernel(self):
        """Irregular from_pdf_table grids must resample and keep the
        in-kernel Pallas IS path (no fallback warning under a forced
        backend), matching the XLA estimate."""
        x = np.concatenate(
            [np.linspace(0.0, 0.5, 150, endpoint=False), np.linspace(0.5, 2.0, 850)]
        )
        pdf = x / 2.0
        target = Distribution.from_pdf_table(x, pdf)
        proposal = Distribution.normal(1.0, 1.2)
        fns = [lambda x: x]

        ref = integrate_importance_sampling(
            fns, target, proposal, n_samples=200_000, backend="xla"
        )
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            got = integrate_importance_sampling(
                fns, target, proposal, n_samples=200_000, backend="pallas"
            )
        # E_p[x] over pdf x/2 on [0,2] = 4/3; both routes must agree
        # statistically (they use different RNG streams).
        assert abs(got.values[0] - 4.0 / 3.0) < 0.02
        assert abs(ref.values[0] - 4.0 / 3.0) < 0.02

    def test_mcmc_irregular_target_grid_resamples(self):
        """Irregular target log-pdf grids resample onto the Pallas MCMC
        kernel path (forced backend, no warning) and land near the truth."""
        x = np.concatenate(
            [np.linspace(0.0, 0.5, 150, endpoint=False), np.linspace(0.5, 2.0, 850)]
        )
        pdf = x / 2.0
        target = Distribution.from_pdf_table(x, pdf)
        proposal = Distribution.uniform(0.0, 2.0)
        integ = MonteCarloIntegrator(backend="pallas")
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            r = integ.integrate_mcmc(
                [lambda x: x], target, proposal,
                n_steps=400, n_chains=512, n_burnin=50,
            )
        assert abs(r.values[0] - 4.0 / 3.0) < 0.05


class TestTableDownsampling:
    """Error-bounded host downsampling of in-kernel lookup tables: the
    kernel lookup scans one lane-gather per 128-knot segment, so smaller
    tables are linearly cheaper; accuracy is guarded by interpolation-error
    bounds checked at every original knot."""

    def test_log_table_smooth_target_shrinks(self):
        import math
        from tpu_montecarlo import Distribution
        from tpu_montecarlo.tables import downsample_log_table

        bi = Distribution.from_pdf(
            lambda x: math.exp(-0.5 * (x - 2.0) ** 2)
            + math.exp(-0.5 * (x + 2.0) ** 2),
            support=(-6.0, 6.0),
        )
        lx, lp = bi.get_log_pdf_table()
        cx, cl = downsample_log_table(lx, lp)
        assert len(cx) < len(lx)
        mask = lp > -90
        err = np.abs(np.interp(lx, cx, cl) - lp)[mask]
        assert err.max() <= 0.01

    def test_log_table_rough_target_kept(self):
        from tpu_montecarlo.tables import downsample_log_table

        # A jagged log-pdf no coarse grid can represent: unchanged.
        rng = np.random.RandomState(0)
        lx = np.linspace(0.0, 1.0, 2048).astype(np.float32)
        lp = rng.uniform(-5.0, 0.0, 2048).astype(np.float32)
        cx, cl = downsample_log_table(lx, lp)
        assert cx is lx and cl is lp

    def test_pdf_table_bound(self):
        from tpu_montecarlo.tables import downsample_pdf_table

        x = np.linspace(-5.0, 5.0, 2048).astype(np.float32)
        v = np.exp(-0.5 * x * x).astype(np.float32)
        cx, cv = downsample_pdf_table(x, v)
        assert len(cx) < len(x)
        err = np.max(np.abs(np.interp(x, cx, cv) - v))
        assert err <= 1e-3 * v.max()

    def test_mcmc_estimates_unchanged_within_tolerance(self):
        """Pallas MCMC with downsampled log tables still meets the
        reference tolerance on a table target."""
        from tpu_montecarlo import Distribution, MonteCarloIntegrator

        beta = Distribution.beta(2.0, 5.0)
        it = MonteCarloIntegrator(backend="pallas")
        r = it.integrate_mcmc(
            [lambda x: x], beta, Distribution.uniform(0.0, 1.0),
            n_steps=1500, n_chains=512, n_burnin=150, seed=42,
        )
        assert abs(r.values[0] - 2.0 / 7.0) < 0.03


class TestCodeReviewRound2:
    """Regressions for the round-2 code-review findings."""

    def test_find_support_survives_zero_division(self):
        # A defensively-written PDF that raises ZeroDivisionError past its
        # domain edge must stop the expand walk, not crash from_pdf.
        import math
        from tpu_montecarlo import Distribution
        from tpu_montecarlo.tables import find_support

        def pdf(x):
            if x < 0:
                return 1 / 0
            return math.exp(-x)

        x_min, x_max = find_support(pdf)
        assert x_min <= 0.0 and x_max > 1.0
        d = Distribution.from_pdf(pdf)
        assert d is not None

    def test_find_support_non_float_return_stops_walk(self):
        from tpu_montecarlo.tables import find_support

        def pdf(x):
            if x > 3.0:
                return "boom"
            return 1.0 if 0 <= x <= 3 else 0.0

        x_min, x_max = find_support(pdf)
        assert x_max <= 3.2

    def test_guard_proposal_log_floor(self):
        from tpu_montecarlo.tables import guard_proposal_log_floor

        lp = np.array(
            [-100.0, 0.5, 0.2, -100.0, -100.0, -100.0, 0.3, -100.0],
            np.float32,
        )
        out = guard_proposal_log_floor(lp)
        # edge floors lifted to their non-floor neighbour...
        assert out[0] == np.float32(0.5)
        assert out[3] == np.float32(0.2)
        assert out[5] == np.float32(0.3)
        assert out[7] == np.float32(0.3)
        # ...interior floors (never emitted) stay at the floor
        assert out[4] == np.float32(-100.0)
        # non-floor values untouched
        np.testing.assert_array_equal(out[[1, 2, 6]], lp[[1, 2, 6]])

    def test_is_q_table_relative_validation(self):
        """An irregular-grid proposal whose resample passes the absolute
        bound but distorts a low-density region relatively must NOT be
        admitted as an in-kernel q table."""
        from tpu_montecarlo import Distribution, MonteCarloIntegrator
        from tpu_montecarlo.api import _uniform_table_mode

        # Irregular grid: dense structured low tail at ~5e-4 of peak.
        x = np.concatenate(
            [np.linspace(0.0, 1.0, 900),
             1.0 + np.geomspace(1e-4, 1.0, 300)]
        )
        p = np.where(
            x <= 1.0, 1.0, 5e-4 * (1.0 + 0.9 * np.sin(40.0 * x))
        )
        d = Distribution.from_pdf_table(x, p)
        xt, pt = d.get_or_compute_pdf_table()
        mode = ("table", xt, pt)
        q_mode = _uniform_table_mode(d, mode, "proposal")
        if q_mode is not None:
            # admitted: then the relative bound must genuinely hold
            # against the distribution's own pdf-table grid.
            xq = np.asarray(xt, np.float64)
            vq = np.asarray(pt, np.float64)
            back = np.interp(
                xq, np.asarray(q_mode[1]), np.asarray(q_mode[2])
            )
            pos = vq > 0
            assert np.all(np.abs(back - vq)[pos] <= 2e-3 * vq[pos])
        else:
            # rejected for q: either the resample itself failed (then the
            # target role rejects too — consistent), or the absolute-bound
            # resample genuinely violates the relative bound somewhere the
            # density is positive.
            p_mode = _uniform_table_mode(d, mode)
            if p_mode is not None:
                xq = np.asarray(xt, np.float64)
                vq = np.asarray(pt, np.float64)
                back = np.interp(
                    xq, np.asarray(p_mode[1]), np.asarray(p_mode[2])
                )
                pos = vq > 0
                assert np.any(np.abs(back - vq)[pos] > 1e-3 * vq[pos])

    def test_is_uniform_grid_cumulative_deviation(self):
        from tpu_montecarlo.tables import is_uniform_grid

        # Per-diff deviation tiny but systematically drifting: total knot
        # misplacement approaches a whole cell -> must be rejected (the
        # arithmetic-indexed lookup would read the wrong knot).
        n = 2048
        dx = 1.0 + 9e-4 * np.sin(np.linspace(0.0, 3.0, n - 1))
        x = np.concatenate([[0.0], np.cumsum(dx)])
        assert not is_uniform_grid(x)
        # float32 linspace grids (non-accumulating rounding) still pass.
        assert is_uniform_grid(np.linspace(0.0, 1.0, n).astype(np.float32))
        assert is_uniform_grid(np.linspace(-6.0, 6.0, n).astype(np.float32))

    def test_mcmc_state_with_seed_batch_rejected(self):
        from tpu_montecarlo import Distribution, MonteCarloIntegrator

        it = MonteCarloIntegrator()
        d = Distribution.normal(0.0, 1.0)
        with pytest.raises(ValueError, match="stateless"):
            it._get_mcmc_program(
                it._trace_user_functions([lambda x: x]),
                d, Distribution.normal(0.0, 2.0),
                10, 256, 0, with_state=True, seed_batch=2,
            )

