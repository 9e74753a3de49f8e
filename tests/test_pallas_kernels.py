"""Pallas kernel tier: interpreter-mode runs on the CPU (SURVEY.md §5
sanitizer tier — the Triton-route kernels execute in the Pallas
interpreter, validating kernel logic without a GPU; statistical
tolerances are loose because interpreter runs must stay small)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from tpu_montecarlo.ops.integrate_pallas import (
    build_integrate_fn_pallas,
    pallas_supports,
    plan_pallas_grid,
)
from tpu_montecarlo.ops.mcmc_pallas import (
    build_mcmc_fn_pallas,
    mcmc_pallas_supports,
    plan_mcmc_grid,
)
from tpu_montecarlo.sampling import DistKind
from tpu_montecarlo.tracing import trace_function
from tpu_montecarlo.utils.dispatch import make_integrate_plan

_DUMMY = np.zeros(1, np.float32)


def _fns():
    return tuple(
        trace_function(f) for f in [lambda x: x, lambda x: x * x]
    )


class TestSupportMatrix:
    def test_analytic_supported(self):
        assert pallas_supports(DistKind.UNIFORM)
        assert pallas_supports(DistKind.NORMAL)
        assert pallas_supports(DistKind.EXPONENTIAL)

    def test_custom_integrate_supported_via_inv_table(self):
        assert pallas_supports(DistKind.CUSTOM)

    def test_custom_mcmc_supported(self):
        assert mcmc_pallas_supports(DistKind.CUSTOM, DistKind.NORMAL)
        assert mcmc_pallas_supports(DistKind.NORMAL, DistKind.CUSTOM)

    def test_grid_plans_cover_request(self):
        for n in (1, 1000, 32768, 32769, 10_000_000):
            programs, loops, actual = plan_pallas_grid(n)
            assert actual >= n
            assert programs >= 1 and loops >= 1

    def test_mcmc_grid_covers_chains(self):
        for chains in (1, 256, 1024, 4096, 65536):
            programs, per, actual = plan_mcmc_grid(chains)
            assert actual >= chains
            # A power-of-two chain tile, one warp to four.
            assert per & (per - 1) == 0 and 32 <= per <= 128


class TestInterpretedIntegrate:
    @pytest.mark.parametrize(
        "kind,params,expect_mean",
        [
            (DistKind.UNIFORM, [0.0, 1.0], 0.5),
            (DistKind.NORMAL, [0.0, 1.0], 0.0),
            (DistKind.EXPONENTIAL, [2.0, 0.0], 0.5),
        ],
    )
    def test_sampler_means(self, kind, params, expect_mean):
        plan = make_integrate_plan(200_000, target_threads=1024)
        run = build_integrate_fn_pallas(
            _fns(), kind, plan, interpret=True
        )
        vals = np.asarray(
            run(np.uint32(42), jnp.asarray(params, jnp.float32), _DUMMY, _DUMMY)
        )
        assert abs(vals[0] - expect_mean) < 0.05

    def test_normal_second_moment(self):
        plan = make_integrate_plan(500_000, target_threads=1024)
        run = build_integrate_fn_pallas(
            _fns(), DistKind.NORMAL, plan, interpret=True
        )
        vals = np.asarray(
            run(
                np.uint32(42),
                jnp.asarray([0.0, 1.0], jnp.float32),
                _DUMMY,
                _DUMMY,
            )
        )
        assert abs(vals[1] - 1.0) < 0.05

    def test_reproducible_for_fixed_seed(self):
        plan = make_integrate_plan(100_000, target_threads=1024)
        run = build_integrate_fn_pallas(
            _fns(), DistKind.UNIFORM, plan, interpret=True
        )
        p = jnp.asarray([0.0, 1.0], jnp.float32)
        v1 = np.asarray(run(np.uint32(7), p, _DUMMY, _DUMMY))
        v2 = np.asarray(run(np.uint32(7), p, _DUMMY, _DUMMY))
        np.testing.assert_array_equal(v1, v2)

    def test_custom_table_sampling(self):
        from tpu_montecarlo import Distribution
        from tpu_montecarlo.sampling import dist_spec_of

        beta = Distribution.beta(2.0, 5.0)
        spec = dist_spec_of(beta)
        plan = make_integrate_plan(200_000, target_threads=1024)
        run = build_integrate_fn_pallas(
            _fns(), DistKind.CUSTOM, plan, interpret=True
        )
        vals = np.asarray(
            run(
                np.uint32(42),
                jnp.asarray(spec.params),
                jnp.asarray(spec.x_table),
                jnp.asarray(spec.cdf_table),
            )
        )
        assert abs(vals[0] - 2.0 / 7.0) < 0.02

    def test_custom_table_stratified_moments(self):
        # Beta(2,5): E[X]=2/7, E[X^2]=a(a+1)/((a+b)(a+b+1))=6/56.
        # Exercises the row-stratified sampler on both default (2048) and
        # small (1024) table sizes.
        from tpu_montecarlo import Distribution
        from tpu_montecarlo.sampling import dist_spec_of

        for table_size in (1024, 2048):
            beta = Distribution.beta(2.0, 5.0, table_size=table_size)
            spec = dist_spec_of(beta)
            plan = make_integrate_plan(200_000, target_threads=1024)
            run = build_integrate_fn_pallas(
                _fns(), DistKind.CUSTOM, plan, interpret=True
            )
            vals = np.asarray(
                run(
                    np.uint32(123),
                    jnp.asarray(spec.params),
                    jnp.asarray(spec.x_table),
                    jnp.asarray(spec.cdf_table),
                )
            )
            assert abs(vals[0] - 2.0 / 7.0) < 0.02
            assert abs(vals[1] - 6.0 / 56.0) < 0.02

    def test_stratified_segments_divide_rows(self):
        """The stratum count is a power of two capped by the knot count
        and block // 8, so it divides every block — ANY m-knot table
        preps without error."""
        from tpu_montecarlo.ops.integrate_pallas import (
            STRATUM_KNOTS,
            prep_inv_table_stratified,
            strata_for,
        )

        for m in (2, 100, 192, 384, 1000, 3000, 4096, 8192):
            for block in (128, 512, 1024):
                strata = strata_for(block, m)
                assert block % strata == 0 and block // strata >= 8
                ts, dts = prep_inv_table_stratified(
                    np.linspace(0.0, 1.0, m).astype(np.float32), strata
                )
                assert ts.shape == (strata * STRATUM_KNOTS,)
                assert dts.shape == (strata * STRATUM_KNOTS,)

    @pytest.mark.parametrize("m", [100, 384, 3000])
    def test_custom_table_any_size(self, m):
        """Stratified prep resamples ANY m-knot inverse table onto its
        per-stratum grids (segments are chosen independently of m), so
        non-lane-multiple tables run in-kernel too.  An m-knot inverse
        for U(0,1) (identity inverse CDF) must integrate correctly."""
        plan = make_integrate_plan(200_000, target_threads=1024)
        run = build_integrate_fn_pallas(
            _fns(), DistKind.CUSTOM, plan, interpret=True
        )
        vals = np.asarray(
            run(
                np.uint32(42),
                jnp.zeros(2, jnp.float32),
                jnp.linspace(0.0, 1.0, m).astype(jnp.float32),
                jnp.zeros(1, jnp.float32),
            )
        )
        assert abs(vals[0] - 0.5) < 0.01
        assert abs(vals[1] - 1.0 / 3.0) < 0.01

    def test_custom_table_too_small_rejected(self):
        plan = make_integrate_plan(1000)
        run = build_integrate_fn_pallas(
            _fns(), DistKind.CUSTOM, plan, interpret=True
        )
        with pytest.raises(ValueError):
            run(
                np.uint32(42),
                jnp.zeros(2, jnp.float32),
                jnp.zeros(1, jnp.float32),
                jnp.zeros(1, jnp.float32),
            )

    def test_high_k_custom_shrinks_block_rows(self):
        """K=64 custom kernels keep their 64 accumulators in registers by
        shrinking the block (and with it the stratum count) instead of
        spilling."""
        from tpu_montecarlo import Distribution
        from tpu_montecarlo.ops.integrate_pallas import pick_block
        from tpu_montecarlo.sampling import dist_spec_of

        assert pick_block(8) == 1024
        assert pick_block(64) == 128
        assert pick_block(8, with_stderr=True) == 512

        edges = np.linspace(0.0, 1.0, 65)

        def bin_fn(lo, hi):
            return lambda v: (v >= lo) * (v < hi)

        fns = tuple(
            trace_function(bin_fn(float(a), float(b)))
            for a, b in zip(edges[:-1], edges[1:])
        )
        beta = Distribution.beta(2.0, 5.0)
        spec = dist_spec_of(beta)
        plan = make_integrate_plan(200_000, target_threads=1024)
        run = build_integrate_fn_pallas(
            fns, DistKind.CUSTOM, plan, interpret=True
        )
        vals = np.asarray(
            run(
                np.uint32(42),
                jnp.asarray(spec.params),
                jnp.asarray(spec.x_table),
                jnp.asarray(spec.cdf_table),
            )
        )
        assert abs(np.sum(vals) - 1.0) < 1e-5  # bins partition [0, 1]
        # bin masses match the table CDF
        cdf_at = np.interp(edges, np.linspace(0, 1, len(spec.cdf_table)),
                           spec.cdf_table)
        np.testing.assert_allclose(vals, np.diff(cdf_at), atol=0.01)


class TestInterpretedMCMC:
    def test_normal_target(self):
        run = build_mcmc_fn_pallas(
            _fns(),
            proposal_kind=DistKind.NORMAL,
            target_kind=DistKind.NORMAL,
            n_steps=300,
            n_burnin=50,
            total_chains=1024,
            interpret=True,
        )
        dummy = jnp.zeros(1, jnp.float32)
        vals, acc = run(
            np.uint32(42),
            jnp.asarray([0.0, 2.0], jnp.float32),
            jnp.asarray([0.0, 1.0], jnp.float32),
            *([dummy] * 6),
        )
        vals = np.asarray(vals)
        assert abs(vals[0]) < 0.15
        assert abs(vals[1] - 1.0) < 0.25
        assert 0.3 < float(acc) < 0.9

    def test_accept_everything_when_q_equals_p(self):
        run = build_mcmc_fn_pallas(
            _fns(),
            proposal_kind=DistKind.NORMAL,
            target_kind=DistKind.NORMAL,
            n_steps=100,
            n_burnin=10,
            total_chains=1024,
            interpret=True,
        )
        dummy = jnp.zeros(1, jnp.float32)
        _, acc = run(
            np.uint32(42),
            jnp.asarray([0.0, 1.0], jnp.float32),
            jnp.asarray([0.0, 1.0], jnp.float32),
            *([dummy] * 6),
        )
        assert float(acc) > 0.99

    def test_custom_target_via_log_table(self):
        from tpu_montecarlo import Distribution
        from tpu_montecarlo.sampling import dist_spec_of

        # Table target N(1,1) truncated to its grid; uniform proposal.
        import math

        target = Distribution.from_pdf(
            lambda x: math.exp(-0.5 * (x - 1.0) ** 2), support=(-4.0, 6.0)
        )
        lx, lp = target.get_log_pdf_table()
        run = build_mcmc_fn_pallas(
            (trace_function(lambda x: x),),
            proposal_kind=DistKind.UNIFORM,
            target_kind=DistKind.CUSTOM,
            n_steps=400,
            n_burnin=50,
            total_chains=1024,
            interpret=True,
        )
        dummy = jnp.zeros(1, jnp.float32)
        vals, acc = run(
            np.uint32(42),
            jnp.asarray([-4.0, 6.0], jnp.float32),
            jnp.zeros(2, jnp.float32),
            dummy, dummy,
            jnp.asarray(lx), jnp.asarray(lp),
            dummy, dummy,
        )
        assert abs(float(np.asarray(vals)[0]) - 1.0) < 0.1
        assert 0.0 < float(acc) <= 1.0

    def test_custom_proposal_via_inv_table(self):
        from tpu_montecarlo import Distribution
        from tpu_montecarlo.sampling import dist_spec_of

        # Custom Laplace-ish proposal sampling a normal target.  The pdf is
        # strictly positive on its support: a pdf that reads exactly zero at
        # a grid knot interpolates toward the -100 log floor nearby, which
        # legitimately (reference convention, distribution.rs:367-475)
        # distorts acceptance around that knot.
        import math

        prop = Distribution.from_pdf(
            lambda x: math.exp(-abs(x) / 2.0), support=(-4.0, 4.0)
        )
        spec = dist_spec_of(prop)
        lx, lp = prop.get_log_pdf_table()
        run = build_mcmc_fn_pallas(
            (trace_function(lambda x: x * x),),
            proposal_kind=DistKind.CUSTOM,
            target_kind=DistKind.NORMAL,
            n_steps=400,
            n_burnin=50,
            total_chains=1024,
            interpret=True,
        )
        dummy = jnp.zeros(1, jnp.float32)
        vals, acc = run(
            np.uint32(42),
            jnp.zeros(2, jnp.float32),
            jnp.asarray([0.0, 1.0], jnp.float32),
            jnp.asarray(spec.x_table), jnp.asarray(spec.cdf_table),
            dummy, dummy,
            jnp.asarray(lx), jnp.asarray(lp),
        )
        assert abs(float(np.asarray(vals)[0]) - 1.0) < 0.25
        assert 0.0 < float(acc) <= 1.0


class TestInterpretedISWeights:
    """In-kernel table-PDF importance sampling (backend='pallas' routes
    through the interpreter on the CPU)."""

    @staticmethod
    def _untraceable_pdf(x):
        return 0.5 if int(abs(x)) < 1 else 0.0

    def test_table_target_weight(self):
        from tpu_montecarlo import Distribution, MonteCarloIntegrator

        integ = MonteCarloIntegrator(backend="pallas")
        target = Distribution.from_pdf(
            self._untraceable_pdf, support=(-1.0, 1.0)
        )
        proposal = Distribution.uniform(-1.0, 1.0)
        r = integ.integrate_importance_sampling(
            [lambda x: x * x], target, proposal, n_samples=400_000
        )
        assert abs(r.values[0] - 1.0 / 3.0) < 0.02

    def test_both_table_weights(self):
        from tpu_montecarlo import Distribution, MonteCarloIntegrator

        integ = MonteCarloIntegrator(backend="pallas")
        target = Distribution.from_pdf(
            self._untraceable_pdf, support=(-1.0, 1.0)
        )
        proposal = Distribution.from_pdf(
            self._untraceable_pdf, support=(-1.0, 1.0)
        )
        r = integ.integrate_importance_sampling(
            [lambda x: x * x], target, proposal, n_samples=400_000
        )
        assert abs(r.values[0] - 1.0 / 3.0) < 0.02

    def test_matches_xla_fallback_statistically(self):
        from tpu_montecarlo import Distribution, MonteCarloIntegrator

        target = Distribution.from_pdf(
            self._untraceable_pdf, support=(-1.0, 1.0)
        )
        proposal = Distribution.normal(0.0, 1.0)
        r_pallas = MonteCarloIntegrator(
            backend="pallas"
        ).integrate_importance_sampling(
            [lambda x: x * x], target, proposal, n_samples=400_000
        )
        r_xla = MonteCarloIntegrator(
            backend="xla"
        ).integrate_importance_sampling(
            [lambda x: x * x], target, proposal, n_samples=400_000
        )
        assert abs(r_pallas.values[0] - r_xla.values[0]) < 0.02


class TestMcmcBuilderValidation:
    def test_use_init_state_requires_with_state(self):
        from tpu_montecarlo.ops.mcmc_pallas import build_mcmc_fn_pallas
        from tpu_montecarlo.sampling import DistKind

        with pytest.raises(ValueError, match="use_init_state"):
            build_mcmc_fn_pallas(
                (lambda x: x,), DistKind.NORMAL, DistKind.NORMAL,
                n_steps=10, n_burnin=0, total_chains=256,
                interpret=True, with_state=False, use_init_state=True,
            )
