"""VEGAS-style adaptive importance sampling (``adapt_proposal``).

The reference's IS takes the proposal as given (__init__.py:893-905);
``adapt_proposal`` LEARNS one by grid refinement and hands back an
ordinary Distribution, so the production run rides the existing
in-kernel table IS path.  Covered: the variance reduction itself
(peaked bump, rare tail, nd bump — each asserted against the naive
target-as-proposal baseline), estimate correctness against closed
forms, grid mechanics (equal-importance edges, monotonicity, support
pinning), history reporting, composition with the IS surface
(stderr, diagnostics/ESS, QMC), and validation.
"""

import math

import numpy as np
import pytest

from tpu_montecarlo import (
    Distribution,
    adapt_proposal,
    integrate_importance_sampling,
)

TARGET = Distribution.normal(0.0, 2.0)


def bump(x):
    return math.exp(-200.0 * (x - 1.0) ** 2)


# E_p[bump] = sqrt(pi/200) * N(1; 0, 2)-density up to the Laplace
# correction; exact: integral of bump * pdf.
BUMP_TRUTH = (
    math.sqrt(math.pi / 200.0)
    * math.exp(-0.5 * (1.0 / 2.0) ** 2)
    / (2.0 * math.sqrt(2.0 * math.pi))
)


@pytest.fixture(scope="module")
def bump_proposal():
    return adapt_proposal(bump, TARGET, n_iterations=6, seed=7)


class TestVarianceReduction:
    def test_peaked_bump(self, bump_proposal):
        n = 2_000_000
        naive = integrate_importance_sampling(
            [bump], TARGET, Distribution.normal(0.0, 2.0),
            n_samples=n, seed=1, return_stderr=True,
        )
        adapted = integrate_importance_sampling(
            [bump], TARGET, bump_proposal,
            n_samples=n, seed=1, return_stderr=True,
        )
        assert abs(adapted.values[0] - BUMP_TRUTH) < 5e-4
        # The learned grid concentrates where bump * p lives: >= 20x
        # variance reduction (measured ~150x; generous margin).
        assert (naive.stderr[0] / adapted.stderr[0]) ** 2 > 20.0

    def test_rare_tail(self):
        target = Distribution.normal(0.0, 1.0)

        def tail(x):
            return 1.0 if x > 4.0 else 0.0

        q = adapt_proposal(
            tail, target, n_iterations=8, seed=9, support=(-8.0, 8.0)
        )
        r = integrate_importance_sampling(
            [tail], target, q, n_samples=2_000_000, seed=2,
            return_stderr=True,
        )
        truth = 3.16712e-05  # P(N(0,1) > 4)
        assert abs(r.values[0] - truth) < 0.05 * truth
        # Naive MC stderr at this n is sqrt(p/n) ~ 4e-6; the adapted
        # proposal must beat it by well over an order of magnitude.
        assert r.stderr[0] < 4e-7

    def test_nd_bump(self):
        def bump2(x, y):
            return math.exp(-50.0 * ((x - 1.0) ** 2 + (y + 1.0) ** 2))

        targets = [
            Distribution.normal(0.0, 2.0), Distribution.normal(0.0, 2.0)
        ]
        q = adapt_proposal(bump2, targets, n_iterations=6, seed=11)
        assert isinstance(q, list) and len(q) == 2
        n = 2_000_000
        adapted = integrate_importance_sampling(
            [bump2], targets, q, n_samples=n, seed=3, return_stderr=True,
        )
        naive = integrate_importance_sampling(
            [bump2], targets, targets, n_samples=n, seed=3,
            return_stderr=True,
        )
        assert (naive.stderr[0] / adapted.stderr[0]) ** 2 > 20.0
        assert abs(adapted.values[0] - naive.values[0]) < 1e-4


class TestAdaptationMechanics:
    def test_history_stderr_falls(self):
        _, hist = adapt_proposal(
            bump, TARGET, n_iterations=6, seed=7, return_history=True
        )
        assert len(hist["estimate"]) == 6
        # The grid locks on: the raw per-iteration error bar collapses.
        assert hist["stderr"][-1] < 0.1 * hist["stderr"][0]
        assert abs(hist["estimate"][-1] - BUMP_TRUTH) < 5e-4

    def test_proposal_is_valid_distribution(self, bump_proposal):
        x = np.asarray(bump_proposal._x_table)
        assert np.all(np.diff(x) > 0)
        assert x[0] == pytest.approx(TARGET.quantile(1e-5), abs=1e-3)
        assert x[-1] == pytest.approx(TARGET.quantile(1 - 1e-5), abs=1e-3)
        cdf = np.asarray(bump_proposal._cdf_table, np.float64)
        assert cdf[-1] == pytest.approx(1.0, abs=1e-5)

    def test_grid_concentrates_on_the_bump(self, bump_proposal):
        # Most knots should sit near x = 1 (bump width ~0.07).
        x = np.asarray(bump_proposal._x_table)
        frac_near = np.mean(np.abs(x - 1.0) < 0.5)
        assert frac_near > 0.5

    def test_custom_table_target(self):
        # IS weights take the user pdf at face value (reference
        # semantics, __init__.py:893-905): pass it normalized.
        target = Distribution.from_pdf(
            lambda x: np.exp(-0.5 * x * x) / np.sqrt(2.0 * np.pi),
            support=(-6.0, 6.0),
        )
        q = adapt_proposal(bump, target, n_iterations=5, seed=13)
        r = integrate_importance_sampling(
            [bump], target, q, n_samples=1_000_000, seed=4,
            return_stderr=True,
        )
        truth = math.sqrt(math.pi / 200.0) * math.exp(-0.5) / math.sqrt(
            2.0 * math.pi
        )
        assert abs(r.values[0] - truth) < 10.0 * max(r.stderr[0], 1e-5)

    def test_zero_integrand_keeps_grid(self):
        def zero(x):
            return 0.0 * x

        q = adapt_proposal(
            zero, TARGET, n_iterations=3, seed=15, grid_size=64
        )
        x = np.asarray(q._x_table)
        # Nothing measured: the uniform grid survives (equal widths up
        # to the interior-edge knot pairs).
        w = np.diff(x)
        big = w[w > w.max() * 0.5]
        assert len(big) == 64
        assert np.allclose(big, big[0], rtol=1e-3)


class TestComposition:
    def test_is_diagnostics_ess(self, bump_proposal):
        r = integrate_importance_sampling(
            [bump], TARGET, bump_proposal,
            n_samples=1_000_000, seed=5, return_diagnostics=True,
        )
        assert r.diagnostics["mean_weight"] == pytest.approx(1.0, abs=0.05)

    def test_qmc_with_adapted_proposal(self, bump_proposal):
        r = integrate_importance_sampling(
            [bump], TARGET, bump_proposal,
            n_samples=1_000_000, seed=6, method="qmc",
        )
        assert abs(r.values[0] - BUMP_TRUTH) < 5e-4


class TestSamplerModeWeights:
    """Learned VEGAS tables have PAIRED knots (spacing ~1e-6 beside
    bin-sized gaps), so their pdf cannot be resampled onto a uniform
    grid for the in-kernel x-space weight lookup.  Round 4: the kernel
    takes q from the SAMPLER instead — the stratified inverse tables'
    reciprocal slope is exactly the density the draws come from (one
    extra gather) — so adaptive-IS production sampling stays on the
    Pallas path instead of the ~4000x-slower XLA closure reroute."""

    def test_learned_table_rides_pallas_no_warning(self, bump_proposal):
        import warnings

        from tpu_montecarlo import MonteCarloIntegrator

        integ = MonteCarloIntegrator(backend="pallas")
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            r = integ.integrate_importance_sampling(
                [bump], TARGET, bump_proposal,
                n_samples=1_000_000, seed=2,
            )
        assert abs(r.values[0] - BUMP_TRUTH) < 2e-4

    def test_matches_xla_face_value_weights(self, bump_proposal):
        from tpu_montecarlo import MonteCarloIntegrator

        rp = MonteCarloIntegrator(
            backend="pallas"
        ).integrate_importance_sampling(
            [bump], TARGET, bump_proposal, n_samples=2_000_000, seed=3
        )
        rx = MonteCarloIntegrator(
            backend="xla"
        ).integrate_importance_sampling(
            [bump], TARGET, bump_proposal, n_samples=2_000_000, seed=3
        )
        # Different streams and q conventions (sampler density vs
        # face-value lerp), but the proposal is normalized so both are
        # unbiased for the same integral.
        assert abs(rp.values[0] - BUMP_TRUTH) < 2e-4
        assert abs(rx.values[0] - BUMP_TRUTH) < 2e-4

    def test_mean_weight_is_one(self, bump_proposal):
        """E_q[p/q] = 1 for a normalized proposal — the sampler-mode
        denominator is the actual sampling density, so the identity
        holds to MC accuracy."""
        from tpu_montecarlo import MonteCarloIntegrator

        integ = MonteCarloIntegrator(backend="pallas")
        r = integ.integrate_importance_sampling(
            [lambda x: 1.0], TARGET, bump_proposal,
            n_samples=2_000_000, seed=5,
        )
        assert abs(r.values[0] - 1.0) < 0.02

    def test_stderr_and_methods_compose(self, bump_proposal):
        from tpu_montecarlo import MonteCarloIntegrator

        integ = MonteCarloIntegrator(backend="pallas")
        r = integ.integrate_importance_sampling(
            [bump], TARGET, bump_proposal,
            n_samples=1_000_000, seed=4, return_stderr=True,
        )
        assert r.stderr is not None and r.stderr[0] > 0
        assert abs(r.values[0] - BUMP_TRUTH) < 6 * float(r.stderr[0])
        for method in ("antithetic", "qmc"):
            rm = integ.integrate_importance_sampling(
                [bump], TARGET, bump_proposal,
                n_samples=1_000_000, seed=4, method=method,
            )
            assert abs(rm.values[0] - BUMP_TRUTH) < 2e-4

    def test_mesh_sharded(self, mesh8, bump_proposal):
        from tpu_montecarlo import MonteCarloIntegrator

        integ = MonteCarloIntegrator(backend="pallas", mesh=mesh8)
        r = integ.integrate_importance_sampling(
            [bump], TARGET, bump_proposal, n_samples=2_000_000, seed=6
        )
        assert abs(r.values[0] - BUMP_TRUTH) < 2e-4

    def test_nd_learned_proposal_sharded(self, mesh8):
        from tpu_montecarlo import MonteCarloIntegrator, adapt_proposal

        def bump2(x, y):
            return math.exp(
                -200.0 * ((x - 1.0) ** 2 + (y + 0.5) ** 2)
            )

        t2 = [
            Distribution.normal(0.0, 2.0),
            Distribution.normal(0.0, 2.0),
        ]
        q2 = adapt_proposal(bump2, t2, seed=7)
        exact = (
            (math.pi / 200.0)
            * (
                math.exp(-0.5 * 0.25) / (2.0 * math.sqrt(2.0 * math.pi))
            )
            * (
                math.exp(-0.5 * 0.0625)
                / (2.0 * math.sqrt(2.0 * math.pi))
            )
        )
        integ = MonteCarloIntegrator(backend="pallas", mesh=mesh8)
        r = integ.integrate_importance_sampling(
            [bump2], t2, q2, n_samples=2_000_000, seed=9
        )
        assert abs(r.values[0] - exact) / exact < 0.02

class TestValidation:
    def test_bad_target_type(self):
        with pytest.raises(TypeError):
            adapt_proposal(bump, "not a distribution")

    def test_bad_support(self):
        with pytest.raises(ValueError, match="support"):
            adapt_proposal(bump, TARGET, support=(3.0, 1.0))

    def test_support_dim_mismatch(self):
        with pytest.raises(ValueError, match="dimension"):
            adapt_proposal(
                bump, TARGET, support=[(0.0, 1.0), (0.0, 1.0)]
            )

    def test_bad_counts(self):
        with pytest.raises(ValueError):
            adapt_proposal(bump, TARGET, n_iterations=0)
        with pytest.raises(ValueError):
            adapt_proposal(bump, TARGET, grid_size=1)
        with pytest.raises(ValueError):
            adapt_proposal(bump, TARGET, n_samples=10, grid_size=256)
        with pytest.raises(ValueError):
            adapt_proposal(bump, TARGET, alpha=0.0)
