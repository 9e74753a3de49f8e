"""Hamiltonian Monte Carlo proposals (``HMC``).

A gradient-based sampler far beyond the reference, whose MCMC is an
independence sampler only and never touches gradients at all
(src/shader_gen.rs:466-539).  Each iteration resamples per-chain
momenta, runs ``n_leapfrog`` leapfrog steps guided by the autodiff
gradient of the target log-density, and applies the exact Metropolis
energy correction, so the chain is exact MH at any step size.

Covered: statistical correctness on analytic / extended / table /
joint-fn targets (the gradient sources: closed forms, interpolant
slopes, traced expressions), the exactness of the energy correction at
deliberately coarse steps, burn-in step adaptation toward the 0.8
target, the mixing advantage over a random walk (ESS at equal step
budget), the stderr / diagnostics / samples / resume / seed-batch /
sharded compositions, and the validation surface.
"""

import numpy as np
import pytest

from tpu_montecarlo import (
    HMC,
    Distribution,
    MonteCarloIntegrator,
    RandomWalk,
    integrate_mcmc,
)


@pytest.fixture(scope="module")
def integ():
    return MonteCarloIntegrator()


# ---------------------------------------------------------------------------
# Statistical correctness
# ---------------------------------------------------------------------------


class TestHmcEstimates:
    def test_normal_target_moments(self, integ):
        target = Distribution.normal(3.0, 2.0)
        r = integ.integrate_mcmc(
            [lambda x: x, lambda x: x * x],
            target,
            HMC(step_size=0.4, n_leapfrog=8),
            n_steps=2000,
            n_chains=1024,
            n_burnin=300,
            seed=7,
        )
        assert abs(r.values[0] - 3.0) < 0.1
        assert abs(r.values[1] - 13.0) < 0.5
        assert 0.5 < r.acceptance_rate <= 1.0

    def test_exponential_target(self, integ):
        # One-sided support: the -100 log-pdf floor has zero gradient,
        # so trajectories that leave x > 0 coast and reject on energy.
        target = Distribution.exponential(2.0)
        r = integ.integrate_mcmc(
            [lambda x: x],
            target,
            HMC(step_size=0.1, n_leapfrog=8),
            n_steps=3000,
            n_chains=1024,
            n_burnin=500,
            seed=11,
        )
        assert abs(r.values[0] - 0.5) < 0.05

    def test_extended_family_target(self, integ):
        # Laplace: |x| kink gives a +-1/b subgradient — leapfrog still
        # integrates a well-defined field and MH corrects any energy
        # error exactly.
        target = Distribution.laplace(2.0, 1.0)
        r = integ.integrate_mcmc(
            [lambda x: x],
            target,
            HMC(step_size=0.5, n_leapfrog=6),
            n_steps=3000,
            n_chains=1024,
            n_burnin=500,
            seed=13,
        )
        assert abs(r.values[0] - 2.0) < 0.1

    def test_custom_table_target(self, integ):
        # Table targets: the gradient is the piecewise-linear
        # interpolant's slope.
        target = Distribution.from_pdf(
            lambda x: np.exp(-0.5 * (x - 1.0) ** 2),
            support=(-5.0, 7.0),
        )
        r = integ.integrate_mcmc(
            [lambda x: x, lambda x: (x - 1.0) ** 2],
            target,
            HMC(step_size=0.4, n_leapfrog=8),
            n_steps=3000,
            n_chains=1024,
            n_burnin=500,
            seed=17,
        )
        assert abs(r.values[0] - 1.0) < 0.1
        assert abs(r.values[1] - 1.0) < 0.15

    def test_module_level_entry(self):
        r = integrate_mcmc(
            [lambda x: x],
            Distribution.normal(-1.0, 1.0),
            HMC(step_size=0.5, n_leapfrog=5),
            n_steps=1500,
            n_chains=512,
            n_burnin=200,
            seed=19,
        )
        assert abs(r.values[0] + 1.0) < 0.1

    def test_exact_at_coarse_steps(self, integ):
        # The Metropolis energy correction makes the chain exact for ANY
        # step size: a deliberately coarse integrator loses acceptance,
        # not correctness.
        target = Distribution.normal(0.0, 1.0)
        r = integ.integrate_mcmc(
            [lambda x: x * x],
            target,
            HMC(step_size=1.8, n_leapfrog=3),
            n_steps=4000,
            n_chains=1024,
            n_burnin=500,
            seed=23,
        )
        assert r.acceptance_rate < 0.9  # the integrator IS coarse
        assert abs(r.values[0] - 1.0) < 0.06  # ... and still unbiased


# ---------------------------------------------------------------------------
# Step adaptation
# ---------------------------------------------------------------------------


class TestAdaptation:
    def test_adapts_down_from_huge_step(self, integ):
        target = Distribution.normal(3.0, 2.0)
        r = integ.integrate_mcmc(
            [lambda x: x],
            target,
            HMC(step_size=8.0, n_leapfrog=5, adapt=True),
            n_steps=2000,
            n_chains=1024,
            n_burnin=800,
            seed=29,
        )
        assert abs(r.values[0] - 3.0) < 0.15
        assert 0.65 < r.acceptance_rate < 0.95

    def test_custom_target_accept(self, integ):
        target = Distribution.normal(0.0, 1.0)
        r = integ.integrate_mcmc(
            [lambda x: x],
            target,
            HMC(step_size=2.0, n_leapfrog=5, adapt=True, target_accept=0.6),
            n_steps=2000,
            n_chains=1024,
            n_burnin=1000,
            seed=31,
        )
        assert abs(r.acceptance_rate - 0.6) < 0.12

    def test_mixes_faster_than_random_walk(self, integ):
        # The capability claim: on a wide smooth target at an equal
        # n_steps budget, gradient-guided trajectories decorrelate far
        # faster than diffusive steps — measured by the split-chain ESS.
        target = Distribution.normal(0.0, 5.0)
        kw = dict(
            n_steps=400, n_chains=512, n_burnin=200,
            seed=37, return_diagnostics=True,
        )
        r_hmc = integ.integrate_mcmc(
            [lambda x: x], target,
            HMC(step_size=1.0, n_leapfrog=10), **kw,
        )
        r_rw = integ.integrate_mcmc(
            [lambda x: x], target, RandomWalk(step_size=1.0), **kw,
        )
        assert r_hmc.diagnostics["ess"][0] > 3 * r_rw.diagnostics["ess"][0]
        assert r_hmc.diagnostics["r_hat"][0] < 1.02


# ---------------------------------------------------------------------------
# Compositions
# ---------------------------------------------------------------------------


class TestCompositions:
    def test_stderr(self, integ):
        target = Distribution.normal(2.0, 1.0)
        r = integ.integrate_mcmc(
            [lambda x: x],
            target,
            HMC(step_size=0.5, n_leapfrog=6),
            n_steps=1000,
            n_chains=1024,
            n_burnin=200,
            seed=41,
            return_stderr=True,
        )
        err = abs(r.values[0] - 2.0)
        assert r.stderr[0] > 0
        assert err < 6 * r.stderr[0]

    def test_diagnostics(self, integ):
        target = Distribution.normal(0.0, 1.0)
        r = integ.integrate_mcmc(
            [lambda x: x],
            target,
            HMC(step_size=0.6, n_leapfrog=8),
            n_steps=1000,
            n_chains=512,
            n_burnin=200,
            seed=43,
            return_diagnostics=True,
        )
        assert r.diagnostics["r_hat"][0] < 1.02
        assert r.diagnostics["ess"][0] > 1000

    def test_return_samples(self, integ):
        target = Distribution.normal(1.0, 2.0)
        r = integ.integrate_mcmc(
            [lambda x: x],
            target,
            HMC(step_size=0.4, n_leapfrog=8),
            n_steps=1000,
            n_chains=512,
            n_burnin=200,
            seed=47,
            return_samples=50,
        )
        assert r.samples.shape == (50, 512)
        assert abs(np.mean(r.samples) - 1.0) < 0.2
        assert abs(np.std(r.samples) - 2.0) < 0.3

    def test_resume_fixed_step(self, integ):
        target = Distribution.normal(3.0, 1.0)
        prop = HMC(step_size=0.4, n_leapfrog=6)
        r1 = integ.integrate_mcmc(
            [lambda x: x], target, prop,
            n_steps=800, n_chains=512, n_burnin=200, seed=53,
            return_state=True,
        )
        r2 = integ.integrate_mcmc(
            [lambda x: x], target, prop,
            n_steps=800, n_chains=512, n_burnin=0, seed=53,
            initial_state=r1.chain_state,
        )
        assert abs(r1.values[0] - 3.0) < 0.1
        assert abs(r2.values[0] - 3.0) < 0.1

    def test_seed_batch_handle_matches_single_calls(self, integ):
        target = Distribution.normal(0.0, 2.0)
        prop = HMC(step_size=0.5, n_leapfrog=5)
        prog = integ.compile_mcmc(
            [lambda x: x * x], target, prop,
            n_steps=400, n_chains=256, n_burnin=100, seed_batch=3,
        )
        vals, accs = prog([5, 6, 7])
        singles = [
            integ.integrate_mcmc(
                [lambda x: x * x], target, prop,
                n_steps=400, n_chains=256, n_burnin=100, seed=s,
            )
            for s in (5, 6, 7)
        ]
        for i, s in enumerate(singles):
            np.testing.assert_allclose(
                np.asarray(vals)[i], s.values, rtol=1e-5
            )

    def test_sharded_matches_expectation(self, mesh8):
        integ = MonteCarloIntegrator(mesh=mesh8)
        target = Distribution.normal(2.0, 1.0)
        r = integ.integrate_mcmc(
            [lambda x: x],
            target,
            HMC(step_size=0.5, n_leapfrog=6),
            n_steps=1000,
            n_chains=1024,
            n_burnin=200,
            seed=59,
        )
        assert abs(r.values[0] - 2.0) < 0.1


# ---------------------------------------------------------------------------
# Pallas kernel tier (interpret mode on the CPU; compiled on the GPU)
# ---------------------------------------------------------------------------


class TestPallasKernel:
    """In-kernel HMC: the leapfrog gradient is jax.grad of the
    closed-form analytic log-density traced into the kernel body
    (gather-free elementwise ops); CUSTOM table targets gather the
    log-table interpolant's slope instead (mcmc_pallas._Chains.log_pdf_grad),
    so both run at kernel speed."""

    @pytest.fixture(scope="class")
    def kern(self):
        return MonteCarloIntegrator(backend="pallas")

    def test_fixed_step_moments(self, kern):
        target = Distribution.normal(3.0, 2.0)
        r = kern.integrate_mcmc(
            [lambda x: x, lambda x: x * x],
            target,
            HMC(step_size=0.4, n_leapfrog=8),
            n_steps=1500,
            n_chains=512,
            n_burnin=200,
            seed=7,
        )
        assert abs(r.values[0] - 3.0) < 0.12
        assert abs(r.values[1] - 13.0) < 0.7

    def test_adapts_to_target_accept(self, kern):
        target = Distribution.normal(3.0, 2.0)
        r = kern.integrate_mcmc(
            [lambda x: x],
            target,
            HMC(step_size=6.0, n_leapfrog=5, adapt=True),
            n_steps=1500,
            n_chains=512,
            n_burnin=600,
            seed=11,
        )
        assert abs(r.values[0] - 3.0) < 0.15
        assert 0.6 < r.acceptance_rate < 0.95

    def test_extended_family_target(self, kern):
        r = kern.integrate_mcmc(
            [lambda x: x],
            Distribution.laplace(2.0, 1.0),
            HMC(step_size=0.5, n_leapfrog=6),
            n_steps=2000,
            n_chains=512,
            n_burnin=300,
            seed=13,
        )
        assert abs(r.values[0] - 2.0) < 0.12

    def test_matches_xla_statistically(self, kern):
        target = Distribution.normal(0.0, 1.5)
        prop = HMC(step_size=0.4, n_leapfrog=6)
        kw = dict(n_steps=1500, n_chains=512, n_burnin=200, seed=17)
        r_k = kern.integrate_mcmc([lambda x: x * x], target, prop, **kw)
        r_x = MonteCarloIntegrator(backend="xla").integrate_mcmc(
            [lambda x: x * x], target, prop, **kw
        )
        assert abs(r_k.values[0] - 2.25) < 0.1
        assert abs(r_x.values[0] - 2.25) < 0.1

    def test_stderr_stays_in_kernel(self, kern):
        import warnings

        target = Distribution.normal(2.0, 1.0)
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            r = kern.integrate_mcmc(
                [lambda x: x],
                target,
                HMC(step_size=0.4, n_leapfrog=6),
                n_steps=800,
                n_chains=512,
                n_burnin=100,
                seed=19,
                return_stderr=True,
            )
        assert not any("XLA" in str(x.message) for x in w)
        assert r.stderr[0] > 0
        assert abs(r.values[0] - 2.0) < 6 * r.stderr[0] + 0.05

    def test_resume_fixed_step(self, kern):
        target = Distribution.normal(3.0, 1.0)
        prop = HMC(step_size=0.4, n_leapfrog=6)
        r1 = kern.integrate_mcmc(
            [lambda x: x], target, prop,
            n_steps=600, n_chains=512, n_burnin=100, seed=23,
            return_state=True,
        )
        r2 = kern.integrate_mcmc(
            [lambda x: x], target, prop,
            n_steps=600, n_chains=512, n_burnin=0, seed=23,
            initial_state=r1.chain_state,
        )
        assert abs(r1.values[0] - 3.0) < 0.12
        assert abs(r2.values[0] - 3.0) < 0.12

    def test_seed_batch_handle_matches_single_calls(self, kern):
        target = Distribution.normal(0.0, 2.0)
        prop = HMC(step_size=0.4, n_leapfrog=6)
        prog = kern.compile_mcmc(
            [lambda x: x * x], target, prop,
            n_steps=400, n_chains=256, n_burnin=100, seed_batch=3,
        )
        vals, accs = prog([5, 6, 7])
        singles = [
            kern.integrate_mcmc(
                [lambda x: x * x], target, prop,
                n_steps=400, n_chains=256, n_burnin=100, seed=s,
            )
            for s in (5, 6, 7)
        ]
        for i, s in enumerate(singles):
            np.testing.assert_allclose(
                np.asarray(vals)[i], s.values, rtol=1e-5
            )

    def test_nd_product_adaptive_with_stderr(self, kern):
        r = kern.integrate_mcmc(
            [lambda x, y: x, lambda x, y: y * y],
            [
                Distribution.normal(0.0, 10.0),
                Distribution.normal(0.0, 1.0),
            ],
            HMC(step_size=[2.0, 0.2], n_leapfrog=8, adapt=True),
            n_steps=2000,
            n_chains=512,
            n_burnin=500,
            seed=31,
            return_stderr=True,
        )
        assert abs(r.values[0]) < 1.0
        assert abs(r.values[1] - 1.0) < 0.15
        assert r.stderr[1] > 0


# ---------------------------------------------------------------------------
# Multi-dimensional
# ---------------------------------------------------------------------------


class TestNdHmc:
    def test_joint_target_correlation(self, integ):
        rho = 0.6

        def logp(x, y):
            return -0.5 * (x * x - 2 * rho * x * y + y * y) / (
                1 - rho * rho
            )

        r = integ.integrate_mcmc(
            [lambda x, y: x * y],
            logp,
            HMC(step_size=0.3, n_leapfrog=10, init_range=(-2.0, 2.0)),
            n_steps=3000,
            n_chains=512,
            n_burnin=300,
            seed=61,
        )
        assert abs(r.values[0] - rho) < 0.08

    def test_product_target_with_table_dim(self, integ):
        tri = Distribution.from_pdf(
            lambda x: 1.0 - abs(x) if abs(x) < 1 else 0.0
        )
        r = integ.integrate_mcmc(
            [lambda x, y: x + y, lambda x, y: y * y],
            [Distribution.normal(1.0, 1.0), tri],
            HMC(
                step_size=0.2, n_leapfrog=8, adapt=True,
                init_range=[(-1.0, 3.0), (-0.9, 0.9)],
            ),
            n_steps=3000,
            n_chains=512,
            n_burnin=500,
            seed=67,
        )
        assert abs(r.values[0] - 1.0) < 0.1
        assert abs(r.values[1] - 1.0 / 6.0) < 0.05

    def test_per_dimension_steps(self, integ):
        # Diagonal mass matrix: scales differ 10x across dimensions.
        r = integ.integrate_mcmc(
            [lambda x, y: x, lambda x, y: y * y],
            [Distribution.normal(0.0, 10.0), Distribution.normal(0.0, 1.0)],
            HMC(step_size=[2.0, 0.2], n_leapfrog=8),
            n_steps=2000,
            n_chains=512,
            n_burnin=300,
            seed=71,
        )
        assert abs(r.values[0]) < 1.0
        assert abs(r.values[1] - 1.0) < 0.15

    def test_joint_target_needs_init_range(self, integ):
        with pytest.raises(ValueError, match="init_range"):
            integ.integrate_mcmc(
                [lambda x, y: x],
                lambda x, y: -(x * x + y * y),
                HMC(step_size=0.3),
                n_steps=100,
                n_chains=256,
                n_burnin=10,
                seed=73,
            )

    def test_nd_diagnostics_and_samples(self, integ):
        # Trajectory length 0.9 * 8 = 7.2: NOT near a multiple of pi.
        # On a unit Gaussian a length-~pi trajectory is resonant (x maps
        # to ~-x each iteration, so radial statistics like x^2 + y^2
        # barely mix and r_hat flags it — measured 1.15 at 0.5 * 6 = 3.0);
        # the diagnostics exist precisely to catch that.
        def logp(x, y):
            return -0.5 * (x * x + y * y)

        r = integ.integrate_mcmc(
            [lambda x, y: x * x + y * y],
            logp,
            HMC(step_size=0.9, n_leapfrog=8, init_range=(-2.0, 2.0)),
            n_steps=1000,
            n_chains=512,
            n_burnin=200,
            seed=79,
            return_diagnostics=True,
            return_samples=20,
        )
        assert r.diagnostics["r_hat"][0] < 1.02
        assert r.samples.shape == (20, 512, 2)
        assert abs(r.values[0] - 2.0) < 0.1

    def test_nd_sharded(self, mesh8):
        integ = MonteCarloIntegrator(mesh=mesh8)

        def logp(x, y):
            return -0.5 * (x * x + y * y)

        r = integ.integrate_mcmc(
            [lambda x, y: x * y],
            logp,
            HMC(step_size=0.5, n_leapfrog=6, init_range=(-2.0, 2.0)),
            n_steps=1000,
            n_chains=1024,
            n_burnin=200,
            seed=83,
        )
        assert abs(r.values[0]) < 0.05


# ---------------------------------------------------------------------------
# Validation surface
# ---------------------------------------------------------------------------


class TestValidation:
    def test_n_leapfrog_must_be_positive(self):
        with pytest.raises(ValueError, match="n_leapfrog"):
            HMC(n_leapfrog=0)

    def test_step_size_must_be_positive(self):
        with pytest.raises(ValueError, match="step_size"):
            HMC(step_size=-0.5)

    def test_adapt_needs_burnin(self, integ):
        with pytest.raises(ValueError, match="HMC.*burn-in"):
            integ.integrate_mcmc(
                [lambda x: x],
                Distribution.normal(0.0, 1.0),
                HMC(adapt=True),
                n_steps=100,
                n_chains=256,
                n_burnin=0,
                seed=1,
            )

    def test_adapt_is_stateless_only(self, integ):
        with pytest.raises(ValueError, match="stateless-only"):
            integ.integrate_mcmc(
                [lambda x: x],
                Distribution.normal(0.0, 1.0),
                HMC(adapt=True),
                n_steps=100,
                n_chains=256,
                n_burnin=10,
                seed=1,
                return_state=True,
            )

    def test_repr(self):
        h = HMC(step_size=0.3, n_leapfrog=12, adapt=True)
        s = repr(h)
        assert "HMC" in s and "n_leapfrog=12" in s

    def test_pallas_table_target_rides_kernel(self):
        # In-kernel HMC on a CUSTOM table target: the position gradient
        # is the log-table interpolant's gathered slope
        # (mcmc_pallas._Chains.log_pdf_grad) — no fallback warning, and the
        # estimates match the XLA route's autodiff-of-interp statistics.
        import warnings

        tab = Distribution.from_pdf(
            lambda x: np.exp(-0.5 * x * x), support=(-6.0, 6.0)
        )
        integ = MonteCarloIntegrator(backend="pallas")
        kw = dict(n_steps=1200, n_chains=512, n_burnin=200, seed=1)
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            r = integ.integrate_mcmc(
                [lambda x: x, lambda x: x * x],
                tab,
                HMC(step_size=0.4, n_leapfrog=5),
                **kw,
            )
        assert not any("XLA" in str(x.message) for x in w)
        r_x = MonteCarloIntegrator(backend="xla").integrate_mcmc(
            [lambda x: x, lambda x: x * x],
            tab,
            HMC(step_size=0.4, n_leapfrog=5),
            **kw,
        )
        assert abs(r.values[0]) < 0.1
        assert abs(r.values[1] - 1.0) < 0.1
        assert abs(r.values[1] - r_x.values[1]) < 0.12
        assert 0.5 < r.acceptance_rate < 1.0

    def test_pallas_beta_table_target_adaptive(self):
        # Bounded table target + step adaptation: the steep floor-edge
        # slopes act as reflecting walls, keeping trajectories inside
        # the support at kernel speed.
        integ = MonteCarloIntegrator(backend="pallas")
        b = Distribution.beta(2.0, 5.0)
        r = integ.integrate_mcmc(
            [lambda x: x],
            b,
            HMC(step_size=0.1, n_leapfrog=6, adapt=True),
            n_steps=1500,
            n_chains=512,
            n_burnin=500,
            seed=3,
        )
        assert abs(r.values[0] - 2.0 / 7.0) < 0.03
