"""Chain-state checkpoint/resume — a capability addition over the
stateless one-shot reference (SURVEY.md §5: chain state never left GPU
registers there)."""

import numpy as np
import pytest

from tpu_montecarlo import Distribution, McmcState


class TestResume:
    def test_state_returned(self, integrator):
        d = Distribution.normal(0.0, 1.0)
        q = Distribution.normal(0.0, 2.0)
        r = integrator.integrate_mcmc(
            [lambda x: x], d, q,
            n_steps=200, n_chains=256, n_burnin=50, return_state=True,
        )
        assert isinstance(r.chain_state, McmcState)
        assert r.chain_state.n_chains == 256
        assert np.all(np.isfinite(r.chain_state.x))
        assert np.all(np.isfinite(r.chain_state.log_p))

    def test_state_not_returned_by_default(self, integrator):
        d = Distribution.normal(0.0, 1.0)
        q = Distribution.normal(0.0, 2.0)
        r = integrator.integrate_mcmc(
            [lambda x: x], d, q, n_steps=100, n_chains=256, n_burnin=10
        )
        assert r.chain_state is None

    def test_resume_continues_chains(self, integrator):
        d = Distribution.normal(0.0, 1.0)
        q = Distribution.normal(0.0, 2.0)
        r1 = integrator.integrate_mcmc(
            [lambda x: x, lambda x: x * x], d, q,
            n_steps=500, n_chains=512, n_burnin=200, return_state=True,
        )
        # Resumed run: no burn-in needed, chains already converged.
        r2 = integrator.integrate_mcmc(
            [lambda x: x, lambda x: x * x], d, q,
            n_steps=500, n_chains=512, n_burnin=0,
            initial_state=r1.chain_state, return_state=True, seed=43,
        )
        assert abs(r2.values[0]) < 0.15
        assert abs(r2.values[1] - 1.0) < 0.25
        # Chains actually moved.
        assert not np.array_equal(r1.chain_state.x, r2.chain_state.x)

    def test_resumed_estimate_uses_given_state(self, integrator):
        """Pin all chains far in the tail with a near-zero-acceptance setup:
        the resumed estimate must reflect the pinned state."""
        d = Distribution.normal(0.0, 1.0)
        q = Distribution.normal(0.0, 1.0)
        pinned = McmcState(
            x=np.full(256, 5.0, np.float32),
            # Lie about log_p: claim the pinned position is vastly more
            # probable than anywhere else so every proposal is rejected.
            log_p=np.full(256, 1e6, np.float32),
        )
        r = integrator.integrate_mcmc(
            [lambda x: x], d, q,
            n_steps=50, n_chains=256, n_burnin=0,
            initial_state=pinned,
        )
        assert r.values[0] == pytest.approx(5.0, abs=1e-4)
        assert r.acceptance_rate == 0.0

    def test_chain_count_mismatch_rejected(self, integrator):
        d = Distribution.normal(0.0, 1.0)
        q = Distribution.normal(0.0, 2.0)
        bad = McmcState(np.zeros(100, np.float32), np.zeros(100, np.float32))
        with pytest.raises(ValueError, match="chains"):
            integrator.integrate_mcmc(
                [lambda x: x], d, q,
                n_steps=10, n_chains=256, initial_state=bad,
            )

class TestResumePallas:
    """The Pallas kernel surfaces chain state too (VERDICT r1 #4): forced
    backend='pallas' exercises it through the interpreter on CPU."""

    @pytest.fixture()
    def pallas_integrator(self):
        from tpu_montecarlo import MonteCarloIntegrator

        return MonteCarloIntegrator(backend="pallas")

    def test_state_routes_pallas(self, pallas_integrator):
        from tpu_montecarlo.ops.mcmc_pallas import plan_state_chains

        d = Distribution.normal(0.0, 1.0)
        q = Distribution.normal(0.0, 2.0)
        r = pallas_integrator.integrate_mcmc(
            [lambda x: x], d, q,
            n_steps=150, n_chains=256, n_burnin=50, return_state=True,
        )
        # The Pallas planner's chain round-up, not the XLA one.
        assert r.chain_state.n_chains == plan_state_chains(256)
        assert np.all(np.isfinite(r.chain_state.x))
        assert np.all(np.isfinite(r.chain_state.log_p))

    def test_fresh_stateful_reproduces_stateless(self, pallas_integrator):
        d = Distribution.normal(0.0, 1.0)
        q = Distribution.normal(0.0, 2.0)
        kw = dict(n_steps=150, n_chains=256, n_burnin=50, seed=9)
        r_stateless = pallas_integrator.integrate_mcmc(
            [lambda x: x, lambda x: x * x], d, q, **kw
        )
        r_stateful = pallas_integrator.integrate_mcmc(
            [lambda x: x, lambda x: x * x], d, q, return_state=True, **kw
        )
        np.testing.assert_array_equal(r_stateless.values, r_stateful.values)

    def test_resume_continues_chains(self, pallas_integrator):
        d = Distribution.normal(0.0, 1.0)
        q = Distribution.normal(0.0, 2.0)
        r1 = pallas_integrator.integrate_mcmc(
            [lambda x: x, lambda x: x * x], d, q,
            n_steps=300, n_chains=512, n_burnin=150, return_state=True,
        )
        r2 = pallas_integrator.integrate_mcmc(
            [lambda x: x, lambda x: x * x], d, q,
            n_steps=300, n_chains=512, n_burnin=0,
            initial_state=r1.chain_state, return_state=True, seed=43,
        )
        assert abs(r2.values[0]) < 0.15
        assert abs(r2.values[1] - 1.0) < 0.25
        assert not np.array_equal(r1.chain_state.x, r2.chain_state.x)

    def test_resume_draws_fresh_streams(self, pallas_integrator):
        """A same-seed continuation must not replay the first segment's
        proposals (the segment counter is mixed into the seed word)."""
        d = Distribution.normal(0.0, 1.0)
        q = Distribution.normal(0.0, 2.0)
        r1 = pallas_integrator.integrate_mcmc(
            [lambda x: x], d, q,
            n_steps=100, n_chains=256, n_burnin=0,
            return_state=True, seed=21,
        )
        r2 = pallas_integrator.integrate_mcmc(
            [lambda x: x], d, q,
            n_steps=100, n_chains=256, n_burnin=0,
            initial_state=r1.chain_state, return_state=True, seed=21,
        )
        assert r1.values[0] != r2.values[0]

    def test_resumed_estimate_uses_given_state(self, pallas_integrator):
        from tpu_montecarlo.ops.mcmc_pallas import plan_state_chains

        n = plan_state_chains(256)
        d = Distribution.normal(0.0, 1.0)
        q = Distribution.normal(0.0, 1.0)
        pinned = McmcState(
            x=np.full(n, 5.0, np.float32),
            log_p=np.full(n, 1e6, np.float32),
        )
        r = pallas_integrator.integrate_mcmc(
            [lambda x: x], d, q,
            n_steps=50, n_chains=256, n_burnin=0,
            initial_state=pinned,
        )
        assert r.values[0] == pytest.approx(5.0, abs=1e-4)
        assert r.acceptance_rate == 0.0

    def test_xla_minted_state_reroutes_to_xla(self, pallas_integrator):
        """A resume state minted by the XLA backend resumes under
        backend='pallas' without error: the kernel's chain plan now
        carries exactly the XLA plan's count (256-chain multiples split
        into power-of-two tiles), so the state rides the kernel."""
        from tpu_montecarlo import MonteCarloIntegrator
        from tpu_montecarlo.ops.mcmc_pallas import plan_state_chains

        assert plan_state_chains(256) == 256
        d = Distribution.normal(0.0, 1.0)
        q = Distribution.normal(0.0, 2.0)
        r1 = MonteCarloIntegrator(backend="xla").integrate_mcmc(
            [lambda x: x], d, q,
            n_steps=100, n_chains=256, n_burnin=20, return_state=True,
        )
        assert r1.chain_state.n_chains == 256
        r2 = pallas_integrator.integrate_mcmc(
            [lambda x: x], d, q,
            n_steps=100, n_chains=256, n_burnin=0,
            initial_state=r1.chain_state, return_state=True, seed=43,
        )
        assert r2.chain_state.n_chains == 256
        assert abs(r2.values[0]) < 0.25

    def test_custom_target_resume(self, pallas_integrator):
        """Stateful Pallas path with a table target (log-pdf lookups)."""
        beta = Distribution.beta(2.0, 5.0)
        q = Distribution.uniform(0.0, 1.0)
        r1 = pallas_integrator.integrate_mcmc(
            [lambda x: x], beta, q,
            n_steps=300, n_chains=512, n_burnin=150, return_state=True,
        )
        r2 = pallas_integrator.integrate_mcmc(
            [lambda x: x], beta, q,
            n_steps=300, n_chains=512, n_burnin=0,
            initial_state=r1.chain_state, seed=43,
        )
        assert abs(r1.values[0] - 2.0 / 7.0) < 0.05
        assert abs(r2.values[0] - 2.0 / 7.0) < 0.05

    def test_resume_on_mesh_pallas(self, mesh8):
        from tpu_montecarlo import MonteCarloIntegrator
        from tpu_montecarlo.ops.mcmc_pallas import plan_state_chains

        integ = MonteCarloIntegrator(backend="pallas", mesh=mesh8)
        d = Distribution.normal(0.0, 1.0)
        q = Distribution.normal(0.0, 2.0)
        r1 = integ.integrate_mcmc(
            [lambda x: x], d, q,
            n_steps=150, n_chains=512, n_burnin=50, return_state=True,
        )
        assert r1.chain_state.n_chains == plan_state_chains(512, 8)
        r2 = integ.integrate_mcmc(
            [lambda x: x], d, q,
            n_steps=150, n_chains=512, n_burnin=0,
            initial_state=r1.chain_state, seed=44,
        )
        assert abs(r2.values[0]) < 0.2


class TestResumeMesh:
    def test_resume_on_mesh(self, mesh8):
        from tpu_montecarlo import MonteCarloIntegrator

        integ = MonteCarloIntegrator(mesh=mesh8)
        d = Distribution.normal(0.0, 1.0)
        q = Distribution.normal(0.0, 2.0)
        r1 = integ.integrate_mcmc(
            [lambda x: x], d, q,
            n_steps=200, n_chains=512, n_burnin=50, return_state=True,
        )
        assert r1.chain_state.n_chains == 512
        r2 = integ.integrate_mcmc(
            [lambda x: x], d, q,
            n_steps=200, n_chains=512, n_burnin=0,
            initial_state=r1.chain_state, seed=44,
        )
        assert abs(r2.values[0]) < 0.2
