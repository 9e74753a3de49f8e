"""Thinned MCMC draws (``return_samples=m`` on integrate_mcmc): raw
post-burn-in chain states every ``n_steps // m`` sampling steps, at
user-bounded memory — raw chain output for downstream inference, a
surface the expectations-only reference lacks (its chains never leave
the device, src/shader_gen.rs:390-392).  Composes with stderr and
diagnostics; 1-D shape (m, n_chains), nd (m, n_chains, d).  Rides the
Pallas kernel on eligible workloads (draw rows stored from registers,
estimates bit-identical to the samples-free run); XLA otherwise.
"""

import numpy as np
import pytest

from tpu_montecarlo import (
    Distribution,
    MonteCarloIntegrator,
    RandomWalk,
    integrate_mcmc,
)


class TestSamples1D:
    def test_shape_dtype_and_distribution(self):
        """Draws from an N(3,2) target must look like N(3,2)."""
        r = integrate_mcmc(
            [lambda x: x], Distribution.normal(3.0, 2.0),
            Distribution.normal(3.0, 4.0),
            n_steps=1000, n_chains=512, n_burnin=200, seed=42,
            return_samples=50,
        )
        s = r.samples
        assert s.shape == (50, 512) and s.dtype == np.float32
        assert abs(s.mean() - 3.0) < 0.2
        assert abs(s.std() - 2.0) < 0.3

    def test_thinning_reduces_autocorrelation(self):
        """Consecutive thinned draws (stride = n_steps/m apart) must be
        far less correlated than consecutive chain steps: lag-1
        correlation of the thinned series stays small."""
        r = integrate_mcmc(
            [lambda x: x], Distribution.normal(0.0, 1.0),
            RandomWalk(step_size=2.4),
            n_steps=2000, n_chains=256, n_burnin=200, seed=7,
            return_samples=20,  # stride 100
        )
        s = r.samples  # (20, 256)
        a, b = s[:-1].ravel(), s[1:].ravel()
        corr = np.corrcoef(a, b)[0, 1]
        assert abs(corr) < 0.15

    def test_composes_with_stderr_and_diagnostics(self):
        r = integrate_mcmc(
            [lambda x: x * x], Distribution.normal(0.0, 1.0),
            Distribution.normal(0.0, 2.0),
            n_steps=1000, n_chains=512, n_burnin=100, seed=1,
            return_samples=10, return_stderr=True,
            return_diagnostics=True,
        )
        assert r.samples.shape == (10, 512)
        assert r.stderr is not None and r.stderr[0] > 0
        assert abs(float(r.diagnostics["r_hat"][0]) - 1.0) < 0.2
        assert abs(r.values[0] - 1.0) < 0.1

    def test_deterministic_per_seed(self):
        kw = dict(
            n_steps=300, n_chains=256, n_burnin=50, return_samples=5
        )
        a = integrate_mcmc(
            [lambda x: x], Distribution.normal(0.0, 1.0),
            Distribution.normal(0.0, 2.0), seed=3, **kw
        )
        b = integrate_mcmc(
            [lambda x: x], Distribution.normal(0.0, 1.0),
            Distribution.normal(0.0, 2.0), seed=3, **kw
        )
        np.testing.assert_array_equal(a.samples, b.samples)

    def test_values_unchanged_by_sampling(self):
        """Recording draws must not perturb the estimates: same seed
        with and without return_samples gives identical values."""
        kw = dict(n_steps=400, n_chains=256, n_burnin=50, seed=11)
        base = integrate_mcmc(
            [lambda x: x], Distribution.normal(1.0, 1.0),
            Distribution.normal(1.0, 2.0), **kw
        )
        with_s = integrate_mcmc(
            [lambda x: x], Distribution.normal(1.0, 1.0),
            Distribution.normal(1.0, 2.0), return_samples=8, **kw
        )
        np.testing.assert_array_equal(base.values, with_s.values)

    def test_mesh_sharded(self, mesh8):
        integ = MonteCarloIntegrator(mesh=mesh8)
        r = integ.integrate_mcmc(
            [lambda x: x], Distribution.normal(3.0, 2.0),
            Distribution.normal(3.0, 4.0),
            n_steps=500, n_chains=512, n_burnin=100, seed=5,
            return_samples=8,
        )
        assert r.samples.shape == (8, 512)
        assert abs(r.samples.mean() - 3.0) < 0.3


class TestSamplesNd:
    def test_joint_target_shape_and_correlation(self):
        """Correlated 2-D Gaussian target: the thinned cloud must show
        the target's negative cross-correlation."""
        rho, c = -0.5, 1.0 / (2.0 * (1.0 - 0.25))
        r = integrate_mcmc(
            [lambda x, y: x * y],
            lambda x, y: -c * (x * x - 2.0 * rho * x * y + y * y),
            RandomWalk(step_size=1.0, init_range=(-3.0, 3.0)),
            n_steps=2000, n_chains=512, n_burnin=500, seed=2,
            return_samples=25,
        )
        s = r.samples
        assert s.shape == (25, 512, 2)
        xs, ys = s[..., 0].ravel(), s[..., 1].ravel()
        emp = np.corrcoef(xs, ys)[0, 1]
        assert abs(emp - rho) < 0.1

    def test_pallas_joint_target_kernel_draws(self):
        """nd draws ride the Pallas kernel: bit-equal estimates vs the
        samples-free kernel, and the thinned cloud shows the joint
        target's cross-correlation."""
        rho, c = -0.5, 1.0 / (2.0 * (1.0 - 0.25))
        integ = MonteCarloIntegrator(backend="pallas")

        def logp(x, y):
            return -c * (x * x - 2.0 * rho * x * y + y * y)

        kw = dict(n_steps=800, n_chains=512, n_burnin=300, seed=2)
        base = integ.integrate_mcmc(
            [lambda x, y: x * y], logp,
            RandomWalk(step_size=1.0, init_range=(-3.0, 3.0)), **kw
        )
        r = integ.integrate_mcmc(
            [lambda x, y: x * y], logp,
            RandomWalk(step_size=1.0, init_range=(-3.0, 3.0)),
            return_samples=20, **kw
        )
        np.testing.assert_array_equal(base.values, r.values)
        s = r.samples
        assert s.ndim == 3 and s.shape[0] == 20 and s.shape[2] == 2
        emp = np.corrcoef(s[..., 0].ravel(), s[..., 1].ravel())[0, 1]
        assert abs(emp - rho) < 0.12

    def test_pallas_product_target_with_stderr(self):
        integ = MonteCarloIntegrator(backend="pallas")
        r = integ.integrate_mcmc(
            [lambda x, y: x + y],
            [Distribution.normal(1.0, 1.0),
             Distribution.normal(-1.0, 0.5)],
            [Distribution.normal(1.0, 2.0),
             Distribution.normal(-1.0, 1.0)],
            n_steps=400, n_chains=512, n_burnin=100, seed=3,
            return_samples=12, return_stderr=True,
        )
        s = r.samples
        assert s.shape[0] == 12 and s.shape[2] == 2
        assert r.stderr is not None and r.stderr[0] > 0
        assert abs(s[..., 0].mean() - 1.0) < 0.2
        assert abs(s[..., 1].mean() + 1.0) < 0.15

    def test_pallas_nd_mesh_sharded_draws(self, mesh8):
        integ = MonteCarloIntegrator(backend="pallas", mesh=mesh8)
        r = integ.integrate_mcmc(
            [lambda x, y: x + y],
            [Distribution.normal(1.0, 1.0),
             Distribution.normal(-1.0, 0.5)],
            [Distribution.normal(1.0, 2.0),
             Distribution.normal(-1.0, 1.0)],
            n_steps=300, n_chains=1024, n_burnin=50, seed=7,
            return_samples=4,
        )
        s = r.samples
        assert s.shape[0] == 4 and s.shape[2] == 2
        assert abs(s[..., 0].mean() - 1.0) < 0.25

    def test_product_target(self):
        r = integrate_mcmc(
            [lambda x, y: x + y],
            [Distribution.normal(1.0, 1.0), Distribution.normal(-1.0, 0.5)],
            [Distribution.normal(1.0, 2.0), Distribution.normal(-1.0, 1.0)],
            n_steps=800, n_chains=512, n_burnin=200, seed=4,
            return_samples=25, return_stderr=True,
        )
        s = r.samples
        assert s.shape == (25, 512, 2)
        assert abs(s[..., 0].mean() - 1.0) < 0.15
        assert abs(s[..., 1].mean() + 1.0) < 0.1


class TestCompiledDraws:
    """``compile_mcmc(return_samples=m)`` — the serving handle returns
    the thinned draws LAST; composes with seed/param batches (round 5:
    the kernel's draw row offset carries the grid-rep index), untempered
    handles only."""

    def test_handle_matches_integrate_mcmc(self):
        integ = MonteCarloIntegrator()
        kw = dict(n_steps=400, n_chains=512, n_burnin=100)
        prog = integ.compile_mcmc(
            [lambda x: x], Distribution.normal(1.0, 1.0),
            Distribution.normal(1.0, 2.0), return_samples=10, **kw
        )
        vals, acc, samp = prog(7)
        ref = integ.integrate_mcmc(
            [lambda x: x], Distribution.normal(1.0, 1.0),
            Distribution.normal(1.0, 2.0), seed=7,
            return_samples=10, **kw
        )
        np.testing.assert_array_equal(np.asarray(samp), ref.samples)
        np.testing.assert_allclose(
            np.asarray(vals), ref.values, rtol=1e-6
        )

    def test_tempered_rejected(self):
        integ = MonteCarloIntegrator()
        args = (
            [lambda x: x], Distribution.normal(0.0, 1.0),
            Distribution.normal(0.0, 2.0),
        )
        kw = dict(n_steps=100, n_chains=256, n_burnin=10)
        with pytest.raises(ValueError, match="untempered"):
            integ.compile_mcmc(
                *args, return_samples=4,
                temperatures=[1.0, 2.0], **kw
            )

    def test_seed_batched_draws_bit_equal_per_rep(self):
        # Each batch rep streams its own (m, chains) draw slab, equal
        # bit-for-bit to the unbatched handle at that seed.
        import warnings as _w

        integ = MonteCarloIntegrator(backend="pallas")
        args = (
            [lambda x: x], Distribution.normal(0.0, 1.0),
            Distribution.normal(0.0, 2.0),
        )
        kw = dict(n_steps=200, n_chains=512, n_burnin=20)
        with _w.catch_warnings():
            _w.simplefilter("error")
            prog = integ.compile_mcmc(
                *args, return_samples=5, seed_batch=3, **kw
            )
            vb, ab, sb = prog(np.arange(3, dtype=np.uint32) + 40)
            prog1 = integ.compile_mcmc(*args, return_samples=5, **kw)
            v1, a1, s1 = prog1(41)
        assert np.asarray(sb).shape == (3, 5, 512)
        np.testing.assert_array_equal(np.asarray(sb)[1], np.asarray(s1))

    def test_param_batched_draws_follow_their_targets(self):
        from tpu_montecarlo import pack_param_batch

        integ = MonteCarloIntegrator(backend="pallas")
        means = (0.0, 2.0, -1.0)
        tp = pack_param_batch(
            [Distribution.normal(m, 1.0) for m in means]
        )
        pp = pack_param_batch([Distribution.normal(0.0, 3.0)] * 3)
        prog = integ.compile_mcmc(
            [lambda x: x], Distribution.normal(0.0, 1.0),
            Distribution.normal(0.0, 3.0),
            n_steps=400, n_chains=512, n_burnin=50,
            seed_batch=3, param_batch=True, return_samples=8,
        )
        v, a, s = prog(np.arange(3, dtype=np.uint32), tp, pp)
        s = np.asarray(s)
        assert s.shape == (3, 8, 512)
        for i, m in enumerate(means):
            assert abs(s[i].mean() - m) < 0.2

    def test_nd_seed_batched_handle_draws(self):
        integ = MonteCarloIntegrator(backend="pallas")
        n01 = Distribution.normal(0.0, 1.0)
        prop = Distribution.normal(0.0, 2.0)
        prog = integ.compile_mcmc(
            [lambda x, y: x + y], [n01, n01], [prop, prop],
            n_steps=200, n_chains=512, n_burnin=20,
            seed_batch=2, return_samples=4,
        )
        v, a, s = prog(np.arange(2, dtype=np.uint32) + 7)
        assert np.asarray(s).shape == (2, 4, 512, 2)
        assert abs(np.asarray(s).mean()) < 0.1


class TestValidation:
    def test_rejects_more_than_n_steps(self):
        with pytest.raises(ValueError, match="return_samples"):
            integrate_mcmc(
                [lambda x: x], Distribution.normal(0.0, 1.0),
                Distribution.normal(0.0, 2.0),
                n_steps=100, n_chains=256, n_burnin=10,
                return_samples=200,
            )

    def test_rejects_stateful(self):
        with pytest.raises(ValueError, match="stateless"):
            integrate_mcmc(
                [lambda x: x], Distribution.normal(0.0, 1.0),
                Distribution.normal(0.0, 2.0),
                n_steps=100, n_chains=256, n_burnin=10,
                return_samples=10, return_state=True,
            )

    def test_pallas_backend_rides_kernel(self):
        """Raw draws ride the Pallas kernel (round 4): no reroute
        warning, the samples carry the kernel's rounded-up chain count
        (plan_mcmc_grid), and the estimates are BIT-equal to the
        samples-free kernel run (the stored draw rows never
        touch the RNG or the accumulators)."""
        import warnings

        integ = MonteCarloIntegrator(backend="pallas")
        kw = dict(n_steps=200, n_chains=256, n_burnin=20, seed=9)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            r = integ.integrate_mcmc(
                [lambda x: x], Distribution.normal(0.0, 1.0),
                Distribution.normal(0.0, 2.0),
                return_samples=4, **kw
            )
        base = integ.integrate_mcmc(
            [lambda x: x], Distribution.normal(0.0, 1.0),
            Distribution.normal(0.0, 2.0), **kw
        )
        from tpu_montecarlo.ops.mcmc_pallas import plan_mcmc_grid

        _, _, chains_actual = plan_mcmc_grid(256)
        assert r.samples.shape == (4, chains_actual)
        np.testing.assert_array_equal(r.samples, r.samples)  # finite
        np.testing.assert_array_equal(base.values, r.values)
        assert abs(r.samples.mean()) < 0.3

    def test_pallas_composes_with_stderr_and_diagnostics(self):
        integ = MonteCarloIntegrator(backend="pallas")
        r = integ.integrate_mcmc(
            [lambda x: x * x], Distribution.normal(0.0, 1.0),
            Distribution.normal(0.0, 2.0),
            n_steps=400, n_chains=512, n_burnin=50, seed=2,
            return_samples=8, return_stderr=True,
            return_diagnostics=True,
        )
        assert r.samples.shape[0] == 8
        assert r.stderr is not None and r.stderr[0] > 0
        assert abs(float(r.diagnostics["r_hat"][0]) - 1.0) < 0.2
        assert abs(r.values[0] - 1.0) < 0.1

    def test_pallas_random_walk_adaptive_draws(self):
        integ = MonteCarloIntegrator(backend="pallas")
        r = integ.integrate_mcmc(
            [lambda x: x], Distribution.normal(2.0, 1.0),
            RandomWalk(step_size=1.0, adapt=True,
                       init_range=(-2.0, 6.0)),
            n_steps=500, n_chains=512, n_burnin=200, seed=6,
            return_samples=10,
        )
        s = r.samples
        assert s.shape[0] == 10
        assert abs(s.mean() - 2.0) < 0.2
        assert abs(s.std() - 1.0) < 0.2

    def test_pallas_mesh_sharded_draws(self, mesh8):
        integ = MonteCarloIntegrator(backend="pallas", mesh=mesh8)
        r = integ.integrate_mcmc(
            [lambda x: x], Distribution.normal(3.0, 2.0),
            Distribution.normal(3.0, 4.0),
            n_steps=300, n_chains=1024, n_burnin=50, seed=5,
            return_samples=6,
        )
        assert r.samples.shape[0] == 6
        assert abs(r.samples.mean() - 3.0) < 0.3
