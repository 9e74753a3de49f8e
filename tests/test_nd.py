"""Multi-dimensional integration (capability extension beyond the 1-D-only
reference, whose device layer binds exactly one distribution per program —
src/engine.rs:250-264).  E[f(X_1..X_d)] over independent per-dimension
distributions: moments, indicator geometry, mixed families (incl. a
table-sampled dim), WGSL d-ary functions, error bars, Sobol QMC, nd
importance sampling, and mesh sharding."""

import math

import numpy as np
import pytest

import jax

import tpu_montecarlo as mc
from tpu_montecarlo import Distribution


@pytest.fixture(scope="module")
def integrator():
    return mc.MonteCarloIntegrator()


class TestIntegrateNd:
    def test_product_moments_independent_normals(self, integrator):
        nx = Distribution.normal(0.0, 1.0)
        ny = Distribution.normal(2.0, 3.0)
        r = integrator.integrate(
            [lambda x, y: x * y, lambda x, y: x * x * y],
            [nx, ny], n_samples=2_000_000, seed=42,
        )
        assert abs(r.values[0]) < 0.02
        assert abs(r.values[1] - 2.0) < 0.04

    def test_quarter_disc_indicator(self, integrator):
        u = Distribution.uniform(0.0, 1.0)
        r = integrator.integrate(
            [lambda x, y: (x * x + y * y) < 1.0], [u, u],
            n_samples=2_000_000, seed=1,
        )
        assert abs(r.values[0] - math.pi / 4) < 0.003

    def test_mixed_families_with_table_dim(self, integrator):
        u = Distribution.uniform(0.0, 1.0)
        ex = Distribution.exponential(2.0)
        b = Distribution.beta(2.0, 5.0)  # table-sampled
        r = integrator.integrate(
            [lambda x, y, z: x * y * z], [u, ex, b],
            n_samples=2_000_000, seed=7,
        )
        expect = 0.5 * 0.5 * (2.0 / 7.0)
        assert abs(r.values[0] - expect) < 0.005

    def test_wgsl_two_argument_function(self, integrator):
        n = Distribution.normal(0.0, 1.0)
        src = "fn f(x: f32, y: f32) -> f32 { return x * x + y * y; }"
        r = integrator.integrate([src], [n, n], n_samples=1_000_000, seed=3)
        assert abs(r.values[0] - 2.0) < 0.03

    def test_single_element_sequence_is_scalar_path(self, integrator):
        n = Distribution.normal(0.0, 1.0)
        r1 = integrator.integrate([lambda x: x * x], n,
                                  n_samples=100_000, seed=9)
        r2 = integrator.integrate([lambda x: x * x], [n],
                                  n_samples=100_000, seed=9)
        assert r1.values[0] == r2.values[0]

    def test_seed_reproducibility(self, integrator):
        n = Distribution.normal(0.0, 1.0)
        u = Distribution.uniform(0.0, 1.0)
        a = integrator.integrate([lambda x, y: x * y], [n, u],
                                 n_samples=200_000, seed=5)
        b = integrator.integrate([lambda x, y: x * y], [n, u],
                                 n_samples=200_000, seed=5)
        c = integrator.integrate([lambda x, y: x * y], [n, u],
                                 n_samples=200_000, seed=6)
        assert a.values[0] == b.values[0]
        assert a.values[0] != c.values[0]

    def test_arity_mismatch_raises(self, integrator):
        n = Distribution.normal(0.0, 1.0)
        with pytest.raises(Exception):
            integrator.integrate([lambda x: x], [n, n], n_samples=1000)
        with pytest.raises(ValueError):
            integrator.integrate(
                ["fn f(x: f32) -> f32 { return x; }"], [n, n],
                n_samples=1000,
            )

    def test_invalid_sequence_elements_raise(self, integrator):
        n = Distribution.normal(0.0, 1.0)
        with pytest.raises(TypeError):
            integrator.integrate([lambda x, y: x], [n, 3.0], n_samples=1000)
        with pytest.raises(TypeError):
            integrator.integrate([lambda x: x], [], n_samples=1000)


class TestNdStderr:
    def test_stderr_scale_and_zero_variance(self, integrator):
        n = Distribution.normal(0.0, 1.0)
        r = integrator.integrate(
            [lambda x, y: x + y, lambda x, y: 1.0 + 0.0 * x],
            [n, n], n_samples=1_000_000, seed=4, return_stderr=True,
        )
        # Var[X+Y] = 2 -> stderr = sqrt(2/N); constants have zero bars.
        assert abs(r.stderr[0] - math.sqrt(2 / 1e6)) < 3e-4
        assert r.stderr[1] < 1e-6
        assert abs(r.values[0]) < 6 * max(r.stderr[0], 1e-9)


class TestNdQmc:
    def test_sobol_beats_mc_on_smooth_integrand(self, integrator):
        u = Distribution.uniform(0.0, 1.0)
        f = lambda x, y: np.exp(x) * np.exp(y)  # noqa: E731
        exact = (math.e - 1.0) ** 2
        rq = integrator.integrate([f], [u, u], n_samples=1_000_000,
                                  seed=5, method="qmc")
        rm = integrator.integrate([f], [u, u], n_samples=1_000_000, seed=5)
        eq = abs(rq.values[0] - exact)
        em = abs(rm.values[0] - exact)
        assert eq < em / 3 or eq < 1e-5

    def test_rqmc_stderr_covers_error(self, integrator):
        u = Distribution.uniform(0.0, 1.0)
        f = lambda x, y: np.exp(x) * np.exp(y)  # noqa: E731
        exact = (math.e - 1.0) ** 2
        r = integrator.integrate([f], [u, u], n_samples=1_000_000,
                                 seed=5, method="qmc", return_stderr=True)
        assert abs(r.values[0] - exact) <= 6 * max(r.stderr[0], 1e-9)

    def test_qmc_normal_dims(self, integrator):
        n = Distribution.normal(0.0, 1.0)
        r = integrator.integrate(
            [lambda x, y: x * y, lambda x, y: x * x * y * y],
            [n, n], n_samples=1_000_000, seed=11, method="qmc",
        )
        assert abs(r.values[0]) < 1e-3
        assert abs(r.values[1] - 1.0) < 1e-2

    def test_qmc_dimension_cap(self, integrator):
        from tpu_montecarlo.ops.qmc import SOBOL_MAX_DIMS

        u = Distribution.uniform(0.0, 1.0)
        dists = [u] * (SOBOL_MAX_DIMS + 1)

        def f(*xs):
            return xs[0]

        with pytest.raises(ValueError):
            integrator.integrate([f], dists, n_samples=1000, method="qmc")


class TestSobolPoints:
    def test_dim0_is_radical_inverse(self):
        import jax.numpy as jnp
        from tpu_montecarlo.ops.qmc import (
            bitrev32, sobol_bits, sobol_direction_numbers)

        idx = jnp.arange(4096, dtype=jnp.uint32)
        v0 = sobol_direction_numbers(0)
        assert np.array_equal(
            np.asarray(sobol_bits(idx, v0)), np.asarray(bitrev32(idx))
        )

    def test_dyadic_equidistribution_every_dim(self):
        import jax.numpy as jnp
        from tpu_montecarlo.ops.qmc import (
            SOBOL_MAX_DIMS, sobol_bits, sobol_direction_numbers)

        n = 1 << 12
        idx = jnp.arange(n, dtype=jnp.uint32)
        for dim in range(SOBOL_MAX_DIMS):
            bits = np.asarray(sobol_bits(idx, sobol_direction_numbers(dim)))
            for b in (1, 4, 8, 12):
                counts = np.bincount(bits >> (32 - b), minlength=1 << b)
                assert counts.min() == counts.max() == n >> b, (dim, b)

    def test_pairwise_cells_balanced(self):
        import jax.numpy as jnp
        from tpu_montecarlo.ops.qmc import (
            SOBOL_MAX_DIMS, sobol_bits, sobol_direction_numbers)

        n = 1 << 12
        idx = jnp.arange(n, dtype=jnp.uint32)
        cols = [
            np.asarray(sobol_bits(idx, sobol_direction_numbers(d))) >> 29
            for d in range(SOBOL_MAX_DIMS)
        ]
        for d1 in range(SOBOL_MAX_DIMS):
            for d2 in range(d1 + 1, SOBOL_MAX_DIMS):
                counts = np.bincount(cols[d1] * 8 + cols[d2], minlength=64)
                # true Sobol pairs are exactly balanced on this 8x8 grid
                assert counts.min() == counts.max() == n // 64, (d1, d2)


class TestImportanceSamplingNd:
    def test_corner_tail_event(self, integrator):
        n = Distribution.normal(0.0, 1.0)
        prop = Distribution.normal(3.5, 1.0)
        p_tail = (0.5 * math.erfc(3 / math.sqrt(2))) ** 2
        r = integrator.integrate_importance_sampling(
            [lambda x, y: ((x > 3.0) & (y > 3.0)) * 1.0],
            [n, n], [prop, prop], n_samples=4_000_000, seed=6,
        )
        assert abs(r.values[0] - p_tail) < 0.3 * p_tail

    def test_p_equals_q_recovers_plain_expectation(self, integrator):
        n = Distribution.normal(0.0, 1.0)
        r = integrator.integrate_importance_sampling(
            [lambda x, y: x * x + y * y], [n, n], [n, n],
            n_samples=1_000_000, seed=2,
        )
        assert abs(r.values[0] - 2.0) < 0.03

    def test_table_pdf_dim_routes_and_integrates(self, integrator):
        # One dim with a table-backed (untraceable closed-form) pdf.
        b = Distribution.beta(2.0, 2.0)
        u = Distribution.uniform(0.0, 1.0)
        r = integrator.integrate_importance_sampling(
            [lambda x, y: x * y], [b, u], [u, u],
            n_samples=2_000_000, seed=8,
        )
        assert abs(r.values[0] - 0.25) < 0.01

    def test_mismatched_sequences_raise(self, integrator):
        n = Distribution.normal(0.0, 1.0)
        with pytest.raises(TypeError):
            integrator.integrate_importance_sampling(
                [lambda x, y: x], [n, n], n, n_samples=1000,
            )
        with pytest.raises(TypeError):
            integrator.integrate_importance_sampling(
                [lambda x, y: x], [n, n], [n], n_samples=1000,
            )

    def test_stderr_nd_is(self, integrator):
        n = Distribution.normal(0.0, 1.0)
        r = integrator.integrate_importance_sampling(
            [lambda x, y: x + y], [n, n], [n, n],
            n_samples=1_000_000, seed=3, return_stderr=True,
        )
        assert abs(r.values[0]) <= 6 * max(r.stderr[0], 1e-9)
        assert abs(r.stderr[0] - math.sqrt(2 / 1e6)) < 3e-4


class TestMcmcNd:
    def test_product_target_moments(self, integrator):
        n01 = Distribution.normal(0.0, 1.0)
        prop = Distribution.normal(0.0, 2.0)
        r = integrator.integrate_mcmc(
            [lambda x, y: x * x + y * y, lambda x, y: x * y],
            [n01, n01], [prop, prop],
            n_steps=2000, n_chains=1024, n_burnin=200, seed=42,
        )
        assert abs(r.values[0] - 2.0) < 0.1
        assert abs(r.values[1]) < 0.05
        assert 0.2 < r.acceptance_rate < 0.7

    def test_joint_correlated_gaussian_target(self, integrator):
        # The capability the 1-D reference cannot express: an arbitrary
        # JOINT log-density.  rho = 0.8 bivariate normal: E[XY] = 0.8.
        rho = 0.8
        c = 1.0 / (2 * (1 - rho * rho))

        def logp(x, y):
            return -c * (x * x - 2 * rho * x * y + y * y)

        prop = Distribution.normal(0.0, 2.0)
        r = integrator.integrate_mcmc(
            [lambda x, y: x * y, lambda x, y: x * x],
            logp, [prop, prop],
            n_steps=4000, n_chains=2048, n_burnin=500, seed=1,
        )
        assert abs(r.values[0] - rho) < 0.05
        assert abs(r.values[1] - 1.0) < 0.06

    def test_wgsl_joint_target(self, integrator):
        src = "fn lp(x: f32, y: f32) -> f32 { return -0.5 * (x*x + y*y); }"
        prop = Distribution.normal(0.0, 2.0)
        r = integrator.integrate_mcmc(
            [lambda x, y: x * x + y * y], src, [prop, prop],
            n_steps=1500, n_chains=1024, n_burnin=200, seed=5,
        )
        assert abs(r.values[0] - 2.0) < 0.1

    def test_1d_callable_log_density_target(self, integrator):
        # d = 1 with a custom log-density: same machinery, scalar state.
        prop = Distribution.normal(0.0, 2.0)
        r = integrator.integrate_mcmc(
            [lambda x: x * x], lambda x: -0.5 * x * x, prop,
            n_steps=2000, n_chains=1024, n_burnin=200, seed=7,
        )
        assert abs(r.values[0] - 1.0) < 0.06

    def test_single_element_sequences_take_scalar_path(self, integrator):
        n01 = Distribution.normal(0.0, 1.0)
        prop = Distribution.normal(0.0, 2.0)
        r1 = integrator.integrate_mcmc(
            [lambda x: x * x], n01, prop,
            n_steps=500, n_chains=512, n_burnin=100, seed=9,
        )
        r2 = integrator.integrate_mcmc(
            [lambda x: x * x], [n01], [prop],
            n_steps=500, n_chains=512, n_burnin=100, seed=9,
        )
        assert r1.values[0] == r2.values[0]

    def test_table_dims_in_target_and_proposal(self, integrator):
        b = Distribution.beta(2.0, 5.0)
        n01 = Distribution.normal(0.0, 1.0)
        u = Distribution.uniform(0.0, 1.0)
        prop = Distribution.normal(0.0, 2.0)
        r = integrator.integrate_mcmc(
            [lambda x, y: x * y], [b, n01], [u, prop],
            n_steps=3000, n_chains=1024, n_burnin=300, seed=11,
        )
        assert abs(r.values[0]) < 0.03

    def test_stderr_between_chain(self, integrator):
        n01 = Distribution.normal(0.0, 1.0)
        prop = Distribution.normal(0.0, 2.0)
        r = integrator.integrate_mcmc(
            [lambda x, y: x + y], [n01, n01], [prop, prop],
            n_steps=1000, n_chains=1024, n_burnin=100, seed=3,
            return_stderr=True,
        )
        assert r.stderr is not None
        assert abs(r.values[0]) <= 6 * max(r.stderr[0], 1e-9)

    def test_mesh_statistics(self):
        n01 = Distribution.normal(0.0, 1.0)
        prop = Distribution.normal(0.0, 2.0)
        meshed = mc.MonteCarloIntegrator(mesh="auto")
        r = meshed.integrate_mcmc(
            [lambda x, y: x * x + y * y], [n01, n01], [prop, prop],
            n_steps=1000, n_chains=2048, n_burnin=100, seed=13,
            return_stderr=True,
        )
        assert abs(r.values[0] - 2.0) <= max(8 * r.stderr[0], 0.1)

    def test_unsupported_features_raise(self, integrator):
        n01 = Distribution.normal(0.0, 1.0)
        prop = Distribution.normal(0.0, 2.0)
        with pytest.raises(TypeError):
            integrator.integrate_mcmc(
                [lambda x, y: x], n01, [prop, prop],
                n_steps=100, n_chains=256,
            )
        with pytest.raises(TypeError):
            integrator.integrate_mcmc(
                [lambda x, y: x], [n01], [prop, prop],
                n_steps=100, n_chains=256,
            )


class TestExpectationFnNd:
    def test_value_and_pathwise_gradients(self, integrator):
        import jax.numpy as jnp

        nx = Distribution.normal(0.0, 1.0)
        est = integrator.expectation_fn(
            [lambda x, y: x * y], [nx, nx], n_samples=400_000
        )
        p = jnp.asarray([[1.0, 1.0], [3.0, 2.0]], jnp.float32)
        assert abs(float(est(p)[0]) - 3.0) < 0.05
        g = jax.grad(lambda q: est(q)[0])(p)
        # E[XY] = m1*m2: d/dm1 = m2 = 3, d/dm2 = m1 = 1, d/dstd = 0
        assert abs(float(g[0, 0]) - 3.0) < 0.05
        assert abs(float(g[1, 0]) - 1.0) < 0.05
        assert abs(float(g[0, 1])) < 0.05

    def test_jit_vmap_compose_and_shape_check(self, integrator):
        import jax.numpy as jnp

        nx = Distribution.normal(0.0, 1.0)
        est = integrator.expectation_fn(
            [lambda x, y: x + y], [nx, nx], n_samples=100_000
        )
        p = jnp.asarray([[0.0, 1.0], [0.0, 1.0]], jnp.float32)
        out = jax.jit(jax.vmap(est))(jnp.stack([p, p + 1.0]))
        assert out.shape == (2, 1)
        with pytest.raises(ValueError):
            est(jnp.zeros((2,)))

    def test_single_element_sequence_matches_scalar(self, integrator):
        import jax.numpy as jnp

        nx = Distribution.normal(0.0, 1.0)
        e1 = integrator.expectation_fn(
            [lambda x: x * x], [nx], n_samples=100_000
        )
        e2 = integrator.expectation_fn(
            [lambda x: x * x], nx, n_samples=100_000
        )
        p = jnp.asarray([0.0, 1.0], jnp.float32)
        assert float(e1(p)[0]) == float(e2(p)[0])


class TestNdPallasKernel:
    """nd integration under backend='pallas': there is no nd kernel, so
    these runs take the XLA nd sweep (with a warning) and must keep every
    estimate; benchmarks/parity.py asserts the nd rows on the device."""

    @pytest.fixture(scope="class")
    def kern(self):
        return mc.MonteCarloIntegrator(backend="pallas")

    def test_matches_xla_statistics(self, kern):
        nx = Distribution.normal(0.0, 1.0)
        u = Distribution.uniform(0.0, 1.0)
        ex = Distribution.exponential(2.0)
        fns = [lambda x, y, z: x * y * z, lambda x, y, z: x * x + y + z]
        xla = mc.MonteCarloIntegrator(backend="xla")
        rp = kern.integrate(fns, [nx, u, ex], n_samples=500_000, seed=42)
        rx = xla.integrate(fns, [nx, u, ex], n_samples=500_000, seed=42)
        assert abs(rp.values[0]) < 0.02
        assert abs(rp.values[1] - 2.0) < 0.02
        assert abs(rx.values[1] - rp.values[1]) < 0.02

    def test_seed_reproducibility(self, kern):
        nx = Distribution.normal(0.0, 1.0)
        u = Distribution.uniform(0.0, 1.0)
        fns = [lambda x, y: x * y]
        a = kern.integrate(fns, [nx, u], n_samples=200_000, seed=5)
        b = kern.integrate(fns, [nx, u], n_samples=200_000, seed=5)
        c = kern.integrate(fns, [nx, u], n_samples=200_000, seed=6)
        assert a.values[0] == b.values[0]
        assert a.values[0] != c.values[0]

    def test_stderr_in_kernel(self, kern):
        import math

        nx = Distribution.normal(0.0, 1.0)
        r = kern.integrate(
            [lambda x, y: x + y, lambda x, y: 1.0 + 0.0 * x],
            [nx, nx], n_samples=500_000, seed=4, return_stderr=True,
        )
        assert abs(r.values[0]) <= 6 * max(r.stderr[0], 1e-9)
        # stderr ~ sqrt(2/N) with N = the kernel's rounded-up actual
        assert 0.5 * math.sqrt(2 / 5e5) < r.stderr[0] < 2 * math.sqrt(2 / 5e5)
        assert r.stderr[1] < 1e-6

    def test_in_kernel_sobol_qmc(self, kern):
        import math

        u = Distribution.uniform(0.0, 1.0)
        f = lambda x, y: np.exp(x) * np.exp(y)  # noqa: E731
        exact = (math.e - 1.0) ** 2
        rq = kern.integrate([f], [u, u], n_samples=1_000_000,
                            seed=5, method="qmc")
        rm = kern.integrate([f], [u, u], n_samples=1_000_000, seed=5)
        eq = abs(rq.values[0] - exact)
        em = abs(rm.values[0] - exact)
        assert eq < em / 3 or eq < 1e-5

    def test_mesh_kernel(self):
        nx = Distribution.normal(0.0, 1.0)
        ex = Distribution.exponential(2.0)
        im = mc.MonteCarloIntegrator(backend="pallas", mesh="auto")
        r = im.integrate(
            [lambda x, y: x * x + y], [nx, ex],
            n_samples=500_000, seed=42,
        )
        assert abs(r.values[0] - 1.5) < 0.02

    def test_gapped_table_dim_falls_back_with_warning(self, kern):
        import warnings as _w

        x = np.linspace(0.0, 1.0, 2048)
        p = np.where((x > 0.4) & (x < 0.6), 0.0, 1.0)
        gapped = Distribution.from_pdf_table(x, p)
        u = Distribution.uniform(0.0, 1.0)
        with _w.catch_warnings(record=True) as rec:
            _w.simplefilter("always")
            r = kern.integrate(
                [lambda x, y: x * y], [gapped, u],
                n_samples=200_000, seed=6,
            )
            assert any("XLA" in str(x.message) for x in rec)
        # E[X] of the gapped density: symmetric around 0.5 -> E[XY] = 0.25
        assert abs(r.values[0] - 0.25) < 0.01

    def test_is_weights_ride_the_kernel(self, kern):
        # Traceable pdfs fold into d-ary weighted closures, which pass
        # the nd kernel gate like any integrand.
        nx = Distribution.normal(0.0, 1.0)
        r = kern.integrate_importance_sampling(
            [lambda x, y: x * x + y * y], [nx, nx], [nx, nx],
            n_samples=500_000, seed=2,
        )
        assert abs(r.values[0] - 2.0) < 0.04


class TestNdSharding:
    def test_mesh_matches_single_device_same_plan(self):
        """Same plan, streams keyed by (dim, global chunk) => the sharded
        program must reproduce the single-device one up to f32 reduction
        order (the 1-D sharding tier's bit-equality check, in nd form)."""
        import jax.numpy as jnp
        from tpu_montecarlo.ops.integrate_nd import build_integrate_nd_fn
        from tpu_montecarlo.sampling import DistKind
        from tpu_montecarlo.utils.dispatch import make_integrate_plan

        mesh = jax.make_mesh((8,), ("mc",))
        traced = mc.MonteCarloIntegrator()._trace_user_functions(
            [lambda x, y: x * y, lambda x, y: x * x + y], n_args=2
        )
        plan = make_integrate_plan(
            800_000, target_threads=1024, max_chunk_elems=100 * 1024,
            n_dev=8,
        )
        kinds = (DistKind.NORMAL, DistKind.UNIFORM)
        dummy = (jnp.zeros(1, jnp.float32),) * 2
        params = (
            jnp.asarray([0.0, 1.0], jnp.float32),
            jnp.asarray([0.0, 1.0], jnp.float32),
        )
        single = build_integrate_nd_fn(traced, kinds, plan)
        sharded = build_integrate_nd_fn(traced, kinds, plan, mesh=mesh)
        v1 = np.asarray(single(np.uint32(42), params, dummy, dummy))
        v8 = np.asarray(sharded(np.uint32(42), params, dummy, dummy))
        np.testing.assert_allclose(v1, v8, rtol=1e-6)

    def test_mesh_statistics(self):
        n = Distribution.normal(0.0, 1.0)
        u = Distribution.uniform(0.0, 1.0)
        meshed = mc.MonteCarloIntegrator(mesh="auto")
        r = meshed.integrate(
            [lambda x, y: x * y, lambda x, y: x * x + y], [n, u],
            n_samples=1_000_000, seed=13,
        )
        assert abs(r.values[0]) < 0.01
        assert abs(r.values[1] - 1.5) < 0.01

    def test_mesh_qmc_and_stderr(self):
        u = Distribution.uniform(0.0, 1.0)
        meshed = mc.MonteCarloIntegrator(mesh="auto")
        r = meshed.integrate(
            [lambda x, y: np.exp(x) * np.exp(y)], [u, u],
            n_samples=1_000_000, seed=5, method="qmc",
        )
        assert abs(r.values[0] - (math.e - 1.0) ** 2) < 1e-4
        r2 = meshed.integrate(
            [lambda x, y: x + y], [u, u],
            n_samples=1_000_000, seed=5, return_stderr=True,
        )
        assert abs(r2.values[0] - 1.0) <= 6 * max(r2.stderr[0], 1e-9)


class TestNdMcmcPallasKernel:
    """nd MH under backend='pallas': there is no nd kernel, so these runs
    take the XLA nd builder (with a warning) and must keep every
    estimate; benchmarks/parity.py asserts the nd rows on the device."""

    @pytest.fixture(scope="class")
    def kern(self):
        return mc.MonteCarloIntegrator(backend="pallas")

    def test_product_target_matches_xla_statistics(self, kern):
        n01 = Distribution.normal(0.0, 1.0)
        prop = Distribution.normal(0.0, 2.0)
        fns = [lambda x, y: x * x + y * y, lambda x, y: x * y]
        rp = kern.integrate_mcmc(
            fns, [n01, n01], [prop, prop],
            n_steps=1500, n_chains=1024, n_burnin=200, seed=42,
        )
        xla = mc.MonteCarloIntegrator(backend="xla")
        rx = xla.integrate_mcmc(
            fns, [n01, n01], [prop, prop],
            n_steps=1500, n_chains=1024, n_burnin=200, seed=42,
        )
        assert abs(rp.values[0] - 2.0) < 0.12
        assert abs(rp.values[1]) < 0.06
        assert abs(rx.values[0] - rp.values[0]) < 0.15
        assert 0.2 < rp.acceptance_rate < 0.7

    def test_joint_fn_target_correlated_gaussian(self, kern):
        rho = 0.8
        c = 1.0 / (2 * (1 - rho * rho))

        def logp(x, y):
            return -c * (x * x - 2 * rho * x * y + y * y)

        prop = Distribution.normal(0.0, 2.0)
        r = kern.integrate_mcmc(
            [lambda x, y: x * y, lambda x, y: x * x],
            logp, [prop, prop],
            n_steps=3000, n_chains=2048, n_burnin=400, seed=1,
        )
        assert abs(r.values[0] - rho) < 0.06
        assert abs(r.values[1] - 1.0) < 0.07

    def test_seed_reproducibility(self, kern):
        n01 = Distribution.normal(0.0, 1.0)
        prop = Distribution.normal(0.0, 2.0)
        fns = [lambda x, y: x + y]
        a = kern.integrate_mcmc(
            fns, [n01, n01], [prop, prop],
            n_steps=300, n_chains=512, n_burnin=50, seed=5,
        )
        b = kern.integrate_mcmc(
            fns, [n01, n01], [prop, prop],
            n_steps=300, n_chains=512, n_burnin=50, seed=5,
        )
        c = kern.integrate_mcmc(
            fns, [n01, n01], [prop, prop],
            n_steps=300, n_chains=512, n_burnin=50, seed=6,
        )
        assert a.values[0] == b.values[0]
        assert a.values[0] != c.values[0]

    def test_stderr_in_kernel(self, kern):
        n01 = Distribution.normal(0.0, 1.0)
        prop = Distribution.normal(0.0, 2.0)
        r = kern.integrate_mcmc(
            [lambda x, y: x + y, lambda x, y: 1.0 + 0.0 * x],
            [n01, n01], [prop, prop],
            n_steps=800, n_chains=1024, n_burnin=100, seed=3,
            return_stderr=True,
        )
        assert r.stderr is not None
        assert abs(r.values[0]) <= 6 * max(r.stderr[0], 1e-9)
        assert r.stderr[0] > 0
        assert r.stderr[1] < 1e-6

    def test_heavy_tail_dim_falls_back_with_warning(self, kern):
        # A heavy-tailed table proposal dim (exact searchsorted inverse
        # required) keeps the XLA reroute + warning.
        import warnings as _w

        t5 = Distribution.student_t(5.0)
        n01 = Distribution.normal(0.0, 1.0)
        with _w.catch_warnings(record=True) as rec:
            _w.simplefilter("always")
            r = kern.integrate_mcmc(
                [lambda x, y: x * y], [n01, n01], [t5, n01],
                n_steps=600, n_chains=512, n_burnin=100, seed=11,
            )
            assert any("XLA" in str(x.message) for x in rec)
        assert abs(r.values[0]) < 0.05

    def test_mesh_kernel(self):
        n01 = Distribution.normal(0.0, 1.0)
        prop = Distribution.normal(0.0, 2.0)
        im = mc.MonteCarloIntegrator(backend="pallas", mesh="auto")
        r = im.integrate_mcmc(
            [lambda x, y: x * x + y * y], [n01, n01], [prop, prop],
            n_steps=800, n_chains=2048, n_burnin=100, seed=13,
        )
        assert abs(r.values[0] - 2.0) < 0.12

    def test_d1_joint_fn_rides_kernel(self, kern):
        prop = Distribution.normal(0.0, 2.0)
        r = kern.integrate_mcmc(
            [lambda x: x * x], lambda x: -0.5 * x * x, prop,
            n_steps=1500, n_chains=1024, n_burnin=200, seed=7,
        )
        assert abs(r.values[0] - 1.0) < 0.08


class TestNdCompiledHandles:
    """AOT serving handles over the nd families (compile_integrate /
    compile_mcmc with Distribution sequences): seed batches ride the nd
    kernels' grid dimension (bit-equal per job), XLA routes batch via a
    traced lax.map."""

    def test_integrate_kernel_seed_batch_bit_equal(self):
        kern = mc.MonteCarloIntegrator(backend="pallas")
        n01 = Distribution.normal(0.0, 1.0)
        u = Distribution.uniform(0.0, 1.0)
        fns = [lambda x, y: x * y, lambda x, y: x * x + y]
        prog = kern.compile_integrate(
            fns, [n01, u], n_samples=200_000, seed_batch=3
        )
        out = np.asarray(prog([5, 6, 7]))
        assert out.shape == (3, 2)
        single = kern.compile_integrate(fns, [n01, u], n_samples=200_000)
        singles = np.stack([np.asarray(single(s)) for s in (5, 6, 7)])
        np.testing.assert_array_equal(out, singles)

    def test_integrate_xla_seed_batch_bit_equal(self):
        xla = mc.MonteCarloIntegrator(backend="xla")
        n01 = Distribution.normal(0.0, 1.0)
        u = Distribution.uniform(0.0, 1.0)
        fns = [lambda x, y: x * y]
        prog = xla.compile_integrate(
            fns, [n01, u], n_samples=200_000, seed_batch=2
        )
        out = np.asarray(prog([5, 6]))
        single = xla.compile_integrate(fns, [n01, u], n_samples=200_000)
        singles = np.stack([np.asarray(single(s)) for s in (5, 6)])
        np.testing.assert_array_equal(out, singles)

    def test_integrate_stderr_handle_shapes(self):
        kern = mc.MonteCarloIntegrator(backend="pallas")
        n01 = Distribution.normal(0.0, 1.0)
        prog = kern.compile_integrate(
            [lambda x, y: x + y], [n01, n01], n_samples=200_000,
            seed_batch=2, return_stderr=True,
        )
        v, se = prog([5, 6])
        assert np.asarray(v).shape == (2, 1)
        assert np.asarray(se).shape == (2, 1)
        assert float(np.asarray(se)[0, 0]) > 0

    def test_mcmc_kernel_seed_batch_bit_equal(self):
        kern = mc.MonteCarloIntegrator(backend="pallas")
        n01 = Distribution.normal(0.0, 1.0)
        q = Distribution.normal(0.0, 2.0)
        fns = [lambda x, y: x * x + y * y]
        prog = kern.compile_mcmc(
            fns, [n01, n01], [q, q],
            n_steps=300, n_chains=512, n_burnin=50, seed_batch=2,
        )
        mv, ma = prog([5, 6])
        mv, ma = np.asarray(mv), np.asarray(ma)
        assert mv.shape == (2, 1) and ma.shape == (2,)
        sv, sa = kern.compile_mcmc(
            fns, [n01, n01], [q, q],
            n_steps=300, n_chains=512, n_burnin=50,
        )(5)
        assert float(np.asarray(sv)[0]) == mv[0, 0]
        assert float(np.asarray(sa)) == ma[0]

    def test_mcmc_joint_fn_stderr_handle(self):
        kern = mc.MonteCarloIntegrator(backend="pallas")
        q = Distribution.normal(0.0, 2.0)
        prog = kern.compile_mcmc(
            [lambda x, y: x * y],
            lambda x, y: -0.5 * (x * x + y * y) - 0.3 * x * y,
            [q, q], n_steps=300, n_chains=512, n_burnin=50,
            seed_batch=2, return_stderr=True,
        )
        jv, ja, jse = prog([5, 6])
        assert np.asarray(jv).shape == (2, 1)
        assert np.asarray(jse).shape == (2, 1)

    def test_mcmc_xla_table_dim_handle(self):
        xla = mc.MonteCarloIntegrator(backend="xla")
        b = Distribution.beta(2.0, 5.0)
        n01 = Distribution.normal(0.0, 1.0)
        u = Distribution.uniform(0.0, 1.0)
        q = Distribution.normal(0.0, 2.0)
        prog = xla.compile_mcmc(
            [lambda x, y: x * y], [b, n01], [u, q],
            n_steps=200, n_chains=512, n_burnin=20, seed_batch=2,
        )
        tv, ta = prog([5, 6])
        assert np.asarray(tv).shape == (2, 1)
        assert np.asarray(ta).shape == (2,)

    def test_param_batch_rejected_for_table_dims(self):
        # nd param_batch works for analytic dims (TestNdParamBatch
        # below); a CUSTOM (table-sampled) dimension must still reject —
        # tables are per-distribution host artifacts, not runtime rows.
        it = mc.MonteCarloIntegrator()
        n01 = Distribution.normal(0.0, 1.0)
        tbl = Distribution.from_pdf(
            lambda x: 1.0 if (0.0 <= x) and (x < 1.0) else 0.0,
            support=(0.0, 1.0),
        )
        with pytest.raises(ValueError, match="param_batch"):
            it.compile_integrate(
                [lambda x, y: x + y], [n01, tbl],
                n_samples=1000, seed_batch=2, param_batch=True,
            )
        with pytest.raises(ValueError, match="param_batch"):
            it.compile_mcmc(
                [lambda x, y: x + y], [n01, tbl],
                [Distribution.normal(0.0, 2.0)] * 2,
                n_steps=10, n_chains=256, n_burnin=0,
                seed_batch=2, param_batch=True,
            )

    def test_single_element_sequence_delegates_to_scalar(self):
        it = mc.MonteCarloIntegrator()
        n01 = Distribution.normal(0.0, 1.0)
        p1 = it.compile_integrate([lambda x: x * x], [n01], n_samples=100_000)
        p2 = it.compile_integrate([lambda x: x * x], n01, n_samples=100_000)
        assert float(np.asarray(p1(5))[0]) == float(np.asarray(p2(5))[0])


class TestNdDiagnostics:
    def test_split_rhat_mixed_vs_stuck(self, integrator):
        n01 = Distribution.normal(0.0, 1.0)
        good = integrator.integrate_mcmc(
            [lambda x, y: x + y], [n01, n01],
            [Distribution.normal(0.0, 2.0)] * 2,
            n_steps=1000, n_chains=512, n_burnin=100, seed=42,
            return_diagnostics=True,
        )
        assert abs(good.diagnostics["r_hat"][0] - 1.0) < 0.05
        assert good.diagnostics["ess"][0] > 100
        # A mismatched proposal on a short run barely moves: R-hat >> 1.
        bad = integrator.integrate_mcmc(
            [lambda x, y: x + y], [n01, n01],
            [Distribution.normal(4.0, 0.3)] * 2,
            n_steps=60, n_chains=512, n_burnin=0, seed=42,
            return_diagnostics=True,
        )
        assert bad.diagnostics["r_hat"][0] > 1.1

    def test_joint_target_diagnostics_with_stderr(self, integrator):
        prop = Distribution.normal(0.0, 2.0)
        r = integrator.integrate_mcmc(
            [lambda x, y: x * y],
            lambda x, y: -0.5 * (x * x + y * y),
            [prop, prop], n_steps=800, n_chains=512, n_burnin=100,
            seed=7, return_diagnostics=True, return_stderr=True,
        )
        assert r.stderr is not None
        assert abs(r.diagnostics["r_hat"][0] - 1.0) < 0.05

    def test_mesh_diagnostics(self):
        n01 = Distribution.normal(0.0, 1.0)
        meshed = mc.MonteCarloIntegrator(mesh="auto")
        r = meshed.integrate_mcmc(
            [lambda x, y: x * x + y * y], [n01, n01],
            [Distribution.normal(0.0, 2.0)] * 2,
            n_steps=400, n_chains=1024, n_burnin=50, seed=3,
            return_diagnostics=True,
        )
        assert abs(r.diagnostics["r_hat"][0] - 1.0) < 0.1

    def test_needs_four_steps(self, integrator):
        n01 = Distribution.normal(0.0, 1.0)
        with pytest.raises(ValueError, match="n_steps"):
            integrator.integrate_mcmc(
                [lambda x, y: x], [n01, n01],
                [Distribution.normal(0.0, 2.0)] * 2,
                n_steps=2, n_chains=256, n_burnin=0,
                return_diagnostics=True,
            )


class TestNdMcmcResume:
    """Checkpoint/resume over d-vector chain state (XLA nd path): fresh
    stateful runs reproduce stateless estimates, segments draw fresh
    streams, resumed halves track one long run."""

    def test_fresh_stateful_matches_stateless(self, integrator):
        n01 = Distribution.normal(0.0, 1.0)
        prop = Distribution.normal(0.0, 2.0)
        fns = [lambda x, y: x * x + y * y]
        r0 = integrator.integrate_mcmc(
            fns, [n01, n01], [prop, prop],
            n_steps=400, n_chains=512, n_burnin=50, seed=42,
        )
        r1 = integrator.integrate_mcmc(
            fns, [n01, n01], [prop, prop],
            n_steps=400, n_chains=512, n_burnin=50, seed=42,
            return_state=True,
        )
        assert r0.values[0] == r1.values[0]
        assert r1.chain_state is not None
        assert r1.chain_state.ndim_state == 2
        assert r1.chain_state.x.shape[0] == 2

    def test_resume_tracks_long_run(self, integrator):
        prop = Distribution.normal(0.0, 2.0)
        rho = 0.6
        c = 1.0 / (2 * (1 - rho * rho))

        def logp(x, y):
            return -c * (x * x - 2 * rho * x * y + y * y)

        fns = [lambda x, y: x * y]
        r1 = integrator.integrate_mcmc(
            fns, logp, [prop, prop],
            n_steps=1500, n_chains=1024, n_burnin=200, seed=3,
            return_state=True,
        )
        r2 = integrator.integrate_mcmc(
            fns, logp, [prop, prop],
            n_steps=1500, n_chains=1024, n_burnin=0, seed=3,
            initial_state=r1.chain_state, return_state=True,
        )
        assert r2.chain_state.segment == r1.chain_state.segment + 1
        combined = 0.5 * (r1.values[0] + r2.values[0])
        assert abs(combined - rho) < 0.05
        # Fresh streams: the two segments are not identical runs.
        assert r1.values[0] != r2.values[0]

    def test_wrong_shape_state_raises(self, integrator):
        n01 = Distribution.normal(0.0, 1.0)
        prop = Distribution.normal(0.0, 2.0)
        r = integrator.integrate_mcmc(
            [lambda x, y: x], [n01, n01], [prop, prop],
            n_steps=100, n_chains=256, n_burnin=10, seed=1,
            return_state=True,
        )
        bad = mc.McmcState(r.chain_state.x[:1], r.chain_state.log_p)
        with pytest.raises(ValueError, match="shape"):
            integrator.integrate_mcmc(
                [lambda x, y: x], [n01, n01], [prop, prop],
                n_steps=100, n_chains=256, n_burnin=10, seed=1,
                initial_state=bad,
            )

    def test_mesh_resume(self):
        n01 = Distribution.normal(0.0, 1.0)
        prop = Distribution.normal(0.0, 2.0)
        meshed = mc.MonteCarloIntegrator(mesh="auto")
        fns = [lambda x, y: x * x + y * y]
        r1 = meshed.integrate_mcmc(
            fns, [n01, n01], [prop, prop],
            n_steps=300, n_chains=1024, n_burnin=50, seed=5,
            return_state=True,
        )
        r2 = meshed.integrate_mcmc(
            fns, [n01, n01], [prop, prop],
            n_steps=300, n_chains=1024, n_burnin=0, seed=5,
            initial_state=r1.chain_state,
        )
        assert abs(0.5 * (r1.values[0] + r2.values[0]) - 2.0) < 0.15


class TestNdParamBatch:
    """nd param-batched handles: (R, d, 2) runtime per-dimension
    parameter rows (pack_param_batch_nd), each batch element bit-equal
    to its unbatched call on the kernel path."""

    def _rows(self):
        return [
            [Distribution.normal(0.0, 1.0), Distribution.uniform(0.0, 1.0)],
            [Distribution.normal(2.0, 3.0), Distribution.uniform(-1.0, 1.0)],
        ]

    def test_kernel_bit_equal_per_element(self):
        kern = mc.MonteCarloIntegrator(backend="pallas")
        fns = [lambda x, y: x * y, lambda x, y: x + y]
        rows = self._rows()
        prog = kern.compile_integrate(
            fns, rows[0], n_samples=200_000,
            seed_batch=2, param_batch=True,
        )
        out = np.asarray(prog([5, 6], mc.pack_param_batch_nd(rows)))
        singles = np.stack([
            np.asarray(
                kern.compile_integrate(fns, row, n_samples=200_000)(s)
            )
            for s, row in zip((5, 6), rows)
        ])
        np.testing.assert_array_equal(out, singles)

    def test_xla_param_batch_matches_singles(self):
        xla = mc.MonteCarloIntegrator(backend="xla")
        fns = [lambda x, y: x * y]
        rows = self._rows()
        prog = xla.compile_integrate(
            fns, rows[0], n_samples=200_000,
            seed_batch=2, param_batch=True,
        )
        out = np.asarray(prog([5, 6], mc.pack_param_batch_nd(rows)))
        singles = np.stack([
            np.asarray(
                xla.compile_integrate(fns, row, n_samples=200_000)(s)
            )
            for s, row in zip((5, 6), rows)
        ])
        np.testing.assert_allclose(out, singles, rtol=1e-6)

    def test_stderr_composes(self):
        kern = mc.MonteCarloIntegrator(backend="pallas")
        rows = self._rows()
        prog = kern.compile_integrate(
            [lambda x, y: x + y], rows[0], n_samples=200_000,
            seed_batch=2, param_batch=True, return_stderr=True,
        )
        v, se = prog([5, 6], mc.pack_param_batch_nd(rows))
        assert np.asarray(v).shape == (2, 1)
        assert np.asarray(se).shape == (2, 1)
        assert float(np.asarray(se)[0, 0]) > 0

    def test_mismatched_pack_rejected(self):
        kern = mc.MonteCarloIntegrator(backend="pallas")
        rows = self._rows()
        prog = kern.compile_integrate(
            [lambda x, y: x + y], rows[0], n_samples=100_000,
            seed_batch=2, param_batch=True,
        )
        bad = mc.pack_param_batch_nd(
            [[Distribution.exponential(2.0), Distribution.uniform(0, 1)]] * 2
        )
        with pytest.raises(ValueError, match="packed for dimensions"):
            prog([5, 6], bad)

    def test_custom_dim_rejected(self):
        it = mc.MonteCarloIntegrator()
        with pytest.raises(ValueError, match="analytic"):
            it.compile_integrate(
                [lambda x, y: x + y],
                [Distribution.beta(2.0, 5.0), Distribution.uniform(0, 1)],
                n_samples=1000, seed_batch=2, param_batch=True,
            )

    def test_pack_validation(self):
        n = Distribution.normal(0.0, 1.0)
        u = Distribution.uniform(0.0, 1.0)
        with pytest.raises(ValueError, match="same number"):
            mc.pack_param_batch_nd([[n, u], [n]])
        with pytest.raises(ValueError, match="mixes families"):
            mc.pack_param_batch_nd([[n, u], [u, u]])


class TestNdMcmcParamBatch:
    """nd MCMC param-batched handles: (R, d, 2) runtime (target,
    proposal) rows — one program per posterior/tempering sweep."""

    def _packs(self):
        targ_rows = [[Distribution.normal(0.0, 1.0)] * 2,
                     [Distribution.normal(1.0, 2.0)] * 2]
        prop_rows = [[Distribution.normal(0.0, 2.0)] * 2,
                     [Distribution.normal(1.0, 4.0)] * 2]
        return targ_rows, prop_rows

    def test_kernel_bit_equal_per_element(self):
        kern = mc.MonteCarloIntegrator(backend="pallas")
        fns = [lambda x, y: x * x + y * y]
        targ_rows, prop_rows = self._packs()
        prog = kern.compile_mcmc(
            fns, targ_rows[0], prop_rows[0],
            n_steps=300, n_chains=512, n_burnin=50,
            seed_batch=2, param_batch=True,
        )
        v, a = prog(
            [5, 6],
            mc.pack_param_batch_nd(targ_rows),
            mc.pack_param_batch_nd(prop_rows),
        )
        v = np.asarray(v)
        assert v.shape == (2, 1)
        singles = np.stack([
            np.asarray(
                kern.compile_mcmc(
                    fns, t, p, n_steps=300, n_chains=512, n_burnin=50
                )(s)[0]
            )
            for s, t, p in zip((5, 6), targ_rows, prop_rows)
        ])
        np.testing.assert_array_equal(v, singles)

    def test_xla_param_batch_statistics(self):
        xla = mc.MonteCarloIntegrator(backend="xla")
        fns = [lambda x, y: x * x + y * y]
        targ_rows, prop_rows = self._packs()
        prog = xla.compile_mcmc(
            fns, targ_rows[0], prop_rows[0],
            n_steps=400, n_chains=512, n_burnin=50,
            seed_batch=2, param_batch=True,
        )
        v, a = prog(
            [5, 6],
            mc.pack_param_batch_nd(targ_rows),
            mc.pack_param_batch_nd(prop_rows),
        )
        v = np.asarray(v)
        assert abs(v[0, 0] - 2.0) < 0.3
        assert abs(v[1, 0] - 10.0) < 1.0

    def test_stderr_and_joint_rejection(self):
        kern = mc.MonteCarloIntegrator(backend="pallas")
        targ_rows, prop_rows = self._packs()
        prog = kern.compile_mcmc(
            [lambda x, y: x + y], targ_rows[0], prop_rows[0],
            n_steps=300, n_chains=512, n_burnin=50,
            seed_batch=2, param_batch=True, return_stderr=True,
        )
        v, a, se = prog(
            [5, 6],
            mc.pack_param_batch_nd(targ_rows),
            mc.pack_param_batch_nd(prop_rows),
        )
        assert np.asarray(se).shape == (2, 1)
        assert float(np.asarray(se)[0, 0]) > 0
        with pytest.raises(ValueError, match="joint log-density"):
            kern.compile_mcmc(
                [lambda x, y: x + y], lambda x, y: -x * x - y * y,
                prop_rows[0], n_steps=10, n_chains=256, n_burnin=0,
                seed_batch=2, param_batch=True,
            )
