"""Uniform-u inverse-CDF resampling and uniform-grid interpolation — the
table machinery that replaces on-device searchsorted."""

import numpy as np
import pytest

import jax.numpy as jnp

from tpu_montecarlo.sampling import (
    log_pdf_from_table,
    pdf_from_table,
)
from tpu_montecarlo.tables import (
    compute_cdf_table,
    compute_inverse_cdf_table,
    is_uniform_grid,
)


class TestInverseCdfTable:
    def test_uniform_dist_inverse_is_identity_scaled(self):
        x = np.linspace(0.0, 2.0, 1000)
        cdf = np.linspace(0.0, 1.0, 1000)
        inv = compute_inverse_cdf_table(x, cdf, m=256)
        np.testing.assert_allclose(inv, np.linspace(0, 2, 256), atol=1e-5)

    def test_roundtrip_through_cdf(self):
        # For a smooth pdf, cdf(inverse(u)) == u.
        x, cdf = compute_cdf_table(
            lambda t: np.exp(-0.5 * t * t), -5.0, 5.0, 2000
        )
        inv = compute_inverse_cdf_table(x, cdf, m=4096)
        u_check = np.interp(inv, x, cdf)
        np.testing.assert_allclose(
            u_check, np.linspace(0, 1, 4096), atol=2e-3
        )

    def test_endpoints(self):
        x, cdf = compute_cdf_table(lambda t: 1.0, 3.0, 7.0, 1000)
        inv = compute_inverse_cdf_table(x, cdf, m=128)
        assert inv[0] == pytest.approx(3.0, abs=1e-5)
        assert inv[-1] == pytest.approx(7.0, abs=1e-5)

    def test_moments_match_exact_inverse(self):
        # Beta(2,5)-like pdf: sampling through the resampled inverse must
        # reproduce the same moments as the exact piecewise inverse.
        def pdf(t):
            return t * (1 - t) ** 4 if 0 < t < 1 else 0.0

        x, cdf = compute_cdf_table(pdf, 0.0, 1.0, 2048)
        inv = compute_inverse_cdf_table(x, cdf)
        rng = np.random.default_rng(0)
        u = rng.uniform(size=500_000)
        exact = np.interp(u, cdf, x)
        via_inv = np.interp(u, np.linspace(0, 1, len(inv)), inv)
        assert abs(exact.mean() - via_inv.mean()) < 1e-4
        assert abs(exact.var() - via_inv.var()) < 1e-4


class TestUniformGridDetection:
    def test_linspace_is_uniform(self):
        assert is_uniform_grid(np.linspace(-3, 3, 1000))

    def test_irregular_is_not(self):
        assert not is_uniform_grid(np.array([0.0, 0.1, 0.5, 1.0]))

    def test_short_grids(self):
        assert not is_uniform_grid(np.array([1.0]))


class TestUniformGridInterp:
    def test_matches_searchsorted_path(self):
        xt = jnp.asarray(np.linspace(-2, 2, 513), jnp.float32)
        pt = jnp.asarray(np.exp(-np.linspace(-2, 2, 513) ** 2), jnp.float32)
        q = jnp.asarray(np.linspace(-2.5, 2.5, 1001), jnp.float32)
        fast = np.asarray(pdf_from_table(q, xt, pt, uniform=True))
        slow = np.asarray(pdf_from_table(q, xt, pt, uniform=False))
        np.testing.assert_allclose(fast, slow, rtol=1e-4, atol=1e-6)

    def test_log_variant_floor_outside(self):
        xt = jnp.asarray(np.linspace(0, 1, 257), jnp.float32)
        lt = jnp.zeros(257, jnp.float32)
        q = jnp.asarray([-0.5, 0.5, 1.5], jnp.float32)
        out = np.asarray(log_pdf_from_table(q, xt, lt, uniform=True))
        assert out[0] == -100.0
        assert out[1] == pytest.approx(0.0)
        assert out[2] == -100.0
