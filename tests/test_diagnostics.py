"""MCMC convergence diagnostics (``return_diagnostics=True``).

Split-R-hat (Gelman-Rubin potential scale reduction over 2*n_chains
half-chain sequences) — a capability push beyond the reference, built
from the per-chain means the stderr machinery computes
(ops/mcmc_xla.py).
"""

import numpy as np
import pytest

from tpu_montecarlo import (
    Distribution,
    MonteCarloIntegrator,
    integrate_mcmc,
)


class TestSplitRhat:
    def test_well_mixed_near_one(self):
        r = integrate_mcmc(
            [lambda x: x, lambda x: x * x],
            Distribution.normal(0.0, 1.0),
            Distribution.normal(0.0, 2.0),
            n_steps=2000, n_chains=512, n_burnin=200,
            return_diagnostics=True,
        )
        r_hat = r.diagnostics["r_hat"]
        assert r_hat.shape == (2,)
        assert np.all(r_hat > 0.99)
        assert np.all(r_hat < 1.02)

    def test_slow_mixing_flagged(self):
        # A badly mismatched independence proposal (mass at 4, target at
        # 0) with a short run: chains crawl toward the target at very
        # different rates, so the two halves of each chain disagree and
        # split-R-hat must rise well above 1 — exactly the failure the
        # user needs flagged, since the VALUES look plausible otherwise.
        r = integrate_mcmc(
            [lambda x: x],
            Distribution.normal(0.0, 1.0),
            Distribution.normal(4.0, 0.3),
            n_steps=60, n_chains=512, n_burnin=0,
            return_diagnostics=True,
        )
        assert r.diagnostics["r_hat"][0] > 1.1

    def test_ess_tracks_mixing(self):
        # ESS near the draw count when mixing, collapsed when stuck; a
        # well-mixed independence sampler at ~60% acceptance still loses
        # some draws to rejection stretches, so just require the right
        # order of magnitude and the right ordering.
        kw = dict(n_chains=512, return_diagnostics=True)
        t = Distribution.normal(0.0, 1.0)
        good = integrate_mcmc(
            [lambda x: x], t, Distribution.normal(0.0, 2.0),
            n_steps=1000, n_burnin=100, **kw
        )
        stuck = integrate_mcmc(
            [lambda x: x], t, Distribution.normal(4.0, 0.3),
            n_steps=60, n_burnin=0, **kw
        )
        draws_good = 2 * 512 * (1000 // 2)
        draws_stuck = 2 * 512 * (60 // 2)
        ess_good = good.diagnostics["ess"][0]
        ess_stuck = stuck.diagnostics["ess"][0]
        assert 0.1 * draws_good < ess_good <= draws_good
        assert ess_stuck < 0.2 * draws_stuck
        assert ess_good / draws_good > 5 * ess_stuck / draws_stuck

    def test_diagnostics_none_by_default(self):
        r = integrate_mcmc(
            [lambda x: x], Distribution.normal(0.0, 1.0),
            Distribution.normal(0.0, 2.0),
            n_steps=200, n_chains=256, n_burnin=10,
        )
        assert r.diagnostics is None

    def test_combined_with_stderr(self):
        r = integrate_mcmc(
            [lambda x: x], Distribution.normal(0.0, 1.0),
            Distribution.normal(0.0, 2.0),
            n_steps=1000, n_chains=512, n_burnin=100,
            return_stderr=True, return_diagnostics=True,
        )
        assert r.stderr is not None and r.stderr[0] > 0
        assert 0.99 < r.diagnostics["r_hat"][0] < 1.05
        assert abs(r.values[0]) < 4 * r.stderr[0]

    def test_sharded(self, mesh8):
        r = MonteCarloIntegrator(mesh=mesh8).integrate_mcmc(
            [lambda x: x], Distribution.normal(0.0, 1.0),
            Distribution.normal(0.0, 2.0),
            n_steps=800, n_chains=2048, n_burnin=100,
            return_diagnostics=True,
        )
        assert 0.99 < r.diagnostics["r_hat"][0] < 1.02

    def test_custom_target_table_path(self):
        r = integrate_mcmc(
            [lambda x: x], Distribution.beta(2.0, 2.0),
            Distribution.uniform(0.0, 1.0),
            n_steps=1500, n_chains=512, n_burnin=150,
            return_diagnostics=True,
        )
        assert abs(r.values[0] - 0.5) < 0.01
        assert r.diagnostics["r_hat"][0] < 1.02

    def test_rejected_with_state(self):
        with pytest.raises(ValueError, match="stateless"):
            integrate_mcmc(
                [lambda x: x], Distribution.normal(0.0, 1.0),
                Distribution.normal(0.0, 2.0),
                n_steps=100, n_chains=256, n_burnin=10,
                return_diagnostics=True, return_state=True,
            )

    def test_rejected_single_step(self):
        with pytest.raises(ValueError, match="n_steps"):
            integrate_mcmc(
                [lambda x: x], Distribution.normal(0.0, 1.0),
                Distribution.normal(0.0, 2.0),
                n_steps=1, n_chains=256, n_burnin=0,
                return_diagnostics=True,
            )

    def test_diagnostics_ride_the_kernel(self):
        # Round 4: split-R-hat/ESS run IN-KERNEL (split-half stat rows
        # in the per-grid-step block) — a forced Pallas backend must
        # not warn-fallback, and the statistics must match the XLA
        # implementation's on a healthy sampler.
        import warnings as _w

        kw = dict(
            n_steps=200, n_chains=256, n_burnin=10, seed=5,
            return_diagnostics=True,
        )
        with _w.catch_warnings():
            _w.simplefilter("error")
            rp = MonteCarloIntegrator(backend="pallas").integrate_mcmc(
                [lambda x: x], Distribution.normal(0.0, 1.0),
                Distribution.normal(0.0, 2.0), **kw,
            )
        rx = MonteCarloIntegrator(backend="xla").integrate_mcmc(
            [lambda x: x], Distribution.normal(0.0, 1.0),
            Distribution.normal(0.0, 2.0), **kw,
        )
        assert abs(rp.diagnostics["r_hat"][0] - rx.diagnostics["r_hat"][0]) < 0.02
        assert rp.diagnostics["ess"][0] > 0
        # ESS scales with the chain count; both plans run the 256
        # requested chains — compare per chain.
        per_chain_p = rp.diagnostics["ess"][0] / 256.0
        per_chain_x = rx.diagnostics["ess"][0] / 256.0
        assert abs(per_chain_p - per_chain_x) / per_chain_x < 0.25

    def test_kernel_diagnostics_with_stderr(self):
        # The combined stat block (rows 0-2 error bars + rows 3-6
        # split-half diagnostics) in one kernel pass, no fallback.
        import warnings as _w

        with _w.catch_warnings():
            _w.simplefilter("error")
            r = MonteCarloIntegrator(backend="pallas").integrate_mcmc(
                [lambda x: x, lambda x: x * x],
                Distribution.normal(0.0, 1.0),
                Distribution.normal(0.0, 2.0),
                n_steps=600, n_chains=512, n_burnin=60, seed=9,
                return_stderr=True, return_diagnostics=True,
            )
        assert r.stderr is not None and r.stderr[0] > 0
        assert 0.99 < r.diagnostics["r_hat"][0] < 1.05
        assert abs(r.values[0]) < 4 * r.stderr[0]
        assert abs(r.values[1] - 1.0) < 0.1

    def test_kernel_diagnostics_sharded(self, mesh8):
        # Sharded kernel diagnostics: per-device sequence stats psum'd
        # before the split-R-hat reduction — values must agree with the
        # single-device kernel run (same total chains, same seed).
        import warnings as _w

        kw = dict(
            n_steps=400, n_chains=2048, n_burnin=50, seed=11,
            return_diagnostics=True,
        )
        with _w.catch_warnings():
            _w.simplefilter("error")
            rs = MonteCarloIntegrator(
                backend="pallas", mesh=mesh8
            ).integrate_mcmc(
                [lambda x: x], Distribution.normal(0.0, 1.0),
                Distribution.normal(0.0, 2.0), **kw,
            )
            r1 = MonteCarloIntegrator(backend="pallas").integrate_mcmc(
                [lambda x: x], Distribution.normal(0.0, 1.0),
                Distribution.normal(0.0, 2.0), **kw,
            )
        assert abs(rs.diagnostics["r_hat"][0] - 1.0) < 0.05
        assert (
            abs(rs.diagnostics["r_hat"][0] - r1.diagnostics["r_hat"][0])
            < 0.02
        )
        assert rs.diagnostics["ess"][0] > 0


class TestRhatFormula:
    """Direct checks of the reduced-statistics formula, incl. degenerate
    branches an end-to-end run cannot easily reach."""

    def _call(self, w_tot, ss_tot, m=8, n1=10):
        import jax.numpy as jnp

        from tpu_montecarlo.ops.mcmc_xla import split_rhat_ess

        r, ess = split_rhat_ess(
            jnp.float32(w_tot), jnp.float32(ss_tot), m, n1
        )
        return float(r), float(ess)

    def test_frozen_at_different_values_is_inf(self):
        # W == 0 but sequence means differ: the worst divergence must
        # NOT read as converged.
        r, ess = self._call(0.0, 5.0)
        assert np.isinf(r)
        assert ess == 8.0  # m distinct frozen values ~ m draws

    def test_all_constant_is_one(self):
        r, ess = self._call(0.0, 0.0)
        assert r == 1.0
        assert ess == 80.0  # capped at the draw count

    def test_well_mixed_near_one(self):
        # iid sequences: var(seq means) ~ W/n1 -> var+ ~ W, R ~ 1.
        m, n1, w = 8, 10, 2.0
        r, ess = self._call(m * w, (m - 1) * (w / n1), m, n1)
        assert abs(r - 1.0) < 0.01
        assert abs(ess - m * n1) < 1.0

    def test_diagnostics_needs_four_steps(self):
        for bad in (2, 3):
            with pytest.raises(ValueError, match="n_steps >= 4"):
                integrate_mcmc(
                    [lambda x: x], Distribution.normal(0.0, 1.0),
                    Distribution.normal(0.0, 2.0),
                    n_steps=bad, n_chains=256, n_burnin=0,
                    return_diagnostics=True,
                )
