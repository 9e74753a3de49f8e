"""Parameter-batched AOT handles: one compiled program serving a whole
(seed, distribution-parameter) sweep in a single dispatch.

``compile_integrate(..., param_batch=True)`` makes the family parameters a
runtime (R, 2) batch input (one params row per kernel grid rep on the Pallas
path, a traced-once lax.map on the XLA path), so each batch element must
reproduce the corresponding unbatched handle bit-for-bit.  A capability
beyond the reference, which baked parameters into per-call uniform buffers
(src/engine.rs:30-37) and recompiled per call.
"""

import numpy as np
import pytest

from tpu_montecarlo import (
    Distribution,
    MonteCarloIntegrator,
    pack_param_batch,
)

SEEDS = [7, 42, 1234]


@pytest.fixture(params=["auto", "pallas"])
def integrator(request):
    return MonteCarloIntegrator(backend=request.param)


class TestPackParamBatch:
    def test_normal_packing(self):
        p = pack_param_batch(
            [Distribution.normal(0.0, 1.0), Distribution.normal(2.0, 3.0)]
        )
        np.testing.assert_array_equal(
            p, np.asarray([[0.0, 1.0], [2.0, 3.0]], np.float32)
        )

    def test_uniform_and_exponential_packing(self):
        u = pack_param_batch([Distribution.uniform(-1.0, 4.0)])
        np.testing.assert_array_equal(u, [[-1.0, 4.0]])
        e = pack_param_batch([Distribution.exponential(2.5)])
        np.testing.assert_array_equal(e, [[2.5, 0.0]])

    def test_mixed_families_rejected(self):
        with pytest.raises(ValueError, match="one family"):
            pack_param_batch(
                [Distribution.normal(0.0, 1.0), Distribution.uniform(0, 1)]
            )

    def test_custom_rejected(self):
        with pytest.raises(ValueError, match="analytic"):
            pack_param_batch([Distribution.beta(2.0, 5.0)])

    def test_empty_rejected(self):
        with pytest.raises(ValueError, match="at least one"):
            pack_param_batch([])


class TestParamBatch:
    def _check_matches_single(self, integrator, dists, fns, n, method="mc"):
        params = pack_param_batch(dists)
        prog = integrator.compile_integrate(
            fns, dists[0], n_samples=n, seed_batch=len(dists),
            param_batch=True, method=method,
        )
        out = np.asarray(prog(SEEDS[: len(dists)], params))
        assert out.shape == (len(dists), len(fns))
        for i, (s, d) in enumerate(zip(SEEDS, dists)):
            single = integrator.compile_integrate(
                fns, d, n_samples=n, method=method
            )
            np.testing.assert_array_equal(out[i], np.asarray(single(s)))

    def test_normal_sweep_matches_single(self, integrator):
        dists = [
            Distribution.normal(0.0, 1.0),
            Distribution.normal(2.0, 3.0),
            Distribution.normal(-1.0, 0.5),
        ]
        self._check_matches_single(
            integrator, dists, [lambda x: x, lambda x: x * x], 200_000
        )

    def test_uniform_sweep_matches_single(self, integrator):
        dists = [
            Distribution.uniform(0.0, 1.0),
            Distribution.uniform(-2.0, 5.0),
        ]
        self._check_matches_single(integrator, dists, [lambda x: x], 100_000)

    def test_exponential_sweep_matches_single(self, integrator):
        dists = [
            Distribution.exponential(1.0),
            Distribution.exponential(0.25),
        ]
        self._check_matches_single(integrator, dists, [lambda x: x], 100_000)

    def test_qmc_sweep_matches_single(self, integrator):
        dists = [
            Distribution.normal(0.0, 1.0),
            Distribution.normal(3.0, 2.0),
        ]
        self._check_matches_single(
            integrator, dists, [lambda x: x], 100_000, method="qmc"
        )

    def test_batch_of_one_keeps_batch_shape(self, integrator):
        d = Distribution.normal(0.0, 2.0)
        prog = integrator.compile_integrate(
            [lambda x: x * x], d, n_samples=100_000, param_batch=True
        )
        out = np.asarray(prog([42], pack_param_batch([d])))
        assert out.shape == (1, 1)
        single = integrator.compile_integrate(
            [lambda x: x * x], d, n_samples=100_000
        )
        np.testing.assert_array_equal(out[0], np.asarray(single(42)))

    def test_estimates_track_parameters(self, integrator):
        # E[X] for each element lands on ITS distribution's mean — the
        # parameter rows really route to the right batch element.
        means = [0.0, 5.0, -3.0]
        dists = [Distribution.normal(m, 1.0) for m in means]
        prog = integrator.compile_integrate(
            [lambda x: x], dists[0], n_samples=400_000,
            seed_batch=3, param_batch=True,
        )
        out = np.asarray(prog(SEEDS, pack_param_batch(dists)))
        for row, m in zip(out, means):
            assert abs(row[0] - m) < 0.02

    def test_custom_distribution_rejected(self, integrator):
        with pytest.raises(ValueError, match="analytic"):
            integrator.compile_integrate(
                [lambda x: x], Distribution.beta(2.0, 5.0),
                n_samples=100_000, param_batch=True,
            )

    def test_family_mismatch_rejected(self, integrator):
        # A pack built for another family must not be silently
        # reinterpreted (e.g. (min, max) rows read as (mean, std)).
        prog = integrator.compile_integrate(
            [lambda x: x], Distribution.normal(0.0, 1.0),
            n_samples=100_000, seed_batch=2, param_batch=True,
        )
        wrong = pack_param_batch(
            [Distribution.uniform(0.0, 1.0), Distribution.uniform(0.0, 2.0)]
        )
        with pytest.raises(ValueError, match="packed for UNIFORM"):
            prog([1, 2], wrong)
        # Plain arrays are the documented escape hatch — no family check.
        out = np.asarray(prog([1, 2], np.asarray(wrong)))
        assert out.shape == (2, 1)

    def test_mcmc_family_mismatch_rejected(self, integrator):
        prog = integrator.compile_mcmc(
            [lambda x: x], Distribution.normal(0.0, 1.0),
            Distribution.normal(0.0, 2.0), n_steps=100, n_chains=256,
            n_burnin=10, seed_batch=2, param_batch=True,
        )
        normal = pack_param_batch(
            [Distribution.normal(0.0, 1.0), Distribution.normal(1.0, 1.0)]
        )
        wrong = pack_param_batch(
            [Distribution.exponential(1.0), Distribution.exponential(2.0)]
        )
        with pytest.raises(ValueError, match="packed for EXPONENTIAL"):
            prog([1, 2], normal, wrong)

    def test_shape_validation(self, integrator):
        d = Distribution.normal(0.0, 1.0)
        prog = integrator.compile_integrate(
            [lambda x: x], d, n_samples=100_000, seed_batch=2,
            param_batch=True,
        )
        with pytest.raises(ValueError, match="seeds"):
            prog([1, 2, 3], np.zeros((2, 2), np.float32))
        with pytest.raises(ValueError, match="params"):
            prog([1, 2], np.zeros((3, 2), np.float32))


class TestMcmcParamBatch:
    def test_sweep_matches_single(self, integrator):
        targets = [
            Distribution.normal(0.0, 1.0),
            Distribution.normal(1.0, 0.5),
        ]
        proposals = [
            Distribution.normal(0.0, 2.0),
            Distribution.normal(1.0, 1.5),
        ]
        fns = [lambda x: x, lambda x: x * x]
        prog = integrator.compile_mcmc(
            fns, targets[0], proposals[0], n_steps=400, n_chains=512,
            n_burnin=100, seed_batch=2, param_batch=True,
        )
        vals, accs = prog(
            SEEDS[:2],
            pack_param_batch(targets),
            pack_param_batch(proposals),
        )
        vals, accs = np.asarray(vals), np.asarray(accs)
        assert vals.shape == (2, 2) and accs.shape == (2,)
        for i, (s, t, q) in enumerate(zip(SEEDS, targets, proposals)):
            single = integrator.compile_mcmc(
                fns, t, q, n_steps=400, n_chains=512, n_burnin=100
            )
            sv, sa = single(s)
            np.testing.assert_array_equal(vals[i], np.asarray(sv))
            np.testing.assert_array_equal(accs[i], np.asarray(sa))

    def test_estimates_track_parameters(self, integrator):
        # Each element's E[X] lands on ITS target's mean.
        means = [0.0, 4.0]
        targets = [Distribution.normal(m, 1.0) for m in means]
        proposals = [Distribution.normal(m, 2.0) for m in means]
        prog = integrator.compile_mcmc(
            [lambda x: x], targets[0], proposals[0], n_steps=1500,
            n_chains=1024, n_burnin=200, seed_batch=2, param_batch=True,
        )
        vals, _ = prog(
            SEEDS[:2], pack_param_batch(targets), pack_param_batch(proposals)
        )
        vals = np.asarray(vals)
        for row, m in zip(vals, means):
            assert abs(row[0] - m) < 0.1

    def test_custom_rejected(self, integrator):
        with pytest.raises(ValueError, match="analytic"):
            integrator.compile_mcmc(
                [lambda x: x], Distribution.beta(2.0, 5.0),
                Distribution.normal(0.0, 2.0), n_steps=100, n_chains=256,
                n_burnin=10, param_batch=True,
            )


class TestParamBatchSharded:
    def test_sharded_sweep_tracks_parameters(self):
        # The sweep through an 8-device mesh program (psum across devices) must
        # still route each parameter row to its batch element.  (Plans
        # re-round for the device count, so mesh-vs-single is a
        # statistical check, not a bit-equality one — the bit-equality
        # same-plan mesh test lives in test_sharding.py.)
        dists = [Distribution.normal(0.0, 1.0), Distribution.normal(2.0, 3.0)]
        fns = [lambda x: x, lambda x: x * x]
        prog = MonteCarloIntegrator(mesh="auto").compile_integrate(
            fns, dists[0], n_samples=800_000, seed_batch=2, param_batch=True
        )
        out = np.asarray(prog([7, 42], pack_param_batch(dists)))
        assert abs(out[0, 0] - 0.0) < 0.02
        assert abs(out[0, 1] - 1.0) < 0.02
        assert abs(out[1, 0] - 2.0) < 0.05
        assert abs(out[1, 1] - 13.0) < 0.2
