"""Parallel tempering (``temperatures=[1.0, ...]`` on integrate_mcmc).

Replica exchange is a capability beyond the reference (whose MCMC is a
1-D independence sampler, src/shader_gen.rs:466-539) and beyond plain
local samplers: hot rungs run against flattened targets
``p(x)^(1/T)``, adjacent rungs exchange states, and the cold rung's
chains mix across modes that trap an untempered walk.

Covered: the multimodal escape itself (a plain walk provably stuck on
one mode of a mixture vs the tempered run recovering both moments, on
traced joint, table, and 2-D joint targets), statistical neutrality on
unimodal targets, HMC tempering, the swap-rate diagnostic, composition
with stderr / diagnostics / adaptation, the sharded path, and the
validation surface.
"""

import math

import numpy as np
import pytest

from tpu_montecarlo import (
    Distribution,
    HMC,
    MonteCarloIntegrator,
    RandomWalk,
    integrate_mcmc,
)

LADDER = [1.0, 2.0, 4.0, 8.0, 16.0]


def logmix(x):
    # 0.5 N(-4,1) + 0.5 N(4,1): E[X] = 0, E[X^2] = 17.  The ~8-sigma
    # barrier at x=0 is impassable for a step-0.5 walk within any
    # reasonable run.
    return math.log(
        math.exp(-0.5 * (x + 4.0) ** 2) + math.exp(-0.5 * (x - 4.0) ** 2)
    )


@pytest.fixture(scope="module")
def integ():
    return MonteCarloIntegrator()


class TestMultimodalEscape:
    def test_plain_walk_traps_tempered_escapes(self, integ):
        # Init every chain in the RIGHT mode's basin: the plain walk
        # never finds the left mode; the tempered run recovers the
        # global moments.
        walk = RandomWalk(step_size=0.5, init_range=(3.0, 5.0))
        plain = integ.integrate_mcmc(
            [lambda x: x], logmix, walk,
            n_steps=2000, n_chains=512, n_burnin=500, seed=1,
        )
        assert plain.values[0] > 3.0  # trapped at the right mode
        pt = integ.integrate_mcmc(
            [lambda x: x, lambda x: x * x], logmix,
            RandomWalk(step_size=0.5, adapt=True, init_range=(3.0, 5.0)),
            n_steps=2000, n_chains=512, n_burnin=500, seed=1,
            temperatures=LADDER,
        )
        assert abs(pt.values[0]) < 0.4
        assert abs(pt.values[1] - 17.0) < 0.8

    def test_table_target_mixture(self, integ):
        # Same physics through the CUSTOM (table) target path: the
        # tempered kernel reads the -100-floored log-pdf table.
        target = Distribution.from_pdf(
            lambda x: np.exp(-0.5 * (x + 4.0) ** 2)
            + np.exp(-0.5 * (x - 4.0) ** 2),
            support=(-9.0, 9.0),
        )
        pt = integ.integrate_mcmc(
            [lambda x: x * x], target,
            RandomWalk(step_size=0.5, adapt=True, init_range=(3.0, 5.0)),
            n_steps=2000, n_chains=512, n_burnin=500, seed=3,
            temperatures=LADDER,
        )
        assert abs(pt.values[0] - 17.0) < 0.8

    def test_2d_joint_mixture(self, integ):
        # Two Gaussian islands at (+-3, +-3); E[x] = E[y] = 0 and
        # E[xy] = 9 only if chains visit both.
        def logmix2(x, y):
            return math.log(
                math.exp(-0.5 * ((x - 3.0) ** 2 + (y - 3.0) ** 2))
                + math.exp(-0.5 * ((x + 3.0) ** 2 + (y + 3.0) ** 2))
            )

        pt = integ.integrate_mcmc(
            [lambda x, y: x, lambda x, y: x * y], logmix2,
            RandomWalk(
                step_size=0.5, adapt=True, init_range=(2.0, 4.0)
            ),
            n_steps=3000, n_chains=512, n_burnin=500, seed=4,
            temperatures=LADDER,
        )
        assert abs(pt.values[0]) < 0.5
        # Per mode x,y are independent: E[xy] = mu_x * mu_y = 9 in both.
        assert abs(pt.values[1] - 9.0) < 1.0

    def test_hmc_tempered(self, integ):
        pt = integ.integrate_mcmc(
            [lambda x: x], logmix,
            HMC(step_size=0.3, n_leapfrog=5, init_range=(3.0, 5.0)),
            n_steps=2000, n_chains=512, n_burnin=500, seed=5,
            temperatures=LADDER,
        )
        assert abs(pt.values[0]) < 0.4
        assert pt.acceptance_rate > 0.6


class TestTemperedStatistics:
    def test_unimodal_neutrality(self, integ):
        # On an easy target, tempering must not bias anything.
        pt = integ.integrate_mcmc(
            [lambda x: x, lambda x: x * x],
            Distribution.normal(3.0, 2.0),
            RandomWalk(step_size=2.0),
            n_steps=3000, n_chains=512, n_burnin=500, seed=6,
            temperatures=[1.0, 3.0, 9.0],
        )
        assert abs(pt.values[0] - 3.0) < 0.15
        assert abs(pt.values[1] - 13.0) < 0.6

    def test_product_target(self, integ):
        pt = integ.integrate_mcmc(
            [lambda x, y: x + y],
            [Distribution.normal(1.0, 1.0), Distribution.normal(2.0, 1.0)],
            RandomWalk(step_size=1.5),
            n_steps=3000, n_chains=512, n_burnin=500, seed=7,
            temperatures=[1.0, 3.0, 9.0],
        )
        assert abs(pt.values[0] - 3.0) < 0.2

    def test_swap_rate_surfaced_and_sane(self, integ):
        pt = integ.integrate_mcmc(
            [lambda x: x], Distribution.normal(0.0, 1.0),
            RandomWalk(step_size=2.0),
            n_steps=1000, n_chains=256, n_burnin=100, seed=8,
            temperatures=[1.0, 2.0],
        )
        assert pt.diagnostics is not None
        assert 0.0 < pt.diagnostics["swap_rate"] <= 1.0

    def test_wide_ladder_low_swap_rate(self, integ):
        # Non-overlapping rungs barely exchange: the diagnostic must
        # order a tight ladder above a sparse one.
        tight = integ.integrate_mcmc(
            [lambda x: x], Distribution.normal(0.0, 1.0),
            RandomWalk(step_size=2.0),
            n_steps=1000, n_chains=256, n_burnin=100, seed=9,
            temperatures=[1.0, 1.5],
        )
        sparse = integ.integrate_mcmc(
            [lambda x: x], Distribution.normal(0.0, 1.0),
            RandomWalk(step_size=2.0),
            n_steps=1000, n_chains=256, n_burnin=100, seed=9,
            temperatures=[1.0, 500.0],
        )
        assert (
            tight.diagnostics["swap_rate"]
            > sparse.diagnostics["swap_rate"]
        )

    def test_module_level_entry(self):
        pt = integrate_mcmc(
            [lambda x: x], Distribution.normal(-1.0, 1.0),
            RandomWalk(step_size=2.0),
            n_steps=1500, n_chains=256, n_burnin=200, seed=10,
            temperatures=[1.0, 4.0],
        )
        assert abs(pt.values[0] + 1.0) < 0.2


class TestTemperedComposition:
    def test_stderr_covers_truth(self, integ):
        pt = integ.integrate_mcmc(
            [lambda x: x], logmix,
            RandomWalk(step_size=0.5, adapt=True, init_range=(3.0, 5.0)),
            n_steps=2000, n_chains=512, n_burnin=500, seed=11,
            temperatures=LADDER, return_stderr=True,
        )
        assert pt.stderr is not None and pt.stderr[0] > 0
        assert abs(pt.values[0]) < 6.0 * pt.stderr[0] + 0.1

    def test_diagnostics_flag_the_trapped_run(self, integ):
        # Overdispersed init across BOTH basins: the plain walk's
        # chains freeze in whichever mode they started (split-R-hat
        # >> 1); tempering repairs exactly that.
        walk = RandomWalk(step_size=0.5, init_range=(-5.0, 5.0))
        plain = integ.integrate_mcmc(
            [lambda x: x], logmix, walk,
            n_steps=2000, n_chains=512, n_burnin=500, seed=12,
            return_diagnostics=True,
        )
        pt = integ.integrate_mcmc(
            [lambda x: x], logmix, walk,
            n_steps=2000, n_chains=512, n_burnin=500, seed=12,
            temperatures=LADDER, return_diagnostics=True,
        )
        assert plain.diagnostics["r_hat"][0] > 1.5
        assert pt.diagnostics["r_hat"][0] < 1.1
        assert pt.diagnostics["ess"][0] > 100.0

    def test_samples_visit_both_modes(self, integ):
        # Thinned cold-rung draws must cover BOTH mixture components —
        # the raw-sample witness of the multimodal escape.
        pt = integ.integrate_mcmc(
            [lambda x: x], logmix,
            RandomWalk(step_size=0.5, adapt=True, init_range=(3.0, 5.0)),
            n_steps=2000, n_chains=512, n_burnin=500, seed=15,
            temperatures=LADDER, return_samples=20,
        )
        s = np.asarray(pt.samples)
        assert s.shape == (20, 512, 1)  # joint-fn target keeps d
        frac_left = float(np.mean(s < 0.0))
        assert 0.3 < frac_left < 0.7

    def test_samples_shape_1d_distribution_target(self, integ):
        pt = integ.integrate_mcmc(
            [lambda x: x], Distribution.normal(2.0, 1.0),
            RandomWalk(step_size=1.5),
            n_steps=400, n_chains=256, n_burnin=100, seed=16,
            temperatures=[1.0, 4.0], return_samples=8,
        )
        s = np.asarray(pt.samples)
        assert s.shape == (8, 256)
        assert abs(s.mean() - 2.0) < 0.3

    def test_program_cache_reuse_across_steps(self, integ):
        # Walk rows are runtime args: two step sizes reuse one program.
        kw = dict(
            n_steps=500, n_chains=256, n_burnin=100, seed=13,
            temperatures=[1.0, 4.0],
        )
        a = integ.integrate_mcmc(
            [lambda x: x], Distribution.normal(0.0, 1.0),
            RandomWalk(step_size=1.0), **kw,
        )
        b = integ.integrate_mcmc(
            [lambda x: x], Distribution.normal(0.0, 1.0),
            RandomWalk(step_size=2.5), **kw,
        )
        assert abs(a.values[0]) < 0.2 and abs(b.values[0]) < 0.2


class TestTemperedSharded:
    def test_mesh_run(self, mesh8):
        integ = MonteCarloIntegrator(mesh=mesh8)
        pt = integ.integrate_mcmc(
            [lambda x: x, lambda x: x * x], logmix,
            RandomWalk(step_size=0.5, adapt=True, init_range=(3.0, 5.0)),
            n_steps=2000, n_chains=512, n_burnin=500, seed=14,
            temperatures=LADDER, return_stderr=True,
        )
        assert abs(pt.values[0]) < 0.4
        assert abs(pt.values[1] - 17.0) < 0.8
        assert 0.0 < pt.diagnostics["swap_rate"] <= 1.0


class TestTemperedIndependence:
    """Round 5: the reference's native INDEPENDENCE proposal tempers too
    — acceptance ``beta (logp' - logp) + logq - logq'`` (q's terms stay
    untempered), logq exchanges with the state on a swap.  Analytic
    proposals ride the kernel; CUSTOM proposals take the XLA sweep."""

    @pytest.fixture(scope="class")
    def integ_p(self):
        return MonteCarloIntegrator(backend="pallas")

    def test_compiled_handle(self, integ_p):
        prog = integ_p.compile_mcmc(
            [lambda v: v], Distribution.normal(1.0, 1.0),
            Distribution.normal(1.0, 3.0),
            n_steps=300, n_chains=512, n_burnin=50,
            temperatures=[1.0, 2.0], seed_batch=2,
        )
        v, a, sw = prog(np.arange(2, dtype=np.uint32))
        assert abs(float(np.asarray(v)[0, 0]) - 1.0) < 0.1
        assert 0.0 <= float(np.asarray(sw)[0]) <= 1.0

    def test_adapt_and_hmc_stay_walk_only(self, integ):
        from tpu_montecarlo.ops.mcmc_pt import build_pt_mcmc_fn
        from tpu_montecarlo.sampling import DistKind

        with pytest.raises(ValueError, match="walk-only"):
            build_pt_mcmc_fn(
                [lambda x: x], 1, (1.0, 0.5), 10, 2, 256,
                targ_kinds=(DistKind.NORMAL,),
                prop_kinds=(DistKind.NORMAL,), rw_adapt=True,
            )


class TestTemperedValidation:

    @pytest.mark.parametrize(
        "temps",
        [[1.0], [2.0, 4.0], [1.0, 4.0, 2.0], [1.0, 1.0], [1.0, float("inf")]],
    )
    def test_bad_ladders(self, integ, temps):
        with pytest.raises(ValueError):
            integ.integrate_mcmc(
                [lambda x: x], Distribution.normal(0.0, 1.0),
                RandomWalk(step_size=1.0),
                n_steps=100, n_chains=64, n_burnin=10,
                temperatures=temps,
            )

    def test_stateless_only(self, integ):
        with pytest.raises(ValueError, match="stateless"):
            integ.integrate_mcmc(
                [lambda x: x], Distribution.normal(0.0, 1.0),
                RandomWalk(step_size=1.0),
                n_steps=100, n_chains=64, n_burnin=10,
                temperatures=[1.0, 2.0], return_state=True,
            )

    def test_bad_samples_count(self, integ):
        with pytest.raises(ValueError, match="return_samples"):
            integ.integrate_mcmc(
                [lambda x: x], Distribution.normal(0.0, 1.0),
                RandomWalk(step_size=1.0),
                n_steps=100, n_chains=64, n_burnin=10,
                temperatures=[1.0, 2.0], return_samples=101,
            )

    def test_joint_target_needs_init_range(self, integ):
        with pytest.raises(ValueError, match="init_range"):
            integ.integrate_mcmc(
                [lambda x: x], logmix, RandomWalk(step_size=1.0),
                n_steps=100, n_chains=64, n_burnin=10,
                temperatures=[1.0, 2.0],
            )


class TestTemperedKernelSamples:
    """Cold-rung draws under backend='pallas': tempered runs have no
    kernel, so they take the XLA builder (with a warning) and keep the
    draw surface."""

    @pytest.fixture(scope="class")
    def integ_p(self):
        return MonteCarloIntegrator(backend="pallas")

    def test_kernel_draws_1d_distribution_target_shape(self, integ_p):
        pt = integ_p.integrate_mcmc(
            [lambda x: x], Distribution.normal(2.0, 1.0),
            RandomWalk(step_size=1.5, init_range=(-2.0, 6.0)),
            n_steps=400, n_chains=256, n_burnin=100, seed=16,
            temperatures=[1.0, 4.0], return_samples=8,
        )
        s = np.asarray(pt.samples)
        from tpu_montecarlo.ops.mcmc_pallas import plan_mcmc_grid

        _, _, chains_actual = plan_mcmc_grid(256)
        assert s.shape == (8, chains_actual)  # 1-D target squeezes d
        assert abs(s.mean() - 2.0) < 0.3

    def test_kernel_draws_sharded(self, mesh8):
        integ = MonteCarloIntegrator(backend="pallas", mesh=mesh8)
        pt = integ.integrate_mcmc(
            [lambda x: x * x], logmix,
            RandomWalk(step_size=0.5, adapt=True,
                       init_range=(3.0, 5.0)),
            n_steps=300, n_chains=1024, n_burnin=150, seed=9,
            temperatures=[1.0, 2.0, 4.0, 8.0, 16.0],
            return_samples=5,
        )
        s = np.asarray(pt.samples)
        assert s.shape[0] == 5
        assert abs(float(np.mean(s * s)) - 17.0) < 2.5


class TestTemperedCompile:
    """``compile_mcmc(temperatures=[...])`` — the tempered serving
    handle: prog(seed) -> (values, acceptance, swap_rate), seed_batch=R
    batching R tempered runs as the kernel's leading grid dimension
    (each rep seeded exactly like its unbatched call)."""

    @pytest.fixture(scope="class")
    def integ_p(self):
        return MonteCarloIntegrator(backend="pallas")

    KW = dict(n_steps=120, n_chains=128, n_burnin=40,
              temperatures=[1.0, 2.0, 4.0])

    def test_handle_matches_integrate_mcmc(self, integ_p):
        walk = RandomWalk(step_size=0.5, adapt=True,
                          init_range=(3.0, 5.0))
        prog = integ_p.compile_mcmc(
            [lambda x: x, lambda x: x * x], logmix, walk, **self.KW
        )
        vals, acc, sw = prog(7)
        ref = integ_p.integrate_mcmc(
            [lambda x: x, lambda x: x * x], logmix, walk,
            seed=7, **self.KW,
        )
        np.testing.assert_allclose(
            np.asarray(vals), ref.values, rtol=1e-6
        )
        assert abs(float(acc) - ref.acceptance_rate) < 1e-6
        assert abs(float(sw) - ref.diagnostics["swap_rate"]) < 1e-6

    def test_seed_batched_rows_match_unbatched(self, integ_p):
        walk = RandomWalk(step_size=0.5, init_range=(3.0, 5.0))
        args = ([lambda x: x * x], logmix, walk)
        prog = integ_p.compile_mcmc(*args, seed_batch=3, **self.KW)
        vals, acc, sw = prog([11, 12, 13])
        assert np.asarray(vals).shape == (3, 1)
        assert np.asarray(acc).shape == (3,)
        single = integ_p.compile_mcmc(*args, **self.KW)
        for r, seed in enumerate((11, 12, 13)):
            v1, a1, s1 = single(seed)
            np.testing.assert_allclose(
                np.asarray(vals)[r], np.asarray(v1), rtol=1e-6
            )
            np.testing.assert_allclose(
                float(np.asarray(acc)[r]), float(a1), rtol=1e-6
            )
            np.testing.assert_allclose(
                float(np.asarray(sw)[r]), float(s1), rtol=1e-6
            )

    def test_analytic_target_estimates(self, integ_p):
        prog = integ_p.compile_mcmc(
            [lambda x: x, lambda x: x * x],
            Distribution.normal(1.0, 2.0),
            RandomWalk(step_size=1.0, adapt=True,
                       init_range=(-3.0, 5.0)),
            n_steps=400, n_chains=512, n_burnin=150,
            temperatures=[1.0, 3.0],
        )
        vals, _, _ = prog(2)
        assert abs(float(vals[0]) - 1.0) < 0.3
        assert abs(float(vals[1]) - 5.0) < 1.2

    def test_param_batch_rejected(self, integ_p):
        with pytest.raises(ValueError, match="param_batch"):
            integ_p.compile_mcmc(
                [lambda x: x], logmix,
                RandomWalk(step_size=0.5, init_range=(3.0, 5.0)),
                param_batch=True, **self.KW,
            )

    def test_bad_ladder_rejected(self, integ_p):
        for temps in ([1.0], [2.0, 4.0], [1.0, 4.0, 2.0]):
            with pytest.raises(ValueError, match="temperatures"):
                integ_p.compile_mcmc(
                    [lambda x: x], logmix,
                    RandomWalk(step_size=0.5, init_range=(3.0, 5.0)),
                    n_steps=100, n_chains=128, n_burnin=20,
                    temperatures=temps,
                )
