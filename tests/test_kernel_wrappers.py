"""The Triton kernels' wrappers and routing, on the CPU.

Covers the routing rule (kernels compile on the GPU, run in the
interpreter only on the CPU, and are refused elsewhere), the integrate
wrapper's shapes, padding, batches and K chaining, each kernel variant
against its plain-jnp reference on the same counter stream, and each
variant's lowering to Triton IR for the GPU.  Tests marked ``gpu``
compile the kernels on a card and skip without one.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import tpu_montecarlo as mc
from tpu_montecarlo.ops import integrate_pallas as ip
from tpu_montecarlo.ops.integrate_pallas import build_integrate_fn_pallas
from tpu_montecarlo.ops.mcmc_pallas import build_mcmc_fn_pallas
from tpu_montecarlo.sampling import DistKind, dist_spec_of
from tpu_montecarlo.tracing import trace_function
from tpu_montecarlo.utils.dispatch import make_integrate_plan

D = jnp.zeros(1, jnp.float32)


def _fns(n=2):
    return tuple(
        trace_function(f)
        for f in [lambda x: x, lambda x: x * x, lambda x: np.cos(x)][:n]
    )


def _while_fn(x):
    """A sample-dependent loop: traces, but no kernel can run it."""
    v = x * x + 2.0
    while v > 1.0:
        v = v * 0.5
    return v


def _lower_gpu(run, *args):
    return run.trace(*args).lower(lowering_platforms=("cuda",)).as_text()


class TestRouting:
    @pytest.mark.parametrize(
        "platform,expect", [("cpu", True), ("gpu", False)]
    )
    def test_interpret_only_on_cpu(self, monkeypatch, platform, expect):
        monkeypatch.setattr(jax, "default_backend", lambda: platform)
        assert ip.interpret_mode() is expect

    def test_other_platforms_refused(self, monkeypatch):
        monkeypatch.setattr(jax, "default_backend", lambda: "rocm")
        with pytest.raises(RuntimeError, match="'gpu' and 'cpu'"):
            ip.interpret_mode()
        with pytest.raises(RuntimeError):
            mc.MonteCarloIntegrator(backend="pallas").integrate(
                [lambda x: x], mc.Distribution.normal(0.0, 1.0),
                n_samples=1000,
            )

    @pytest.mark.parametrize(
        "backend,platform,expect",
        [
            ("auto", "cpu", False),
            ("auto", "gpu", True),
            ("xla", "gpu", False),
            ("pallas", "cpu", True),
            ("pallas", "gpu", True),
        ],
    )
    def test_backend_choice(self, monkeypatch, backend, platform, expect):
        integ = mc.MonteCarloIntegrator(backend=backend)
        monkeypatch.setattr(jax, "default_backend", lambda: platform)
        assert integ._use_pallas(DistKind.NORMAL) is expect

    def test_nd_forced_pallas_warns_and_runs_xla(self):
        u = mc.Distribution.uniform(0.0, 1.0)
        with pytest.warns(UserWarning, match="no Pallas kernel"):
            r = mc.MonteCarloIntegrator(backend="pallas").integrate(
                [lambda x, y: x * y], [u, u], n_samples=100_000, seed=1
            )
        assert abs(r.values[0] - 0.25) < 0.01

    @pytest.mark.parametrize(
        "workload",
        ["nd_integrate", "while_fn", "nd_mcmc", "tempered",
         "mcmc_while_fn", "expectation_fn"],
    )
    def test_forced_pallas_without_kernel_raises_on_gpu(
        self, monkeypatch, workload
    ):
        """On the GPU a forced backend='pallas' either builds the Triton
        kernel or raises; it never quietly runs the XLA builder."""
        n = mc.Distribution.normal(0.0, 1.0)
        kw = dict(n_steps=20, n_chains=128, n_burnin=5)
        integ = mc.MonteCarloIntegrator(backend="pallas")
        calls = {
            "nd_integrate": lambda: integ.integrate(
                [lambda x, y: x * y], [n, n], n_samples=1000
            ),
            "while_fn": lambda: integ.integrate(
                [_while_fn], n, n_samples=1000
            ),
            "nd_mcmc": lambda: integ.integrate_mcmc(
                [lambda x, y: x * y], [n, n],
                [mc.Distribution.normal(0.0, 2.0)] * 2, **kw
            ),
            "tempered": lambda: integ.integrate_mcmc(
                [lambda x: x * x], n, mc.RandomWalk(step_size=1.0),
                temperatures=[1.0, 4.0], **kw
            ),
            "mcmc_while_fn": lambda: integ.integrate_mcmc(
                [_while_fn], n, mc.Distribution.normal(0.0, 2.0), **kw
            ),
            "expectation_fn": lambda: integ.expectation_fn(
                [lambda x: x], n, n_samples=1000
            ),
        }
        monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
        with pytest.raises(ValueError, match="backend='pallas' requested"):
            calls[workload]()


class TestIntegrateWrapper:
    @pytest.mark.parametrize(
        "k,stderr,block",
        [(1, False, 1024), (8, False, 1024), (16, False, 512),
         (8, True, 512), (64, False, 128), (64, True, 128)],
    )
    def test_block_register_budget(self, k, stderr, block):
        assert ip.pick_block(k, stderr) == block

    @pytest.mark.parametrize("block", [128, 512, 1024])
    def test_grid_padding_covers_request(self, block):
        for n in (1, 1000, 65_536, 10_000_001, 1_000_000_000):
            programs, loops, actual = ip.plan_pallas_grid(n, block)
            assert actual >= n and actual == programs * loops * block
            assert loops <= ip.MAX_LOOPS_PER_PROGRAM
            # Padding stays under one program's worth of blocks.
            assert actual - n < loops * block

    def test_actual_samples_reported(self):
        plan = make_integrate_plan(300_000)
        run = build_integrate_fn_pallas(
            _fns(), DistKind.NORMAL, plan, interpret=True
        )
        assert run.actual_samples >= plan.actual_samples
        assert run.actual_samples % ip.pick_block(2) == 0

    @pytest.mark.parametrize("backend", ["xla", "pallas"])
    def test_handle_reports_actual_samples(self, backend):
        prog = mc.MonteCarloIntegrator(backend=backend).compile_integrate(
            [lambda x: x], mc.Distribution.normal(0.0, 1.0),
            n_samples=300_000,
        )
        assert prog.actual_samples >= 300_000
        if backend == "pallas":
            assert prog.actual_samples % ip.pick_block(1) == 0

    def test_seed_batch_rows_equal_single_calls(self):
        plan = make_integrate_plan(100_000)
        p = jnp.asarray([0.0, 1.0], jnp.float32)
        batched = build_integrate_fn_pallas(
            _fns(), DistKind.NORMAL, plan, interpret=True, seed_batch=3
        )
        single = build_integrate_fn_pallas(
            _fns(), DistKind.NORMAL, plan, interpret=True
        )
        out = np.asarray(batched(np.asarray([4, 5, 6], np.uint32), p, D, D))
        assert out.shape == (3, 2)
        for r, s in enumerate((4, 5, 6)):
            np.testing.assert_array_equal(
                out[r], np.asarray(single(np.uint32(s), p, D, D))
            )

    def test_param_batch_rows(self):
        plan = make_integrate_plan(100_000)
        rows = jnp.asarray([[0.0, 1.0], [2.0, 0.5]], jnp.float32)
        batched = build_integrate_fn_pallas(
            _fns(), DistKind.NORMAL, plan, interpret=True, seed_batch=2,
            param_batch=True,
        )
        single = build_integrate_fn_pallas(
            _fns(), DistKind.NORMAL, plan, interpret=True
        )
        seeds = np.asarray([8, 9], np.uint32)
        out = np.asarray(batched(seeds, rows, D, D))
        for r in range(2):
            np.testing.assert_array_equal(
                out[r], np.asarray(single(seeds[r], rows[r], D, D))
            )
        assert abs(out[1, 0] - 2.0) < 0.02

    def test_k_chaining_past_max_fused(self):
        # K > MAX_FUSED chains passes over one stream: identical
        # integrands in different passes give bit-identical means.
        k = ip.MAX_FUSED + 6
        fns = [lambda x: x * x] * k
        r = mc.MonteCarloIntegrator(backend="pallas").integrate(
            fns, mc.Distribution.normal(0.0, 1.0), n_samples=100_000,
            seed=3,
        )
        assert r.values.shape == (k,)
        assert np.all(r.values == r.values[0])
        assert abs(r.values[0] - 1.0) < 0.03


INTEGRATE_VARIANTS = {
    "normal_mc": dict(kind="normal", method="mc"),
    "normal_qmc_stderr": dict(kind="normal", method="qmc", with_stderr=True),
    "normal_antithetic_stderr": dict(
        kind="normal", method="antithetic", with_stderr=True
    ),
    "exponential_mc": dict(kind="exponential", method="mc"),
    "cauchy_mc": dict(kind="cauchy", method="mc"),
    "table_mc_stderr": dict(kind="beta_table", method="mc", with_stderr=True),
    "table_antithetic": dict(kind="beta_table", method="antithetic"),
    "is_traced_weights": dict(kind="normal", method="mc", weights="traced"),
    "is_table_weights": dict(kind="normal", method="mc", weights="table"),
    "is_sampler_weights": dict(
        kind="beta_table", method="mc", weights="sampler"
    ),
}


def _integrate_case(name, interpret, reference=False):
    v = dict(INTEGRATE_VARIANTS[name])
    kind_name = v.pop("kind")
    weights = v.pop("weights", None)
    extra = ()
    if kind_name == "beta_table":
        spec = dist_spec_of(mc.Distribution.beta(2.0, 5.0))
        kind = DistKind.CUSTOM
        args = (jnp.asarray(spec.params), jnp.asarray(spec.x_table),
                jnp.asarray(spec.cdf_table))
    else:
        kind = {
            "normal": DistKind.NORMAL,
            "exponential": DistKind.EXPONENTIAL,
            "cauchy": DistKind.CAUCHY,
        }[kind_name]
        params = [2.0, 0.0] if kind_name == "exponential" else [0.0, 1.0]
        args = (jnp.asarray(params, jnp.float32), D, D)
    is_weight = None
    if weights == "traced":
        is_weight = (
            trace_function(lambda x: np.exp(-0.5 * x * x) * 0.39894228),
            trace_function(lambda x: np.exp(-0.5 * x * x) * 0.39894228),
        )
    elif weights == "table":
        xs = jnp.linspace(-6.0, 6.0, 600)
        pdf = jnp.exp(-0.5 * xs * xs) * 0.39894228
        is_weight = ("table", "table")
        extra = (xs, pdf, xs, pdf)
    elif weights == "sampler":
        xs = jnp.linspace(0.0, 1.0, 300)
        is_weight = ("table", "sampler")
        extra = (xs, jnp.ones_like(xs))
    plan = make_integrate_plan(131_072)
    run = build_integrate_fn_pallas(
        _fns(3), kind, plan, interpret=interpret, reference=reference,
        is_weight=is_weight, **v,
    )
    return run, (np.uint32(21),) + args + extra


@pytest.mark.parametrize("name", sorted(INTEGRATE_VARIANTS))
def test_integrate_kernel_matches_reference(name):
    kern, args = _integrate_case(name, True)
    ref, _ = _integrate_case(name, None, reference=True)
    got = jax.tree_util.tree_map(np.asarray, kern(*args))
    want = jax.tree_util.tree_map(np.asarray, ref(*args))
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        assert np.all(np.isfinite(g))
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", sorted(INTEGRATE_VARIANTS))
def test_integrate_kernel_lowers_for_gpu(name):
    kern, args = _integrate_case(name, False)
    assert "triton" in _lower_gpu(kern, *args)


MCMC_VARIANTS = {
    "independence": dict(),
    "stderr": dict(with_stderr=True),
    "diagnostics": dict(with_stderr=True, with_diagnostics=True),
    "random_walk": dict(random_walk=True),
    "rw_adapt": dict(random_walk=True, rw_adapt=True),
    "hmc": dict(random_walk=True, hmc_leapfrog=4, rw_adapt=True),
    "table_target": dict(table_target=True),
    "hmc_table_target": dict(
        table_target=True, random_walk=True, hmc_leapfrog=3
    ),
    "table_proposal_sampler_logq": dict(table_prop=True),
    "stateful_resume": dict(with_state=True, use_init_state=True),
    "seed_batch": dict(seed_batch=2),
    "param_batch": dict(seed_batch=2, param_batch=True),
}


def _mcmc_case(name, interpret, reference=False):
    v = dict(MCMC_VARIANTS[name])
    table_target = v.pop("table_target", False)
    table_prop = v.pop("table_prop", False)
    rw = v.get("random_walk", False)
    beta = mc.Distribution.beta(2.0, 5.0)
    spec = dist_spec_of(beta)
    pkind, tkind = DistKind.NORMAL, DistKind.NORMAL
    prop = [0.5, -1.0, 1.0, 0.5] if rw else [0.0, 2.0]
    targ = [0.0, 1.0]
    tables = [D] * 6
    if table_target:
        from tpu_montecarlo.api.device import _device_uniform_log_tables

        tkind = DistKind.CUSTOM
        tables[2:4] = _device_uniform_log_tables(beta)
        prop = [0.05, 0.1, 0.9, 0.6] if rw else [0.0, 1.0]
        pkind = DistKind.UNIFORM
    if table_prop:
        pkind = DistKind.CUSTOM
        tables[0] = jnp.asarray(spec.x_table)
    batch = v.get("seed_batch", 1)
    seed = (
        np.asarray([3, 4], np.uint32) if batch > 1 else np.uint32(3)
    )
    prop_a = jnp.asarray(prop, jnp.float32)
    targ_a = jnp.asarray(targ, jnp.float32)
    if v.get("param_batch"):
        prop_a = jnp.stack([prop_a, prop_a * 1.1])
        targ_a = jnp.asarray([[0.0, 1.0], [1.0, 2.0]], jnp.float32)
    state = ()
    if v.get("with_state"):
        x0 = jnp.linspace(-1.0, 1.0, 256, dtype=jnp.float32)
        state = (x0, -0.5 * x0 * x0, 1)
    run = build_mcmc_fn_pallas(
        _fns(2), pkind, tkind, 60, 20, 256, interpret=interpret,
        reference=reference, **v,
    )
    return run, (seed, prop_a, targ_a, *tables, *state)


@pytest.mark.parametrize("name", sorted(MCMC_VARIANTS))
def test_mcmc_kernel_matches_reference(name):
    kern, args = _mcmc_case(name, True)
    ref, _ = _mcmc_case(name, None, reference=True)
    got = jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(np.asarray, kern(*args))
    )
    want = jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(np.asarray, ref(*args))
    )
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.all(np.isfinite(g))
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", sorted(MCMC_VARIANTS))
def test_mcmc_kernel_lowers_for_gpu(name):
    kern, args = _mcmc_case(name, False)
    assert "triton" in _lower_gpu(kern, *args)


def test_mcmc_draws_are_post_step_states():
    """Thinned draws are stored from registers: the run's estimates equal
    the draw-free run's, and the draws have the thinning grid's shape."""
    kw = dict(interpret=True)
    args = (np.uint32(3), jnp.asarray([0.0, 2.0]), jnp.asarray([0.0, 1.0]),
            *[D] * 6)
    plain = build_mcmc_fn_pallas(
        _fns(1), DistKind.NORMAL, DistKind.NORMAL, 40, 10, 256, **kw
    )(*args)
    vals, acc, draws = build_mcmc_fn_pallas(
        _fns(1), DistKind.NORMAL, DistKind.NORMAL, 40, 10, 256,
        with_samples=5, **kw
    )(*args)
    np.testing.assert_array_equal(np.asarray(vals), np.asarray(plain[0]))
    assert np.asarray(draws).shape == (5, 256)
    assert abs(float(np.mean(np.asarray(draws) ** 2)) - 1.0) < 0.3


@pytest.mark.gpu
def test_integrate_kernel_on_gpu(gpu):
    kern, args = _integrate_case("table_mc_stderr", False)
    ref, _ = _integrate_case("table_mc_stderr", None, reference=True)
    got, want = kern(*args), ref(*args)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                   rtol=1e-4, atol=1e-6)


@pytest.mark.gpu
def test_mcmc_kernel_on_gpu(gpu):
    kern, args = _mcmc_case("hmc_table_target", False)
    ref, _ = _mcmc_case("hmc_table_target", None, reference=True)
    got, want = kern(*args), ref(*args)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                   rtol=1e-4, atol=1e-6)
