#!/usr/bin/env python3
"""Smoke test of the library on a GPU: the quickest proof that it starts.

Phases, in one process (``nvidia-smi`` is its only child):

1. device   — a GPU is required; prints the card, JAX and XLA_FLAGS.
2. kernels  — each Pallas kernel compiled for the card at the headline
               and c5 shapes, checked against its plain-jnp reference fed
               by the same counter stream and against the XLA builder.
3. main     — the public entry points at the sizes the reference runs,
               then the reference-derived parity checks
               (``benchmarks/parity.py --quick``).
4. timing   — each kernel against the XLA builder for the same workload
               (median of 5 timed calls, compile excluded).

Any failed phase exits non-zero.  The last line of standard output is
``{"ok": true, "device": {...}}`` with the device as JAX reports it.

Run:  python chip_smoke.py                 (one GPU, every phase)
      python chip_smoke.py --four-cards    (the 4-GPU mesh path only)
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

# The sizes the reference and its users run (BASELINE.md).
HEADLINE = 1_000_000_000
K2, K2_BATCH = 1_000_000, 64
TABLE = 10_000_000
IS_RARE = 100_000_000
QMC = 100_000_000
CHAINS, STEPS, BURNIN = 4096, 10_000, 1_000
ND = 1_000_000
SCALE_REF = 10_000_000
MCMC_BATCH = 8

FAILURES = []


def check(name, ok, detail):
    print(f"[{'PASS' if ok else 'FAIL'}] {name}: {detail}", flush=True)
    if not ok:
        FAILURES.append(name)
    return ok


def card():
    """Name and power limit of the card, read by a child that does not
    import JAX; None when nvidia-smi cannot read them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None


def median_time(fn, *args, repeats=5):
    """Median wall time of ``repeats`` calls that end in
    block_until_ready; the first (compiling) call is excluded."""
    import jax

    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def headline_fns():
    import numpy as _np

    return [
        lambda x: x,
        lambda x: x * x,
        lambda x: x * x * x,
        lambda x: x * x * x * x,
        lambda x: _np.sin(x),
        lambda x: _np.exp(-x * x),
        lambda x: x > 1.0,
        lambda x: abs(x),
    ]


# E[f(X)], X ~ N(0, 1), for headline_fns.
HEADLINE_TRUTH = [
    0.0, 1.0, 0.0, 3.0, 0.0, 1.0 / math.sqrt(3.0),
    0.5 * math.erfc(1.0 / math.sqrt(2.0)), math.sqrt(2.0 / math.pi),
]


def bimodal(x):
    import math as m

    return m.exp(-0.5 * (x - 2.0) ** 2) + m.exp(-0.5 * (x + 2.0) ** 2)


def tri_pdf(x):
    if 0 <= x <= 1:
        return x
    if 1 < x <= 2:
        return 2 - x
    return 0.0


def gap_pdf(x):
    """Uniform on [0, 1] and [2, 3]: a density with a zero span."""
    if 0.0 <= x <= 1.0 or 2.0 <= x <= 3.0:
        return 1.0
    return 0.0


def wide_pdf(x):
    return math.exp(-0.5 * (x / 3.0) ** 2)


def bump(x):
    return math.exp(-0.5 * ((x - 2.5) / 0.1) ** 2)


def hist_fns(k):
    """k indicator integrands, one per bin of [0, 1]."""
    edges = np.linspace(0.0, 1.0, k + 1)
    return [
        (lambda v, lo=float(lo), hi=float(hi): (v >= lo) * (v < hi))
        for lo, hi in zip(edges[:-1], edges[1:])
    ]


def memory_line(compiled):
    m = compiled.memory_analysis()
    if m is None:
        return "memory_analysis: n/a"
    return (
        f"memory_analysis: args {m.argument_size_in_bytes} B, "
        f"out {m.output_size_in_bytes} B, temp {m.temp_size_in_bytes} B, "
        f"code {m.generated_code_size_in_bytes} B"
    )


def peak_line():
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return f"peak_bytes_in_use: {stats.get('peak_bytes_in_use', 'n/a')}"


# ---------------------------------------------------------------------------
# phase 2: kernels at real widths
# ---------------------------------------------------------------------------


def phase_kernels():
    """Each kernel vs its same-stream jnp reference and vs the XLA
    builder.  There is no matrix product on these paths (no dot/einsum
    in tpu_montecarlo/), so TF32 never enters; every comparison is in
    float32."""
    import jax
    import jax.numpy as jnp

    import tpu_montecarlo as mc
    from tpu_montecarlo.ops.integrate_pallas import build_integrate_fn_pallas
    from tpu_montecarlo.ops.integrate_xla import build_integrate_fn
    from tpu_montecarlo.sampling import DistKind
    from tpu_montecarlo.tracing import trace_function
    from tpu_montecarlo.utils.dispatch import make_integrate_plan

    dummy = jnp.zeros(1, jnp.float32)
    params = jnp.asarray([0.0, 1.0], jnp.float32)
    traced = tuple(trace_function(f) for f in headline_fns())

    # E|f_k| on an independent stream sets the scale of the bound.
    abs_fns = tuple(
        (lambda x, f=f: jnp.abs(f(x).astype(jnp.float32))) for f in traced
    )
    scale = np.asarray(build_integrate_fn(
        abs_fns, DistKind.NORMAL, make_integrate_plan(SCALE_REF)
    )(np.uint32(7), params, dummy, dummy), np.float64)

    plan = make_integrate_plan(HEADLINE)
    kern = build_integrate_fn_pallas(
        traced, DistKind.NORMAL, plan, with_stderr=True
    )
    ref = build_integrate_fn_pallas(
        traced, DistKind.NORMAL, plan, with_stderr=True, reference=True
    )
    args = (np.uint32(2024), params, dummy, dummy)
    t0 = time.perf_counter()
    compiled = kern.lower(*args).compile()
    print(f"integrate kernel K=8 N(0,1) n={kern.actual_samples}: "
          f"compiled in {time.perf_counter() - t0:.1f} s; "
          f"{memory_line(compiled)}", flush=True)
    kv, ks = (np.asarray(a, np.float64) for a in compiled(*args))
    print(peak_line(), flush=True)
    rv, _ = (np.asarray(a, np.float64) for a in ref(*args))
    # Same draws: the two differ only in summation order and in the last
    # bits of the math functions (libdevice vs XLA), so the bound is
    # relative to E|f_k| — E[X] and E[X^3] are near 0.
    err = np.abs(kv - rv)
    check(
        "integrate kernel == same-stream jnp reference",
        bool(np.all(err <= 1e-4 * scale)),
        f"max |kernel-ref|/E|f| = {np.max(err / scale):.3g} "
        f"(bound 1e-4); kernel {np.round(kv, 6).tolist()}",
    )
    xv, xs = (
        np.asarray(a, np.float64)
        for a in build_integrate_fn(
            traced, DistKind.NORMAL, plan, with_stderr=True
        )(*args)
    )
    z = np.abs(kv - xv) / np.sqrt(ks ** 2 + xs ** 2 + 1e-30)
    check(
        "integrate kernel ~ XLA builder (threefry stream)",
        bool(np.all(z <= 5.0)),
        f"max |kernel-xla|/combined stderr = {np.max(z):.3g} (bound 5)",
    )

    from tpu_montecarlo.api.device import _device_uniform_log_tables
    from tpu_montecarlo.ops.mcmc_pallas import build_mcmc_fn_pallas

    table_target = mc.Distribution.from_pdf(bimodal, support=(-6.0, 6.0))
    cases = [
        ("analytic N(0,1) <- N(0,2)", DistKind.NORMAL,
         mc.Distribution.normal(0.0, 1.0), mc.Distribution.normal(0.0, 2.0),
         None),
        ("table bimodal <- U(-6,6)", DistKind.UNIFORM, table_target,
         mc.Distribution.uniform(-6.0, 6.0), table_target),
    ]
    fn = (trace_function(lambda x: x * x),)
    for name, pkind, target, prop, tab in cases:
        tkind = DistKind.CUSTOM if tab is not None else DistKind.NORMAL
        targ_p = jnp.asarray(
            [0.0, 1.0] if tab is None else [0.0, 0.0], jnp.float32
        )
        prop_p = jnp.asarray(
            [0.0, 2.0] if tab is None else [-6.0, 6.0], jnp.float32
        )
        lx, lp = (
            _device_uniform_log_tables(tab) if tab is not None
            else (dummy, dummy)
        )
        margs = (np.uint32(11), prop_p, targ_p, dummy, dummy, lx, lp,
                 dummy, dummy)
        build = dict(with_stderr=True)
        kern = build_mcmc_fn_pallas(
            fn, pkind, tkind, STEPS, BURNIN, CHAINS, **build
        )
        ref = build_mcmc_fn_pallas(
            fn, pkind, tkind, STEPS, BURNIN, CHAINS,
            reference=True, **build
        )
        t0 = time.perf_counter()
        compiled = kern.lower(*margs).compile()
        print(f"mcmc kernel {name} {CHAINS}x({STEPS}+{BURNIN}): "
              f"compiled in {time.perf_counter() - t0:.1f} s; "
              f"{memory_line(compiled)}", flush=True)
        kv, ka, ks = (np.asarray(a, np.float64) for a in compiled(*margs))
        rv, ra, _ = (np.asarray(a, np.float64) for a in ref(*margs))
        # f = x^2 >= 0, so E|f| is the estimate itself.  The bound also
        # absorbs an accept test that flips on a last-bit difference of
        # log/erf_inv: the flipped chain then follows another path, which
        # moves the chain average by ~1e-5 of E|f|.
        rel = np.abs(kv - rv) / np.abs(rv)
        check(
            f"mcmc kernel == same-stream jnp reference ({name})",
            bool(np.all(rel <= 1e-4)) and abs(ka - ra) <= 1e-4,
            f"|kernel-ref|/E|f| = {np.max(rel):.3g}, "
            f"accept {ka:.6f} vs {ra:.6f}",
        )
        rx = mc.MonteCarloIntegrator(backend="xla").integrate_mcmc(
            [lambda x: x * x], target, prop, n_steps=STEPS,
            n_chains=CHAINS, n_burnin=BURNIN, seed=11,
            return_stderr=True,
        )
        z = np.abs(kv - rx.values) / np.sqrt(ks ** 2 + rx.stderr ** 2)
        check(
            f"mcmc kernel ~ XLA builder ({name})",
            bool(np.all(z <= 5.0)),
            f"kernel {kv[0]:.5f}±{ks[0]:.2g}, xla {rx.values[0]:.5f}"
            f"±{rx.stderr[0]:.2g}, z = {np.max(z):.3g} (bound 5)",
        )
    print(peak_line(), flush=True)


# ---------------------------------------------------------------------------
# phase 3: the public entry points
# ---------------------------------------------------------------------------


def within(name, values, truth, stderr=None, tol=None):
    values = np.asarray(values, np.float64).ravel()
    truth = np.asarray(truth, np.float64).ravel()
    if stderr is not None:
        bound = 6.0 * np.asarray(stderr, np.float64).ravel() + 1e-6
    else:
        bound = np.broadcast_to(tol, truth.shape)
    ok = bool(np.all(np.isfinite(values)) and np.all(
        np.abs(values - truth) <= bound
    ))
    return check(name, ok, f"{np.round(values, 5).tolist()} vs "
                           f"{np.round(truth, 5).tolist()}")


def phase_main():
    import tpu_montecarlo as mc
    from tpu_montecarlo import HMC, RandomWalk

    integ = mc.MonteCarloIntegrator()
    nrm = mc.Distribution.normal(0.0, 1.0)

    prog = integ.compile_integrate(
        headline_fns(), nrm, n_samples=HEADLINE, return_stderr=True
    )
    v, s = prog(2025)
    within("integrate K=8 N(0,1)", v, HEADLINE_TRUTH, stderr=s)

    prog = integ.compile_integrate(
        [lambda x: x, lambda x: x * x], nrm, n_samples=K2,
        seed_batch=K2_BATCH,
    )
    out = np.asarray(prog(list(range(K2_BATCH))))
    within("integrate K=2 x seed_batch", out.mean(axis=0), [0.0, 1.0],
           tol=0.01)

    beta = mc.Distribution.beta(2.0, 5.0, table_size=512)
    tri = mc.Distribution.from_pdf(tri_pdf, support=(0.0, 2.0),
                                   table_size=512)
    r = integ.integrate([lambda x: x, lambda x: x * x], beta,
                        n_samples=TABLE, seed=3, return_stderr=True)
    within("integrate Beta(2,5) table", r.values, [2 / 7, 3 / 28],
           tol=2e-3)
    r = integ.integrate([lambda x: x], tri, n_samples=TABLE, seed=3)
    within("integrate triangular table", r.values, [1.0], tol=2e-3)

    r = integ.integrate_importance_sampling(
        [lambda x: x > 4.0], nrm, mc.Distribution.normal(4.0, 1.5),
        n_samples=IS_RARE, seed=4, return_stderr=True,
    )
    within("importance sampling P(X>4)", r.values,
           [0.5 * math.erfc(4.0 / math.sqrt(2.0))], stderr=r.stderr)

    table_target = mc.Distribution.from_pdf(bimodal, support=(-6.0, 6.0))
    mcmc_cases = [
        ("mcmc c5 table target", table_target,
         mc.Distribution.uniform(-6.0, 6.0), 5.0),
        ("mcmc c5 analytic target", nrm, mc.Distribution.normal(0.0, 2.0),
         1.0),
        ("mcmc RandomWalk(adapt=True)", nrm,
         RandomWalk(step_size=2.4, adapt=True), 1.0),
        ("mcmc HMC", nrm, HMC(step_size=0.9, n_leapfrog=8, adapt=True),
         1.0),
    ]
    for name, target, prop, truth in mcmc_cases:
        prog = integ.compile_mcmc(
            [lambda x: x * x], target, prop, n_steps=STEPS,
            n_chains=CHAINS, n_burnin=BURNIN, return_stderr=True,
        )
        v, acc, s = prog(5)
        within(name, v, [truth], stderr=s)
        check(f"{name} acceptance", 0.05 < float(acc) < 1.0,
              f"{float(acc):.4f}")

    # Beyond the reference, through the XLA builders.
    u = mc.Distribution.uniform(0.0, 1.0)
    r = integ.integrate([lambda x, y, z: x * y * z], [u, u, u],
                        n_samples=ND, method="qmc", seed=6)
    within("integrate 3-D qmc", r.values, [0.125], tol=2e-3)
    r = integ.integrate_mcmc(
        [lambda x, y: x * y],
        lambda x, y: -(x * x - 1.2 * x * y + y * y) / (2 * 0.64),
        [mc.Distribution.normal(0.0, 2.0)] * 2,
        n_steps=2_000, n_chains=4096, n_burnin=500, seed=8,
        return_stderr=True,
    )
    within("nd MCMC joint target", r.values, [0.6], stderr=r.stderr)
    r = integ.integrate_mcmc(
        [lambda x: x * x], table_target,
        RandomWalk(step_size=1.0, init_range=(-4.0, 4.0)),
        n_steps=2_000, n_chains=4096, n_burnin=500, seed=9,
        temperatures=[1.0, 2.0, 4.0, 8.0, 16.0], return_stderr=True,
    )
    within("tempered MCMC, 5 rungs", r.values, [5.0], stderr=r.stderr)

    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "parity", os.path.join(HERE, "benchmarks", "parity.py")
    )
    parity_mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(parity_mod)
    t0 = time.perf_counter()
    rc = parity_mod.main(["--quick"])
    check("parity checks at the reference tolerances", rc == 0,
          f"rc {rc}, {time.perf_counter() - t0:.0f} s")


# ---------------------------------------------------------------------------
# phase 4: kernel vs XLA builder
# ---------------------------------------------------------------------------


def phase_timing(card_line):
    """Each kernel against the XLA builder on the same workload: one cell
    per mode the kernels serve under backend='auto' (a forced
    backend='pallas' raises on the GPU where no kernel serves a cell)."""
    import tpu_montecarlo as mc
    from tpu_montecarlo import HMC, RandomWalk, adapt_proposal
    from tpu_montecarlo import pack_param_batch

    nrm = mc.Distribution.normal(0.0, 1.0)
    n02 = mc.Distribution.normal(0.0, 2.0)
    table_target = mc.Distribution.from_pdf(bimodal, support=(-6.0, 6.0))
    beta = mc.Distribution.beta(2.0, 5.0, table_size=512)
    tri = mc.Distribution.from_pdf(tri_pdf, support=(0.0, 2.0),
                                   table_size=512)
    gapped = mc.Distribution.from_pdf(gap_pdf, support=(0.0, 3.0))
    xs = np.linspace(0.0, 2.0, 513)
    tri_table = mc.Distribution.from_pdf_table(xs, 1.0 - np.abs(xs - 1.0))
    wide_q = mc.Distribution.from_pdf(wide_pdf, support=(-7.0, 7.0))
    q13 = adapt_proposal(bump, nrm, seed=11)
    k2 = [lambda x: x, lambda x: x * x]
    sq = [lambda x: x * x]
    seeds = list(range(K2_BATCH))
    k2_rows = pack_param_batch([
        mc.Distribution.normal(0.01 * i, 1.0 + 0.01 * i)
        for i in range(K2_BATCH)
    ])
    mc_seeds = list(range(MCMC_BATCH))
    targ_rows = pack_param_batch([nrm] * MCMC_BATCH)
    prop_rows = pack_param_batch([n02] * MCMC_BATCH)
    mkw = dict(n_steps=STEPS, n_chains=CHAINS, n_burnin=BURNIN)
    chain_work = CHAINS * (STEPS + BURNIN)

    def handle(entry, *a, **kw):
        return lambda integ: getattr(integ, entry)(*a, **kw)

    def mcmc_call(**kw):
        """A timed integrate_mcmc call, for the modes no handle serves."""
        return lambda integ: lambda seed: integ.integrate_mcmc(
            sq, nrm, n02, seed=seed, **mkw, **kw
        ).values

    def mcmc_resume(integ):
        state = integ.integrate_mcmc(
            sq, nrm, n02, seed=1, return_state=True, **mkw
        ).chain_state
        return lambda seed: integ.integrate_mcmc(
            sq, nrm, n02, n_steps=STEPS, n_chains=CHAINS, n_burnin=0,
            seed=seed, initial_state=state,
        ).values

    s, cs = "samples/s", "chain-steps/s"
    # (name, handle builder, call args, work per call, unit)
    cells = [
        ("c2 K=8 N(0,1) 1e9",
         handle("compile_integrate", headline_fns(), nrm,
                n_samples=HEADLINE), (1,), HEADLINE, s),
        ("c2b K=8 antithetic 1e9",
         handle("compile_integrate", headline_fns(), nrm,
                n_samples=HEADLINE, method="antithetic"),
         (1,), HEADLINE, s),
        ("c8 K=8 with stderr 1e9",
         handle("compile_integrate", headline_fns(), nrm,
                n_samples=HEADLINE, return_stderr=True),
         (1,), HEADLINE, s),
        ("c6 K=8 qmc 1e8",
         handle("compile_integrate", headline_fns(), nrm, n_samples=QMC,
                method="qmc"), (1,), QMC, s),
        ("c7 K=128 Beta-table histogram 1e8 (2 kernel passes)",
         handle("compile_integrate", hist_fns(128),
                mc.Distribution.beta(2.0, 5.0, table_size=2048),
                n_samples=QMC), (1,), QMC, s),
        ("c1 K=2 1e6 x 64 seeds",
         handle("compile_integrate", k2, nrm, n_samples=K2,
                seed_batch=K2_BATCH), (seeds,), K2 * K2_BATCH, s),
        ("K=2 1e6 x 64 param_batch rows",
         handle("compile_integrate", k2, nrm, n_samples=K2,
                seed_batch=K2_BATCH, param_batch=True),
         (seeds, k2_rows), K2 * K2_BATCH, s),
        ("c3a Beta(2,5) table 1e7",
         handle("compile_integrate", k2, beta, n_samples=TABLE),
         (1,), TABLE, s),
        ("c3b triangular table 1e7",
         handle("compile_integrate", k2[:1], tri, n_samples=TABLE),
         (1,), TABLE, s),
        ("gapped table (zero-density span) 1e7",
         handle("compile_integrate", k2, gapped, n_samples=TABLE),
         (1,), TABLE, s),
        ("c4 IS P(X>4), traced weights 1e8",
         handle("compile_importance_sampling", [lambda x: x > 4.0], nrm,
                mc.Distribution.normal(4.0, 1.5), n_samples=IS_RARE),
         (1,), IS_RARE, s),
        ("IS table-pdf target weights 1e8",
         handle("compile_importance_sampling", k2, tri_table,
                mc.Distribution.uniform(0.0, 2.0), n_samples=IS_RARE),
         (1,), IS_RARE, s),
        ("c13 IS sampler-mode weights (VEGAS proposal) 1e8",
         handle("compile_importance_sampling", [bump], nrm, q13,
                n_samples=IS_RARE), (1,), IS_RARE, s),
    ]
    for name, target, prop in [
        ("c5 MCMC table target", table_target,
         mc.Distribution.uniform(-6.0, 6.0)),
        ("c5b MCMC analytic target", nrm, n02),
        ("MCMC table proposal (sampler-mode logq)", nrm, wide_q),
        ("c10 RandomWalk(adapt=True)", nrm,
         RandomWalk(step_size=2.4, adapt=True)),
        ("c11 HMC L=8", nrm, HMC(step_size=0.9, n_leapfrog=8, adapt=True)),
        ("c11c HMC L=8 table target", table_target,
         HMC(step_size=0.5, n_leapfrog=8, adapt=True)),
    ]:
        cells.append((name, handle("compile_mcmc", sq, target, prop, **mkw),
                      (1,), chain_work, cs))
    cells += [
        ("c14 RandomWalk return_samples=100",
         handle("compile_mcmc", sq, nrm,
                RandomWalk(step_size=2.4, init_range=(-4.0, 4.0)),
                return_samples=100, **mkw), (1,), chain_work, cs),
        ("c8b MCMC with stderr",
         handle("compile_mcmc", sq, nrm, n02, return_stderr=True, **mkw),
         (1,), chain_work, cs),
        (f"MCMC seed_batch={MCMC_BATCH}",
         handle("compile_mcmc", sq, nrm, n02, seed_batch=MCMC_BATCH, **mkw),
         (mc_seeds,), chain_work * MCMC_BATCH, cs),
        (f"MCMC param_batch x {MCMC_BATCH}",
         handle("compile_mcmc", sq, nrm, n02, seed_batch=MCMC_BATCH,
                param_batch=True, **mkw),
         (mc_seeds, targ_rows, prop_rows), chain_work * MCMC_BATCH, cs),
        ("MCMC return_diagnostics (integrate_mcmc call)",
         mcmc_call(return_diagnostics=True), (1,), chain_work, cs),
        ("MCMC resume from a chain state (integrate_mcmc call)",
         mcmc_resume, (1,), CHAINS * STEPS, cs),
    ]
    print(f"timing: MCMC cells run {CHAINS} chains x ({STEPS} steps + "
          f"{BURNIN} burn-in); median of 5 calls, compile excluded",
          flush=True)
    for name, make, args, work, unit in cells:
        times = {}
        for backend in ("pallas", "xla"):
            prog = make(mc.MonteCarloIntegrator(backend=backend))
            times[backend] = median_time(prog, *args)
        ratio = times["xla"] / times["pallas"]
        print(
            f"timing {name}: kernel {times['pallas'] * 1e3:.3f} ms "
            f"({work / times['pallas']:.4g} {unit}), XLA builder "
            f"{times['xla'] * 1e3:.3f} ms ({work / times['xla']:.4g} "
            f"{unit}), XLA/kernel {ratio:.3g}x"
            f"{'' if ratio > 1.0 else ' (KERNEL NOT FASTER)'} "
            f"[{card_line}]",
            flush=True,
        )


# ---------------------------------------------------------------------------
# --four-cards: the mesh path
# ---------------------------------------------------------------------------


def phase_four_cards(card_line):
    import jax
    import jax.numpy as jnp

    import tpu_montecarlo as mc
    from tpu_montecarlo.ops.mcmc_pallas import build_mcmc_fn_pallas
    from tpu_montecarlo.parallel import default_mesh
    from tpu_montecarlo.sampling import DistKind
    from tpu_montecarlo.tracing import trace_function

    n = len(jax.devices())
    check("four devices", n == 4, f"{n} devices")
    nrm = mc.Distribution.normal(0.0, 1.0)
    n02 = mc.Distribution.normal(0.0, 2.0)
    sq = [lambda x: x * x]
    mkw = dict(n_steps=STEPS, n_chains=CHAINS, n_burnin=BURNIN)
    one = mc.MonteCarloIntegrator()
    four = mc.MonteCarloIntegrator(mesh="auto")
    check("mesh over every device",
          four._mesh is not None and four._mesh.size == n,
          str(four._mesh))
    for name, run in [
        ("integrate K=8 N(0,1)", lambda integ: integ.integrate(
            headline_fns(), nrm, n_samples=HEADLINE, seed=31,
            return_stderr=True)),
        ("mcmc c5 analytic target", lambda integ: integ.integrate_mcmc(
            sq, nrm, n02, seed=32, return_stderr=True, **mkw)),
    ]:
        t0 = time.perf_counter()
        r4 = run(four)
        t4 = time.perf_counter() - t0
        r1 = run(one)
        z = np.abs(r4.values - r1.values) / np.sqrt(
            r4.stderr ** 2 + r1.stderr ** 2 + 1e-30
        )
        check(f"4-card {name} ~ 1-card", bool(np.all(z <= 5.0)),
              f"4-card {np.round(r4.values, 5).tolist()}, 1-card "
              f"{np.round(r1.values, 5).tolist()}, max z {np.max(z):.3g}; "
              f"first 4-card call {t4:.1f} s")

    # Kernel vs XLA builder on the mesh, through the compiled handles,
    # beside the kernel on one card.
    for name, make, work, unit in [
        ("integrate K=8 N(0,1) 1e9", lambda integ: integ.compile_integrate(
            headline_fns(), nrm, n_samples=HEADLINE), HEADLINE, "samples/s"),
        (f"mcmc c5b analytic {CHAINS}x({STEPS}+{BURNIN})",
         lambda integ: integ.compile_mcmc(sq, nrm, n02, **mkw),
         CHAINS * (STEPS + BURNIN), "chain-steps/s"),
    ]:
        times = {
            label: median_time(make(integ), 1)
            for label, integ in [
                ("4-card kernel",
                 mc.MonteCarloIntegrator(backend="pallas", mesh="auto")),
                ("4-card XLA builder",
                 mc.MonteCarloIntegrator(backend="xla", mesh="auto")),
                ("1-card kernel", mc.MonteCarloIntegrator(backend="pallas")),
            ]
        }
        print(
            f"timing mesh {name}: "
            + ", ".join(f"{k} {t * 1e3:.3f} ms ({work / t:.4g} {unit})"
                        for k, t in times.items())
            + f"; XLA/kernel on 4 cards "
            f"{times['4-card XLA builder'] / times['4-card kernel']:.3g}x"
            f" [{card_line}]",
            flush=True,
        )

    # Each device holds its own shard of the chain state.
    mesh = default_mesh()
    run = build_mcmc_fn_pallas(
        (trace_function(lambda x: x * x),), DistKind.NORMAL, DistKind.NORMAL,
        STEPS, BURNIN, CHAINS, mesh=mesh, with_state=True,
    )
    d = jnp.zeros(1, jnp.float32)
    out = run(np.uint32(3), jnp.asarray([0.0, 2.0]), jnp.asarray([0.0, 1.0]),
              d, d, d, d, d, d, None, None, 0)
    x_f = out[2]
    shards = x_f.addressable_shards
    devs = {s.device for s in shards}
    sizes = [s.data.shape[0] for s in shards]
    check("chain state sharded one shard per device",
          len(devs) == n and len(shards) == n
          and sum(sizes) == x_f.shape[0],
          f"{len(shards)} shards on {len(devs)} devices, sizes {sizes}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-GPU mesh path and its comparison")
    args = ap.parse_args(argv)

    import jax

    from tpu_montecarlo.utils.compile_cache import use_compile_cache

    cache = use_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"no GPU: JAX found platform {dev.platform!r}",
              file=sys.stderr)
        return 1
    card_line = card()
    if card_line is None:
        print("device phase failed: nvidia-smi did not report the card's "
              "name and power limit", file=sys.stderr)
        return 1
    print(f"device: {dev.device_kind} x{len(jax.devices())} "
          f"({dev.platform}); jax {jax.__version__}; XLA_FLAGS="
          f"{os.environ.get('XLA_FLAGS', '')!r}; compile cache {cache}",
          flush=True)
    print(f"card: {card_line}", flush=True)
    t_start = time.perf_counter()
    if args.four_cards:
        phases = [("four_cards", lambda: phase_four_cards(card_line))]
    else:
        phases = [
            ("kernels", phase_kernels),
            ("main", phase_main),
            ("timing", lambda: phase_timing(card_line)),
        ]
    for name, fn in phases:
        t0 = time.perf_counter()
        fn()
        print(f"phase {name}: {time.perf_counter() - t0:.1f} s", flush=True)
    print(f"total {time.perf_counter() - t_start:.1f} s; "
          f"card: {card_line}", flush=True)
    if FAILURES:
        print(f"FAILED: {FAILURES}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices()),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
