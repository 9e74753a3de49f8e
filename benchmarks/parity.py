#!/usr/bin/env python3
"""Asserted statistical parity of the compiled program on real hardware.

The pytest suite validates kernel logic through the Pallas interpreter on
the CPU; this harness runs the same reference-derived statistical checks
on whatever backend JAX resolves (the GPU: compiled Pallas-Triton
kernels and XLA builders) and ASSERTS the reference's own tolerances
(wgpu-monte-carlo tests/test_integrator.py:196-257,
tests/test_distributions.py:78-157, tests/test_mcmc.py:88-148,319-344,
tests/test_importance_sampling.py:23-62).

Prints one JSON record per check and exits non-zero if any check fails;
``--out PATH`` also writes all records to PATH.  ``--quick`` runs only the
reference-derived sections (integrate, math surface, table sampling, IS,
MCMC, table histogram); ``chip_smoke.py`` runs those in its main phase.

Run:  python benchmarks/parity.py [--quick] [--out chiprun_out/parity.json]
"""

from __future__ import annotations

import json
import math
import os
import sys
import traceback

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _setup_jax():
    import jax

    from tpu_montecarlo.utils.compile_cache import use_compile_cache

    use_compile_cache()
    return jax


RECORDS = []


def check(name, values, expected, tol, note=""):
    values = [float(v) for v in np.ravel(values)]
    expected = [float(e) for e in np.ravel(expected)]
    tol = list(np.broadcast_to(tol, (len(expected),)).astype(float))
    errs = [abs(v - e) for v, e in zip(values, expected)]
    ok = all(err < t for err, t in zip(errs, tol))
    RECORDS.append(
        {
            "check": name,
            "values": values,
            "expected": expected,
            "tol": tol,
            "max_err": max(errs),
            "pass": bool(ok),
            "note": note,
        }
    )
    print(json.dumps(RECORDS[-1]), flush=True)
    return ok


def _finish(ok, backend, out) -> int:
    n_fail = sum(1 for r in RECORDS if not r["pass"])
    print(f"# {len(RECORDS) - n_fail}/{len(RECORDS)} checks pass; "
          f"backend {backend}", flush=True)
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as f:
            json.dump({"backend": backend, "all_pass": bool(ok),
                       "checks": RECORDS}, f, indent=2)
    return 0 if ok else 1


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--quick", action="store_true",
                    help="only the reference-derived sections (integrate, "
                         "math surface, tables, IS, MCMC, histogram)")
    args = ap.parse_args(argv)
    jax = _setup_jax()
    import tpu_montecarlo as mc

    backend = jax.default_backend()
    print(f"# backend: {backend}", flush=True)
    ok = True

    # --- integrate: analytic families (ref test_integrator.py:196-257) ---
    d = mc.Distribution.normal(0.0, 1.0)
    r = mc.integrate(
        [lambda x: x, lambda x: x * x, lambda x: x * x * x,
         lambda x: x * x * x * x],
        d, n_samples=10_000_000, seed=42,
    )
    ok &= check("normal_moments_1e7", r.values, [0, 1, 0, 3], 0.01,
                "ref test_integrator.py:230-246")

    u = mc.Distribution.uniform(0.0, 1.0)
    r = mc.integrate([lambda x: x, lambda x: x * x], u,
                     n_samples=10_000_000, seed=42)
    var = r.values[1] - r.values[0] ** 2
    ok &= check("uniform_mean_var_1e7", [r.values[0], var],
                [0.5, 1.0 / 12.0], 0.01, "ref test_integrator.py:196-209")

    e = mc.Distribution.exponential(2.0)
    r = mc.integrate([lambda x: x, lambda x: x * x], e,
                     n_samples=10_000_000, seed=42)
    var = r.values[1] - r.values[0] ** 2
    ok &= check("exponential_mean_var_1e7", [r.values[0], var],
                [0.5, 0.25], 0.01, "ref test_integrator.py:211-228")

    u2pi = mc.Distribution.uniform(0.0, 2 * math.pi)
    r = mc.integrate([lambda x: math.sin(x), lambda x: math.cos(x)], u2pi,
                     n_samples=10_000_000, seed=42)
    ok &= check("trig_uniform_1e7", r.values, [0, 0], 0.01,
                "ref test_integrator.py:248-257")

    # --- math surface asserted on the device ---
    # sin^2 + cos^2 = 1 holds POINTWISE, so the estimate carries no MC
    # noise: the tolerance tests the math functions' accuracy directly
    # (wide-sigma samples exercise the range reduction).
    r = mc.integrate(
        [lambda x: math.sin(x) ** 2 + math.cos(x) ** 2],
        mc.Distribution.normal(0.0, 3.0), n_samples=1_000_000, seed=42,
    )
    ok &= check("math_pythagorean_pointwise", r.values, [1.0], 1e-5,
                "sin/cos identity, no MC noise at this tol")
    # Closed-form expectations over U(0,1) for the inverse-trig and
    # hyperbolic builtins.
    u01 = mc.Distribution.uniform(0.0, 1.0)
    r = mc.integrate(
        [
            lambda x: math.atan(x),
            lambda x: math.asin(x),
            lambda x: math.asinh(x),
            lambda x: math.acosh(1.0 + x),
            lambda x: math.atanh(x),
            lambda x: math.tan(x),
            lambda x: math.copysign(1.0, x - 0.5),
        ],
        u01, n_samples=10_000_000, seed=42,
    )
    expect_u = [
        math.pi / 4 - math.log(2.0) / 2,      # int_0^1 atan
        math.pi / 2 - 1.0,                    # int_0^1 asin
        math.asinh(1.0) - math.sqrt(2.0) + 1.0,
        2.0 * math.acosh(2.0) - math.sqrt(3.0),
        math.log(2.0),                        # int_0^1 atanh (log sing.)
        -math.log(math.cos(1.0)),             # int_0^1 tan
        0.0,                                  # symmetric sign flip
    ]
    ok &= check("math_inverse_trig_u01_1e7", r.values, expect_u, 0.01,
                "closed forms")
    r = mc.integrate(
        [
            lambda x: math.cosh(x),
            lambda x: math.sinh(x),
            lambda x: math.expm1(x),
            lambda x: math.cbrt(x),
        ],
        mc.Distribution.normal(0.0, 1.0), n_samples=10_000_000, seed=42,
    )
    expect_n = [math.exp(0.5), 0.0, math.exp(0.5) - 1.0, 0.0]
    ok &= check("math_hyperbolic_n01_1e7", r.values, expect_n, 0.02,
                "E[cosh]=E[expm1]+1=sqrt(e); odd fns vanish")

    # --- integrate: table sampling (ref test_distributions.py:78-157) ---
    a, b = 2.0, 5.0
    beta = mc.Distribution.beta(a, b, table_size=2048)
    r = mc.integrate(
        [lambda x: x, lambda x: x * x, lambda x: x * x * x], beta,
        n_samples=10_000_000, seed=42,
    )
    m1 = a / (a + b)
    m2 = a * (a + 1) / ((a + b) * (a + b + 1))
    m3 = a * (a + 1) * (a + 2) / ((a + b) * (a + b + 1) * (a + b + 2))
    ok &= check("beta_2_5_moments_1e7", r.values, [m1, m2, m3], 0.01,
                "ref test_distributions.py:78-110")

    a, b = 3.0, 2.0
    beta32 = mc.Distribution.beta(a, b, table_size=2048)
    r = mc.integrate([lambda x: x, lambda x: x * x], beta32,
                     n_samples=5_000_000, seed=123)
    m1 = a / (a + b)
    m2 = a * (a + 1) / ((a + b) * (a + b + 1))
    var = r.values[1] - r.values[0] ** 2
    ok &= check("beta_3_2_mean_var_5e6", [r.values[0], var],
                [m1, m2 - m1 * m1], 0.02, "ref test_distributions.py:112-132")

    def unit_pdf(x):
        return 1.0 if 0 <= x < 1 else 0.0

    tbl = mc.Distribution.from_pdf(unit_pdf, support=(0.0, 1.0))
    r = mc.integrate([lambda x: x, lambda x: x * x], tbl,
                     n_samples=1_000_000, seed=42)
    ok &= check("table_vs_direct_uniform_1e6", r.values, [0.5, 1.0 / 3.0],
                0.01, "ref test_distributions.py:134-157")

    # --- importance sampling (ref test_importance_sampling.py:23-62) ---
    p = mc.Distribution.normal(0.0, 1.0)
    q = mc.Distribution.normal(0.0, 1.0)
    r = mc.integrate_importance_sampling(
        [lambda x: x * x], p, q, n_samples=1_000_000, seed=42
    )
    ok &= check("is_p_equals_q_1e6", r.values, [1.0], 0.01,
                "ref test_importance_sampling.py:23-32")

    q = mc.Distribution.normal(0.5, 1.2)
    r = mc.integrate_importance_sampling(
        [lambda x: x, lambda x: x * x], p, q, n_samples=5_000_000, seed=42
    )
    ok &= check("is_shifted_wider_5e6", r.values, [0.0, 1.0], 0.02,
                "ref test_importance_sampling.py:34-62")

    q = mc.Distribution.normal(4.0, 1.5)
    r = mc.integrate_importance_sampling(
        [lambda x: x > 4.0], p, q, n_samples=100_000_000, seed=42
    )
    true_tail = 3.1671e-5  # P(N(0,1) > 4)
    ok &= check("is_rare_event_1e8", r.values, [true_tail], true_tail * 0.1,
                "rare-event IS, 10% relative")

    # Non-traceable target PDF -> table-weight route stays on-device.
    def stepped_pdf(x):
        # int() defeats tracing (reference: TranspilerError -> table path).
        return float(int(x >= 0)) * math.exp(-x)

    pt = mc.Distribution.from_pdf(stepped_pdf, support=(0.0, 12.0))
    q = mc.Distribution.exponential(0.7)
    r = mc.integrate_importance_sampling(
        [lambda x: x], pt, q, n_samples=5_000_000, seed=42
    )
    ok &= check("is_table_route_exp_5e6", r.values, [1.0], 0.02,
                "table-PDF weight route; E[x]=1 for Exp(1)")

    # --- MCMC (ref test_mcmc.py:88-148) ---
    target = mc.Distribution.normal(0.0, 1.0)
    proposal = mc.Distribution.normal(0.0, 1.0)
    r = mc.integrate_mcmc([lambda x: x], target, proposal,
                          n_steps=5000, n_chains=256, n_burnin=500, seed=42)
    ok &= check("mcmc_normal_mean", r.values, [0.0], 0.15,
                "ref test_mcmc.py:91-106")

    proposal = mc.Distribution.normal(0.0, 1.5)
    r = mc.integrate_mcmc([lambda x: x * x], target, proposal,
                          n_steps=10_000, n_chains=512, n_burnin=1000, seed=42)
    ok &= check("mcmc_normal_second_moment", r.values, [1.0], 0.15,
                "ref test_mcmc.py:108-123")

    def bimodal(x):
        return math.exp(-0.5 * (x - 2.0) ** 2) + math.exp(-0.5 * (x + 2.0) ** 2)

    bi = mc.Distribution.from_pdf(bimodal, support=(-6.0, 6.0))
    r = mc.integrate_mcmc([lambda x: x * x], bi,
                          mc.Distribution.uniform(-6.0, 6.0),
                          n_steps=10_000, n_chains=1024, n_burnin=1000,
                          seed=42)
    ok &= check("mcmc_bimodal_table_target", r.values, [5.0], 0.2,
                "E[X^2] = 4 + 1 for the +-2 mixture; ref test_mcmc.py:349-372")

    beta25 = mc.Distribution.beta(2.0, 5.0)
    r = mc.integrate_mcmc([lambda x: x], beta25,
                          mc.Distribution.uniform(0.0, 1.0),
                          n_steps=5000, n_chains=512, n_burnin=500, seed=42)
    ok &= check("mcmc_beta_target", r.values, [2.0 / 7.0], 0.05,
                "ref test_mcmc.py:374-392")

    # Seed reproducibility of the compiled kernels (ref test_mcmc.py:319-344).
    r1 = mc.integrate([lambda x: x * x], d, n_samples=1_000_000, seed=7)
    r2 = mc.integrate([lambda x: x * x], d, n_samples=1_000_000, seed=7)
    same = bool(np.array_equal(r1.values, r2.values))
    RECORDS.append({"check": "seed_reproducibility_integrate",
                    "pass": same, "note": "bit-equal same-seed estimates"})
    print(json.dumps(RECORDS[-1]), flush=True)
    ok &= same

    ra = mc.integrate_mcmc([lambda x: x], target,
                           mc.Distribution.normal(0.0, 2.0),
                           n_steps=2000, n_chains=256, n_burnin=200, seed=11)
    rb = mc.integrate_mcmc([lambda x: x], target,
                           mc.Distribution.normal(0.0, 2.0),
                           n_steps=2000, n_chains=256, n_burnin=200, seed=11)
    same = bool(np.array_equal(ra.values, rb.values))
    RECORDS.append({"check": "seed_reproducibility_mcmc",
                    "pass": same, "note": "ref test_mcmc.py:319-344"})
    print(json.dumps(RECORDS[-1]), flush=True)
    ok &= same

    # --- distributional shape of the table sampler (64-bin histogram) ----
    # Exercises K=64 fused indicator integrands AND validates the full
    # sampling distribution, not just low moments: each bin estimate must
    # match the table-defined bin mass within Monte Carlo noise (the
    # stratified sampler's variance is at most the i.i.d. sampler's, so
    # the i.i.d. bound applies).  K=64 shrinks the kernel's sample block
    # to 128 (integrate_pallas.pick_block), so this also pins the
    # small-block path on hardware.
    beta_h = mc.Distribution.beta(2.0, 5.0, table_size=2048)
    edges = np.linspace(0.0, 1.0, 65)

    def bin_fn(lo_, hi_):
        return lambda v: (v >= lo_) * (v < hi_)

    n_hist = 10_000_000
    r = mc.integrate(
        [bin_fn(float(lo), float(hi)) for lo, hi in zip(edges[:-1], edges[1:])],
        beta_h, n_samples=n_hist, seed=42,
    )
    cdf_at = np.interp(edges, beta_h._x_table, beta_h._cdf_table)
    expected_mass = np.diff(cdf_at)
    sigma = np.sqrt(np.maximum(expected_mass, 1e-12) / n_hist)
    # 6-sigma MC slack + table-resampling slack (4096-knot inverse).
    tol_bins = 6.0 * sigma + 5e-4
    ok &= check("beta_histogram_64bins", r.values, expected_mass,
                tol_bins.tolist(),
                "table-sampler distributional shape; K=64 fused indicators "
                "via adaptive block rows")

    if args.quick:
        return _finish(ok, backend, args.out)

    # --- gapped (zero-density-span) distributions, compiled kernels ------
    gx = np.linspace(0.0, 1.0, 2048)
    gp = np.where((gx > 0.4) & (gx < 0.6), 0.0, 1.0)
    gapped = mc.Distribution.from_pdf_table(gx, gp)
    r = mc.integrate(
        [lambda v: v, lambda v: (v > 0.41) * (v < 0.59)], gapped,
        n_samples=2_000_000, seed=42,
    )
    ok &= check("gapped_integrate_no_gap_samples", r.values, [0.5, 0.0],
                [0.01, 1e-12],
                "gap-respecting tables: zero samples inside the gap")

    r = mc.integrate_mcmc(
        [lambda v: v * v], mc.Distribution.uniform(0.0, 1.0), gapped,
        n_steps=3000, n_chains=512, n_burnin=300, seed=42,
    )
    # Independence sampler == target restricted to the proposal islands:
    # E[X^2] = 1.25*(0.4^3 + 1 - 0.6^3)/3 = 0.35333.
    ok &= check("gapped_proposal_mcmc", [r.values[0], r.acceptance_rate],
                [0.35333, 1.0], [0.01, 0.02],
                "proposal log-floor guard: no absorbing gap-edge states")

    # --- batched dispatch bit-equality on the compiled kernels -----------
    it_b = mc.MonteCarloIntegrator()
    single = it_b.compile_integrate(
        [lambda v: v * v], d, n_samples=1_000_000
    )
    batched = it_b.compile_integrate(
        [lambda v: v * v], d, n_samples=1_000_000, seed_batch=4
    )
    outs = np.asarray(batched([11, 12, 13, 14]))
    singles = np.asarray(
        [np.asarray(single(s)) for s in (11, 12, 13, 14)]
    ).reshape(4, 1)
    same = bool(np.array_equal(outs, singles))
    RECORDS.append({"check": "seed_batch_grid_bit_equality",
                    "pass": same,
                    "note": "each grid-batched job == its unbatched call"})
    print(json.dumps(RECORDS[-1]), flush=True)
    ok &= same

    m_single = it_b.compile_mcmc(
        [lambda v: v], target, mc.Distribution.normal(0.0, 2.0),
        n_steps=500, n_chains=512, n_burnin=100,
    )
    m_batched = it_b.compile_mcmc(
        [lambda v: v], target, mc.Distribution.normal(0.0, 2.0),
        n_steps=500, n_chains=512, n_burnin=100, seed_batch=2,
    )
    bv, ba = m_batched([21, 22])
    sv, sa = m_single(21)
    same = bool(
        np.array_equal(np.asarray(bv)[0], np.asarray(sv))
        and float(np.asarray(ba)[0]) == float(np.asarray(sa))
    )
    RECORDS.append({"check": "seed_batch_mcmc_bit_equality", "pass": same,
                    "note": "grid-batched MCMC == unbatched"})
    print(json.dumps(RECORDS[-1]), flush=True)
    ok &= same

    # --- checkpoint/resume on the compiled kernel -------------------------
    it = mc.MonteCarloIntegrator()
    q2 = mc.Distribution.normal(0.0, 2.0)
    rs1 = it.integrate_mcmc([lambda x: x * x], target, q2,
                            n_steps=3000, n_chains=512, n_burnin=500,
                            seed=42, return_state=True)
    rs2 = it.integrate_mcmc([lambda x: x * x], target, q2,
                            n_steps=3000, n_chains=512, n_burnin=0,
                            initial_state=rs1.chain_state, seed=42)
    ok &= check("mcmc_resume_second_moment",
                [rs1.values[0], rs2.values[0]], [1.0, 1.0], 0.15,
                "stateful + resumed segments both within tolerance")

    # Cross-backend: resumed segments vs one stateless run of 2x steps
    # must agree statistically (VERDICT r1 weak #7).
    combined = 0.5 * (rs1.values[0] + rs2.values[0])
    r_full = it.integrate_mcmc([lambda x: x * x], target, q2,
                               n_steps=6000, n_chains=512, n_burnin=500,
                               seed=43)
    ok &= check("mcmc_resumed_vs_continuous",
                [combined - r_full.values[0]], [0.0], 0.1,
                "mean of 2 resumed segments vs one 2x stateless run")

    # --- quasi-Monte Carlo on the compiled kernels ------------------------
    # Tolerances ~10x tighter than plain MC at the same N: they fail if
    # the compiled QMC path silently degrades to MC-rate convergence.
    r = mc.integrate(
        [lambda x: x, lambda x: x * x, lambda x: x * x * x * x],
        d, n_samples=10_000_000, seed=42, method="qmc",
    )
    ok &= check("qmc_normal_moments_1e7", r.values, [0, 1, 3],
                [1e-3, 1e-3, 2e-3],
                "QMC addition: rotated radical-inverse point set")

    r = mc.integrate(
        [lambda x: x, lambda x: x * x], u,
        n_samples=10_000_000, seed=42, method="qmc",
    )
    ok &= check("qmc_uniform_1e7", r.values, [0.5, 1.0 / 3.0], 1e-5,
                "QMC addition: vdc stream through the affine transform")

    r = mc.integrate_importance_sampling(
        [lambda x: x * x], p, mc.Distribution.normal(0.0, 1.5),
        n_samples=5_000_000, seed=42, method="qmc",
    )
    ok &= check("qmc_is_5e6", r.values, [1.0], 1e-3,
                "QMC addition through the IS weight fold")

    # --- param-batched dispatch on the compiled kernel --------------------
    # One program, a (seed, params) sweep per dispatch; each element must
    # be BIT-equal to its unbatched call (params route per grid rep).
    sweep_dists = [mc.Distribution.normal(0.0, 1.0),
                   mc.Distribution.normal(2.0, 3.0)]
    sweep = it.compile_integrate(
        [lambda x: x, lambda x: x * x], sweep_dists[0],
        n_samples=1_000_000, seed_batch=2, param_batch=True,
    )
    sweep_out = np.asarray(sweep([7, 42], mc.pack_param_batch(sweep_dists)))
    singles = np.stack([
        np.asarray(it.compile_integrate(
            [lambda x: x, lambda x: x * x], dd, n_samples=1_000_000)(s))
        for s, dd in zip([7, 42], sweep_dists)
    ])
    ok &= check("param_batch_bit_equal",
                list((sweep_out - singles).ravel()), [0.0] * 4, 1e-12,
                "param-batched sweep bit-equal to unbatched calls")

    mc_targets = [mc.Distribution.normal(0.0, 1.0),
                  mc.Distribution.normal(1.0, 0.5)]
    mc_props = [mc.Distribution.normal(0.0, 2.0),
                mc.Distribution.normal(1.0, 1.5)]
    mcmc_sweep = it.compile_mcmc(
        [lambda x: x * x], mc_targets[0], mc_props[0],
        n_steps=2000, n_chains=1024, n_burnin=200,
        seed_batch=2, param_batch=True,
    )
    sv, sa = mcmc_sweep([7, 42], mc.pack_param_batch(mc_targets),
                        mc.pack_param_batch(mc_props))
    sv, sa = np.asarray(sv), np.asarray(sa)
    singles = [
        it.compile_mcmc(
            [lambda x: x * x], t, q,
            n_steps=2000, n_chains=1024, n_burnin=200)(s)
        for s, t, q in zip([7, 42], mc_targets, mc_props)
    ]
    singles_v = np.stack([np.asarray(v) for v, _ in singles])
    singles_a = np.asarray([float(np.asarray(a)) for _, a in singles])
    ok &= check("mcmc_param_batch_bit_equal",
                list((sv - singles_v).ravel()) + list(sa - singles_a),
                [0.0] * 4, 1e-12,
                "param-batched MCMC sweep (values AND acceptance) "
                "bit-equal to unbatched calls")

    # --- error bars on hardware -------------------------------------------
    # stderr of E[X] under N(0,1) at N samples is 1/sqrt(N_actual) (the
    # plan rounds N up slightly); assert within 15%.
    n_se = 10_000_000
    r = mc.integrate([lambda x: x], d, n_samples=n_se, seed=42,
                     return_stderr=True)
    se_expected = 1.0 / math.sqrt(n_se)
    ok &= check("stderr_normal_mean_1e7",
                [r.stderr[0] / se_expected, r.values[0] / r.stderr[0]],
                [1.0, 0.0], [0.15, 4.0],
                "integrate error bar ~1/sqrt(N); truth within 4 sigma")

    rm = mc.integrate_mcmc([lambda x: x], d, q2,
                           n_steps=2000, n_chains=4096, n_burnin=200,
                           seed=42, return_stderr=True)
    iid_floor = 1.0 / math.sqrt(2000 * 4096)
    ok &= check("stderr_mcmc_between_chain",
                [rm.values[0] / rm.stderr[0],
                 min(max(rm.stderr[0] / iid_floor, 0.0), 20.0)],
                [0.0, 10.0], [4.0, 9.75],
                "MCMC between-chain error bar: truth within 4 sigma, "
                "stderr in (0.25x, 19.75x) of the iid floor")

    # In-kernel stderr (round 3): the error-bar kernel's VALUE
    # accumulators are untouched, so means are bit-equal to the plain
    # kernel; stderr agrees with the forced-XLA implementation.
    r_se = mc.integrate([lambda x: x, lambda x: x * x], d,
                        n_samples=1_000_000, seed=9, return_stderr=True)
    r_plain = mc.integrate([lambda x: x, lambda x: x * x], d,
                           n_samples=1_000_000, seed=9)
    same = bool(np.array_equal(r_se.values, r_plain.values))
    RECORDS.append({"check": "stderr_values_bit_equal_plain",
                    "pass": same,
                    "note": "stderr kernel means == plain kernel means"})
    print(json.dumps(RECORDS[-1]), flush=True)
    ok &= same
    r_xla = mc.integrate([lambda x: x, lambda x: x * x], d,
                         n_samples=1_000_000, seed=9, backend="xla",
                         return_stderr=True)
    ok &= check("stderr_kernel_vs_xla",
                list(np.asarray(r_se.stderr) / np.asarray(r_xla.stderr)),
                [1.0, 1.0], 0.1,
                "in-kernel pilot-shifted squares vs XLA sweep, 10%")

    r_cse = mc.integrate([lambda x: x], beta25, n_samples=2_000_000,
                         seed=9, return_stderr=True)
    beta_sd = math.sqrt(2 * 5 / ((2 + 5) ** 2 * 8))
    ok &= check("stderr_custom_table_kernel",
                [r_cse.stderr[0] * math.sqrt(2_000_000) / beta_sd],
                [1.0], 0.15,
                "custom-table stderr ~ sd(Beta(2,5))/sqrt(N_actual)")

    rm_x = mc.integrate_mcmc([lambda x: x], d, q2,
                             n_steps=2000, n_chains=4096, n_burnin=200,
                             seed=42, backend="xla", return_stderr=True)
    ratio = float(rm.stderr[0] / rm_x.stderr[0])
    ok &= check("mcmc_stderr_kernel_vs_xla", [min(max(ratio, 0.0), 3.0)],
                [1.0], 0.6,
                "kernel between-chain stderr within (0.4x, 1.6x) of XLA "
                "(different streams, same estimator)")

    # K>128 multi-pass fusion (round 3): 256 fused indicators on a
    # custom-table distribution, chained kernel passes over identical
    # sample streams — plus the stream-identity proof (same integrand in
    # different passes -> bit-equal estimates).
    edges256 = np.linspace(0.0, 1.0, 257)
    n_hist = 10_000_000
    r = mc.integrate(
        [bin_fn(float(lo), float(hi))
         for lo, hi in zip(edges256[:-1], edges256[1:])],
        beta_h, n_samples=n_hist, seed=42,
    )
    cdf_at = np.interp(edges256, beta_h._x_table, beta_h._cdf_table)
    expected_mass = np.diff(cdf_at)
    sigma = np.sqrt(np.maximum(expected_mass, 1e-12) / n_hist)
    ok &= check("multi_pass_k256_histogram", r.values, expected_mass,
                (6.0 * sigma + 5e-4).tolist(),
                "K=256 multi-pass kernel chaining, 256-bin Beta histogram")

    def _sq(v):
        return v * v

    r_dup = mc.integrate([_sq] * 129, d, n_samples=1_000_000, seed=5)
    same = bool(np.all(r_dup.values == r_dup.values[0]))
    RECORDS.append({"check": "multi_pass_stream_identity", "pass": same,
                    "note": "same integrand in both passes -> bit-equal"})
    print(json.dumps(RECORDS[-1]), flush=True)
    ok &= same

    # QMC auto-segmentation (round 3): one call past the 2^32-point vdc
    # cycle.  8.6e9 samples, tolerance far below the MC rate at that N.
    r = mc.integrate(
        [lambda x: x, lambda x: x * x], d,
        n_samples=8_600_000_000, seed=42, method="qmc",
    )
    ok &= check("qmc_segmented_8p6e9", r.values, [0.0, 1.0], 2e-4,
                "auto-split rotations past the uint32 counter, one call")

    # Split-R-hat diagnostics (round 3): near 1 when mixed, well above 1
    # for a deliberately mismatched proposal on a short run.
    r_good = mc.integrate_mcmc([lambda x: x], d, q2,
                               n_steps=2000, n_chains=512, n_burnin=200,
                               seed=42, return_diagnostics=True)
    r_bad = mc.integrate_mcmc([lambda x: x], d,
                              mc.Distribution.normal(4.0, 0.3),
                              n_steps=60, n_chains=512, n_burnin=0,
                              seed=42, return_diagnostics=True)
    ok &= check("split_rhat_mixed_vs_stuck",
                [r_good.diagnostics["r_hat"][0],
                 min(float(r_bad.diagnostics["r_hat"][0]), 3.0)],
                [1.0, 2.0], [0.05, 1.0],
                "R-hat ~1 when mixed; >1.1 for the mismatched proposal")

    # WGSL for-loop surface (round 3): a hand-written bounded-for WGSL
    # function runs end-to-end (desugared to while; XLA route).
    wgsl_src = """
    fn taylor_exp(x: f32) -> f32 {
        var term: f32 = 1.0;
        var s: f32 = 1.0;
        for (var i: f32 = 1.0; i < 12.0; i++) {
            term = term * x / i;
            s = s + term;
        }
        return s;
    }
    """
    r = mc.integrate([wgsl_src], mc.Distribution.uniform(0.0, 1.0),
                     n_samples=2_000_000, seed=42)
    ok &= check("wgsl_for_loop_integral", r.values, [math.e - 1.0], 0.01,
                "bounded-for WGSL string: E[exp(U)] on [0,1)")

    # WGSL structured jumps (round 3): loop/continuing/break if with a
    # convergence-controlled break, plus switch with WGSL case binding —
    # through the full dispatch path on hardware.
    wgsl_jump_src = """
    fn taylor_exp_adaptive(x: f32) -> f32 {
        var term: f32 = 1.0;
        var s: f32 = 1.0;
        var i: f32 = 1.0;
        loop {
            term = term * x / i;
            s = s + term;
            if (abs(term) < 1.0e-6) { break; }
            continuing {
                i = i + 1.0;
                break if i > 30.0;
            }
        }
        return s;
    }
    """
    r = mc.integrate([wgsl_jump_src], mc.Distribution.uniform(0.0, 1.0),
                     n_samples=2_000_000, seed=42)
    ok &= check("wgsl_loop_break_if_integral", r.values, [math.e - 1.0],
                0.01, "loop/continuing/break-if WGSL: E[exp(U)] on [0,1)")

    wgsl_switch_src = """
    fn inside_unit(x: f32) -> f32 {
        var region: f32 = 0.0;
        if (x < -1.0) { region = 0.0; }
        else { if (x < 1.0) { region = 1.0; } else { region = 2.0; } }
        switch (region) {
            case 0.0, 2.0: { return 0.0; }
            default: { return 1.0; }
        }
    }
    """
    r = mc.integrate([wgsl_switch_src], d, n_samples=10_000_000, seed=42)
    p_unit = math.erf(1.0 / math.sqrt(2.0))
    ok &= check("wgsl_switch_indicator", r.values, [p_unit], 0.01,
                "switch-dispatched indicator: P(|X|<1) under N(0,1)")

    # Return inside a loop (round 3): the reference transpiles Python
    # loop returns to WGSL 'return' (transpiler.py:561-567); here they
    # lower to a first-return-wins mask through lax.while_loop.
    def first_sq(x):
        i = 0.0
        while i < 100.0:
            i = i + 1.0
            if i * i > x:
                return i
        return -1.0

    u16 = mc.Distribution.uniform(0.0, 16.0)
    r = mc.integrate([first_sq], u16, n_samples=4_000_000, seed=42)
    exact_first_sq = sum(i * (2 * i - 1) for i in range(1, 5)) / 16.0
    ok &= check("return_in_loop_integral", r.values, [exact_first_sq], 0.02,
                "python integrand returning from inside a while loop")

    # Multi-dimensional family (round 3, capability beyond the 1-D
    # reference): the nd fused kernel compiled on hardware (mixed
    # analytic dims), in-kernel Sobol QMC, nd error bars, nd importance
    # sampling, and a joint-log-density MCMC target.
    u01 = mc.Distribution.uniform(0.0, 1.0)
    ex2 = mc.Distribution.exponential(2.0)
    r = mc.integrate(
        [lambda x, y, z: x * y * z, lambda x, y, z: x * x + y + z],
        [d, u01, ex2], n_samples=10_000_000, seed=42,
    )
    ok &= check("nd_mixed_dims", r.values, [0.0, 2.0], 0.01,
                "3-dim fused kernel: E[XYZ], E[X^2+Y+Z] over N x U x Exp")

    r = mc.integrate(
        [lambda x, y: np.exp(x) * np.exp(y)], [u01, u01],
        n_samples=10_000_000, seed=5, method="qmc",
    )
    ok &= check("nd_sobol_qmc", r.values, [(math.e - 1.0) ** 2],
                5e-4, "in-kernel 2-dim Sobol net: E[e^X e^Y] on U(0,1)^2")

    r = mc.integrate(
        [lambda x, y: x + y], [d, d], n_samples=10_000_000, seed=4,
        return_stderr=True,
    )
    ok &= check("nd_stderr",
                [float(r.values[0]) / max(float(r.stderr[0]), 1e-12),
                 float(r.stderr[0]) * math.sqrt(5e6)],
                [0.0, 1.0], [6.0, 0.4],
                "nd in-kernel error bars: |mean| <= 6 se, se ~ sqrt(2/N)")

    p_tail = (0.5 * math.erfc(3.0 / math.sqrt(2.0))) ** 2
    prop35 = mc.Distribution.normal(3.5, 1.0)
    r = mc.integrate_importance_sampling(
        [lambda x, y: ((x > 3.0) & (y > 3.0)) * 1.0],
        [d, d], [prop35, prop35], n_samples=10_000_000, seed=6,
    )
    ok &= check("nd_is_corner_tail", r.values, [p_tail], p_tail * 0.2,
                "nd IS: P(X>3, Y>3) with shifted product proposal")

    rho = 0.8
    cc = 1.0 / (2.0 * (1.0 - rho * rho))
    r = mc.integrate_mcmc(
        [lambda x, y: x * y],
        lambda x, y: -cc * (x * x - 2.0 * rho * x * y + y * y),
        [q2, q2], n_steps=4000, n_chains=2048, n_burnin=500, seed=1,
    )
    ok &= check("nd_mcmc_joint_density", r.values, [rho], 0.05,
                "nd MCMC: E[XY] of a rho=0.8 bivariate Gaussian from its "
                "joint log-density (rides the nd MH kernel)")

    # Table-sampled nd dims in-kernel (round 3): two custom dims — the
    # first through row-stratified tables, the second through the
    # full-inverse loop lookup — cross-term unbiasedness is exactly what
    # diagonal stratification would break.
    beta33 = mc.Distribution.beta(3.0, 3.0)
    r = mc.integrate(
        [lambda x, y: x * y, lambda x, y: x + y],
        [beta25, beta33], n_samples=10_000_000, seed=8,
    )
    ok &= check("nd_two_table_dims", r.values,
                [(2.0 / 7.0) * 0.5, 2.0 / 7.0 + 0.5], 0.005,
                "nd kernel, two custom dims: E[XY]=E[X]E[Y], E[X+Y]")
    r = mc.integrate(
        [lambda x, y: x * y], [beta25, u01],
        n_samples=10_000_000, seed=9, method="qmc",
    )
    ok &= check("nd_table_dim_qmc", r.values, [(2.0 / 7.0) * 0.5],
                0.002, "Sobol QMC through a full-inverse table dim")

    # nd param-batched serving + nd resume on hardware: each sweep
    # element bit-equal to its unbatched call; a fresh stateful nd run
    # reproduces the stateless estimates and a resumed segment draws
    # fresh streams.
    it_nd = mc.MonteCarloIntegrator()
    nd_rows = [
        [mc.Distribution.normal(0.0, 1.0), mc.Distribution.uniform(0.0, 1.0)],
        [mc.Distribution.normal(1.0, 2.0), mc.Distribution.uniform(-1.0, 1.0)],
    ]
    sweep_nd = it_nd.compile_integrate(
        [lambda x, y: x + y, lambda x, y: x * y], nd_rows[0],
        n_samples=1_000_000, seed_batch=2, param_batch=True,
    )
    out_nd = np.asarray(sweep_nd([7, 42], mc.pack_param_batch_nd(nd_rows)))
    singles_nd = np.stack([
        np.asarray(
            it_nd.compile_integrate(
                [lambda x, y: x + y, lambda x, y: x * y], row,
                n_samples=1_000_000,
            )(s)
        )
        for s, row in zip([7, 42], nd_rows)
    ])
    same = bool(np.array_equal(out_nd, singles_nd))
    RECORDS.append({"check": "nd_param_batch_bit_equal", "pass": same,
                    "note": "nd (R, d, 2) sweep elements bit-equal to "
                            "unbatched calls"})
    print(json.dumps(RECORDS[-1]), flush=True)
    ok &= same

    it_nd_xla = mc.MonteCarloIntegrator(backend="xla")
    r_st0 = it_nd_xla.integrate_mcmc(
        [lambda x, y: x * x + y * y], [d, d], [q2, q2],
        n_steps=1000, n_chains=1024, n_burnin=100, seed=42,
    )
    r_st1 = it_nd.integrate_mcmc(
        [lambda x, y: x * x + y * y], [d, d], [q2, q2],
        n_steps=1000, n_chains=1024, n_burnin=100, seed=42,
        return_state=True,
    )
    r_st2 = it_nd.integrate_mcmc(
        [lambda x, y: x * x + y * y], [d, d], [q2, q2],
        n_steps=1000, n_chains=1024, n_burnin=0, seed=42,
        initial_state=r_st1.chain_state,
    )
    ok &= check(
        "nd_mcmc_resume",
        [float(r_st1.values[0] - r_st0.values[0]),
         0.5 * (r_st1.values[0] + r_st2.values[0])],
        [0.0, 2.0], [1e-12, 0.05],
        "fresh stateful nd run == stateless (both on the XLA state "
        "path); resumed halves combine to E[X^2+Y^2]=2",
    )

    # nd MH kernel, product target + in-kernel between-chain error bars.
    rp = mc.integrate_mcmc(
        [lambda x, y: x * x + y * y, lambda x, y: x * y],
        [d, d], [q2, q2],
        n_steps=4000, n_chains=4096, n_burnin=400, seed=42,
        return_stderr=True,
    )
    ok &= check("nd_mcmc_product_kernel",
                [float(rp.values[0]), float(rp.values[1]),
                 float(rp.values[0] - 2.0)
                 / max(float(rp.stderr[0]), 1e-12)],
                [2.0, 0.0, 0.0], [0.05, 0.03, 6.0],
                "nd MH kernel, product N(0,1)^2 target: E[X^2+Y^2]=2, "
                "E[XY]=0, truth within 6 in-kernel error bars")

    # Randomized-QMC error bars (round 3): the rotation spread must
    # cover the composite estimate's error AND sit far below the MC
    # stderr at equal N on a smooth integrand.
    rq = mc.integrate([lambda x: np.exp(x)],
                      mc.Distribution.uniform(0.0, 1.0),
                      n_samples=4_000_000, seed=11, method="qmc",
                      return_stderr=True)
    rm = mc.integrate([lambda x: np.exp(x)],
                      mc.Distribution.uniform(0.0, 1.0),
                      n_samples=4_000_000, seed=11, return_stderr=True)
    err = abs(float(rq.values[0]) - (math.e - 1.0))
    ok &= check("rqmc_stderr_covers_error",
                [min(err / max(float(rq.stderr[0]), 1e-12), 10.0),
                 min(float(rq.stderr[0]) / float(rm.stderr[0]), 1.0)],
                [0.0, 0.0], [6.0, 0.2],
                "rotation-spread bars: |err|<=6*stderr and <0.2x MC bars")

    # --- extended analytic families (beyond the reference surface) ----
    # One compiled-kernel moment check per registry family; Cauchy has
    # no moments, so its check is the CDF at loc +/- scale.
    euler_gamma = 0.5772156649
    fam_rows = [
        (mc.Distribution.lognormal(0.3, 0.5), math.exp(0.425), "lognormal"),
        (mc.Distribution.laplace(1.0, 2.0), 1.0, "laplace"),
        (mc.Distribution.logistic(0.5, 1.0), 0.5, "logistic"),
        (mc.Distribution.gumbel(0.0, 1.5), 1.5 * euler_gamma, "gumbel"),
        (mc.Distribution.weibull(2.0, 1.0), math.gamma(1.5), "weibull"),
        (mc.Distribution.pareto(1.0, 3.0), 1.5, "pareto"),
    ]
    for dist_f, truth, fam in fam_rows:
        rf = mc.integrate([lambda x: x], dist_f,
                          n_samples=4_000_000, seed=42,
                          return_stderr=True)
        ok &= check(f"family_{fam}_mean",
                    [float(rf.values[0]),
                     float(rf.values[0] - truth)
                     / max(float(rf.stderr[0]), 1e-12)],
                    [truth, 0.0], [0.02 * max(abs(truth), 0.5), 6.0],
                    f"{fam} kernel: E[X] within tolerance AND 6 "
                    "in-kernel error bars")
    rc = mc.integrate([lambda x: x < 2.0, lambda x: x < 0.5,
                       lambda x: x < 3.5],
                      mc.Distribution.cauchy(2.0, 1.5),
                      n_samples=4_000_000, seed=42)
    ok &= check("family_cauchy_cdf", rc.values, [0.5, 0.25, 0.75], 0.005,
                "cauchy kernel (fast_tan inverse CDF): CDF at loc, "
                "loc +/- scale")

    # New-family MCMC in-kernel: laplace target via logistic proposal.
    rlm = mc.integrate_mcmc(
        [lambda x: x], mc.Distribution.laplace(3.0, 1.0),
        mc.Distribution.logistic(0.0, 2.0),
        n_steps=4000, n_chains=2048, n_burnin=500, seed=42,
    )
    ok &= check("family_mcmc_laplace_target", rlm.values, [3.0], 0.1,
                "MH kernel with extended-family target AND proposal")

    # New-family QMC through the kernel's rotated radical inverse.
    rwq = mc.integrate([lambda x: x], mc.Distribution.weibull(1.5, 2.0),
                       n_samples=1 << 21, seed=42, method="qmc")
    ok &= check("family_weibull_qmc", rwq.values,
                [2.0 * math.gamma(1.0 + 1.0 / 1.5)], 0.005,
                "monotone inverse CDF carries QMC structure")

    # Antithetic variates in the compiled kernel: exact pair
    # cancellation for E[X] (estimate == mean, stderr ~ 0), unbiased
    # second moment, and a REDUCED honest error bar on a monotone
    # integrand vs iid MC at the same N.
    ra = mc.integrate(
        [lambda x: x, lambda x: x * x], mc.Distribution.normal(3.0, 2.0),
        n_samples=10_000_000, seed=42, method="antithetic",
        return_stderr=True,
    )
    ok &= check("antithetic_exact_cancel",
                [ra.values[0], float(ra.stderr[0] < 1e-6),
                 ra.values[1]],
                [3.0, 1.0, 13.0], [1e-4, 1e-9, 0.05],
                "antithetic pairs cancel E[X] exactly in-kernel; "
                "E[X^2] unbiased")
    f_mono = [lambda x: 2.718281828 ** (0.5 * x)]
    dn = mc.Distribution.normal(0.0, 1.0)
    r_mc = mc.integrate(f_mono, dn, n_samples=10_000_000, seed=1,
                        method="mc", return_stderr=True)
    r_an = mc.integrate(f_mono, dn, n_samples=10_000_000, seed=1,
                        method="antithetic", return_stderr=True)
    ok &= check("antithetic_variance_reduction",
                [r_an.values[0],
                 float(r_an.stderr[0] < 0.7 * r_mc.stderr[0])],
                [math.exp(0.125), 1.0], [0.005, 1e-9],
                "monotone integrand: honest antithetic error bar "
                "under 0.7x the iid MC bar at equal N")

    # Control variates on the compiled kernel: the regression-corrected
    # estimate stays right while the residual error bar drops well
    # under the plain one (all moments fused into one kernel program).
    r_cv = mc.integrate(
        f_mono, dn, n_samples=10_000_000, seed=1, return_stderr=True,
        control_variates=[(lambda x: x, 0.0), (lambda x: x * x, 1.0)],
    )
    ok &= check("control_variates_kernel",
                [r_cv.values[0],
                 float(r_cv.stderr[0] < 0.3 * r_mc.stderr[0])],
                [math.exp(0.125), 1.0], [0.002, 1e-9],
                "two-control regression: estimate right, residual "
                "error bar under 0.3x the plain MC bar")

    # Thinned MCMC draws on hardware: the recorded states must carry the
    # target's distribution (N(3,2) moments) and recording must not
    # perturb the estimates.
    r_sm = mc.integrate_mcmc(
        [lambda x: x], mc.Distribution.normal(3.0, 2.0),
        mc.Distribution.normal(3.0, 4.0),
        n_steps=2000, n_chains=1024, n_burnin=200, seed=42,
        return_samples=40,
    )
    r_plain_sm = mc.integrate_mcmc(
        [lambda x: x], mc.Distribution.normal(3.0, 2.0),
        mc.Distribution.normal(3.0, 4.0),
        n_steps=2000, n_chains=1024, n_burnin=200, seed=42,
    )
    sm = np.asarray(r_sm.samples)
    ok &= check("mcmc_thinned_draws",
                [float(sm.shape == (40, 1024)), sm.mean(), sm.std(),
                 r_sm.values[0] - r_plain_sm.values[0]],
                [1.0, 3.0, 2.0, 0.0], [1e-9, 0.15, 0.2, 1e-12],
                "(m, chains) draws match the target's moments; "
                "recording leaves estimates bit-identical (both runs "
                "on the backend the workload routes to)")

    # In-kernel thinned draws (round 4): the Pallas kernel stores draw
    # rows from registers; forced-kernel runs must keep estimates
    # bit-identical and produce target-shaped draws, 1-D and nd.
    integ_p = mc.MonteCarloIntegrator(backend="pallas")
    kw_sp = dict(n_steps=2000, n_chains=4096, n_burnin=200, seed=42)
    r_ks = integ_p.integrate_mcmc(
        [lambda x: x], mc.Distribution.normal(3.0, 2.0),
        mc.Distribution.normal(3.0, 4.0), return_samples=40, **kw_sp
    )
    r_kp = integ_p.integrate_mcmc(
        [lambda x: x], mc.Distribution.normal(3.0, 2.0),
        mc.Distribution.normal(3.0, 4.0), **kw_sp
    )
    sk = np.asarray(r_ks.samples)
    ok &= check("kernel_thinned_draws_1d",
                [float(sk.shape == (40, 4096)), sk.mean(), sk.std(),
                 r_ks.values[0] - r_kp.values[0]],
                [1.0, 3.0, 2.0, 0.0], [1e-9, 0.15, 0.2, 1e-12],
                "Pallas in-kernel draws: target moments, estimates "
                "bit-identical to the samples-free kernel")

    rho_s, c_s = -0.5, 1.0 / (2.0 * (1.0 - 0.25))
    r_kn = integ_p.integrate_mcmc(
        [lambda x, y: x * y],
        lambda x, y: -c_s * (x * x - 2.0 * rho_s * x * y + y * y),
        mc.RandomWalk(step_size=1.0, init_range=(-3.0, 3.0)),
        n_steps=2000, n_chains=2048, n_burnin=500, seed=42,
        return_samples=25,
    )
    skn = np.asarray(r_kn.samples)
    corr_kn = float(np.corrcoef(
        skn[..., 0].ravel(), skn[..., 1].ravel()
    )[0, 1])
    ok &= check("kernel_thinned_draws_nd",
                [float(skn.shape[0] == 25 and skn.shape[2] == 2),
                 corr_kn],
                [1.0, rho_s], [1e-9, 0.06],
                "nd Pallas draws reproduce the joint target's "
                "cross-correlation")

    # IS proposal diagnostics (Kish ESS in-kernel): p=N(0,1), q=N(1,1)
    # has E_q[w^2] = e, so ESS/n -> e^-1.
    ress = mc.integrate_importance_sampling(
        [lambda x: x], mc.Distribution.normal(0.0, 1.0),
        mc.Distribution.normal(1.0, 1.0),
        n_samples=4_000_000, seed=42, return_diagnostics=True,
    )
    ok &= check("is_ess_diagnostics",
                [ress.diagnostics["mean_weight"],
                 ress.diagnostics["ess"] / 4_000_000],
                [1.0, math.exp(-1.0)], [0.01, 0.02],
                "weight-column ESS: mean weight ~1, ESS/n ~ e^-1")

    # Random-walk Metropolis in-kernel: fixed-step moments, burn-in
    # step adaptation converging to the target acceptance, and a 2-D
    # correlated joint target (rho = 0.6 -> E[XY] = 0.6) whose dimension
    # count is read off the density's arity.
    rrw = mc.integrate_mcmc(
        [lambda x: x, lambda x: x * x],
        mc.Distribution.normal(3.0, 2.0), mc.RandomWalk(step_size=2.0),
        n_steps=4000, n_chains=2048, n_burnin=500, seed=42,
    )
    ok &= check("rw_normal_moments", rrw.values, [3.0, 13.0],
                [0.1, 0.5], "random-walk MH kernel: N(3,2) moments")
    rra = mc.integrate_mcmc(
        [lambda x: x], mc.Distribution.normal(3.0, 2.0),
        mc.RandomWalk(step_size=50.0, adapt=True),
        n_steps=4000, n_chains=2048, n_burnin=1000, seed=42,
    )
    ok &= check("rw_adapt_acceptance",
                [rra.values[0], rra.acceptance_rate], [3.0, 0.44],
                [0.15, 0.08],
                "Robbins-Monro step adaptation: estimate right AND "
                "acceptance at the 0.44 target from a 25x-off step")
    rho_rw = 0.6
    c_rw = 1.0 / (2.0 * (1.0 - rho_rw * rho_rw))
    rrn = mc.integrate_mcmc(
        [lambda x, y: x * y],
        lambda x, y: -c_rw * (x * x - 2.0 * rho_rw * x * y + y * y),
        mc.RandomWalk(step_size=1.0, init_range=(-3.0, 3.0)),
        n_steps=4000, n_chains=2048, n_burnin=500, seed=42,
    )
    ok &= check("rw_nd_joint_corr", rrn.values, [rho_rw], 0.06,
                "2-D random walk on a correlated joint log-density "
                "(arity-derived d): E[XY] = rho")
    rrx = mc.MonteCarloIntegrator(backend="xla").integrate_mcmc(
        [lambda x: x, lambda x: x * x],
        mc.Distribution.normal(3.0, 2.0), mc.RandomWalk(step_size=2.0),
        n_steps=4000, n_chains=2048, n_burnin=500, seed=42,
    )
    ok &= check("rw_kernel_vs_xla",
                [rrw.values[0] - rrx.values[0],
                 rrw.values[1] - rrx.values[1]], [0.0, 0.0],
                [0.1, 0.5],
                "kernel and XLA random walks agree statistically "
                "(different RNG streams)")

    # Param-batched random-walk sweep: (R, 4) walk rows ride the
    # proposal-params slot (pack_random_walk_batch); every element must
    # be bit-equal to its unbatched call.  Both rows adapt their step
    # during burn-in (adaptation is a compile-time kernel phase, so a
    # pack's adapt tag must match the program's — mixed packs are
    # rejected at pack time).
    rw_targets = [mc.Distribution.normal(0.0, 1.0),
                  mc.Distribution.normal(2.0, 0.5)]
    rw_walks = [mc.RandomWalk(step_size=2.4, adapt=True),
                mc.RandomWalk(step_size=1.0, adapt=True)]
    it_rw = mc.MonteCarloIntegrator()
    rw_sweep = it_rw.compile_mcmc(
        [lambda x: x], rw_targets[0], rw_walks[0],
        n_steps=2000, n_chains=1024, n_burnin=200,
        seed_batch=2, param_batch=True,
    )
    wv, wa = rw_sweep(
        [7, 42], mc.pack_param_batch(rw_targets),
        mc.pack_random_walk_batch(rw_walks, rw_targets),
    )
    wv, wa = np.asarray(wv), np.asarray(wa)
    rw_singles = [
        it_rw.compile_mcmc([lambda x: x], t, w,
                           n_steps=2000, n_chains=1024, n_burnin=200)(s)
        for s, t, w in zip([7, 42], rw_targets, rw_walks)
    ]
    rw_sv = np.stack([np.asarray(v) for v, _ in rw_singles])
    rw_sa = np.asarray([float(np.asarray(a)) for _, a in rw_singles])
    ok &= check("rw_param_batch_bit_equal",
                list((wv - rw_sv).ravel()) + list(wa - rw_sa),
                [0.0] * 4, 1e-12,
                "param-batched random-walk sweep (adaptive + fixed "
                "rows) bit-equal to unbatched calls")

    # Hamiltonian Monte Carlo in-kernel: leapfrog + exact Metropolis
    # energy correction.  Analytic target moments, burn-in step
    # adaptation toward the 0.8 HMC optimum, a 2-D correlated joint
    # target (gradient traced from the density expression), and
    # kernel-vs-XLA statistical agreement.
    rh = mc.integrate_mcmc(
        [lambda x: x, lambda x: x * x],
        mc.Distribution.normal(3.0, 2.0),
        mc.HMC(step_size=0.4, n_leapfrog=8),
        n_steps=3000, n_chains=2048, n_burnin=400, seed=42,
    )
    ok &= check("hmc_normal_moments",
                list(rh.values) + [rh.acceptance_rate > 0.6],
                [3.0, 13.0, 1.0], [0.1, 0.5, 1e-9],
                "in-kernel leapfrog HMC: N(3,2) moments, healthy "
                "acceptance")
    rha = mc.integrate_mcmc(
        [lambda x: x],
        mc.Distribution.normal(0.0, 1.0),
        mc.HMC(step_size=2.5, n_leapfrog=5, adapt=True),
        n_steps=3000, n_chains=2048, n_burnin=1000, seed=42,
    )
    ok &= check("hmc_adapt_acceptance",
                [rha.values[0], rha.acceptance_rate], [0.0, 0.8],
                [0.1, 0.08],
                "Robbins-Monro leapfrog-step adaptation reaches the "
                "0.8 HMC target from a 5x-off step")
    rho_h = 0.6
    c_h = 1.0 / (2.0 * (1.0 - rho_h * rho_h))
    rhn = mc.integrate_mcmc(
        [lambda x, y: x * y],
        lambda x, y: -c_h * (x * x - 2.0 * rho_h * x * y + y * y),
        mc.HMC(step_size=0.5, n_leapfrog=6, init_range=(-3.0, 3.0)),
        n_steps=3000, n_chains=2048, n_burnin=400, seed=42,
    )
    ok &= check("hmc_nd_joint_corr", rhn.values, [rho_h], 0.06,
                "2-D in-kernel HMC on a correlated joint log-density: "
                "E[XY] = rho (gradient traced from the expression)")
    rhx = mc.MonteCarloIntegrator(backend="xla").integrate_mcmc(
        [lambda x: x, lambda x: x * x],
        mc.Distribution.normal(3.0, 2.0),
        mc.HMC(step_size=0.4, n_leapfrog=8),
        n_steps=3000, n_chains=2048, n_burnin=400, seed=42,
    )
    ok &= check("hmc_kernel_vs_xla",
                [rh.values[0] - rhx.values[0],
                 rh.values[1] - rhx.values[1]], [0.0, 0.0],
                [0.1, 0.5],
                "kernel and XLA HMC agree statistically "
                "(different RNG streams)")

    # Parallel tempering: the multimodal escape itself, on-chip.  A
    # step-0.5 walk initialised in the right-hand basin of
    # 0.5 N(-4,1) + 0.5 N(4,1) is provably trapped there (the ~8-sigma
    # barrier); the tempered ladder recovers both global moments.
    def _pt_logmix(x):
        return math.log(
            math.exp(-0.5 * (x + 4.0) ** 2)
            + math.exp(-0.5 * (x - 4.0) ** 2)
        )

    r_trap = mc.integrate_mcmc(
        [lambda x: x], _pt_logmix,
        mc.RandomWalk(step_size=0.5, init_range=(3.0, 5.0)),
        n_steps=2000, n_chains=1024, n_burnin=500, seed=42,
    )
    r_temp = mc.integrate_mcmc(
        [lambda x: x, lambda x: x * x], _pt_logmix,
        mc.RandomWalk(step_size=0.5, adapt=True,
                      init_range=(3.0, 5.0)),
        n_steps=2000, n_chains=1024, n_burnin=500, seed=42,
        temperatures=[1.0, 2.0, 4.0, 8.0, 16.0],
    )
    ok &= check("tempering_multimodal_escape",
                [float(r_trap.values[0] > 3.0), r_temp.values[0],
                 r_temp.values[1],
                 float(0.0 < r_temp.diagnostics["swap_rate"] <= 1.0)],
                [1.0, 0.0, 17.0, 1.0], [1e-9, 0.4, 0.8, 1e-9],
                "plain walk trapped at the right mode; replica "
                "exchange recovers E[X]=0, E[X^2]=17")

    # Adaptive importance sampling: learn the proposal on-device (VEGAS
    # grid refinement), then run the production IS through the table
    # fast path.  P(X > 4) = 3.16712e-5 under N(0,1); the learned
    # proposal must hit it within 3% AND cut the naive-MC error bar
    # (sqrt(p/n) ~ 2.8e-6 at this n) by >= 20x.
    q_ad = mc.adapt_proposal(
        lambda x: 1.0 if x > 4.0 else 0.0,
        mc.Distribution.normal(0.0, 1.0),
        n_iterations=8, seed=42, support=(-8.0, 8.0),
    )
    r_ad = mc.integrate_importance_sampling(
        [lambda x: 1.0 if x > 4.0 else 0.0],
        mc.Distribution.normal(0.0, 1.0), q_ad,
        n_samples=4_000_000, seed=42, return_stderr=True,
    )
    ok &= check("adaptive_is_rare_event",
                [r_ad.values[0] / 3.16712e-05,
                 float(r_ad.stderr[0] < 1.4e-7)],
                [1.0, 1.0], [0.03, 1e-9],
                "VEGAS-learned proposal: rare-event estimate within 3% "
                "with >= 20x the naive-MC precision")

    # Scipy-backed table families: gamma rides the in-kernel stratified
    # custom sampler (quantile-spaced knots); Student-t is heavy-tailed,
    # so the distortion guard must route it to the knot-exact XLA
    # searchsorted sampler — E[X^2] is the bias detector (the resampled
    # inverse tables measured 1.95 against the true 1.667).
    g = mc.Distribution.gamma(shape=3.0, rate=2.0)
    r_g = mc.integrate([lambda x: x, lambda x: x * x], g,
                       n_samples=4_000_000, seed=42)
    ok &= check("gamma_moments", r_g.values, [1.5, 3.0], [0.01, 0.03],
                "Gamma(3, rate 2): mean 1.5, E[X^2] = 3")

    t5 = mc.Distribution.student_t(df=5.0)
    from tpu_montecarlo.sampling import dist_spec_of
    spec_t5 = dist_spec_of(t5)
    r_t = mc.integrate([lambda x: x, lambda x: x * x], t5,
                       n_samples=4_000_000, seed=42)
    ok &= check("student_t5_heavy_tail_exact",
                [r_t.values[0], r_t.values[1],
                 float(spec_t5.heavy_tail)],
                [0.0, 5.0 / 3.0, 1.0], [0.02, 0.06, 1e-9],
                "t(5) routed knot-exact: E[X^2] 5/3 (smeared inverse "
                "tables gave 1.95)")

    x2 = mc.Distribution.chi2(df=4.0)
    r_x = mc.integrate_mcmc(
        [lambda x: x], x2, mc.Distribution.gamma(2.0, 0.25),
        n_steps=2_000, n_chains=1024, n_burnin=500, seed=42,
    )
    ok &= check("chi2_mcmc_target", r_x.values, [4.0], 0.2,
                "chi-squared(4) MCMC target via a gamma proposal")

    # --- round 5: table dims in the nd MCMC kernel, HMC table
    # gradients, in-kernel nd/tempered inference, tempered
    # independence, batched draws, WGSL matrices + bitwise ----------
    nprop = mc.Distribution.normal(0.0, 2.0)
    n01d = mc.Distribution.normal(0.0, 1.0)
    r = mc.integrate_mcmc(
        [lambda x, y: x * y, lambda x, y: x * x], [beta25, n01d],
        [beta25, nprop], n_steps=3000, n_chains=2048, n_burnin=400,
        seed=11,
    )
    ok &= check("nd_mcmc_table_dims_kernel", r.values,
                [0.0, 15.0 / 140.0], [0.01, 0.004],
                "nd MCMC with CUSTOM target AND proposal dims fully "
                "in-kernel (round 5): Beta(2,5) x N(0,1) product")

    r = mc.integrate_mcmc(
        [lambda x: x, lambda x: x * x], beta25,
        mc.HMC(step_size=0.05, n_leapfrog=6),
        n_steps=3000, n_chains=2048, n_burnin=500, seed=4,
    )
    ok &= check("hmc_table_target_kernel", r.values,
                [2.0 / 7.0, 15.0 / 140.0], [0.01, 0.005],
                "in-kernel HMC on a CUSTOM table target: the gradient "
                "is the log-table interpolant's gathered slope")

    r = mc.integrate_mcmc(
        [lambda x, y: x + y], [n01d, n01d], [nprop, nprop],
        n_steps=2000, n_chains=2048, n_burnin=300, seed=5,
        return_stderr=True, return_diagnostics=True,
    )
    ok &= check("nd_diagnostics_kernel",
                [r.diagnostics["r_hat"][0],
                 float(abs(r.values[0]) < 6 * r.stderr[0] + 1e-3),
                 float(r.diagnostics["ess"][0] > 0)],
                [1.0, 1.0, 1.0], [0.02, 1e-9, 1e-9],
                "nd split-R-hat/ESS + stderr in-kernel (round 5)")

    r = mc.integrate_mcmc(
        [lambda x: x * x], mc.Distribution.normal(0.0, 1.5),
        mc.RandomWalk(step_size=0.8, adapt=True),
        n_steps=2000, n_chains=2048, n_burnin=500, seed=3,
        temperatures=[1.0, 2.0, 4.0],
        return_stderr=True, return_diagnostics=True,
    )
    ok &= check("tempered_inference_kernel",
                [r.values[0], r.diagnostics["r_hat"][0],
                 float(r.stderr[0] > 0)],
                [2.25, 1.0, 1.0], [0.1, 0.02, 1e-9],
                "tempered cold-rung stderr + split-R-hat in-kernel "
                "(round 5)")

    r = mc.integrate_mcmc(
        [lambda x: x, lambda x: x * x], _pt_logmix,
        mc.Distribution.normal(0.0, 6.0),
        n_steps=2000, n_chains=2048, n_burnin=300, seed=7,
        temperatures=[1.0, 2.0, 4.0],
    )
    ok &= check("tempered_independence_kernel",
                [r.values[0], r.values[1],
                 float(0.0 < r.diagnostics["swap_rate"] <= 1.0)],
                [0.0, 17.0, 1.0], [0.4, 0.8, 1e-9],
                "tempered INDEPENDENCE sampling (the reference's "
                "native proposal, round 5): q terms untempered, logq "
                "swaps with the state; both modes recovered")

    # Tempered independence with a CUSTOM (table) proposal — the
    # sampler-mode-logq kernel path (round 5): logq is the draw's own
    # gathered inverse slope, so no q-table is staged and the values
    # swap between rungs like closed forms.  Target 0.5 N(-2,1) +
    # 0.5 N(2,1) (table): E[X] = 0, E[X^2] = 5.
    bi_t = mc.Distribution.from_pdf(
        lambda x: math.exp(-0.5 * (x - 2.0) ** 2)
        + math.exp(-0.5 * (x + 2.0) ** 2),
        support=(-6.0, 6.0),
    )
    wide_q = mc.Distribution.from_pdf(
        lambda x: math.exp(-0.5 * (x / 3.0) ** 2),
        support=(-7.0, 7.0),
    )
    r = mc.integrate_mcmc(
        [lambda x: x, lambda x: x * x], bi_t, wide_q,
        n_steps=2000, n_chains=2048, n_burnin=300, seed=7,
        temperatures=[1.0, 2.0, 4.0],
    )
    ok &= check("tempered_custom_proposal_kernel",
                [r.values[0], r.values[1],
                 float(0.0 < r.diagnostics["swap_rate"] <= 1.0)],
                [0.0, 5.0, 1.0], [0.1, 0.2, 1e-9],
                "tempered CUSTOM table proposal in-kernel via "
                "sampler-mode logq (round 5)")

    r = mc.integrate_mcmc(
        [lambda x, y: x * y, lambda x, y: x * x], [beta25, n01d],
        mc.RandomWalk(
            step_size=0.3, init_range=[(0.05, 0.95), (-2.0, 2.0)]
        ),
        n_steps=2000, n_chains=2048, n_burnin=400, seed=7,
        temperatures=[1.0, 2.0, 4.0],
    )
    ok &= check("tempered_nd_table_dim_kernel", r.values,
                [0.0, 15.0 / 140.0], [0.01, 0.005],
                "tempered nd product target with a CUSTOM table dim "
                "runs in-kernel (round 5): Beta(2,5) x N(0,1)")

    r = mc.integrate_mcmc(
        [lambda v: v], beta25,
        mc.HMC(step_size=0.05, n_leapfrog=5, init_range=(0.05, 0.95)),
        n_steps=2000, n_chains=2048, n_burnin=400, seed=9,
        temperatures=[1.0, 2.0],
    )
    ok &= check("tempered_hmc_table_kernel", r.values, [2.0 / 7.0],
                0.01, "tempered HMC on a CUSTOM table target in-kernel "
                "(gathered interpolant slopes, round 5)")

    _integ_b = mc.MonteCarloIntegrator()
    prog_b = _integ_b.compile_mcmc(
        [lambda x: x], mc.Distribution.normal(1.0, 1.0), nprop,
        n_steps=400, n_chains=1024, n_burnin=50,
        seed_batch=3, return_samples=5,
    )
    _, _, s_b = prog_b(np.arange(3, dtype=np.uint32) + 40)
    prog_1 = _integ_b.compile_mcmc(
        [lambda x: x], mc.Distribution.normal(1.0, 1.0), nprop,
        n_steps=400, n_chains=1024, n_burnin=50, return_samples=5,
    )
    _, _, s_1 = prog_1(41)
    ok &= check("batched_thinned_draws_bit_equal",
                [float(np.array_equal(np.asarray(s_b)[1],
                                      np.asarray(s_1))),
                 float(np.asarray(s_b).shape == (3, 5, 1024))],
                [1.0, 1.0], [1e-9, 1e-9],
                "seed-batched in-kernel draws: rep slab bit-equal "
                "to the unbatched handle (round 5)")

    r = mc.integrate(
        ["fn f(x: f32) -> f32 {\n"
         "  let m = mat2x2<f32>(2.0, 0.0, 0.0, 3.0);\n"
         "  let v = vec2<f32>(x, 1.0);\n"
         "  return dot(v, m * v); }"],
        u01, n_samples=5_000_000, seed=9,
    )
    ok &= check("wgsl_matrix_integrand", r.values, [2.0 / 3.0 + 3.0],
                0.005, "WGSL matCxR<f32> locals trace into the kernel "
                "(round 5): E[v'Mv] with v=(U,1)")

    r = mc.integrate(
        ["fn f(x: f32) -> f32 {\n"
         "  let q = u32(x * 255.0);\n"
         "  return f32((q >> 4u) & 15u) / 15.0; }"],
        u01, n_samples=5_000_000, seed=5,
    )
    ok &= check("wgsl_bitwise_integrand", r.values, [0.498], 0.02,
                "WGSL bitwise/shift ops via int32 conversions "
                "(round 5), in-kernel")

    return _finish(ok, backend, args.out)


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:
        traceback.print_exc()
        sys.exit(2)
