#!/usr/bin/env python3
"""Benchmark harness: the BASELINE.md configs + chain-steps/sec, on a GPU.

Prints one JSON line per config; ``--out PATH`` also writes them all to
PATH.  Fails when JAX finds no GPU.

Methodology: programs are compiled once via the ahead-of-time handles
(`compile_integrate` / `compile_importance_sampling` / `compile_mcmc`)
in seed-batched mode (``seed_batch=R``): R independent n_samples-jobs with
distinct seeds execute inside ONE device program, each keeping the exact
single-call semantics (bit-equal to the unbatched handle;
tests/test_seed_batch.py).  The batch is warmed (compile + first run),
then timed over back-to-back dispatches that all end in
``block_until_ready``; the better of two rounds is kept.

Run:  python benchmarks/run_all.py [--repeats N] [--out PATH]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _setup_jax():
    import jax

    from tpu_montecarlo.utils.compile_cache import use_compile_cache

    use_compile_cache()
    return jax


def _throughput(
    prog, work_per_call, repeats, fetch=lambda out: np.asarray(out), outer=3
):
    """prog is a seed_batch=repeats handle: each dispatch sweeps `repeats`
    independent jobs in one device program.  `outer` dispatches are
    issued back-to-back and all are blocked on before the clock stops;
    two timed rounds, the faster kept.  Returns (throughput, last job's
    estimates)."""
    import jax

    warm_seeds = [42 + r for r in range(repeats)]
    jax.block_until_ready(prog(warm_seeds))  # compile + first run
    best_dt, last = None, None
    for rnd in range(2):
        t0 = time.perf_counter()
        outs = [
            prog([100 + (rnd * outer + o) * repeats + r for r in range(repeats)])
            for o in range(outer)
        ]
        jax.block_until_ready(outs)
        dt = time.perf_counter() - t0
        if best_dt is None or dt < best_dt:
            best_dt, last = dt, outs[-1]
    return work_per_call * repeats * outer / best_dt, fetch(last)[-1]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeats", type=int, default=10)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    jax = _setup_jax()
    if jax.devices()[0].platform != "gpu":
        sys.exit(f"no GPU: JAX found {jax.devices()[0].platform!r}")
    from tpu_montecarlo import Distribution, MonteCarloIntegrator

    repeats = args.repeats

    def rbatch(n_samples):
        """Per-config batch size: ~1e9 samples per dispatch, so device
        time dominates the per-dispatch host cost (the kernels batch via a
        grid dimension)."""
        return max(repeats, min(1024, 1_000_000_000 // max(n_samples, 1)))

    integrator = MonteCarloIntegrator()
    results = []

    def emit(name, metric, value, unit, estimates):
        rec = {
            "config": name,
            "metric": metric,
            "value": value,
            "unit": unit,
            "device": jax.devices()[0].device_kind,
            "estimates": [float(v) for v in np.ravel(estimates)[:4]],
        }
        results.append(rec)
        print(json.dumps(rec), flush=True)

    # Config 1: K=2 simple moments, 1e6 samples (CPU-runnable sanity).
    r1b = rbatch(1_000_000)
    prog = integrator.compile_integrate(
        [lambda x: x, lambda x: x**2],
        Distribution.normal(0.0, 1.0),
        n_samples=1_000_000,
        seed_batch=r1b,
    )
    sps, est = _throughput(prog, 1_000_000, r1b)
    emit("c1_k2_normal_1e6", "samples_per_sec", sps, "samples/s", est)

    # Config 2: K=8 fused incl. indicators, 1e8 samples.
    k8 = [
        lambda x: x,
        lambda x: x**2,
        lambda x: x**3,
        lambda x: x**4,
        lambda x: np.sin(x),
        lambda x: np.exp(-x * x),
        lambda x: x > 1.0,
        lambda x: abs(x),
    ]
    n2 = 100_000_000
    prog = integrator.compile_integrate(
        k8, Distribution.normal(0.0, 1.0), n_samples=n2, seed_batch=repeats
    )
    sps, est = _throughput(prog, n2, repeats)
    emit("c2_k8_normal_1e8", "samples_per_sec", sps, "samples/s", est)

    # Config 2b: the same K=8 workload under antithetic pairing — one
    # erf_inv per PAIR, so it should run FASTER than plain MC while also
    # cutting variance on the monotone integrands.
    prog = integrator.compile_integrate(
        k8, Distribution.normal(0.0, 1.0), n_samples=n2,
        seed_batch=repeats, method="antithetic",
    )
    sps, est = _throughput(prog, n2, repeats)
    emit("c2b_k8_antithetic_1e8", "samples_per_sec", sps, "samples/s", est)

    # Config 3: custom from_pdf Beta(2,5) + triangular via table, 1e7 samples.
    def tri_pdf(x):
        if 0 <= x <= 1:
            return x
        if 1 < x <= 2:
            return 2 - x
        return 0.0

    n3 = 10_000_000
    beta = Distribution.beta(2.0, 5.0, table_size=512)
    tri = Distribution.from_pdf(tri_pdf, support=(0.0, 2.0), table_size=512)
    r3b = rbatch(n3)
    prog = integrator.compile_integrate(
        [lambda x: x, lambda x: x * x], beta, n_samples=n3,
        seed_batch=r3b,
    )
    sps_b, est_b = _throughput(prog, n3, r3b)
    emit("c3a_beta_table_1e7", "samples_per_sec", sps_b, "samples/s", est_b)
    prog = integrator.compile_integrate(
        [lambda x: x], tri, n_samples=n3, seed_batch=r3b
    )
    sps_t, est_t = _throughput(prog, n3, r3b)
    emit("c3b_triangular_table_1e7", "samples_per_sec", sps_t, "samples/s", est_t)

    # Config 4: IS rare event P(X>4), 1e8 samples.
    n4 = 100_000_000
    prog = integrator.compile_importance_sampling(
        [lambda x: x > 4.0],
        Distribution.normal(0.0, 1.0),
        Distribution.normal(4.0, 1.5),
        n_samples=n4,
        seed_batch=repeats,
    )
    sps, est = _throughput(prog, n4, repeats)
    emit("c4_is_rare_event_1e8", "samples_per_sec", sps, "samples/s", est)

    # Config 5: MCMC 4096 chains x 10k steps + 1k burn-in, table target.
    def bimodal(x):
        import math

        return math.exp(-0.5 * (x - 2.0) ** 2) + math.exp(-0.5 * (x + 2.0) ** 2)

    def fetch_mcmc(out):
        return np.asarray(out[0])

    steps5 = 10_000
    burn5 = 1_000
    work5 = 4096 * (steps5 + burn5)

    rmc5 = repeats
    table_target = Distribution.from_pdf(bimodal, support=(-6.0, 6.0))
    prog = integrator.compile_mcmc(
        [lambda x: x * x], table_target, Distribution.uniform(-6.0, 6.0),
        n_steps=steps5, n_chains=4096, n_burnin=burn5, seed_batch=rmc5,
    )
    csps, est = _throughput(
        prog, work5, rmc5, fetch=fetch_mcmc
    )
    emit("c5_mcmc_4096x10k_table", "chain_steps_per_sec", csps, "steps/s", est)

    # Chain-steps/sec on the analytic fast path.
    prog = integrator.compile_mcmc(
        [lambda x: x * x],
        Distribution.normal(0.0, 1.0),
        Distribution.normal(0.0, 2.0),
        n_steps=steps5, n_chains=4096, n_burnin=burn5, seed_batch=rmc5,
    )
    csps, est = _throughput(
        prog, work5, rmc5, fetch=fetch_mcmc
    )
    emit("c5b_mcmc_4096x10k_analytic", "chain_steps_per_sec", csps, "steps/s", est)

    # Config 5c (round 3): K=8 MCMC with 1k burn-in — the split kernel
    # loop runs NO integrand evals during burn-in.  c5c_fused_shape runs
    # the same iteration count with every iteration evaluating (burnin=0,
    # steps=11k): the old fused-loop behavior's workload.  The c5c /
    # c5c_fused_shape ratio is the measured burn-in-split gain.
    prog = integrator.compile_mcmc(
        k8,
        Distribution.normal(0.0, 1.0),
        Distribution.normal(0.0, 2.0),
        n_steps=steps5, n_chains=4096, n_burnin=burn5, seed_batch=rmc5,
    )
    csps, est = _throughput(
        prog, work5, rmc5, fetch=fetch_mcmc
    )
    emit("c5c_mcmc_k8_burnin_split", "chain_steps_per_sec", csps,
         "steps/s", est)
    prog = integrator.compile_mcmc(
        k8,
        Distribution.normal(0.0, 1.0),
        Distribution.normal(0.0, 2.0),
        n_steps=steps5 + burn5, n_chains=4096, n_burnin=0,
        seed_batch=rmc5,
    )
    csps, est = _throughput(
        prog, work5, rmc5, fetch=fetch_mcmc
    )
    emit("c5c_fused_shape_all_evals", "chain_steps_per_sec", csps,
         "steps/s", est)

    # Config 7 (round 3): 128- vs 256-bin custom-table histograms.  K=256
    # chains two kernel passes over identical streams (the former >128
    # cliff); its per-FUNCTION eval throughput should be within ~2x of
    # the single-pass K=128 kernel.
    n7 = 1_000_000_000
    beta_hist = Distribution.beta(2.0, 5.0, table_size=2048)

    def hist_fns(k):
        edges = np.linspace(0.0, 1.0, k + 1)

        def mk(lo, hi):
            return lambda v: (v >= lo) * (v < hi)

        return [
            mk(float(lo), float(hi))
            for lo, hi in zip(edges[:-1], edges[1:])
        ]

    for kk in (128, 256):
        prog = integrator.compile_integrate(
            hist_fns(kk), beta_hist, n_samples=n7
        )
        jax.block_until_ready(prog(42))  # compile + first run
        t0 = time.perf_counter()
        outs = [prog(100 + i) for i in range(3)]
        jax.block_until_ready(outs)
        dt = time.perf_counter() - t0
        last = np.asarray(outs[-1])
        emit(
            f"c7_k{kk}_custom_hist", "samples_per_sec", n7 * 3 / dt,
            "samples/s", last[:4],
        )

    # Config 8 (round 3): the error-bar cost on the kernel path — the
    # same K=8 / MCMC workloads with in-kernel pilot-shifted squares.
    # Compare against c2 / c5b: before round 3 return_stderr forced the
    # XLA sweep (~5x on analytic K=8, up to ~500x on custom tables).
    def fetch_first(out):
        return np.asarray(out[0])

    prog = integrator.compile_integrate(
        k8, Distribution.normal(0.0, 1.0), n_samples=n2,
        seed_batch=repeats, return_stderr=True,
    )
    sps, est = _throughput(prog, n2, repeats, fetch=fetch_first)
    emit("c8_k8_stderr_kernel", "samples_per_sec", sps, "samples/s", est)
    prog = integrator.compile_mcmc(
        [lambda x: x * x],
        Distribution.normal(0.0, 1.0),
        Distribution.normal(0.0, 2.0),
        n_steps=steps5, n_chains=4096, n_burnin=burn5,
        seed_batch=rmc5, return_stderr=True,
    )
    csps, est = _throughput(
        prog, work5, rmc5, fetch=fetch_first
    )
    emit("c8b_mcmc_stderr_kernel", "chain_steps_per_sec", csps,
         "steps/s", est)

    # Config 6 (addition over BASELINE): QMC at the config-2 shape — same
    # K=8 fused kernel drawing the rotated radical-inverse point set.
    # Throughput should be within a few % of config 2; the estimates
    # recorded alongside show the 1-2 orders-of-magnitude accuracy gain.
    n6 = 100_000_000
    r6b = rbatch(n6)
    prog = integrator.compile_integrate(
        k8, Distribution.normal(0.0, 1.0), n_samples=n6,
        seed_batch=r6b, method="qmc",
    )
    sps, est = _throughput(prog, n6, r6b)
    emit("c6_qmc_k8_normal_1e8", "samples_per_sec", sps, "samples/s", est)

    # Config 9 (round 3): the multi-dimensional family on its kernels.
    # Throughput counts d-VECTOR samples (each costs d draws + the fused
    # K evals); nd MCMC counts chain steps as in c5.
    n9 = 100_000_000
    r9 = rbatch(n9)
    prog = integrator.compile_integrate(
        [lambda x, y, z: x * y * z, lambda x, y, z: x * x + y + z],
        [
            Distribution.normal(0.0, 1.0),
            Distribution.uniform(0.0, 1.0),
            Distribution.exponential(2.0),
        ],
        n_samples=n9, seed_batch=r9,
    )
    sps, est = _throughput(prog, n9, r9)
    emit("c9_nd3_mixed_1e8", "samples_per_sec", sps, "samples/s", est)

    n9b = 10_000_000
    r9b = rbatch(n9b)
    prog = integrator.compile_integrate(
        [lambda x, y: x * y],
        [Distribution.beta(2.0, 5.0), Distribution.uniform(0.0, 1.0)],
        n_samples=n9b, seed_batch=r9b,
    )
    sps, est = _throughput(prog, n9b, r9b)
    emit("c9b_nd2_beta_table_1e7", "samples_per_sec", sps, "samples/s", est)

    prog = integrator.compile_integrate(
        [lambda x, y: np.exp(x) * np.exp(y)],
        [Distribution.uniform(0.0, 1.0), Distribution.uniform(0.0, 1.0)],
        n_samples=n9, seed_batch=r9, method="qmc",
    )
    sps, est = _throughput(prog, n9, r9)
    emit("c9c_nd2_sobol_qmc_1e8", "samples_per_sec", sps, "samples/s", est)

    prog = integrator.compile_mcmc(
        [lambda x, y: x * x + y * y],
        [Distribution.normal(0.0, 1.0), Distribution.normal(0.0, 1.0)],
        [Distribution.normal(0.0, 2.0), Distribution.normal(0.0, 2.0)],
        n_steps=steps5, n_chains=4096, n_burnin=burn5,
        seed_batch=rmc5,
    )
    csps, est = _throughput(
        prog, work5, rmc5, fetch=fetch_mcmc
    )
    emit("c9d_nd_mcmc_product_4096", "chain_steps_per_sec", csps,
         "steps/s", est)

    rho9 = 0.8
    c9c = 1.0 / (2.0 * (1.0 - rho9 * rho9))
    prog = integrator.compile_mcmc(
        [lambda x, y: x * y],
        lambda x, y: -c9c * (x * x - 2.0 * rho9 * x * y + y * y),
        [Distribution.normal(0.0, 2.0), Distribution.normal(0.0, 2.0)],
        n_steps=steps5, n_chains=4096, n_burnin=burn5,
        seed_batch=rmc5,
    )
    csps, est = _throughput(
        prog, work5, rmc5, fetch=fetch_mcmc
    )
    emit("c9e_nd_mcmc_joint_4096", "chain_steps_per_sec", csps,
         "steps/s", est)

    # c9f (round 5): a CUSTOM table dimension in the nd MCMC kernel —
    # Beta(2,5) target AND proposal in dim 0 (inverse-CDF sampling +
    # log-table lane-gathers per step), N(0,1)/N(0,2) analytic in dim 1.
    # Target: within ~15% of c9d (the all-analytic product rate).
    prog = integrator.compile_mcmc(
        [lambda x, y: x * y],
        [Distribution.beta(2.0, 5.0), Distribution.normal(0.0, 1.0)],
        [Distribution.beta(2.0, 5.0), Distribution.normal(0.0, 2.0)],
        n_steps=steps5, n_chains=4096, n_burnin=burn5,
        seed_batch=rmc5,
    )
    csps, est = _throughput(
        prog, work5, rmc5, fetch=fetch_mcmc
    )
    emit("c9f_nd_mcmc_table_dim_4096", "chain_steps_per_sec", csps,
         "steps/s", est)

    # Config 10 (round 3 cont.): random-walk Metropolis on the kernel
    # tier.  c10: 1-D adaptive walk (burn-in carries the per-chain
    # log-step + Robbins-Monro update); c10b: 2-D walk on a correlated
    # joint log-density.  Work counts chain steps as in c5.
    from tpu_montecarlo import RandomWalk

    prog = integrator.compile_mcmc(
        [lambda x: x * x],
        Distribution.normal(0.0, 1.0),
        RandomWalk(step_size=2.4, adapt=True),
        n_steps=steps5, n_chains=4096, n_burnin=burn5,
        seed_batch=rmc5,
    )
    csps, est = _throughput(
        prog, work5, rmc5, fetch=fetch_mcmc
    )
    emit("c10_rw_adapt_4096", "chain_steps_per_sec", csps, "steps/s", est)

    prog = integrator.compile_mcmc(
        [lambda x, y: x * y],
        lambda x, y: -c9c * (x * x - 2.0 * rho9 * x * y + y * y),
        RandomWalk(
            step_size=1.0, target_accept=0.234, init_range=(-4.0, 4.0)
        ),
        n_steps=steps5, n_chains=4096, n_burnin=burn5,
        seed_batch=rmc5,
    )
    csps, est = _throughput(
        prog, work5, rmc5, fetch=fetch_mcmc
    )
    emit("c10b_rw_nd_joint_4096", "chain_steps_per_sec", csps,
         "steps/s", est)

    # Config 11 (round 3 cont.): in-kernel HMC.  Each MH step inlines
    # L leapfrog (gradient, position, momentum) updates, so steps/s is
    # expected ~L-fold under the random walk's — the quantity to watch
    # is GRADIENT evals/s = steps/s * L, which should approach c10's
    # step rate.  c11: 1-D adaptive leapfrog on N(0,1); c11b: 2-D
    # correlated joint target, gradient traced from the expression.
    from tpu_montecarlo import HMC

    L11 = 8
    prog = integrator.compile_mcmc(
        [lambda x: x * x],
        Distribution.normal(0.0, 1.0),
        HMC(step_size=0.9, n_leapfrog=L11, adapt=True),
        n_steps=steps5, n_chains=4096, n_burnin=burn5,
        seed_batch=rmc5,
    )
    csps, est = _throughput(
        prog, work5, rmc5, fetch=fetch_mcmc
    )
    emit("c11_hmc_adapt_4096_L8", "chain_steps_per_sec", csps,
         "steps/s", est)
    emit("c11_hmc_grad_evals", "grad_evals_per_sec", csps * L11,
         "evals/s", est)

    prog = integrator.compile_mcmc(
        [lambda x, y: x * y],
        lambda x, y: -c9c * (x * x - 2.0 * rho9 * x * y + y * y),
        HMC(step_size=0.4, n_leapfrog=L11, init_range=(-4.0, 4.0)),
        n_steps=steps5, n_chains=4096, n_burnin=burn5,
        seed_batch=rmc5,
    )
    csps, est = _throughput(
        prog, work5, rmc5, fetch=fetch_mcmc
    )
    emit("c11b_hmc_nd_joint_4096_L8", "chain_steps_per_sec", csps,
         "steps/s", est)

    # c11c (round 5): in-kernel HMC on a CUSTOM table target — each
    # leapfrog step gathers the log-table interpolant's slope
    # (mcmc_pallas._Chains.log_pdf_grad) instead of tracing a closed-form
    # gradient; L+1 table scans per MH step + the final density scan.
    prog = integrator.compile_mcmc(
        [lambda x: x],
        Distribution.beta(2.0, 5.0),
        HMC(step_size=0.05, n_leapfrog=L11, adapt=True),
        n_steps=steps5, n_chains=4096, n_burnin=burn5,
        seed_batch=rmc5,
    )
    csps, est = _throughput(
        prog, work5, rmc5, fetch=fetch_mcmc
    )
    emit("c11c_hmc_table_4096_L8", "chain_steps_per_sec", csps,
         "steps/s", est)
    emit("c11c_hmc_table_grad_evals", "grad_evals_per_sec", csps * L11,
         "evals/s", est)

    # Config 12 (round 4): in-kernel parallel tempering.  The T-rung
    # ladder runs as ONE flat lane ensemble (T * n_chains lanes) with
    # rung-block replica exchange inside the Pallas kernel, so the
    # honest device-throughput unit is LANE-steps/s (every lane pays a
    # full MH step per iteration; the cold rung supplies the
    # estimates).  Compare against c5b/c10: at T=4 a lane-steps rate
    # near the plain kernel means tempering's multimodal coverage is
    # ~free per lane.  Target: 0.5*N(-4,1)+0.5*N(4,1), an ~8-sigma
    # barrier a step-0.5 walk cannot cross without the hot rungs.
    import math as _math

    def _logmix(x):
        return _math.log(
            _math.exp(-0.5 * (x + 4.0) ** 2)
            + _math.exp(-0.5 * (x - 4.0) ** 2)
        )

    from tpu_montecarlo import RandomWalk

    T12 = 4
    chains12 = 4096
    temps12 = [1.0, 2.0, 4.0, 8.0]
    work12 = T12 * chains12 * (steps5 + burn5)
    rmc12 = repeats
    prog = integrator.compile_mcmc(
        [lambda x: x, lambda x: x * x], _logmix,
        RandomWalk(step_size=0.5, adapt=True, init_range=(3.0, 5.0)),
        n_steps=steps5, n_chains=chains12, n_burnin=burn5,
        temperatures=temps12, seed_batch=rmc12,
    )
    csps, est = _throughput(
        prog, work12, rmc12, fetch=fetch_mcmc
    )
    emit("c12_pt_rw_T4_4096", "lane_steps_per_sec", csps, "steps/s", est)

    # c12b: tempered HMC — leapfrog trajectories on every rung.
    prog = integrator.compile_mcmc(
        [lambda x: x * x], _logmix,
        HMC(step_size=0.35, n_leapfrog=L11, init_range=(3.0, 5.0)),
        n_steps=steps5, n_chains=chains12, n_burnin=burn5,
        temperatures=temps12, seed_batch=rmc12,
    )
    csps, est = _throughput(
        prog, work12, rmc12, fetch=fetch_mcmc
    )
    emit("c12b_pt_hmc_T4_4096_L8", "lane_steps_per_sec", csps,
         "steps/s", est)

    # c12c (round 5): tempered INDEPENDENCE sampling — the reference's
    # native proposal family under the replica-exchange ladder (every
    # rung draws fresh proposals; logq exchanges with the state).
    prog = integrator.compile_mcmc(
        [lambda x: x, lambda x: x * x], _logmix,
        Distribution.normal(0.0, 6.0),
        n_steps=steps5, n_chains=chains12, n_burnin=burn5,
        temperatures=temps12, seed_batch=rmc12,
    )
    csps, est = _throughput(
        prog, work12, rmc12, fetch=fetch_mcmc
    )
    emit("c12c_pt_independence_T4_4096", "lane_steps_per_sec", csps,
         "steps/s", est)

    # c12d (round 5): tempered independence with a CUSTOM table
    # proposal — the sampler-mode-logq kernel path (logq rides the
    # draw; no q-table staged; the proposal inverse is the W1-bounded
    # downsample).  Target: the bimodal table (E[X^2] = 5).
    wide_q = Distribution.from_pdf(
        lambda x: _math.exp(-0.5 * (x / 3.0) ** 2),
        support=(-7.0, 7.0),
    )
    prog = integrator.compile_mcmc(
        [lambda x: x, lambda x: x * x], table_target, wide_q,
        n_steps=steps5, n_chains=chains12, n_burnin=burn5,
        temperatures=temps12, seed_batch=rmc12,
    )
    csps, est = _throughput(prog, work12, rmc12, fetch=fetch_mcmc)
    emit("c12d_pt_custom_prop_T4_4096", "lane_steps_per_sec", csps,
         "steps/s", est)

    # Config 13 (round 4): adaptive-IS production sampling.  VEGAS
    # learns a table proposal for a narrow tail bump under N(0,1)
    # (host-side, excluded from the timed region — it is a one-off
    # calibration), then the learned CUSTOM table rides the in-kernel
    # stratified IS path at full production rate.
    from tpu_montecarlo import adapt_proposal

    def _bump(x):
        return _math.exp(-0.5 * ((x - 2.5) / 0.1) ** 2)

    target13 = Distribution.normal(0.0, 1.0)
    q13 = adapt_proposal(_bump, target13, seed=11)
    n13 = 100_000_000
    r13b = rbatch(n13)
    prog = integrator.compile_importance_sampling(
        [_bump], target13, q13, n_samples=n13, seed_batch=r13b,
    )
    sps, est = _throughput(prog, n13, r13b)
    emit("c13_adaptive_is_1e8", "samples_per_sec", sps, "samples/s", est)

    # Config 14 (round 4): in-kernel thinned draws.  return_samples=m
    # stores chain states from the MCMC kernel's registers; the step rate
    # should sit at the plain kernel's.  Unbatched program (samples are a
    # single-run inference surface), so the run is long (500k steps x
    # 4096 chains).
    steps14, m14 = 500_000, 500
    prog14 = integrator.compile_mcmc(
        [lambda x: x * x], Distribution.normal(0.0, 1.0),
        RandomWalk(step_size=2.4, init_range=(-4.0, 4.0)),
        n_steps=steps14, n_chains=4096, n_burnin=burn5,
        return_samples=m14,
    )
    jax.block_until_ready(prog14(42))
    t0 = time.perf_counter()
    outs14 = [prog14(100 + o) for o in range(3)]
    jax.block_until_ready(outs14)
    dt14 = time.perf_counter() - t0
    csps = 3 * 4096 * (steps14 + burn5) / dt14
    last14 = np.asarray(outs14[-1][-1])  # draws: sanity, untimed
    emit("c14_mcmc_samples_kernel", "chain_steps_per_sec", csps,
         "steps/s", [float(last14.mean()), float(last14.std())])

    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=2)
        print(f"# wrote {args.out}", flush=True)


if __name__ == "__main__":
    main()
