#!/usr/bin/env python3
"""MCMC throughput vs run length: quantify the dispatch/occupancy bound.

Sweeps ``n_steps`` at fixed chains (4096) and batch shape (seed_batch
jobs per dispatch, `outer` pipelined dispatches, best-of-2 rounds),
recording steps/s per point.

The model: one dispatch costs a fixed overhead t0 (host dispatch +
program launch) plus n_iters * t_step device time; throughput = work /
(t0 + work/rate), so short runs are overhead-bound and the curve
saturates at the kernel's step rate.  The fitted (t0, rate) pair is
reported; ``--out PATH`` writes the points and fit as JSON.  Fails when
JAX finds no GPU.

Run:  python benchmarks/mcmc_scaling.py [--out PATH]
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import argparse

    import jax

    from tpu_montecarlo.utils.compile_cache import use_compile_cache

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    use_compile_cache()
    if jax.devices()[0].platform != "gpu":
        sys.exit(f"no GPU: JAX found {jax.devices()[0].platform!r}")
    from tpu_montecarlo import Distribution, MonteCarloIntegrator

    integrator = MonteCarloIntegrator()
    chains = 4096
    repeats = 10
    outer = 3
    points = []
    # Burn-in fixed at 1/11 of steps (the c5b shape's ratio).
    for steps in (1_000, 3_000, 10_000, 30_000, 100_000, 300_000):
        burn = steps // 10
        prog = integrator.compile_mcmc(
            [lambda x: x * x],
            Distribution.normal(0.0, 1.0),
            Distribution.normal(0.0, 2.0),
            n_steps=steps, n_chains=chains, n_burnin=burn,
            seed_batch=repeats,
        )
        work = chains * (steps + burn)

        jax.block_until_ready(prog([42 + r for r in range(repeats)]))
        best = None
        for rnd in range(2):
            t0 = time.perf_counter()
            outs = [
                prog(
                    [
                        100 + (rnd * outer + o) * repeats + r
                        for r in range(repeats)
                    ]
                )
                for o in range(outer)
            ]
            jax.block_until_ready(outs)
            dt = time.perf_counter() - t0
            if best is None or dt < best:
                best = dt
        sps = work * repeats * outer / best
        per_dispatch = best / outer
        rec = {
            "n_steps": steps,
            "n_iters": steps + burn,
            "steps_per_sec": sps,
            "sec_per_dispatch": per_dispatch,
        }
        points.append(rec)
        print(json.dumps(rec), flush=True)

    # Fit t_dispatch = t0 + n_iters * t_step by least squares.
    n = np.array([p["n_iters"] for p in points], float)
    t = np.array([p["sec_per_dispatch"] for p in points], float)
    a = np.vstack([np.ones_like(n), n]).T
    (t0_fit, t_step), *_ = np.linalg.lstsq(a, t, rcond=None)
    rate = chains * repeats / t_step if t_step > 0 else float("inf")
    summary = {
        "chains": chains,
        "seed_batch": repeats,
        "fixed_overhead_sec_per_dispatch": float(t0_fit),
        "asymptotic_steps_per_sec": float(rate),
        "points": points,
    }
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=2)
    print(f"# t0={t0_fit * 1e3:.2f} ms/dispatch, asymptotic {rate:.3e} "
          f"steps/s ({jax.devices()[0].device_kind})", flush=True)


if __name__ == "__main__":
    main()
