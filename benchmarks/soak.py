#!/usr/bin/env python3
"""Serving-stability soak: hammer one compiled seed-batched handle with
back-to-back dispatches (pipelined in windows of 5, each window blocked
on before its clock stops) and report throughput stability, estimate
drift, and same-seed bit-stability.  Fails when JAX finds no GPU.

Run:  python benchmarks/soak.py
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dispatches", type=int, default=50)
    ap.add_argument("--batch", type=int, default=10)
    ap.add_argument("--n-samples", type=int, default=100_000_000)
    args = ap.parse_args()

    import jax

    from tpu_montecarlo.utils.compile_cache import use_compile_cache

    use_compile_cache()
    if jax.devices()[0].platform != "gpu":
        print(f"no GPU: JAX found {jax.devices()[0].platform!r}",
              file=sys.stderr)
        return 1

    import tpu_montecarlo as mc

    it = mc.MonteCarloIntegrator()
    d = mc.Distribution.normal(0.0, 1.0)
    R = args.batch
    prog = it.compile_integrate(
        [lambda x: x, lambda x: x * x], d,
        n_samples=args.n_samples, seed_batch=R,
    )
    jax.block_until_ready(prog(list(range(R))))  # compile + first run

    fixed = np.asarray(prog([999 + r for r in range(R)]))
    # Time in pipelined windows: W dispatches issued back-to-back, then
    # all blocked on.
    W = max(1, min(5, args.dispatches))
    windows = args.dispatches // W
    times, means = [], []
    for w in range(windows):
        t0 = time.perf_counter()
        outs = [
            prog([1000 * (w * W + i) + r for r in range(R)])
            for i in range(W)
        ]
        jax.block_until_ready(outs)
        times.append(time.perf_counter() - t0)
        vals = [np.asarray(o) for o in outs]
        means.extend(float(v[:, 1].mean()) for v in vals)
    fixed2 = np.asarray(prog([999 + r for r in range(R)]))

    rec = {
        "dispatches": windows * W,
        "jobs_per_dispatch": R,
        "dispatches_per_window": W,
        "n_samples_per_job": args.n_samples,
        "sps_median": W * R * args.n_samples / float(np.median(times)),
        "sps_p10": W * R * args.n_samples / float(np.percentile(times, 90)),
        "ex2_mean": float(np.mean(means)),
        "ex2_spread": float(np.std(means)),
        "bit_stable": bool(np.array_equal(fixed, fixed2)),
        "device": jax.devices()[0].device_kind,
    }
    print(json.dumps(rec))
    ok = (
        rec["bit_stable"]
        and abs(rec["ex2_mean"] - 1.0) < 0.01
        and rec["sps_p10"] > 0.5 * rec["sps_median"]
    )
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
