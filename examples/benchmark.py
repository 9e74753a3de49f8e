#!/usr/bin/env python3
"""Throughput sweep: fused device kernel vs NumPy vs a Python loop.

Integrates a smooth two-term test function under N(0, 1) across a
logarithmic sweep of sample counts and reports samples/second for each
engine.  Device numbers are measured by fetching the result to host
(``np.asarray``), which waits for the device.  The Python loop is capped at a small N and
extrapolated, so the sweep finishes in seconds.
"""

import time

import numpy as np

from tpu_montecarlo import Distribution, MonteCarloIntegrator


def smooth_probe(x):
    return np.cos(3.0 * x) * np.exp(0.25 * x) + 0.1 * x * x


SWEEP = [10_000, 100_000, 1_000_000, 10_000_000, 100_000_000]
LOOP_CAP = 50_000  # pure-Python is extrapolated past this

mc = MonteCarloIntegrator()
dist = Distribution.normal(0.0, 1.0)
mc.integrate([smooth_probe], dist, n_samples=1_000)  # compile once

rows = []
for n in SWEEP:
    t0 = time.perf_counter()
    est = np.asarray(mc.integrate([smooth_probe], dist, n_samples=n).values)
    dev_s = time.perf_counter() - t0

    rng = np.random.default_rng(7)
    t0 = time.perf_counter()
    xs = rng.standard_normal(n, dtype=np.float32)
    np_est = float(np.mean(smooth_probe(xs)))
    np_s = time.perf_counter() - t0

    n_loop = min(n, LOOP_CAP)
    t0 = time.perf_counter()
    acc = 0.0
    for x in rng.standard_normal(n_loop):
        acc += float(smooth_probe(x))
    loop_s = (time.perf_counter() - t0) * (n / n_loop)

    rows.append((n, dev_s, np_s, loop_s))
    print(
        f"N={n:>11,}  device {n / dev_s:>12,.0f}/s   "
        f"numpy {n / np_s:>12,.0f}/s   loop(est) {n / loop_s:>10,.0f}/s   "
        f"estimates agree to {abs(est[0] - np_est):.1e}"
    )

best_n, best_dev, best_np, _ = rows[-1]
print(
    f"\nAt N={best_n:,}: device is {best_np / best_dev:.1f}x numpy "
    f"and {rows[-1][3] / best_dev:,.0f}x the Python loop."
)

try:
    from matplotlib import pyplot as plt

    ns = [r[0] for r in rows]
    fig, ax = plt.subplots(figsize=(7, 5), layout="constrained")
    ax.loglog(ns, [r[0] / r[1] for r in rows], "o-", label="device kernel")
    ax.loglog(ns, [r[0] / r[2] for r in rows], "s--", label="numpy")
    ax.loglog(ns, [r[0] / r[3] for r in rows], "v:", label="python loop (extrapolated)")
    ax.set_xlabel("samples per call")
    ax.set_ylabel("throughput (samples/s)")
    ax.set_title("Monte Carlo integrate throughput")
    ax.legend()
    fig.savefig("benchmark.png")
    print("Wrote benchmark.png")
except ImportError:
    pass
