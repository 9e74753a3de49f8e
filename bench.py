"""Headline benchmark: fused K=8 N(0,1) Monte Carlo integrate on a GPU.

Prints ONE JSON line: {"metric", "value", "unit", "device"}.

The workload mirrors BASELINE.md config 2: eight integrands (moments,
trig, exp, an indicator, abs) fused into one compiled pass over shared
samples, 1e9 samples per call through the public handle
(``compile_integrate``, which takes the Pallas-Triton kernel on the GPU);
the rate counts the samples the kernel grid rounds that up to.
A warm call compiles; ten timed calls each end in ``block_until_ready``.
The script fails when JAX finds no GPU.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

N_SAMPLES = 1_000_000_000
N_REPEATS = 10


def main() -> int:
    import jax

    from tpu_montecarlo.utils.compile_cache import use_compile_cache

    use_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"no GPU: JAX found platform {dev.platform!r}",
              file=sys.stderr)
        return 1

    import tpu_montecarlo as mc

    fns = [
        lambda x: x,
        lambda x: x * x,
        lambda x: x * x * x,
        lambda x: x * x * x * x,
        lambda x: np.sin(x),
        lambda x: np.exp(-x * x),
        lambda x: x > 1.0,
        lambda x: abs(x),
    ]
    prog = mc.MonteCarloIntegrator().compile_integrate(
        fns, mc.Distribution.normal(0.0, 1.0), n_samples=N_SAMPLES
    )

    jax.block_until_ready(prog(42))  # compile + first run
    t0 = time.perf_counter()
    for rep in range(N_REPEATS):
        out = jax.block_until_ready(prog(1000 + rep))
    elapsed = time.perf_counter() - t0

    # Sanity: E[X^2] must be ~1 or the benchmark measured garbage.
    ex2 = float(np.asarray(out)[1])
    assert abs(ex2 - 1.0) < 0.05, f"E[X^2] = {ex2}, expected ~1"

    # The kernel grid rounds the sample count up; count what the device
    # executes.
    print(json.dumps({
        "metric": "samples_per_sec_chip_k8_normal",
        "value": prog.actual_samples * N_REPEATS / elapsed,
        "unit": "samples/s",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
