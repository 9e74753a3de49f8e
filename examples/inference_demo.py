#!/usr/bin/env python3
"""Posterior inference end-to-end: raw draws, quantiles, and tempering.

A small Bayesian workflow on a deliberately awkward posterior — a
two-component mixture with an ~8-sigma energy barrier — showing the
inference surfaces beyond point estimates:

1. ``return_samples=m``: thinned raw chain states stream straight out
   of the device kernel (each draw row is stored to HBM mid-run, so
   memory stays bounded by the m you ask for).  Raw draws feed
   anything expectations can't: quantiles, intervals, posterior
   predictive simulation.
2. ``temperatures=[...]``: replica exchange lets local walkers cross
   the barrier; the cold rung's draws cover BOTH modes where a plain
   walk provably sits in one.
3. ``return_diagnostics=True``: split-R-hat says WHICH of the two runs
   to trust, without knowing the truth.
"""

import math

import numpy as np

from tpu_montecarlo import MonteCarloIntegrator, RandomWalk


def log_posterior(x):
    # Mixture of N(-4, 1) and N(4, 1): E[X] = 0, E[X^2] = 17,
    # median 0, but the density at x=0 is ~e^-8 of the modes.
    return math.log(
        math.exp(-0.5 * (x + 4.0) ** 2) + math.exp(-0.5 * (x - 4.0) ** 2)
    )


mc = MonteCarloIntegrator()
# A fixed local step: well-tuned for WITHIN a mode, hopeless across the
# barrier (a +4 -> -4 move needs a 16-sigma step draw).
walk = RandomWalk(step_size=0.5, init_range=(3.0, 5.0))
kw = dict(n_steps=4000, n_chains=1024, n_burnin=1000, seed=11)

# A plain walk: every chain starts near +4 and stays there.
plain = mc.integrate_mcmc(
    [lambda x: x], log_posterior, walk,
    return_samples=50, return_diagnostics=True, **kw
)

# The same walk under a temperature ladder: hot rungs shuttle states
# across the barrier, the cold rung samples the true posterior.
tempered = mc.integrate_mcmc(
    [lambda x: x], log_posterior, walk,
    temperatures=[1.0, 2.0, 4.0, 8.0, 16.0],
    return_samples=50, **kw
)

for name, run in (("plain walk", plain), ("tempered", tempered)):
    draws = np.asarray(run.samples).ravel()
    q05, q50, q95 = np.percentile(draws, [5, 50, 95])
    frac_left = float((draws < 0).mean())
    print(f"{name:>11}: E[X]={run.values[0]:+.3f}  "
          f"q05/q50/q95 = {q05:+.2f}/{q50:+.2f}/{q95:+.2f}  "
          f"mass(x<0) = {frac_left:.2f}")
    if run.diagnostics and "r_hat" in run.diagnostics:
        print(f"{'':>11}  split-R-hat = "
              f"{float(run.diagnostics['r_hat'][0]):.3f} "
              "(>> 1: chains disagree, don't trust the point estimate)")
    if run.diagnostics and "swap_rate" in run.diagnostics:
        print(f"{'':>11}  swap rate = "
              f"{float(run.diagnostics['swap_rate']):.2f} "
              "(healthy ladders exchange 20-60% of attempts)")

# The honest picture: the plain walk reports one mode's statistics with
# a large R-hat flag; the tempered draws put ~half the mass on each
# side and recover the global median near 0.
