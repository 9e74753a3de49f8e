#!/usr/bin/env python3
"""Parallel MCMC with convergence diagnostics on a bimodal target.

2048 independence-sampler Metropolis-Hastings chains (one per device thread)
draw from an unnormalised two-bump density given only as a Python pdf.
Besides the moment estimates, the run surfaces the two health signals
the framework adds over point estimates: the sampling-phase acceptance
rate and split-R-hat (``return_diagnostics=True``), plus between-chain
error bars (``return_stderr=True``).
"""

import math

from tpu_montecarlo import Distribution, MonteCarloIntegrator


def two_bumps(x):
    """Unnormalised mixture: bumps at -1.5 and +2 with different widths."""
    left = math.exp(-2.0 * (x + 1.5) ** 2)
    right = 0.7 * math.exp(-1.2 * (x - 2.0) ** 2)
    return left + right


target = Distribution.from_pdf(two_bumps, support=(-6.0, 7.0))
proposal = Distribution.normal(0.5, 2.5)  # wide enough to hop both modes

mc = MonteCarloIntegrator()
result = mc.integrate_mcmc(
    [lambda x: x, lambda x: x * x, lambda x: x > 0.0],
    target,
    proposal,
    n_steps=5_000,
    n_chains=2_048,
    n_burnin=500,
    return_stderr=True,
    return_diagnostics=True,
)

mean, second, p_right = result.values
print("Bimodal target, 2048 chains x 5000 steps (500 burn-in)")
print(f"  E[X]        {mean:+.4f} +/- {result.stderr[0]:.4f}")
print(f"  Var[X]      {second - mean * mean:.4f}")
print(f"  P(X > 0)    {p_right:.4f}   (mass of the right bump)")
print(f"  acceptance  {result.acceptance_rate:.3f}")
print(f"  split-R-hat {result.diagnostics['r_hat'].round(4)}")
for r_hat in result.diagnostics["r_hat"]:
    assert r_hat < 1.05, "chains failed to mix — widen the proposal"

# --- Parallel tempering: when a LOCAL sampler meets a barrier ---------
# A random walk started inside one basin of a well-separated mixture
# never crosses to the other; replicas at hotter temperatures do, and
# replica exchange hands those crossings down to the T=1 chains.
from tpu_montecarlo import RandomWalk  # noqa: E402


def far_modes(x):
    """log of 0.5 N(-4,1) + 0.5 N(4,1): an ~8-sigma barrier at x=0."""
    return math.log(
        math.exp(-0.5 * (x + 4.0) ** 2) + math.exp(-0.5 * (x - 4.0) ** 2)
    )


walk = RandomWalk(step_size=0.5, adapt=True, init_range=(3.0, 5.0))
trapped = mc.integrate_mcmc(
    [lambda x: x], far_modes,
    RandomWalk(step_size=0.5, init_range=(3.0, 5.0)),
    n_steps=4_000, n_chains=2_048, n_burnin=500,
)
tempered = mc.integrate_mcmc(
    [lambda x: x, lambda x: x * x], far_modes, walk,
    n_steps=4_000, n_chains=2_048, n_burnin=500,
    temperatures=[1.0, 2.0, 4.0, 8.0, 16.0],
)
print("\nFar-apart mixture 0.5 N(-4,1) + 0.5 N(4,1), walk init in (3, 5)")
print(f"  untempered  E[X] {trapped.values[0]:+.4f}   (stuck in one mode)")
print(
    f"  tempered    E[X] {tempered.values[0]:+.4f}   "
    f"E[X^2] {tempered.values[1]:.3f}  (truth: 0, 17)"
)
print(f"  swap rate   {tempered.diagnostics['swap_rate']:.3f}")
assert trapped.values[0] > 3.0
assert abs(tempered.values[0]) < 0.4
