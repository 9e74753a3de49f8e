#!/usr/bin/env python3
"""Multi-dimensional Monte Carlo demo (a capability family beyond the
strictly 1-D reference): pass a SEQUENCE of per-dimension distributions
and integrands of matching arity.

Six vignettes:
  1. geometry  — P(X^2 + Y^2 < 1) over the unit square, MC vs the Sobol
     digital net (method="qmc") at equal sample budget,
  2. basket IS — a rare joint tail P(X > 3, Y > 3) under N(0,1)^2 with a
     shifted product proposal,
  3. correlated MCMC — E[XY] under a rho = 0.8 bivariate Gaussian given
     only its JOINT log-density (inexpressible in a one-distribution-
     per-program design),
  4. calibration — gradient descent on d E[payoff]/d(params) through the
     differentiable nd estimator,
  5. serving — one AOT handle dispatching 4 replications per device
     program, checkpoint/resume over the d-vector chain state, and
     split-R-hat / ESS mixing diagnostics.

Run: python examples/multidim_demo.py
"""

import math

import jax
import jax.numpy as jnp
import numpy as np

from tpu_montecarlo import Distribution, MonteCarloIntegrator

integrator = MonteCarloIntegrator()

# 1. Quarter-disc area: the classic pi-from-darts, on both point sets.
u = Distribution.uniform(0.0, 1.0)
in_disc = lambda x, y: (x * x + y * y) < 1.0  # noqa: E731
n = 4_000_000
mc_est = integrator.integrate([in_disc], [u, u], n_samples=n, seed=7)
qmc_est = integrator.integrate(
    [in_disc], [u, u], n_samples=n, seed=7, method="qmc"
)
truth = math.pi / 4
print("1) P(X^2+Y^2 < 1) over the unit square")
print(f"   exact     {truth:.7f}")
print(f"   MC        {mc_est.values[0]:.7f}   (err {abs(mc_est.values[0]-truth):.2e})")
print(f"   Sobol QMC {qmc_est.values[0]:.7f}   (err {abs(qmc_est.values[0]-truth):.2e})")

# 2. Joint rare event with a product proposal.
n01 = Distribution.normal(0.0, 1.0)
shifted = Distribution.normal(3.5, 1.0)
corner = integrator.integrate_importance_sampling(
    [lambda x, y: ((x > 3.0) & (y > 3.0)) * 1.0],
    [n01, n01], [shifted, shifted],
    n_samples=4_000_000, seed=11, return_stderr=True,
)
p1 = 0.5 * math.erfc(3.0 / math.sqrt(2.0))
print("\n2) P(X > 3, Y > 3) under independent N(0,1)")
print(f"   exact     {p1 * p1:.4e}")
print(f"   IS        {corner.values[0]:.4e} +/- {corner.stderr[0]:.1e}")

# 3. Correlated Gaussian through its joint log-density.
rho = 0.8
c = 1.0 / (2.0 * (1.0 - rho * rho))
log_density = lambda x, y: -c * (x * x - 2.0 * rho * x * y + y * y)  # noqa: E731
prop = Distribution.normal(0.0, 2.0)
corr = integrator.integrate_mcmc(
    [lambda x, y: x * y, lambda x, y: x * x],
    log_density, [prop, prop],
    n_steps=5_000, n_chains=2_048, n_burnin=500, seed=3,
    return_stderr=True,
)
print("\n3) Bivariate Gaussian (rho = 0.8) from its joint log-density")
print(f"   E[XY]     {corr.values[0]:.4f} +/- {corr.stderr[0]:.4f}   (exact {rho})")
print(f"   E[X^2]    {corr.values[1]:.4f} +/- {corr.stderr[1]:.4f}   (exact 1.0)")
print(f"   accept    {corr.acceptance_rate:.2f}")

# 4. Calibrate two normal means so that E[max(X + Y, 0)] hits a target.
est = integrator.expectation_fn(
    [lambda x, y: jnp.maximum(x + y, 0.0)],
    [n01, n01], n_samples=400_000,
)
target = 2.0
loss = jax.jit(lambda p: (est(p)[0] - target) ** 2)
grad = jax.jit(jax.grad(loss))
params = jnp.asarray([[0.0, 1.0], [0.0, 1.0]], jnp.float32)
for step in range(60):
    # descend on the means only (column 0); keep the stds fixed at 1
    params = params.at[:, 0].add(-0.5 * grad(params)[:, 0])
final = float(est(params)[0])
print("\n4) Calibrated E[max(X+Y, 0)] via pathwise nd gradients")
print(f"   target    {target}")
print(f"   achieved  {final:.4f}  at means "
      f"({float(params[0, 0]):.3f}, {float(params[1, 0]):.3f})")

# 5. Serve the correlated-Gaussian study: one AOT handle, R independent
#    replications per dispatch, then extend the chains with checkpoint/resume and
#    confirm mixing with split-R-hat.
prog = integrator.compile_mcmc(
    [lambda x, y: x * y], log_density, [prop, prop],
    n_steps=2_000, n_chains=1_024, n_burnin=200, seed_batch=4,
)
reps = np.asarray(prog([20, 21, 22, 23])[0], np.float64)[:, 0]
print("\n5) Served replications of E[XY] (one dispatch, 4 jobs)")
print(f"   estimates {np.round(reps, 4)}")
print(f"   spread    {reps.std(ddof=1):.4f}")

seg1 = integrator.integrate_mcmc(
    [lambda x, y: x * y], log_density, [prop, prop],
    n_steps=2_000, n_chains=1_024, n_burnin=200, seed=20,
    return_state=True,
)
seg2 = integrator.integrate_mcmc(
    [lambda x, y: x * y], log_density, [prop, prop],
    n_steps=2_000, n_chains=1_024, n_burnin=0, seed=20,
    initial_state=seg1.chain_state,
)
diag = integrator.integrate_mcmc(
    [lambda x, y: x * y], log_density, [prop, prop],
    n_steps=2_000, n_chains=1_024, n_burnin=200, seed=24,
    return_diagnostics=True,
)
print("   resumed   segment means "
      f"{seg1.values[0]:.4f} -> {seg2.values[0]:.4f} "
      f"(combined {(0.5 * (seg1.values[0] + seg2.values[0])):.4f})")
print(f"   mixing    split-R-hat {diag.diagnostics['r_hat'][0]:.4f}, "
      f"ESS {diag.diagnostics['ess'][0]:.0f}")
