"""tpu_montecarlo — Monte Carlo integration, importance sampling and MCMC
in JAX/Pallas, compiled for the GPU.

A ground-up JAX rebuild of the capabilities of wgpu-monte-carlo (Python
user API + Python->WGSL transpiler + wgpu compute engine): user callables
are traced straight into fused XLA/Pallas kernels, sampling uses
counter-based random streams, reductions happen on-device, and workloads
shard across device meshes with a final psum.

Example:
    >>> from tpu_montecarlo import MonteCarloIntegrator, Distribution
    >>> integrator = MonteCarloIntegrator()
    >>> dist = Distribution.normal(mean=0.0, std=1.0)
    >>> result = integrator.integrate(
    ...     [lambda x: x, lambda x: x**2], dist, n_samples=10_000_000)
    >>> print(f"E[X] = {result.values[0]:.4f}")    # ~0.0
    >>> print(f"E[X^2] = {result.values[1]:.4f}")  # ~1.0
"""

from .api import (
    IntegrationResult,
    McmcState,
    MonteCarloIntegrator,
    expectation_fn,
    integrate,
    integrate_importance_sampling,
    integrate_mcmc,
    pack_param_batch,
    pack_param_batch_nd,
    pack_random_walk_batch,
    pack_random_walk_batch_nd,
)
from .adaptive import adapt_proposal
from .distributions import Distribution, DistributionType, HMC, RandomWalk
from .tracing import TraceError, is_traceable, trace_function
from .wgsl_frontend import WgslError, trace_wgsl_function

# Compatibility aliases for code written against the reference API: the
# transpiler's error type gates the importance-sampling fallback there;
# ``trace_function`` is the tracer playing the transpiler's role here.
TranspilerError = TraceError
transpile_function = trace_function

__version__ = "0.1.0"

__all__ = [
    "MonteCarloIntegrator",
    "Distribution",
    "DistributionType",
    "RandomWalk",
    "HMC",
    "IntegrationResult",
    "McmcState",
    "adapt_proposal",
    "expectation_fn",
    "integrate",
    "integrate_importance_sampling",
    "integrate_mcmc",
    "pack_param_batch",
    "pack_param_batch_nd",
    "pack_random_walk_batch",
    "pack_random_walk_batch_nd",
    "trace_function",
    "trace_wgsl_function",
    "is_traceable",
    "TraceError",
    "WgslError",
    "TranspilerError",
    "transpile_function",
]
