"""Public API: MonteCarloIntegrator, IntegrationResult, convenience funcs.

Call signatures, defaults, validation messages and result conventions match
the reference (reference: python/wgpu_montecarlo/__init__.py:611-1266):

  * ``integrate(functions, distribution, n_samples=1_000_000, seed=42)``
  * ``integrate_importance_sampling(...)`` — PDFs that trace compile into
    closed-form ``f·p/q`` weight kernels; PDFs that don't fall back to
    interpolated PDF-table lookups (same routing triggers as the reference's
    TranspilerError, __init__.py:826-838)
  * ``integrate_mcmc(functions, target, proposal, n_steps=10_000,
    n_chains=1024, n_burnin=1_000, seed=42)``
  * results come back float64 in an ``IntegrationResult``

Unlike the reference — which re-generates and re-compiles its shader on
every call (SURVEY.md §3.2) — compiled programs are cached, keyed by the
traced functions and workload plan, so repeat calls skip compilation.
"""

from .batching import (
    NdParamBatch,
    ParamBatch,
    RwParamBatch,
    pack_param_batch,
    pack_param_batch_nd,
    pack_random_walk_batch,
    pack_random_walk_batch_nd,
    _target_arity,
)
from .cache import _GLOBAL_CACHE, _ProgramCache, _block_traceable
from .device import _uniform_table_mode
from .functions import (
    expectation_fn,
    integrate,
    integrate_importance_sampling,
    integrate_mcmc,
)
from .integrator import MonteCarloIntegrator
from .results import IntegrationResult, McmcState

__all__ = [
    "IntegrationResult",
    "McmcState",
    "MonteCarloIntegrator",
    "NdParamBatch",
    "ParamBatch",
    "RwParamBatch",
    "expectation_fn",
    "integrate",
    "integrate_importance_sampling",
    "integrate_mcmc",
    "pack_param_batch",
    "pack_param_batch_nd",
    "pack_random_walk_batch",
    "pack_random_walk_batch_nd",
]
