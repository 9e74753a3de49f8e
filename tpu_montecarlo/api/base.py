"""Shared integrator plumbing: user-function tracing and the
Pallas-kernel eligibility gates every workload consults."""

from __future__ import annotations

import hashlib
import warnings
from typing import Callable, List, Optional, Union

import numpy as np

import jax
import jax.numpy as jnp

from ..distributions import Distribution, HMC, RandomWalk
from ..ops.integrate_xla import build_integrate_fn
from ..ops.mcmc_xla import build_mcmc_fn, plan_chains
from ..sampling import (
    DistKind,
    dist_spec_of,
    ensure_param_batch_family,
    pdf_from_table,
)
from ..tables import is_uniform_grid
from ..tracing import TraceError, trace_function
from ..utils.dispatch import make_integrate_plan
from ..wgsl_frontend import trace_wgsl_function

from .batching import (
    _check_param_batch_args,
    _check_random_walk_args,
    _checked_batch_prog,
    _nd_mcmc_param_map_adapter,
    _nd_mcmc_param_prog,
    _nd_param_map_adapter,
    _nd_param_prog,
    _target_arity,
)
from .cache import (
    _GLOBAL_CACHE,
    _ProgramCache,
    _block_traceable,
    _fn_key,
    _fns_key,
    _mesh_key,
    _resolve_mesh,
    _tag_native_batch,
)
from .device import (
    _device_args_of,
    _device_gapped_tables,
    _device_log_tables_of,
    _device_mode_tables,
    _device_uniform_log_tables,
    _proposal_kernel_log_tables,
    _table_shapes,
    _tbl,
    _uniform_log_tables,
    _uniform_table_mode,
)
from .results import (
    IntegrationResult,
    McmcState,
    _unit_integrand,
    _weight_diagnostics,
)


class _BaseMixin:
    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------

    def _trace_user_functions(self, functions, n_args: int = 1) -> tuple:
        if len(functions) == 0:
            raise ValueError("At least one function is required")
        traced = []
        for func in functions:
            if isinstance(func, str):
                tf = trace_wgsl_function(func)
                arity = getattr(tf, "__tpu_mc_arity__", n_args)
                if arity != n_args:
                    raise ValueError(
                        f"WGSL function {tf.__name__!r} takes {arity} "
                        f"argument(s) but the integration is "
                        f"{n_args}-dimensional"
                    )
                traced.append(tf)
            elif callable(func):
                traced.append(trace_function(func, n_args))
            else:
                raise TypeError(
                    f"Function must be callable or WGSL string, got {type(func)}"
                )
        return tuple(traced)

    def _use_pallas(self, kind: DistKind) -> bool:
        """Whether a kernel-capable workload takes the Pallas kernels:
        always under backend='pallas' (compiled on the GPU, interpreted
        on the CPU test tier, refused elsewhere), and under 'auto' on the
        GPU, where the kernels measured faster than the XLA builders
        (PERF.md)."""
        del kind  # per-kind routing happens at the call sites
        if self._backend == "xla":
            return False
        from ..ops.integrate_pallas import interpret_mode

        if self._backend == "pallas":
            interpret_mode()  # raises on a platform with no kernel route
            return True
        return jax.default_backend() == "gpu"

    def _no_kernel(self, reason: str, stacklevel: int = 3) -> None:
        """A forced backend='pallas' on a workload no kernel serves.  On
        the GPU that is an error: the caller asked for the compiled
        kernel, and the XLA builder is a different program.  On the CPU
        test tier it warns and the XLA builder runs."""
        if self._backend != "pallas":
            return
        msg = f"backend='pallas' requested but {reason}"
        if jax.default_backend() != "cpu":
            raise ValueError(f"{msg}; use backend='auto' or 'xla'")
        warnings.warn(
            f"{msg}; running the XLA backend instead",
            stacklevel=stacklevel + 1,
        )

    def _warn_no_kernel(self, what: str) -> None:
        """Multi-dimensional and tempered workloads have no Pallas kernel
        (the XLA builders serve them)."""
        self._no_kernel(f"{what} has no Pallas kernel", stacklevel=4)

    def _pallas_eligible(self, spec, traced) -> bool:
        """Shared Pallas-kernel eligibility gate for the sampling side:
        kernel-supported family, <=128 fused integrands, none carrying
        table-lookup closures and all evaluating on a sample block
        (functions with sample-dependent ``while`` loops trace as scalar
        programs but cannot lower inside the kernel — those take the XLA
        sweep, which vmaps them).  A forced backend='pallas' that fails
        it goes through ``_no_kernel``."""
        from ..ops.integrate_pallas import MAX_FUSED, pallas_supports

        ok = (
            pallas_supports(spec.kind)
            and len(traced) <= MAX_FUSED
            and not any(
                getattr(f, "__tpu_mc_no_pallas__", False) for f in traced
            )
            and _block_traceable(traced)
            # Heavy-tailed customs: the kernel's uniform-u stratified
            # tables share the resampled inverse's tail-moment bias, so
            # they must take the XLA searchsorted sampler.
            and not spec.heavy_tail
            and (
                spec.kind != DistKind.CUSTOM
                # Zero-density-span (exact_inverse) customs sample through
                # host-built gap-respecting tables.
                or spec.exact_inverse
                or (
                    spec.x_table is not None
                    and spec.x_table.shape[0] >= 2
                )
            )
        )
        if not ok:
            self._no_kernel(
                "this workload is not Pallas-eligible (table-lookup "
                "closure, a function that does not evaluate on a sample "
                "block, too many fused integrands, or an incompatible "
                "table layout)"
            )
        return ok
