"""The MonteCarloIntegrator class: mixin assembly + construction."""

from __future__ import annotations

from typing import Optional

from .base import _BaseMixin
from .cache import _GLOBAL_CACHE, _resolve_mesh
from .importance import _ImportanceMixin
from .integrate import _IntegrateMixin
from .mcmc import _McmcMixin
from .mcmc_nd import _McmcNdMixin
from .tempering import _PtMixin


class MonteCarloIntegrator(
    _BaseMixin,
    _IntegrateMixin,
    _ImportanceMixin,
    _McmcMixin,
    _McmcNdMixin,
    _PtMixin,
):
    """GPU-accelerated Monte Carlo integrator for expected values.

    Fuses K integrands into a single compiled pass over shared samples
    (E[f_1(X)] … E[f_K(X)] in one sweep), with native device sampling for
    uniform/normal/exponential/table distributions and on-device reduction.

    Args:
        target_threads: lane-width knob, kept from the reference API
            (default 65,536; reference src/engine.rs:164).  For MCMC it
            overrides ``n_chains`` (reference quirk, src/engine.rs:860).
        backend: "auto" | "xla" | "pallas".  "auto" picks the fused
            Pallas-Triton kernels on the GPU where available and the XLA
            builders elsewhere; "pallas" forces the kernels (interpreted
            on the CPU, refused on other platforms).
        mesh: None (single device), "auto" (1-D mesh over all visible
            devices), or a ``jax.sharding.Mesh`` — samples/chains are
            sharded over the mesh and reduced with psum across devices.
    """

    def __init__(
        self,
        target_threads: Optional[int] = None,
        backend: str = "auto",
        mesh=None,
    ):
        if backend not in ("auto", "xla", "pallas"):
            raise ValueError(f"Unknown backend: {backend!r}")
        self._target_threads = target_threads
        self._backend = backend
        self._mesh = _resolve_mesh(mesh)
        self._cache = _GLOBAL_CACHE
