"""Device-mesh helpers for sharded Monte Carlo.

The reference is single-device (one wgpu adapter, src/engine.rs:91-131);
multi-chip scale-out here is pure data parallelism over the sample/chain
axis: each device sweeps a disjoint chunk range / chain block and partial
sums combine with a psum across devices (SURVEY.md §2.4).  The mesh is a
plain 1-D mesh over the devices: the cards of one host are joined all to
all, so no topology is assumed.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

import jax

__all__ = ["default_mesh", "mesh_info"]


def default_mesh(
    devices: Optional[Sequence] = None, axis_name: str = "mc"
) -> jax.sharding.Mesh:
    """1-D mesh over the given (default: all visible) devices."""
    if devices is None:
        devices = jax.devices()
    return jax.sharding.Mesh(np.asarray(devices), (axis_name,))


def mesh_info(mesh: Optional[jax.sharding.Mesh]) -> str:
    if mesh is None:
        return "single-device"
    return f"mesh{tuple(mesh.devices.shape)} axes={mesh.axis_names}"
