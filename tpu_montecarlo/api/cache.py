"""Program cache, mesh resolution, and program-key helpers shared by
every orchestration path (integrate / IS / MCMC, both backends)."""

from __future__ import annotations

from collections import OrderedDict

import numpy as np

import jax
import jax.numpy as jnp


class _ProgramCache:
    """Bounded LRU of compiled programs.  Holding the traced functions in
    the key tuple keeps their ids stable for the cache's lifetime."""

    def __init__(self, maxsize: int = 128):
        self._store: OrderedDict = OrderedDict()
        self._maxsize = maxsize

    def get_or_build(self, key, builder):
        if key in self._store:
            self._store.move_to_end(key)
            return self._store[key]
        value = builder()
        self._store[key] = value
        if len(self._store) > self._maxsize:
            self._store.popitem(last=False)
        return value


_GLOBAL_CACHE = _ProgramCache()


def _resolve_mesh(mesh):
    if mesh is None or isinstance(mesh, jax.sharding.Mesh):
        return mesh
    if mesh == "auto":
        devices = jax.devices()
        if len(devices) == 1:
            return None
        return jax.sharding.Mesh(np.array(devices), ("mc",))
    raise TypeError(f"mesh must be None, 'auto' or a jax Mesh, got {mesh!r}")


def _mesh_key(mesh):
    if mesh is None:
        return None
    return (tuple(d.id for d in mesh.devices.flat), mesh.axis_names)


def _tag_native_batch(run, seed_batch: int, param_batch: bool = False):
    """Mark a program whose signature already takes an (R,) seed vector
    (and, with ``param_batch``, an (R, 2) params array) and returns
    (R, K) — _finalize_prog then skips the unroll wrapper.
    (jitted callables may not accept attributes; wrap if needed.)"""
    if seed_batch == 1 and not param_batch:
        return run

    def _set_tags(obj):
        if seed_batch != 1:
            obj.__native_seed_batch__ = seed_batch
        if param_batch:
            obj.__native_param_batch__ = seed_batch

    try:
        _set_tags(run)
        return run
    except (AttributeError, TypeError):
        def tagged(*args):
            return run(*args)

        _set_tags(tagged)
        for attr in ("actual_samples", "strata"):
            if hasattr(run, attr):
                setattr(tagged, attr, getattr(run, attr))
        return tagged


def _block_traceable(fns, n_args: int = 1) -> bool:
    """True when every function evaluates on (8, 128) float32 blocks (one
    per argument) with a block-broadcastable result — a stand-in for the
    sample vectors the Pallas kernels feed integrands.  A scalar trace alone does not
    guarantee this: a sample-dependent ``while`` becomes a
    ``lax.while_loop`` whose cond is a bool block, which cannot lower
    inside a kernel (the XLA backend vmaps such functions instead, keeping
    the reference's run-anything-on-device guarantee,
    src/shader_gen.rs:272-282).  Cached on the function object."""
    probe = [jax.ShapeDtypeStruct((8, 128), jnp.float32)] * n_args
    attr = (
        "__tpu_mc_block_ok__"
        if n_args == 1
        else f"__tpu_mc_block_ok_{n_args}__"
    )
    for f in fns:
        ok = getattr(f, attr, None)
        if ok is None:
            try:
                out = jax.eval_shape(f, *probe)
                shape = getattr(out, "shape", ())
                ok = np.broadcast_shapes(shape, (8, 128)) == (8, 128)
            except Exception:
                ok = False
            try:
                setattr(f, attr, ok)
            except Exception:
                pass
        if not ok:
            return False
    return True


def _fn_key(f):
    return getattr(f, "__tpu_mc_key__", ("id", id(f)))


def _fns_key(fns):
    return tuple(_fn_key(f) for f in fns)
