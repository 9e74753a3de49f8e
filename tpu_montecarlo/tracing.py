"""Tracing front-end: restricted Python -> jittable JAX scalar functions.

This module plays the role the Python->WGSL transpiler plays in the
reference (reference: python/wgpu_montecarlo/transpiler.py): it takes user
callables written against a restricted math subset of Python — lambdas or
``def`` functions of one float argument using arithmetic, comparisons,
``math``/``numpy`` functions, ternaries, ``and``/``or``, ``if``/``while``
statements, and captured numeric constants — and turns them into pure,
jittable JAX scalar functions that compile straight into fused kernels.

Instead of generating device source text, we *symbolically evaluate* the
function's AST on JAX tracers:

  * ternary expressions and ``if`` statements become ``jnp.where`` merges
    (both branches evaluated, like WGSL ``select``),
  * ``while`` loops become ``jax.lax.while_loop`` (vectorising via ``vmap``
    batching, i.e. per-sample loop termination like per-thread WGSL loops);
    ``return`` inside a loop lowers to a first-return-wins mask carried
    through the loop (the reference emits WGSL ``return`` statements there,
    transpiler.py:561-567 via _visit_while:626-637),
  * ``math.*`` / ``numpy.*`` calls and constants are resolved to their
    ``jax.numpy`` equivalents,
  * captured closure/global ``int``/``float``/``bool`` values are baked in
    as constants (bools as 1.0/0.0),

and the same constructs that defeated the reference transpiler raise
``TraceError`` here — ``int(x)``/``float(x)`` casts, ``for`` loops, captured
lists/dicts/arrays, unknown modules — so importance sampling routes to the
PDF-table fallback for exactly the same class of functions (reference:
python/wgpu_montecarlo/__init__.py:826-838).

Functions that are already JAX-traceable (e.g. written with ``jax.numpy``)
are accepted as-is via a direct-tracing tier, a capability superset of the
reference (which required raw WGSL strings for anything its transpiler
could not handle).
"""

from __future__ import annotations

import ast
import functools
import hashlib
import inspect
import linecache
import math
import textwrap
import types
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

import jax
import jax.numpy as jnp

__all__ = ["TraceError", "trace_function", "is_traceable"]

_MAX_TRACE_DEPTH = 16


class TraceError(Exception):
    """Raised when a user function cannot be traced to a JAX computation."""


class _PartialReturnError(TraceError):
    """Internal: a block returned on one control path but its local
    continuation has no return — the direct (env, ret) evaluation cannot
    express a maybe-return, so the function is re-lowered through the
    return-mask transform (see run())."""


# ---------------------------------------------------------------------------
# Function / constant tables
# ---------------------------------------------------------------------------


def _int_pow(base, exp: int):
    """Binary exponentiation with exact multiplies."""
    if exp == 0:
        return jnp.ones_like(jnp.asarray(base))
    inv = exp < 0
    exp = abs(exp)
    result = None
    acc = jnp.asarray(base)
    while exp:
        if exp & 1:
            result = acc if result is None else result * acc
        exp >>= 1
        if exp:
            acc = acc * acc
    return 1.0 / result if inv else result


class _Vec:
    """WGSL ``vecN<f32>`` / ``array<f32, N>`` value: a fixed-length tuple
    of SCALAR components (Python floats or JAX tracers).

    Components stay independent scalar dataflow — never stacked into an
    (N, ...) array — so vec code lowers to exactly the elementwise ops the
    Pallas kernels accept (a stacked leading axis would add a block
    dimension and gathers the kernels must avoid).
    Registered as a pytree, so ``lax.while_loop`` carries and branch
    merges thread vec-typed variables transparently.

    The reference accepts any WGSL naga compiles, including vector and
    array locals (python/wgpu_montecarlo/__init__.py:738-747 passes source
    through unchanged); this is the JAX counterpart for that surface.
    """

    __slots__ = ("comps",)

    # Two separate character sets: WGSL forbids mixing them in one
    # swizzle (naga rejects e.g. ``v.xg``), so resolution tries each set
    # whole rather than one merged map.
    _SWIZZLE_SETS = ("xyzw", "rgba")
    _SWIZZLE = {c: i for i, c in enumerate("xyzw")}
    _SWIZZLE.update({c: i for i, c in enumerate("rgba")})

    @classmethod
    def _swizzle_indices(cls, attr: str):
        for chars in cls._SWIZZLE_SETS:
            if all(ch in chars for ch in attr):
                return [chars.index(ch) for ch in attr]
        if all(ch in cls._SWIZZLE for ch in attr):
            raise TraceError(
                f"Swizzle '.{attr}' mixes the xyzw and rgba character "
                "sets (WGSL forbids mixed-set swizzles)"
            )
        raise TraceError(
            f"Unknown vector component or swizzle: '.{attr}'"
        )

    def __init__(self, comps):
        self.comps = tuple(comps)
        if not 1 <= len(self.comps):
            raise TraceError("empty vector value")

    def __len__(self):
        return len(self.comps)

    def __repr__(self):
        return f"_Vec({len(self.comps)})"

    # -- elementwise arithmetic (scalar operands broadcast) -----------------

    def _zip(self, other, op, swap=False):
        if isinstance(other, _Vec):
            if len(other) != len(self):
                raise TraceError(
                    f"vector size mismatch: {len(self)} vs {len(other)}"
                )
            pairs = zip(self.comps, other.comps)
        else:
            pairs = ((c, other) for c in self.comps)
        if swap:
            return _Vec(op(b, a) for a, b in pairs)
        return _Vec(op(a, b) for a, b in pairs)

    def __add__(self, o):
        return self._zip(o, lambda a, b: a + b)

    def __radd__(self, o):
        return self._zip(o, lambda a, b: a + b, swap=True)

    def __sub__(self, o):
        return self._zip(o, lambda a, b: a - b)

    def __rsub__(self, o):
        return self._zip(o, lambda a, b: a - b, swap=True)

    def __mul__(self, o):
        return self._zip(o, lambda a, b: a * b)

    def __rmul__(self, o):
        return self._zip(o, lambda a, b: a * b, swap=True)

    def __truediv__(self, o):
        return self._zip(o, lambda a, b: a / b)

    def __rtruediv__(self, o):
        return self._zip(o, lambda a, b: a / b, swap=True)

    def __neg__(self):
        return _Vec(-c for c in self.comps)

    def __pos__(self):
        return self

    # -- component access ----------------------------------------------------

    def swizzle(self, attr: str):
        idx = self._swizzle_indices(attr)
        if max(idx) >= len(self):
            raise TraceError(
                f"Swizzle '.{attr}' out of range for a {len(self)}-component "
                "vector"
            )
        if len(idx) == 1:
            return self.comps[idx[0]]
        return _Vec(self.comps[i] for i in idx)

    def with_component(self, attr: str, value):
        """Single-component store (``v.x = e``).  WGSL forbids assigning
        through multi-component swizzles; enforce the same."""
        if len(attr) != 1 or attr not in self._SWIZZLE:
            raise TraceError(
                f"Cannot assign through '.{attr}': only single components "
                "(.x/.y/.z/.w) are assignable"
            )
        i = self._SWIZZLE[attr]
        if i >= len(self):
            raise TraceError(
                f"Component '.{attr}' out of range for a {len(self)}-"
                "component vector"
            )
        if isinstance(value, _Vec):
            raise TraceError(
                f"Cannot assign a {len(value)}-component vector to the "
                f"scalar component '.{attr}'"
            )
        comps = list(self.comps)
        comps[i] = value
        return _Vec(comps)

    @staticmethod
    def _static_index(idx) -> Optional[int]:
        if isinstance(idx, (int, float)) and float(idx).is_integer():
            return int(idx)
        return None

    def index(self, idx):
        """``v[i]`` — static indices resolve at trace time (negative or
        out-of-range raises, as naga does for constant OOB); dynamic
        indices lower to a running select chain whose result is the
        clamped component (WGSL's out-of-bounds behaviour is an
        implementation-defined clamp; the chain realises clamp-to-edge
        with no gather, keeping the kernel path elementwise)."""
        k = self._static_index(idx)
        if k is not None:
            if not 0 <= k < len(self):
                raise TraceError(
                    f"Index {k} out of range for {len(self)} components"
                )
            return self.comps[k]
        # Truncate first: the frontend models WGSL integers as f32, and
        # u32(x) truncates — ``a[i / 2]`` at i=1 must read element 0,
        # not round to element 1.
        pos = jnp.floor(jnp.asarray(idx, jnp.float32))
        out = self.comps[0]
        for j in range(1, len(self)):
            out = _merge(pos >= (j - 0.5), self.comps[j], out)
        return out

    def with_index(self, idx, value):
        """``a[i] = e`` — static index rebuilds the tuple; dynamic index
        writes through per-component equality masks on the clamped,
        truncated position (same clamp-to-edge + u32-truncation
        convention as reads)."""
        if isinstance(value, _Vec):
            raise TraceError(
                f"Cannot assign a {len(value)}-component vector to a "
                "scalar array element"
            )
        k = self._static_index(idx)
        if k is not None:
            if not 0 <= k < len(self):
                raise TraceError(
                    f"Index {k} out of range for {len(self)} components"
                )
            comps = list(self.comps)
            comps[k] = value
            return _Vec(comps)
        pos = jnp.clip(
            jnp.floor(jnp.asarray(idx, jnp.float32)), 0.0, len(self) - 1.0
        )
        return _Vec(
            _merge(pos == float(j), value, c)
            for j, c in enumerate(self.comps)
        )


jax.tree_util.register_pytree_node(
    _Vec,
    lambda v: (v.comps, len(v.comps)),
    lambda n, comps: _Vec(comps),
)


class _Mat:
    """WGSL ``matCxR<f32>`` value: C column :class:`_Vec`\\ s of R
    components each (WGSL's column-major convention) — like ``_Vec``,
    a trace-time aggregate of SCALAR lane values, never a stacked
    array, so matrix-typed locals stay Pallas-eligible.  The reference
    accepts any WGSL naga compiles
    (python/wgpu_montecarlo/__init__.py:738-747); this closes the
    matrix slice of that surface."""

    __slots__ = ("cols",)

    def __init__(self, cols):
        cols = tuple(cols)
        if not cols or not all(isinstance(c, _Vec) for c in cols):
            raise TraceError("matrix columns must be vectors")
        r = len(cols[0])
        if any(len(c) != r for c in cols):
            raise TraceError("matrix columns must have equal length")
        if not (2 <= len(cols) <= 4 and 2 <= r <= 4):
            raise TraceError(
                f"unsupported matrix shape mat{len(cols)}x{r}"
            )
        self.cols = cols

    @property
    def shape(self):
        """(columns, rows) — WGSL's CxR."""
        return (len(self.cols), len(self.cols[0]))

    def __repr__(self):
        c, r = self.shape
        return f"_Mat({c}x{r})"

    def __neg__(self):
        return _Mat(-c for c in self.cols)

    def __pos__(self):
        return self

    def index(self, idx):
        """``m[i]`` — the i-th COLUMN (WGSL convention).  Static
        indices resolve at trace time; dynamic indices lower to the
        clamp-to-edge select chain per component (the _Vec design)."""
        k = _Vec._static_index(idx)
        if k is not None:
            if not 0 <= k < len(self.cols):
                raise TraceError(
                    f"Column index {k} out of range for "
                    f"{len(self.cols)} columns"
                )
            return self.cols[k]
        pos = jnp.floor(jnp.asarray(idx, jnp.float32))
        out = list(self.cols[0].comps)
        for j in range(1, len(self.cols)):
            out = [
                _merge(pos >= (j - 0.5), c, o)
                for c, o in zip(self.cols[j].comps, out)
            ]
        return _Vec(out)

    def with_index(self, idx, value):
        """``m[i] = v`` — replace a column (static index) or write
        through per-column equality masks (dynamic, clamped+truncated
        like _Vec stores)."""
        if not isinstance(value, _Vec) or len(value) != self.shape[1]:
            got = (
                f"a {len(value)}-component vector"
                if isinstance(value, _Vec)
                else "a scalar"
            )
            raise TraceError(
                f"matrix columns take {self.shape[1]}-component "
                f"vectors, got {got}"
            )
        k = _Vec._static_index(idx)
        if k is not None:
            if not 0 <= k < len(self.cols):
                raise TraceError(
                    f"Column index {k} out of range for "
                    f"{len(self.cols)} columns"
                )
            cols = list(self.cols)
            cols[k] = value
            return _Mat(cols)
        pos = jnp.clip(
            jnp.floor(jnp.asarray(idx, jnp.float32)),
            0.0,
            len(self.cols) - 1.0,
        )
        return _Mat(
            _Vec(
                _merge(pos == float(j), v, c)
                for v, c in zip(value.comps, col.comps)
            )
            for j, col in enumerate(self.cols)
        )


jax.tree_util.register_pytree_node(
    _Mat,
    lambda m: (m.cols, len(m.cols)),
    lambda n, cols: _Mat(cols),
)


class _Struct:
    """WGSL ``struct`` value: an ordered (field name -> value) record
    whose members are scalars, vectors, matrices, arrays, or nested
    structs — a trace-time aggregate like :class:`_Vec`/:class:`_Mat`
    (pure dataflow, no stacked axes), closing the last WGSL value-type
    slice of the reference's pass-any-string surface
    (python/wgpu_montecarlo/__init__.py:738-747)."""

    __slots__ = ("tyname", "names", "values")

    def __init__(self, tyname, names, values):
        self.tyname = tyname
        self.names = tuple(names)
        self.values = tuple(values)
        if len(self.names) != len(self.values):
            raise TraceError("struct field/value count mismatch")

    def __repr__(self):
        return f"_Struct({self.tyname})"

    def field(self, attr: str):
        try:
            return self.values[self.names.index(attr)]
        except ValueError:
            raise TraceError(
                f"struct '{self.tyname}' has no member '.{attr}'"
            ) from None

    def with_field(self, attr: str, value):
        try:
            i = self.names.index(attr)
        except ValueError:
            raise TraceError(
                f"struct '{self.tyname}' has no member '.{attr}'"
            ) from None
        vals = list(self.values)
        vals[i] = value
        return _Struct(self.tyname, self.names, vals)


jax.tree_util.register_pytree_node(
    _Struct,
    lambda s: (s.values, (s.tyname, s.names)),
    lambda aux, values: _Struct(aux[0], aux[1], values),
)


def _mat_vec(m: _Mat, v: _Vec) -> _Vec:
    """``m * v``: (C, R) by vec C -> vec R (linear combination of the
    columns — pure scalar multiply-adds)."""
    if len(v) != len(m.cols):
        raise TraceError(
            f"mat{m.shape[0]}x{m.shape[1]} * vec{len(v)}: the vector "
            f"must have {len(m.cols)} components"
        )
    out = None
    for col, s in zip(m.cols, v.comps):
        t = col._zip(s, lambda a, b: a * b)
        out = t if out is None else out._zip(t, lambda a, b: a + b)
    return out


def _vec_mat(v: _Vec, m: _Mat) -> _Vec:
    """``v * m``: vec R by (C, R) -> vec C (row vector times matrix)."""
    if len(v) != m.shape[1]:
        raise TraceError(
            f"vec{len(v)} * mat{m.shape[0]}x{m.shape[1]}: the vector "
            f"must have {m.shape[1]} components"
        )
    comps = []
    for col in m.cols:
        s = None
        for a, b in zip(v.comps, col.comps):
            t = a * b
            s = t if s is None else s + t
        comps.append(s)
    return _Vec(comps)


def _mat_binop(op: str, a, b):
    """Matrix arithmetic: +/- between equal-shape matrices, * for
    mat-mat / mat-vec / vec-mat / mat-scalar, / by a scalar — WGSL's
    operator surface for matCxR<f32>."""
    if op == "Mult":
        if isinstance(a, _Mat) and isinstance(b, _Mat):
            # (C1, R) * (C2, C1) -> (C2, R): each result column is
            # a * (column of b).
            if len(a.cols) != b.shape[1]:
                raise TraceError(
                    f"mat{a.shape[0]}x{a.shape[1]} * "
                    f"mat{b.shape[0]}x{b.shape[1]}: inner dimensions "
                    "must agree"
                )
            return _Mat(_mat_vec(a, col) for col in b.cols)
        if isinstance(a, _Mat) and isinstance(b, _Vec):
            return _mat_vec(a, b)
        if isinstance(a, _Vec) and isinstance(b, _Mat):
            return _vec_mat(a, b)
        m, s = (a, b) if isinstance(a, _Mat) else (b, a)
        return _Mat(c._zip(s, lambda x, y: x * y) for c in m.cols)
    if op in ("Add", "Sub"):
        if not (isinstance(a, _Mat) and isinstance(b, _Mat)):
            raise TraceError(
                "matrix +/- takes two matrices of the same shape"
            )
        if a.shape != b.shape:
            raise TraceError(
                f"matrix shape mismatch: {a.shape} vs {b.shape}"
            )
        impl = (
            (lambda x, y: x + y) if op == "Add" else (lambda x, y: x - y)
        )
        return _Mat(
            ca._zip(cb, impl) for ca, cb in zip(a.cols, b.cols)
        )
    if op == "Div" and isinstance(a, _Mat) and not isinstance(
        b, (_Mat, _Vec)
    ):
        return _Mat(c._zip(b, lambda x, y: x / y) for c in a.cols)
    raise TraceError(f"Unsupported matrix operator: {op}")


def _is_bool_like(v):
    if isinstance(v, (bool, np.bool_)):
        return True
    dt = getattr(v, "dtype", None)
    return dt is not None and dt == jnp.bool_


def _bit_binop(op: str, a, b):
    """WGSL's ``& | ^ << >>`` on the front-end's f32-modeled integers:
    convert to int32, operate, convert back — both conversions lower
    on every backend and in the kernels.  On BOOL operands ``& | ^`` are the logical connectives
    (Python traced lambdas write ``(x > a) & (x < b)``).  Shift
    amounts mask to the 32-bit width, as WGSL mandates.  Note the
    model's limits: integers are exact only to 2^24 (f32 mantissa) and
    ``~``/``>>`` follow int32 (two's-complement, arithmetic-shift)
    semantics."""
    if op in ("BitAnd", "BitOr", "BitXor") and (
        _is_bool_like(a) or _is_bool_like(b)
    ):
        fn = {
            "BitAnd": jnp.logical_and,
            "BitOr": jnp.logical_or,
            "BitXor": jnp.logical_xor,
        }[op]
        return fn(_truthy(a), _truthy(b))
    if isinstance(a, float) and isinstance(b, float):
        # Constant folding in exact Python ints.
        if not (a.is_integer() and b.is_integer()):
            raise TraceError(
                "bitwise/shift operators need integer operands"
            )
        ai, bi = int(a), int(b)
        impl = {
            "BitAnd": lambda x, y: x & y,
            "BitOr": lambda x, y: x | y,
            "BitXor": lambda x, y: x ^ y,
            "LShift": lambda x, y: _wrap_i32(x << (y & 31)),
            "RShift": lambda x, y: x >> (y & 31),
        }[op]
        return float(impl(ai, bi))
    ai = jnp.asarray(a).astype(jnp.int32)
    bi = jnp.asarray(b).astype(jnp.int32)
    if op == "BitAnd":
        r = ai & bi
    elif op == "BitOr":
        r = ai | bi
    elif op == "BitXor":
        r = ai ^ bi
    elif op == "LShift":
        r = ai << (bi & jnp.int32(31))
    else:
        r = ai >> (bi & jnp.int32(31))
    return r.astype(jnp.float32)


def _wrap_i32(x: int) -> int:
    x &= 0xFFFFFFFF
    return x - (1 << 32) if x >= (1 << 31) else x


def _vec_map(fn, *args):
    """Apply a scalar function componentwise across _Vec args (scalars
    broadcast), the lowering for WGSL's elementwise builtins on vectors."""
    n = None
    for a in args:
        if isinstance(a, _Vec):
            if n is not None and len(a) != n:
                raise TraceError(
                    f"vector size mismatch in call: {n} vs {len(a)}"
                )
            n = len(a)
    if n is None:
        return fn(*args)
    return _Vec(
        fn(*[a.comps[i] if isinstance(a, _Vec) else a for a in args])
        for i in range(n)
    )


def _require_vec(val, fname: str) -> _Vec:
    if not isinstance(val, _Vec):
        raise TraceError(f"{fname}() requires a vector argument")
    return val


def _vec_dot(a, b):
    a = _require_vec(a, "dot")
    b = _require_vec(b, "dot")
    if len(a) != len(b):
        raise TraceError(f"dot(): size mismatch {len(a)} vs {len(b)}")
    total = a.comps[0] * b.comps[0]
    for x, y in zip(a.comps[1:], b.comps[1:]):
        total = total + x * y
    return total


def _vec_length(a):
    if not isinstance(a, _Vec):
        return jnp.abs(jnp.asarray(a, jnp.float32))  # WGSL length(scalar)
    return jnp.sqrt(_vec_dot(a, a))


def _vec_distance(a, b):
    if isinstance(a, _Vec):
        return _vec_length(a - b)
    if isinstance(b, _Vec):
        return _vec_length(b._zip(a, lambda x, y: y - x))
    return jnp.abs(jnp.asarray(a, jnp.float32) - jnp.asarray(b, jnp.float32))


def _vec_normalize(a):
    a = _require_vec(a, "normalize")
    return a * (1.0 / _vec_length(a))


def _vec_cross(a, b):
    a = _require_vec(a, "cross")
    b = _require_vec(b, "cross")
    if len(a) != 3 or len(b) != 3:
        raise TraceError("cross() requires vec3 arguments")
    (a0, a1, a2), (b0, b1, b2) = a.comps, b.comps
    return _Vec((a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0))


def _vec_any(a):
    a = _require_vec(a, "any")
    acc = _truthy(a.comps[0])
    for c in a.comps[1:]:
        acc = jnp.logical_or(acc, _truthy(c))
    return acc


def _vec_all(a):
    a = _require_vec(a, "all")
    acc = _truthy(a.comps[0])
    for c in a.comps[1:]:
        acc = jnp.logical_and(acc, _truthy(c))
    return acc


for _vfn in (_vec_dot, _vec_length, _vec_distance, _vec_normalize,
             _vec_cross, _vec_any, _vec_all):
    _vfn.__wgsl_vec_aware__ = True


def _truthy(v):
    if isinstance(v, _Vec):
        raise TraceError(
            "a vector cannot be used as a condition: reduce it with "
            "all() or any()"
        )
    v = jnp.asarray(v)
    if v.dtype == jnp.bool_:
        return v
    return v != 0


def _fract(x):
    return x - jnp.floor(x)


def _mix(a, b, t):
    return a + (b - a) * t


def _step(edge, x):
    return jnp.where(jnp.asarray(x) < edge, 0.0, 1.0)


def _smoothstep(e0, e1, x):
    t = jnp.clip((x - e0) / (e1 - e0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def _merge(cond, t_val, f_val):
    """``where(cond, t, f)`` with a boolean-branch special case: bool
    branches compute the select logically (identical semantics, and no
    select between bool blocks for a kernel lowering to handle).
    ``cond`` must already be boolean."""
    if isinstance(t_val, _Struct) or isinstance(f_val, _Struct):
        # Branch merges of struct variables: field-by-field.
        if not (
            isinstance(t_val, _Struct)
            and isinstance(f_val, _Struct)
            and t_val.tyname == f_val.tyname
            and t_val.names == f_val.names
        ):
            raise TraceError(
                "cannot merge differently-typed struct values in a "
                "branch"
            )
        return _Struct(
            t_val.tyname,
            t_val.names,
            (
                _merge(cond, tv, fv)
                for tv, fv in zip(t_val.values, f_val.values)
            ),
        )
    if isinstance(t_val, _Mat) or isinstance(f_val, _Mat):
        # Branch merges of matrix variables: column-by-column.
        if not (isinstance(t_val, _Mat) and isinstance(f_val, _Mat)):
            raise TraceError("cannot merge a matrix with a non-matrix")
        if t_val.shape != f_val.shape:
            raise TraceError(
                f"matrix shape mismatch in branch merge: {t_val.shape} "
                f"vs {f_val.shape}"
            )
        return _Mat(
            _merge(cond, tc, fc)
            for tc, fc in zip(t_val.cols, f_val.cols)
        )
    if isinstance(t_val, _Vec) or isinstance(f_val, _Vec):
        # Branch merges of vector variables: componentwise, scalars
        # broadcast (e.g. a masked-return vector merging with the scalar
        # zero-initialised return slot).
        n = len(t_val) if isinstance(t_val, _Vec) else len(f_val)
        t_c = t_val.comps if isinstance(t_val, _Vec) else (t_val,) * n
        f_c = f_val.comps if isinstance(f_val, _Vec) else (f_val,) * n
        if len(t_c) != len(f_c):
            raise TraceError(
                f"vector size mismatch in branch merge: {len(t_c)} vs "
                f"{len(f_c)}"
            )
        return _Vec(_merge(cond, t, f) for t, f in zip(t_c, f_c))
    t_arr = jnp.asarray(t_val)
    f_arr = jnp.asarray(f_val)
    if t_arr.dtype == jnp.bool_ and f_arr.dtype == jnp.bool_:
        return jnp.logical_or(
            jnp.logical_and(cond, t_arr),
            jnp.logical_and(jnp.logical_not(cond), f_arr),
        )
    return jnp.where(cond, t_val, f_val)


def _select(f_val, t_val, cond):
    return _merge(_truthy(cond), t_val, f_val)


def _cast_f32(v):
    v = jnp.asarray(v)
    return v.astype(jnp.float32)


def _round_half_even(x):
    """``round`` with ties to even (Python, numpy and WGSL semantics) from
    floor/compare/select alone, which every backend lowers — the Pallas
    Triton route has no rounding primitive."""
    x = jnp.asarray(x)
    if not jnp.issubdtype(x.dtype, jnp.floating):
        return x
    f = jnp.floor(x)
    d = x - f
    even = f - 2.0 * jnp.floor(0.5 * f) == 0.0
    up = jnp.logical_or(d > 0.5, jnp.logical_and(d == 0.5, ~even))
    return jnp.where(up, f + 1.0, f)


def _minmax(op):
    def impl(*args):
        if len(args) < 2:
            raise TraceError("min/max need at least two arguments")
        return functools.reduce(op, args)

    return impl


# Python math-subset name -> JAX implementation.  Mirrors (and modestly
# extends) the reference transpiler's FUNC_MAP (transpiler.py:82-112).
_FUNC_MAP: Dict[str, Callable] = {
    "abs": jnp.abs,
    "fabs": jnp.abs,
    "sin": jnp.sin,
    "cos": jnp.cos,
    "tan": jnp.tan,
    "asin": jnp.arcsin,
    "acos": jnp.arccos,
    "atan": jnp.arctan,
    "atan2": jnp.arctan2,
    "arcsin": jnp.arcsin,
    "arccos": jnp.arccos,
    "arctan": jnp.arctan,
    "arctan2": jnp.arctan2,
    "sinh": jnp.sinh,
    "cosh": jnp.cosh,
    "tanh": jnp.tanh,
    "asinh": jnp.arcsinh,
    "acosh": jnp.arccosh,
    "atanh": jnp.arctanh,
    "arcsinh": jnp.arcsinh,
    "arccosh": jnp.arccosh,
    "arctanh": jnp.arctanh,
    "sqrt": jnp.sqrt,
    "cbrt": jnp.cbrt,
    "exp": jnp.exp,
    "exp2": jnp.exp2,
    "expm1": jnp.expm1,
    "log": jnp.log,
    "log2": jnp.log2,
    "log10": jnp.log10,
    "log1p": jnp.log1p,
    "floor": jnp.floor,
    "ceil": jnp.ceil,
    "round": _round_half_even,
    "trunc": jnp.trunc,
    "fract": _fract,
    "sign": jnp.sign,
    "copysign": jnp.copysign,
    "fmod": jnp.fmod,
    "hypot": jnp.hypot,
    "degrees": jnp.degrees,
    "radians": jnp.radians,
    "min": _minmax(jnp.minimum),
    "max": _minmax(jnp.maximum),
    "minimum": jnp.minimum,
    "maximum": jnp.maximum,
    "fmin": jnp.minimum,
    "fmax": jnp.maximum,
    "clamp": jnp.clip,
    "clip": jnp.clip,
    "mix": _mix,
    "lerp": _mix,
    "step": _step,
    "smoothstep": _smoothstep,
    "pow": jnp.power,
    "power": jnp.power,
    "where": jnp.where,
    "select": _select,
    "heaviside": jnp.heaviside,
    "square": jnp.square,
    # WGSL-style casts used by the WGSL front-end
    "f32": _cast_f32,
}

# Explicitly rejected calls — these are exactly the constructs whose failure
# drives the importance-sampling table fallback (transpiler parity).
_REJECTED_CALLS = {
    "int": "int() casts are not traceable",
    "float": "float() casts are not traceable",
    "bool": "bool() casts are not traceable",
    "complex": "complex numbers are not supported",
    "str": "str() is not supported",
    "list": "list() is not supported",
    "dict": "dict() is not supported",
    "tuple": "tuple() is not supported",
    "set": "set() is not supported",
    "len": "len() is not supported",
    "range": "range() is not supported",
    "print": "print() is not supported",
    "input": "input() is not supported",
}

_KNOWN_MODULES = {"math", "numpy", "np", "jnp", "jax"}

# Module constants (reference: transpiler.py:114-126).
_CONSTANTS: Dict[str, float] = {
    "pi": math.pi,
    "e": math.e,
    "tau": math.tau,
    "inf": math.inf,
    "nan": math.nan,
    "euler_gamma": float(np.euler_gamma),
}

_BUILTIN_FUNCS = {
    "abs": jnp.abs,
    "min": _FUNC_MAP["min"],
    "max": _FUNC_MAP["max"],
    "pow": jnp.power,
    "round": _round_half_even,
}


class _ModuleRef:
    """Marker for a resolved math-like module (math / numpy / jax.numpy)."""

    __slots__ = ("kind",)

    def __init__(self, kind: str):
        self.kind = kind  # "math" | "numpy" | "jnp"


def _classify_module(val) -> Optional[_ModuleRef]:
    if not isinstance(val, types.ModuleType):
        return None
    name = getattr(val, "__name__", "")
    if name == "math":
        return _ModuleRef("math")
    if name == "numpy":
        return _ModuleRef("numpy")
    if name in ("jax.numpy", "jax"):
        return _ModuleRef("jnp")
    return None


# ---------------------------------------------------------------------------
# Source recovery
# ---------------------------------------------------------------------------


def _first_instruction_col(code) -> Optional[int]:
    """Smallest column of any instruction on the code object's first line.

    Used to pick the right lambda when several share a source line
    (requires Python >= 3.11 position tables; reference transpiler solves
    the same problem with co_positions at transpiler.py:413-453).
    """
    try:
        positions = list(code.co_positions())
    except AttributeError:
        return None
    cols = [
        p[2]
        for p in positions
        if p[0] == code.co_firstlineno
        and p[2] is not None
        # skip zero-width prologue positions (RESUME reports col 0:0)
        and not (p[2] == 0 and p[3] == 0)
    ]
    return min(cols) if cols else None


def _find_def_node(func) -> ast.AST:
    """Recover the AST node (Lambda or FunctionDef) for a live callable."""
    code = func.__code__
    filename = code.co_filename
    lineno = code.co_firstlineno
    is_lambda = func.__name__ == "<lambda>"

    trees: List[Tuple[ast.AST, int]] = []  # (tree, line offset)

    file_src = "".join(linecache.getlines(filename))
    if file_src:
        try:
            trees.append((ast.parse(file_src), 0))
        except SyntaxError:
            pass

    if not trees:
        try:
            snippet = textwrap.dedent(inspect.getsource(func))
            snippet_start = lineno  # getsource starts at the def/statement
            trees.append((ast.parse(snippet), snippet_start - 1))
        except (OSError, TypeError, SyntaxError, IndentationError):
            pass

    for tree, offset in trees:
        if is_lambda:
            cands = [
                n
                for n in ast.walk(tree)
                if isinstance(n, ast.Lambda) and n.lineno + offset == lineno
            ]
            if len(cands) == 1:
                return cands[0]
            if len(cands) > 1:
                col = _first_instruction_col(code)
                if col is not None:
                    inside = [
                        n
                        for n in cands
                        if n.col_offset
                        <= col
                        <= (n.end_col_offset or 10**9)
                    ]
                    if inside:
                        return min(
                            inside,
                            key=lambda n: (n.end_col_offset or 10**9)
                            - n.col_offset,
                        )
                raise TraceError(
                    "Cannot disambiguate multiple lambdas defined on one "
                    "source line (Python >= 3.11 required)"
                )
        else:
            cands = [
                n
                for n in ast.walk(tree)
                if isinstance(n, ast.FunctionDef) and n.name == func.__name__
            ]
            if cands:
                return min(cands, key=lambda n: abs(n.lineno + offset - lineno))

    raise TraceError(
        f"Cannot retrieve source for {getattr(func, '__name__', func)!r}"
    )


# ---------------------------------------------------------------------------
# AST interpreter
# ---------------------------------------------------------------------------


def _collect_assigned(stmts: Sequence[ast.stmt]) -> List[str]:
    names: List[str] = []
    for node in stmts:
        for sub in ast.walk(node):
            if isinstance(sub, ast.Assign):
                for tgt in sub.targets:
                    if isinstance(tgt, ast.Name):
                        names.append(tgt.id)
                    elif isinstance(
                        tgt, (ast.Attribute, ast.Subscript)
                    ) and isinstance(tgt.value, ast.Name):
                        # v.x = / a[i] = rebind the whole vector variable.
                        names.append(tgt.value.id)
            elif isinstance(sub, (ast.AugAssign, ast.AnnAssign)):
                if isinstance(sub.target, ast.Name):
                    names.append(sub.target.id)
    seen, out = set(), []
    for n in names:
        if n not in seen:
            seen.add(n)
            out.append(n)
    return out


def _contains_return(stmts: Sequence[ast.stmt]) -> bool:
    return any(
        isinstance(sub, ast.Return)
        for node in stmts
        for sub in ast.walk(node)
    )


# -- return-inside-loop lowering ----------------------------------------------
#
# The reference transpiler emits WGSL ``return`` wherever the Python function
# had one — including inside ``while`` bodies (transpiler.py:561-567 reached
# from _visit_while:626-637), and raw WGSL strings can do the same.  Under
# ``lax.while_loop`` there is no early exit, so a loop return lowers to masked
# dataflow: ``return e`` becomes ``__ret_val = e; __ret_mask = 1`` with the
# rest of the block guarded on the mask, EVERY loop condition in the function
# gets ``mask == 0`` conjoined — loops containing returns (via _mask_while)
# AND return-free loops executed after the mask exists (exec_block), whose
# conditions can depend on variables the returned lanes froze — and every
# subsequent concrete ``return`` folds ``where(mask, __ret_val, value)`` —
# first return wins, which is exactly early-return semantics.

_RET_MASK = "__tmc_ret_mask__"
_RET_VAL = "__tmc_ret_val__"


def _synth(node: ast.AST, like: ast.AST) -> ast.AST:
    ast.copy_location(node, like)
    ast.fix_missing_locations(node)
    return node


def _assign_name(name: str, value: ast.expr, like: ast.AST) -> ast.stmt:
    return _synth(
        ast.Assign(
            targets=[ast.Name(id=name, ctx=ast.Store())], value=value
        ),
        like,
    )


def _mask_clear_test(like: ast.AST) -> ast.expr:
    return _synth(
        ast.Compare(
            left=ast.Name(id=_RET_MASK, ctx=ast.Load()),
            ops=[ast.Eq()],
            comparators=[ast.Constant(value=0.0)],
        ),
        like,
    )


def _mask_returns(stmts: Sequence[ast.stmt]) -> List[ast.stmt]:
    """Rewrite every ``return`` in a loop-body statement list into mask/value
    assignments, guarding statements a conditional return would skip."""
    out: List[ast.stmt] = []
    for idx, stmt in enumerate(stmts):
        if isinstance(stmt, ast.Return):
            if stmt.value is None:
                raise TraceError("Functions must return a value")
            out.append(_assign_name(_RET_VAL, stmt.value, stmt))
            out.append(
                _assign_name(_RET_MASK, ast.Constant(value=1.0), stmt)
            )
            return out  # statements after an unconditional return are dead
        if isinstance(stmt, (ast.If, ast.While)) and _contains_return([stmt]):
            if isinstance(stmt, ast.If):
                body = _mask_returns(stmt.body) or [_synth(ast.Pass(), stmt)]
                out.append(
                    _synth(
                        ast.If(
                            test=stmt.test,
                            body=body,
                            orelse=_mask_returns(stmt.orelse),
                        ),
                        stmt,
                    )
                )
            else:
                out.append(_mask_while(stmt))
            rest = stmts[idx + 1 :]
            if rest:
                out.append(
                    _synth(
                        ast.If(
                            test=_mask_clear_test(stmt),
                            body=_mask_returns(rest)
                            or [_synth(ast.Pass(), stmt)],
                            orelse=[],
                        ),
                        stmt,
                    )
                )
            return out
        out.append(stmt)
    return out


def _mask_while(stmt: ast.While) -> ast.While:
    """A while whose body may return: conjoin ``mask == 0`` into the test
    (returned lanes stop iterating — outer masked loops stop too, since the
    mask is a shared carried variable) and mask the body's returns."""
    if stmt.orelse:
        raise TraceError("while/else is not supported")
    test = _synth(
        ast.BoolOp(op=ast.And(), values=[_mask_clear_test(stmt), stmt.test]),
        stmt,
    )
    return _synth(
        ast.While(test=test, body=_mask_returns(stmt.body), orelse=[]), stmt
    )


def _needs_return_mask(stmts: Sequence[ast.stmt]) -> bool:
    return any(
        isinstance(sub, ast.While) and _contains_return(sub.body)
        for node in stmts
        for sub in ast.walk(node)
    )


def _definitely_returns(stmts: Sequence[ast.stmt]) -> bool:
    """Static guarantee that every control path through the list returns
    (while bodies never count — a loop may run zero iterations)."""
    for stmt in stmts:
        if isinstance(stmt, ast.Return):
            return True
        if isinstance(stmt, ast.If) and stmt.orelse:
            if _definitely_returns(stmt.body) and _definitely_returns(
                stmt.orelse
            ):
                return True
    return False


def _mask_lowered_body(body: Sequence[ast.stmt]) -> List[ast.stmt]:
    """Whole-function masked-return lowering: every return becomes a
    mask/value assignment (with rest-of-block guards), and a synthetic
    trailing ``return __tmc_ret_val__`` delivers the result — its fold is
    ``where(mask, v, v)``, an identity because _definitely_returns
    guaranteed the mask is set on every path."""
    like = body[0]
    out = _mask_returns(list(body))
    out.append(
        _synth(
            ast.Return(value=ast.Name(id=_RET_VAL, ctx=ast.Load())), like
        )
    )
    return out


class _Interpreter:
    """Symbolically evaluates a restricted-Python function body on JAX
    values.  One instance per traced call; cheap (runs only at trace time —
    jit caches the result)."""

    def __init__(self, func=None, depth: int = 0, captured: Optional[Dict[str, Any]] = None):
        self.func = func
        self.depth = depth
        if depth > _MAX_TRACE_DEPTH:
            raise TraceError("Maximum trace recursion depth exceeded")
        if captured is not None:
            # Pre-built environment (used by the WGSL front-end).
            self.captured = captured
            return
        # Captured environment: closure cells first, then globals.
        self.captured = dict(getattr(func, "__globals__", {}) or {})
        code = func.__code__
        closure = func.__closure__ or ()
        for name, cell in zip(code.co_freevars, closure):
            try:
                self.captured[name] = cell.cell_contents
            except ValueError:
                pass

    # -- name resolution ---------------------------------------------------

    def resolve_external(self, name: str):
        if name in self.captured:
            return self.admit(name, self.captured[name])
        if name in _BUILTIN_FUNCS:
            return _BUILTIN_FUNCS[name]
        if name in _REJECTED_CALLS:
            raise TraceError(_REJECTED_CALLS[name])
        raise TraceError(f"Unknown variable or function: '{name}'")

    def admit(self, name: str, val):
        """Validate a captured external value (reference transpiler captures
        only int/float/bool; transpiler.py:234-300)."""
        if isinstance(val, bool):
            return 1.0 if val else 0.0
        if isinstance(val, (int, float, np.floating, np.integer)):
            return float(val)
        mod = _classify_module(val)
        if mod is not None:
            return mod
        if callable(val):
            return val  # resolved further at call sites
        raise TraceError(
            f"Unsupported external variable '{name}' of type "
            f"{type(val).__name__} (only int/float/bool constants, math "
            f"modules and callables are allowed)"
        )

    # -- expression evaluation ----------------------------------------------

    def eval(self, node: ast.expr, env: Dict[str, Any]):
        meth = getattr(self, f"_eval_{type(node).__name__}", None)
        if meth is None:
            raise TraceError(
                f"Unsupported expression: {type(node).__name__}"
            )
        return meth(node, env)

    def _eval_Constant(self, node, env):
        v = node.value
        if isinstance(v, bool):
            return 1.0 if v else 0.0
        if isinstance(v, (int, float)):
            return float(v)
        if v is None:
            raise TraceError("None is not a valid value in traced functions")
        raise TraceError(f"Unsupported constant: {v!r}")

    def _eval_Name(self, node, env):
        if node.id in env:
            return env[node.id]
        return self.resolve_external(node.id)

    _VEC_BINOPS = {
        "Add": lambda a, b: a + b,
        "Sub": lambda a, b: a - b,
        "Mult": lambda a, b: a * b,
        "Div": lambda a, b: a / b,
        "Mod": lambda a, b: jnp.mod(a, b),
        "Pow": lambda a, b: jnp.power(a, b),
    }

    def _eval_BinOp(self, node, env):
        left = self.eval(node.left, env)
        right = self.eval(node.right, env)
        op = type(node.op).__name__
        if isinstance(left, _Struct) or isinstance(right, _Struct):
            raise TraceError(
                "WGSL defines no operators on struct values; operate "
                "on their members"
            )
        if isinstance(left, _Mat) or isinstance(right, _Mat):
            return _mat_binop(op, left, right)
        if op in ("BitAnd", "BitOr", "BitXor", "LShift", "RShift"):
            if isinstance(left, _Vec) or isinstance(right, _Vec):
                impl = lambda a, b, op=op: _bit_binop(op, a, b)  # noqa: E731
                if isinstance(left, _Vec):
                    return left._zip(right, impl)
                return right._zip(left, impl, swap=True)
            return _bit_binop(op, left, right)
        if isinstance(left, _Vec) or isinstance(right, _Vec):
            impl = self._VEC_BINOPS.get(op)
            if impl is None:
                raise TraceError(f"Unsupported vector operator: {op}")
            if isinstance(left, _Vec):
                return left._zip(right, impl)
            return right._zip(left, impl, swap=True)
        if op == "Add":
            return left + right
        if op == "Sub":
            return left - right
        if op == "Mult":
            return left * right
        if op == "Div":
            return left / right
        if op == "Mod":
            # Python floor-mod semantics (jnp.mod); note the reference
            # transpiles '%' to WGSL '%' (trunc-mod) — Python semantics win.
            if isinstance(left, float) and isinstance(right, float):
                return math.fmod(left, right) if right == 0 else left % right
            return jnp.mod(left, right)
        if op == "Pow":
            if isinstance(left, float) and isinstance(right, float):
                return left**right
            if isinstance(right, float) and right.is_integer() and abs(right) <= 64:
                # Exact repeated-multiplication for integer exponents: avoids
                # the f32 exp/log round-trip and is defined for negative
                # bases (unlike WGSL pow, which the reference emits).
                return _int_pow(left, int(right))
            return jnp.power(left, right)
        if op == "FloorDiv":
            return jnp.floor_divide(left, right)
        raise TraceError(f"Unsupported binary operator: {op}")

    def _eval_UnaryOp(self, node, env):
        val = self.eval(node.operand, env)
        op = type(node.op).__name__
        if op == "USub":
            return -val
        if op == "UAdd":
            return +val
        if op == "Not":
            if isinstance(val, _Vec):  # WGSL '!' on vec<bool>: componentwise
                return _Vec(jnp.logical_not(_truthy(c)) for c in val.comps)
            return jnp.logical_not(_truthy(val))
        if op == "Invert":
            # WGSL '~' on the f32-modeled integers: int32 bitwise not
            # (two's complement — see _bit_binop's model notes).
            if isinstance(val, _Vec):
                return _Vec(
                    _bit_binop("BitXor", c, -1.0) for c in val.comps
                )
            return _bit_binop("BitXor", val, -1.0)
        raise TraceError(f"Unsupported unary operator: {op}")

    _CMP = {
        "Gt": lambda a, b: a > b,
        "Lt": lambda a, b: a < b,
        "GtE": lambda a, b: a >= b,
        "LtE": lambda a, b: a <= b,
        "Eq": lambda a, b: a == b,
        "NotEq": lambda a, b: a != b,
    }

    def _eval_Compare(self, node, env):
        left = self.eval(node.left, env)
        result = None
        for op, comparator in zip(node.ops, node.comparators):
            opname = type(op).__name__
            if opname not in self._CMP:
                raise TraceError(f"Unsupported comparison: {opname}")
            right = self.eval(comparator, env)
            if isinstance(left, _Vec) or isinstance(right, _Vec):
                # WGSL vector comparisons are componentwise -> vec<bool>;
                # chained vec comparisons (a < b < c) have no WGSL meaning.
                if result is not None or comparator is not node.comparators[-1]:
                    raise TraceError(
                        "Chained comparisons are not supported on vectors"
                    )
                op = self._CMP[opname]
                cmpfn = lambda a, b: op(jnp.asarray(a), jnp.asarray(b))
                if isinstance(left, _Vec):
                    return left._zip(right, cmpfn)
                return right._zip(left, cmpfn, swap=True)
            term = self._CMP[opname](jnp.asarray(left), jnp.asarray(right))
            result = term if result is None else jnp.logical_and(result, term)
            left = right
        return result

    def _eval_BoolOp(self, node, env):
        # Python value semantics without short-circuit: a and b ==
        # where(truthy(a), b, a); a or b == where(truthy(a), a, b).
        # For boolean operands this reduces to logical and/or (which is what
        # the reference's '&&'/'||' mapping produces).
        vals = [self.eval(v, env) for v in node.values]
        is_and = isinstance(node.op, ast.And)
        acc = vals[0]
        for v in vals[1:]:
            if is_and:
                acc = _merge(_truthy(acc), v, acc)
            else:
                acc = _merge(_truthy(acc), acc, v)
        return acc

    def _eval_IfExp(self, node, env):
        test = _truthy(self.eval(node.test, env))
        body = self.eval(node.body, env)
        orelse = self.eval(node.orelse, env)
        return _merge(test, body, orelse)

    def _eval_Attribute(self, node, env):
        base = self.eval(node.value, env)
        if isinstance(base, _Vec):
            return base.swizzle(node.attr)
        if isinstance(base, _Struct):
            return base.field(node.attr)
        if isinstance(base, _ModuleRef):
            if node.attr in _CONSTANTS:
                if node.attr == "euler_gamma" and base.kind == "math":
                    raise TraceError("math module has no attribute euler_gamma")
                return _CONSTANTS[node.attr]
            if node.attr in _FUNC_MAP:
                return _FUNC_MAP[node.attr]
            if base.kind == "jnp":
                impl = getattr(jnp, node.attr, None)
                if impl is not None:
                    return impl
            raise TraceError(
                f"Unknown function or constant: {base.kind}.{node.attr}"
            )
        raise TraceError(
            f"Attribute access is only supported on math modules, got "
            f"attribute '{node.attr}'"
        )

    def _eval_Call(self, node, env):
        if node.keywords:
            raise TraceError("Keyword arguments are not supported")

        # __import__('math') idiom
        if (
            isinstance(node.func, ast.Name)
            and node.func.id == "__import__"
            and len(node.args) == 1
            and isinstance(node.args[0], ast.Constant)
        ):
            modname = node.args[0].value
            if modname == "math":
                return _ModuleRef("math")
            if modname == "numpy":
                return _ModuleRef("numpy")
            raise TraceError(f"Unknown module: {modname}")

        fn = self._resolve_callable(node.func, env)
        args = [self.eval(a, env) for a in node.args]
        if any(isinstance(a, (_Mat, _Struct)) for a in args) and not getattr(
            fn, "__wgsl_vec_aware__", False
        ):
            raise TraceError(
                "matrices/structs are not componentwise-mappable; only "
                "the aggregate-aware builtins and user-defined "
                "functions take them as arguments"
            )
        if any(isinstance(a, _Vec) for a in args) and not getattr(
            fn, "__wgsl_vec_aware__", False
        ):
            # WGSL's math builtins extend componentwise to vectors; only
            # the genuinely vector-typed builtins (dot/cross/length/...)
            # and user-defined WGSL functions see the _Vec itself.
            return _vec_map(fn, *args)
        return fn(*args)

    def _eval_Subscript(self, node, env):
        base = self.eval(node.value, env)
        if not isinstance(base, (_Vec, _Mat)):
            raise TraceError(
                "Indexing is only supported on vector/array/matrix values"
            )
        if isinstance(node.slice, ast.Slice):
            raise TraceError("Slicing is not supported on vectors/arrays")
        return base.index(self.eval(node.slice, env))

    def _resolve_callable(self, func_node: ast.expr, env: Dict[str, Any]):
        if isinstance(func_node, ast.Name):
            name = func_node.id
            if name in env:
                val = env[name]
            else:
                if name in _REJECTED_CALLS:
                    raise TraceError(_REJECTED_CALLS[name])
                if name in self.captured:
                    val = self.admit(name, self.captured[name])
                elif name in _BUILTIN_FUNCS:
                    return _BUILTIN_FUNCS[name]
                else:
                    raise TraceError(f"Unknown function: {name}")
            return self._as_callable(name, val)
        if isinstance(func_node, ast.Attribute):
            val = self.eval(func_node, env)
            return self._as_callable(func_node.attr, val)
        raise TraceError("Only direct function calls are supported")

    def _as_callable(self, name: str, val):
        if isinstance(val, _ModuleRef):
            raise TraceError(f"'{name}' is a module, not callable")
        if callable(val):
            modname = getattr(val, "__module__", "") or ""
            qualname = getattr(val, "__name__", name)
            if modname == "math" or isinstance(val, np.ufunc):
                impl = _FUNC_MAP.get(qualname)
                if impl is None:
                    raise TraceError(f"Unknown function: {qualname}")
                return impl
            if modname.startswith("jax") or modname.startswith(
                "tpu_montecarlo"
            ):
                return val
            if isinstance(val, types.FunctionType):
                # User helper function: trace it recursively (capability
                # superset over the reference, which rejected these).
                return _interpret_callable(val, self.depth + 1)
            impl = _FUNC_MAP.get(qualname)
            if impl is not None:
                return impl
            raise TraceError(f"Unknown function: {qualname}")
        if isinstance(val, float):
            raise TraceError(f"'{name}' is a constant, not callable")
        raise TraceError(f"Unknown function: {name}")

    # -- statement execution -------------------------------------------------

    def exec_block(
        self, stmts: Sequence[ast.stmt], env: Dict[str, Any]
    ) -> Tuple[Dict[str, Any], Optional[Any]]:
        """Execute statements; returns (env, return_value_or_None)."""
        for idx, stmt in enumerate(stmts):
            rest = stmts[idx + 1 :]
            kind = type(stmt).__name__

            if kind == "Return":
                if stmt.value is None:
                    raise TraceError("Functions must return a value")
                val = self.eval(stmt.value, env)
                if _RET_MASK in env:
                    # Fold any pending loop-return: lanes whose mask is set
                    # already returned earlier — first return wins.
                    val = _merge(
                        _truthy(env[_RET_MASK]), env[_RET_VAL], val
                    )
                return env, val

            if kind == "Assign":
                if len(stmt.targets) != 1:
                    raise TraceError(
                        "Only single-variable assignments are supported"
                    )
                tgt = stmt.targets[0]
                if isinstance(tgt, ast.Name):
                    env = dict(env)
                    env[tgt.id] = self.eval(stmt.value, env)
                    continue
                # Component / element stores (v.x = e, a[i] = e) rebuild
                # the whole _Vec binding: pure dataflow, so branch merges
                # and loop carries see an ordinary variable update.
                if isinstance(tgt, (ast.Attribute, ast.Subscript)) and isinstance(
                    tgt.value, ast.Name
                ):
                    name = tgt.value.id
                    if name not in env:
                        raise TraceError(f"Unknown variable: '{name}'")
                    base = env[name]
                    if not isinstance(base, (_Vec, _Mat, _Struct)):
                        raise TraceError(
                            f"'{name}' is not a vector/array/matrix/"
                            "struct value"
                        )
                    if isinstance(base, _Mat) and isinstance(
                        tgt, ast.Attribute
                    ):
                        raise TraceError(
                            "matrices have no component names; assign "
                            "columns by index (m[i] = ...)"
                        )
                    if isinstance(base, _Struct) and isinstance(
                        tgt, ast.Subscript
                    ):
                        raise TraceError(
                            "structs are indexed by member name, not "
                            "position"
                        )
                    val = self.eval(stmt.value, env)
                    env = dict(env)
                    if isinstance(tgt, ast.Attribute):
                        if isinstance(base, _Struct):
                            env[name] = base.with_field(tgt.attr, val)
                            continue
                        env[name] = base.with_component(tgt.attr, val)
                    else:
                        if isinstance(tgt.slice, ast.Slice):
                            raise TraceError(
                                "Slicing is not supported on vectors/arrays"
                            )
                        idx = self.eval(tgt.slice, env)
                        env[name] = base.with_index(idx, val)
                    continue
                raise TraceError(
                    "Only single-variable assignments are supported"
                )

            if kind == "AugAssign":
                if not isinstance(stmt.target, ast.Name):
                    raise TraceError(
                        "Only single-variable assignments are supported"
                    )
                binop = ast.BinOp(
                    left=ast.Name(id=stmt.target.id, ctx=ast.Load()),
                    op=stmt.op,
                    right=stmt.value,
                )
                ast.copy_location(binop, stmt)
                ast.fix_missing_locations(binop)
                env = dict(env)
                env[stmt.target.id] = self._eval_BinOp(binop, env)
                continue

            if kind == "AnnAssign":
                if stmt.value is None or not isinstance(stmt.target, ast.Name):
                    raise TraceError("Unsupported annotated assignment")
                env = dict(env)
                env[stmt.target.id] = self.eval(stmt.value, env)
                continue

            if kind == "If":
                return self._exec_if(stmt, rest, env)

            if kind == "While":
                if _contains_return([stmt]):
                    # Loop returns lower to masked dataflow; the rest of the
                    # block keeps executing (its effects are dead on returned
                    # lanes) and later Return statements fold the mask.
                    env = self._exec_while(_mask_while(stmt), env)
                    continue
                if _RET_MASK in env:
                    # A return-free loop in a function that may have already
                    # returned: its condition can depend on variables frozen
                    # by the mask (e.g. a counter the returned lanes never
                    # advanced), so it too must stop on returned lanes or it
                    # spins forever.
                    stmt = _synth(
                        ast.While(
                            test=ast.BoolOp(
                                op=ast.And(),
                                values=[_mask_clear_test(stmt), stmt.test],
                            ),
                            body=stmt.body,
                            orelse=stmt.orelse,
                        ),
                        stmt,
                    )
                env = self._exec_while(stmt, env)
                continue

            if kind == "Expr":
                # Docstrings and bare expressions: no effect.
                continue

            if kind == "Pass":
                continue

            if kind == "For":
                raise TraceError("For loops are not supported")

            raise TraceError(f"Unsupported statement: {kind}")

        return env, None

    def _exec_if(self, stmt: ast.If, rest, env):
        test = _truthy(self.eval(stmt.test, env))
        env_t, ret_t = self.exec_block(stmt.body, dict(env))
        env_f, ret_f = self.exec_block(stmt.orelse, dict(env))

        if ret_t is not None and ret_f is not None:
            return env, _merge(test, ret_t, ret_f)

        if ret_t is None and ret_f is None:
            merged = dict(env)
            for key in set(env_t) | set(env_f):
                in_t, in_f = key in env_t, key in env_f
                if in_t and in_f:
                    if env_t[key] is env_f[key]:
                        merged[key] = env_t[key]
                    else:
                        merged[key] = _merge(test, env_t[key], env_f[key])
                elif key in env:
                    merged[key] = _merge(
                        test, env_t.get(key, env[key]), env_f.get(key, env[key])
                    )
                # else: one-sided new variable — dropped; later use errors.
            return self.exec_block(rest, merged)

        # Exactly one branch returned: the continuation only runs on the
        # non-returning side.  A continuation without a return is not
        # necessarily an error — an ENCLOSING block may return after us —
        # so signal the caller to re-lower through the return mask.
        if ret_t is not None:
            env_c, ret_c = self.exec_block(rest, env_f)
            if ret_c is None:
                raise _PartialReturnError()
            return env, _merge(test, ret_t, ret_c)
        env_c, ret_c = self.exec_block(rest, env_t)
        if ret_c is None:
            raise _PartialReturnError()
        return env, _merge(test, ret_c, ret_f)

    def _exec_while(self, stmt: ast.While, env):
        if stmt.orelse:
            raise TraceError("while/else is not supported")
        if _contains_return([stmt]):
            # exec_block rewrites loop returns via _mask_while before
            # reaching here; a raw Return at this point is a bug upstream.
            raise TraceError("internal: unmasked return reached _exec_while")

        carry_names = [n for n in _collect_assigned(stmt.body) if n in env]
        if not carry_names:
            raise TraceError(
                "while loop must modify at least one pre-existing variable"
            )

        def to_carry(e):
            # tree_map so _Vec-typed carries (pytrees of scalars) thread
            # through lax.while_loop exactly like plain scalars.
            return tuple(
                jax.tree_util.tree_map(
                    lambda v: jnp.asarray(v, dtype=jnp.float32), e[n]
                )
                for n in carry_names
            )

        base_env = dict(env)

        def with_carry(carry):
            e = dict(base_env)
            e.update(zip(carry_names, carry))
            return e

        def cond_fn(carry):
            return _truthy(self.eval(stmt.test, with_carry(carry)))

        def body_fn(carry):
            e2, _ = self.exec_block(stmt.body, with_carry(carry))
            return to_carry(e2)

        final = jax.lax.while_loop(cond_fn, body_fn, to_carry(env))
        out = dict(env)
        out.update(zip(carry_names, final))
        return out

    # -- entry ----------------------------------------------------------------

    def run(self, node: ast.AST, args: Sequence[Any]):
        if isinstance(node, ast.Lambda):
            params = [a.arg for a in node.args.args]
            if len(params) != len(args):
                raise TraceError(
                    f"Function takes {len(params)} arguments, got {len(args)}"
                )
            env = dict(zip(params, args))
            return self.eval(node.body, env)
        if isinstance(node, ast.FunctionDef):
            params = [a.arg for a in node.args.args]
            if len(params) != len(args):
                raise TraceError(
                    f"Function takes {len(params)} arguments, got {len(args)}"
                )
            env = dict(zip(params, args))
            if _needs_return_mask(node.body):
                # Pre-declare the loop-return mask/value so if-branch merges
                # propagate them (one-sided new variables are dropped).
                env[_RET_MASK] = jnp.float32(0.0)
                env[_RET_VAL] = jnp.float32(0.0)
            try:
                _, ret = self.exec_block(node.body, env)
            except _PartialReturnError:
                # A branch returns but its local continuation does not
                # (e.g. `if c: return a` as the last statement of an outer
                # if-branch, with the function returning later) — valid in
                # the reference's WGSL output.  Re-lower the whole body
                # through the return mask, where every return is an
                # assignment and control flow is pure dataflow.
                if not _definitely_returns(node.body):
                    raise TraceError("Function must return a value")
                env = dict(zip(params, args))
                env[_RET_MASK] = jnp.float32(0.0)
                env[_RET_VAL] = jnp.float32(0.0)
                _, ret = self.exec_block(_mask_lowered_body(node.body), env)
            if ret is None:
                # A function whose only returns sit inside loops has no
                # statically-guaranteed return — the reference's WGSL
                # compiler rejects the missing trailing return the same way.
                raise TraceError("Function must return a value")
            return ret
        raise TraceError(f"Cannot trace node of type {type(node).__name__}")


def _as_scalar_f32(value):
    out = jnp.asarray(value)
    if out.dtype == jnp.bool_:
        # Boolean results become 0.0/1.0, like the reference's
        # select(0.0, 1.0, cond) wrapping (transpiler.py:540-543).
        out = out.astype(jnp.float32)
    return out.astype(jnp.float32)


def _interpret_callable(func, depth: int = 0) -> Callable:
    node = _find_def_node(func)
    interp = _Interpreter(func, depth)

    def traced(*args):
        return _as_scalar_f32(interp.run(node, args))

    traced.__name__ = getattr(func, "__name__", "traced")
    return traced


def _direct_callable(func) -> Callable:
    def traced(*args):
        return _as_scalar_f32(func(*args))

    traced.__name__ = getattr(func, "__name__", "traced")
    return traced


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


def _code_fingerprint(code, depth: int = 0):
    """Structural fingerprint of a code object (recursing into nested code
    constants, e.g. inner lambdas)."""
    consts = []
    for c in code.co_consts:
        if isinstance(c, types.CodeType):
            if depth < 4:
                consts.append(_code_fingerprint(c, depth + 1))
        elif isinstance(c, (int, float, bool, str, bytes, type(None))):
            consts.append(c)
    return (code.co_filename, code.co_firstlineno, code.co_code, tuple(consts))


def function_fingerprint(func) -> Optional[tuple]:
    """Content-based cache key for a user function: code identity plus the
    values of captured numeric constants (and the code identity of captured
    helper callables).  Lets the compiled-program cache hit for fresh lambda
    objects with identical semantics — the reference re-compiles its shader
    on every call; we don't."""
    try:
        code = func.__code__
    except AttributeError:
        return None
    try:
        captured = []
        glb = getattr(func, "__globals__", {}) or {}
        cells = dict(zip(code.co_freevars, func.__closure__ or ()))
        for name in sorted(set(code.co_names) | set(code.co_freevars)):
            if name in cells:
                try:
                    v = cells[name].cell_contents
                except ValueError:
                    continue
            elif name in glb:
                v = glb[name]
            else:
                continue
            if isinstance(v, (bool, int, float, np.floating, np.integer)):
                captured.append((name, float(v)))
            elif isinstance(v, types.FunctionType):
                captured.append((name, function_fingerprint(v)))
            elif isinstance(v, types.ModuleType):
                captured.append((name, ("mod", getattr(v, "__name__", ""))))
            elif isinstance(v, np.ufunc) or isinstance(
                v, types.BuiltinFunctionType
            ):
                captured.append(
                    (name, ("ufunc", getattr(v, "__name__", str(v))))
                )
            elif isinstance(v, np.ndarray):
                captured.append(
                    (name, ("arr", v.shape, str(v.dtype),
                            hashlib.sha1(np.ascontiguousarray(v)).hexdigest()))
                )
            elif isinstance(v, jax.Array):
                host = np.asarray(v)
                captured.append(
                    (name, ("arr", host.shape, str(host.dtype),
                            hashlib.sha1(np.ascontiguousarray(host)).hexdigest()))
                )
            else:
                # A captured value the fingerprint can't represent (custom
                # object, builtin callable, ...): content-addressing would
                # collide two semantically different functions that share
                # code (direct-trace tier accepts captures the interpreter
                # tier rejects), so fall back to identity keying.
                return None
        return ("pyfn", _code_fingerprint(code), tuple(captured))
    except Exception:
        return None


def trace_function(func: Callable, n_args: int = 1) -> Callable:
    """Convert a user callable into a jittable JAX scalar function.

    Tries the restricted-subset AST interpreter first (the analog of the
    reference transpiler); if the source is unavailable or uses constructs
    outside the subset, falls back to tracing the callable directly (for
    functions already written against ``jax.numpy``).

    Raises:
        TraceError: if the function cannot be traced by either tier —
            callers use this to route importance sampling to the PDF-table
            fallback path.
    """
    if getattr(func, "__tpu_mc_traced__", False):
        return func
    if not callable(func):
        raise TypeError(f"Function must be callable, got {type(func)}")

    probe_args = [jax.ShapeDtypeStruct((), jnp.float32)] * n_args
    errors: List[Exception] = []

    for builder in (_interpret_callable, _direct_callable):
        try:
            candidate = builder(func)
            out = jax.eval_shape(candidate, *probe_args)
            if out.shape != ():
                raise TraceError(
                    f"Traced function must be scalar->scalar, got output "
                    f"shape {out.shape}"
                )
            candidate.__tpu_mc_traced__ = True
            fp = function_fingerprint(func)
            candidate.__tpu_mc_key__ = (
                fp if fp is not None else ("id", id(candidate))
            )
            return candidate
        except TraceError as e:
            errors.append(e)
        except Exception as e:  # direct-trace failures (concretization etc.)
            errors.append(e)

    primary = next((e for e in errors if isinstance(e, TraceError)), errors[0])
    if isinstance(primary, TraceError):
        raise primary
    raise TraceError(str(primary)) from primary


def is_traceable(func: Callable, n_args: int = 1) -> bool:
    """True if ``trace_function`` would succeed — the traceability probe
    that drives the importance-sampling closed-form vs. table routing."""
    try:
        trace_function(func, n_args)
        return True
    except (TraceError, TypeError):
        return False
