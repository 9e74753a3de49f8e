"""WGSL string front-end: WGSL compute functions -> jittable JAX functions.

The reference API accepts raw WGSL source strings wherever it accepts
Python callables (reference: python/wgpu_montecarlo/__init__.py:734-747,
tests/test_integrator.py:48-68).  To keep that surface working without
a WGSL compiler, this module parses the WGSL *function*
subset the reference emits and consumes (scalar ``fn name(x: f32) -> f32``
definitions with let/var, if/else, while, ``for``, ``loop`` with an
optional ``continuing { ... break if cond; }`` block, ``break`` /
``continue`` in every loop form, ``switch``, ``i++``/``i--`` updates,
arithmetic, comparisons, ``&&``/``||``/``!``, ``select`` and the WGSL math
builtins) into Python AST nodes, then evaluates them with the same symbolic
interpreter the Python tracer uses (tracing.py).  A string may contain
several functions that call each other (the reference's importance-sampling
wrappers are shaped that way, __init__.py:893-905); the FIRST function is
the entry point, matching ``_rename_wgsl_function``'s first-match rename
(__init__.py:1123-1135).

Structured jumps lower to flag-guarded dataflow because the interpreter's
loops become ``lax.while_loop`` (no early exit in a traced loop): each loop with
jumps gets a break flag (conjoined into the loop condition) and a continue
flag (reset every iteration); statements following a conditional jump are
wrapped in ``if (flags == 0)`` guards.  ``break`` inside ``switch`` binds
to the switch and ``continue`` inside ``switch`` binds to the enclosing
loop, both per the WGSL spec — the binding falls out of desugaring
constructs inside-out as they finish parsing.  ``discard`` stays rejected:
it is a fragment-shader statement, invalid in the compute entry points the
reference compiles (naga validates the same way).
"""

from __future__ import annotations

import ast
import re
from typing import Callable, Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp

from .tracing import (
    TraceError,
    _FUNC_MAP,
    _Interpreter,
    _Mat,
    _Struct,
    _Vec,
    _as_scalar_f32,
    _contains_return,
    _RET_VAL,
    _vec_all,
    _vec_any,
    _vec_cross,
    _vec_distance,
    _vec_dot,
    _vec_length,
    _vec_normalize,
)

__all__ = ["WgslError", "trace_wgsl_function"]


class WgslError(TraceError):
    """Raised when a WGSL string cannot be parsed/traced."""


def _inverse_sqrt(x):
    return jax.lax.rsqrt(jnp.asarray(x, jnp.float32))


def _trunc_mod(a, b):
    """WGSL '%' semantics: remainder with the sign of the dividend."""
    return jnp.fmod(jnp.asarray(a, jnp.float32), jnp.asarray(b, jnp.float32))


def _make_vec_ctor(n: int):
    """``vecN(...)`` value constructor: a single scalar splats; otherwise
    the scalar/vector arguments must flatten to exactly N components
    (WGSL's mixed constructor forms, e.g. ``vec4<f32>(v.xy, 0.0, 1.0)``)."""

    def ctor(*args):
        comps = []
        for a in args:
            comps.extend(a.comps if isinstance(a, _Vec) else (a,))
        if len(comps) == n:
            return _Vec(comps)
        if len(comps) == 1 and not isinstance(args[0], _Vec):
            return _Vec(comps * n)
        raise TraceError(
            f"vec{n} constructor got {len(comps)} component(s)"
        )

    ctor.__wgsl_vec_aware__ = True
    ctor.__name__ = f"__wgsl_vec{n}__"
    return ctor


def _arr_ctor(*args):
    for a in args:
        if isinstance(a, _Vec):
            raise TraceError(
                "array constructors take scalar elements (arrays of "
                "vectors are not supported)"
            )
    return _Vec(args)


_arr_ctor.__wgsl_vec_aware__ = True


def _cast_f32(x):
    return x


def _cast_int(x):
    """WGSL u32()/i32() conversion: truncate toward zero (the all-f32
    integer model; floor/ceil lower everywhere, trunc via the sign
    select)."""
    if isinstance(x, float):
        return float(int(x))
    import jax.numpy as jnp

    xa = jnp.asarray(x, jnp.float32)
    return jnp.where(xa >= 0, jnp.floor(xa), jnp.ceil(xa))


def _make_mat_ctor(c, r):
    """``matCxR<f32>(...)`` constructor: C*R scalars in column-major
    order, or C column vectors of R components (WGSL's two forms)."""

    def ctor(*args):
        if len(args) == c and all(isinstance(a, _Vec) for a in args):
            if any(len(a) != r for a in args):
                raise TraceError(
                    f"mat{c}x{r} column constructor needs "
                    f"{r}-component vectors"
                )
            return _Mat(args)
        comps = []
        for a in args:
            comps.extend(a.comps if isinstance(a, _Vec) else (a,))
        if len(comps) != c * r:
            raise TraceError(
                f"mat{c}x{r} constructor got {len(comps)} component(s), "
                f"needs {c * r} (column-major) or {c} column vectors"
            )
        return _Mat(
            _Vec(comps[i * r : (i + 1) * r]) for i in range(c)
        )

    ctor.__wgsl_vec_aware__ = True
    ctor.__name__ = f"__wgsl_mat{c}x{r}__"
    return ctor


def _mat_transpose(m):
    if not isinstance(m, _Mat):
        raise TraceError("transpose takes a matrix")
    c, r = m.shape
    return _Mat(
        _Vec(m.cols[j].comps[i] for j in range(c)) for i in range(r)
    )


def _mat_determinant(m):
    """determinant(matNxN) by cofactor expansion on the scalar
    components (N <= 4: at most 40 multiplies, pure elementwise)."""
    if not isinstance(m, _Mat):
        raise TraceError("determinant takes a matrix")
    c, r = m.shape
    if c != r:
        raise TraceError("determinant takes a square matrix")

    def det(rows_):
        n = len(rows_)
        if n == 1:
            return rows_[0][0]
        if n == 2:
            return rows_[0][0] * rows_[1][1] - rows_[0][1] * rows_[1][0]
        total = None
        for j in range(n):
            minor = [
                [row[jj] for jj in range(n) if jj != j]
                for row in rows_[1:]
            ]
            term = rows_[0][j] * det(minor)
            if j % 2:
                term = -term
            total = term if total is None else total + term
        return total

    # element (i, j) = column j, component i
    rows_ = [[m.cols[j].comps[i] for j in range(c)] for i in range(r)]
    return det(rows_)


_mat_transpose.__wgsl_vec_aware__ = True
_mat_determinant.__wgsl_vec_aware__ = True


def _decl_check(value, kind_code, n):
    """Trace-time check that an ANNOTATED declaration's initializer
    matches the declared type (naga rejects e.g. ``var v: vec2<f32> =
    vec3<f32>(...)``; without this the mismatched value would silently
    bind).  ``kind_code``: 0 scalar, 1 vec, 2 array (numeric so the
    tracer's constant admission stays numbers-only)."""
    kind_code = int(kind_code)
    n = int(n)
    if kind_code == 3:
        c, r = divmod(n, 10)
        if not isinstance(value, _Mat) or value.shape != (c, r):
            got = (
                f"mat{value.shape[0]}x{value.shape[1]}"
                if isinstance(value, _Mat)
                else (
                    f"a {len(value)}-component vector"
                    if isinstance(value, _Vec)
                    else "a scalar"
                )
            )
            raise TraceError(
                f"declared mat{c}x{r} but the initializer is {got}"
            )
        return value
    if kind_code == 0:
        if isinstance(value, (_Vec, _Mat, _Struct)):
            raise TraceError(
                "declared a scalar but the initializer is an "
                "aggregate value"
            )
        return value
    label = f"vec{n}" if kind_code == 1 else f"array<f32, {n}>"
    if not isinstance(value, _Vec):
        raise TraceError(
            f"declared {label} but the initializer is not a "
            "vector/array value"
        )
    if len(value) != n:
        raise TraceError(
            f"declared {label} but the initializer has "
            f"{len(value)} component(s)"
        )
    return value


_decl_check.__wgsl_vec_aware__ = True

_VEC_FUNCS = {
    "__wgsl_vec2__": _make_vec_ctor(2),
    "__wgsl_vec3__": _make_vec_ctor(3),
    "__wgsl_vec4__": _make_vec_ctor(4),
    "__wgsl_arr__": _arr_ctor,
    "__wgsl_declcheck__": _decl_check,
    **{
        f"__wgsl_mat{c}x{r}__": _make_mat_ctor(c, r)
        for c in (2, 3, 4)
        for r in (2, 3, 4)
    },
    "transpose": _mat_transpose,
    "determinant": _mat_determinant,
    "dot": _vec_dot,
    "cross": _vec_cross,
    "length": _vec_length,
    "distance": _vec_distance,
    "normalize": _vec_normalize,
    "any": _vec_any,
    "all": _vec_all,
}


def _wgsl_mod_call(left: ast.expr, right: ast.expr) -> ast.expr:
    return _loc(
        ast.Call(
            func=_loc(ast.Name(id="__wgsl_mod__", ctx=ast.Load())),
            args=[left, right],
            keywords=[],
        )
    )


# -- structured-jump desugaring helpers ---------------------------------------
#
# ``break``/``continue`` parse into marker statements (a bare Name inside an
# Expr); the construct they bind to consumes them when IT finishes parsing —
# inner constructs finish first, so a break inside ``switch`` is consumed by
# the switch and a continue inside the same switch survives to the enclosing
# loop, exactly the WGSL binding rules.

_BREAK_MARKER = "__wgsl_break__"
_CONTINUE_MARKER = "__wgsl_continue__"


def _marker(name: str) -> ast.stmt:
    return _loc(ast.Expr(value=_loc(ast.Name(id=name, ctx=ast.Load()))))


def _is_marker(stmt: ast.stmt, name: str) -> bool:
    return (
        isinstance(stmt, ast.Expr)
        and isinstance(stmt.value, ast.Name)
        and stmt.value.id == name
    )


def _has_marker(stmts: List[ast.stmt], names: Tuple[str, ...]) -> bool:
    """True if any statement subtree still holds an unconsumed jump marker
    from ``names``.  Inner loops/switches consumed their own markers at
    parse time, so whatever ``ast.walk`` finds binds to the asking
    construct (or, for continues under a switch, to an enclosing loop)."""
    for stmt in stmts:
        for node in ast.walk(stmt):
            if isinstance(node, ast.Name) and node.id in names:
                return True
    return False


def _assign_const(name: str, value: float) -> ast.stmt:
    return _loc(
        ast.Assign(
            targets=[_loc(ast.Name(id=name, ctx=ast.Store()))],
            value=_loc(ast.Constant(value=value)),
        )
    )


def _flag_clear(name: str) -> ast.expr:
    """``name == 0.0`` — the flag-not-set test."""
    return _loc(
        ast.Compare(
            left=_loc(ast.Name(id=name, ctx=ast.Load())),
            ops=[ast.Eq()],
            comparators=[_loc(ast.Constant(value=0.0))],
        )
    )


def _flags_clear(flags: List[str]) -> ast.expr:
    tests = [_flag_clear(f) for f in flags]
    if len(tests) == 1:
        return tests[0]
    return _loc(ast.BoolOp(op=ast.And(), values=tests))


def _masked_value_return() -> ast.stmt:
    """``return __tmc_ret_val__`` — placed after an infinite loop whose only
    exit is a ``return`` in its body (valid WGSL: control cannot fall
    through, so naga does not demand a trailing return).  The loop's
    return-mask lowering (tracing.py) stops iterating exactly when the mask
    is set, so at this point the masked value IS the function's result; the
    fold at the Return site is a no-op ``where(mask, v, v)``."""
    return _loc(ast.Return(value=_loc(ast.Name(id=_RET_VAL, ctx=ast.Load()))))


def _guard_if(flags: List[str], body: List[ast.stmt]) -> ast.stmt:
    return _loc(
        ast.If(
            test=_flags_clear(flags),
            body=body if body else [_loc(ast.Pass())],
            orelse=[],
        )
    )


def _flag_guard(
    stmts: List[ast.stmt],
    brk: Optional[str],
    cont: Optional[str],
) -> List[ast.stmt]:
    """Consume this construct's jump markers from a statement list.

    An unconditional jump replaces the (unreachable) rest of the list with
    a flag set; a jump nested in an ``if`` sets the flag in that branch and
    the rest of the list re-wraps in ``if (flags == 0)``, so execution
    "falls through" without running anything — the dataflow rendering of a
    structured early exit.  ``brk``/``cont`` are the flag variable names;
    pass ``None`` to leave that marker kind for an enclosing construct
    (switch consumes breaks only; continues bind to the enclosing loop)."""
    consumed = tuple(
        m
        for m, f in ((_BREAK_MARKER, brk), (_CONTINUE_MARKER, cont))
        if f is not None
    )
    flags = [f for f in (brk, cont) if f is not None]
    out: List[ast.stmt] = []
    for idx, stmt in enumerate(stmts):
        if brk is not None and _is_marker(stmt, _BREAK_MARKER):
            out.append(_assign_const(brk, 1.0))
            return out
        if cont is not None and _is_marker(stmt, _CONTINUE_MARKER):
            out.append(_assign_const(cont, 1.0))
            return out
        if isinstance(stmt, ast.If) and _has_marker([stmt], consumed):
            body = _flag_guard(stmt.body, brk, cont)
            orelse = _flag_guard(stmt.orelse, brk, cont)
            out.append(
                _loc(
                    ast.If(
                        test=stmt.test,
                        body=body if body else [_loc(ast.Pass())],
                        orelse=orelse,
                    )
                )
            )
            rest = stmts[idx + 1 :]
            if rest:
                out.append(_guard_if(flags, _flag_guard(rest, brk, cont)))
            return out
        out.append(stmt)
    return out


_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+|//[^\n]*|/\*.*?\*/)
  | (?P<num>(?:\d+\.\d*|\.\d+|\d+)(?:[eE][+-]?\d+)?[fhui]?)
  | (?P<name>[A-Za-z_][A-Za-z0-9_]*)
  | (?P<op>->|&&|\|\||==|!=|<=|>=|<<|>>|\+\+|--|\+=|-=|\*=|/=|%=|[-+*/%<>=!(){},;:.&|^~@\[\]])
    """,
    re.VERBOSE | re.DOTALL,
)

_KEYWORDS = {"fn", "let", "var", "return", "if", "else", "while", "for", "loop",
             "break", "continue", "true", "false", "const", "discard"}

_TYPES = {"f32", "f16", "u32", "i32", "bool"}
_VEC_TYPES = {"vec2": 2, "vec3": 3, "vec4": 4}
_VEC_CTOR = {"vec2": "__wgsl_vec2__", "vec3": "__wgsl_vec3__",
             "vec4": "__wgsl_vec4__"}
# matCxR: C columns x R rows (WGSL column-major), f32 only.
_MAT_TYPES = {
    f"mat{c}x{r}": (c, r) for c in (2, 3, 4) for r in (2, 3, 4)
}


def _tokenize(src: str) -> List[Tuple[str, str]]:
    tokens: List[Tuple[str, str]] = []
    pos = 0
    while pos < len(src):
        m = _TOKEN_RE.match(src, pos)
        if m is None:
            raise WgslError(f"Unexpected character in WGSL source: {src[pos]!r}")
        pos = m.end()
        if m.lastgroup == "ws":
            continue
        tokens.append((m.lastgroup, m.group()))
    tokens.append(("eof", ""))
    return tokens


class _Parser:
    """Recursive-descent parser for the scalar WGSL function subset,
    producing Python ``ast`` nodes consumed by the tracing interpreter."""

    def __init__(self, tokens: List[Tuple[str, str]]):
        self.toks = tokens
        self.i = 0
        self._loop_depth = 0  # break/continue validity (WGSL binding rules)
        self._switch_depth = 0  # break (but not continue) also binds here
        self._in_continuing = False  # only 'break if' may jump in there
        # switch nesting depth at continuing entry: a 'break' inside a
        # continuing block is legal only when it binds to a switch opened
        # WITHIN the continuing (it then cannot exit the continuing).
        self._continuing_switch_base = 0
        self._flag_seq = 0  # unique ids for desugared flag/temp variables
        # struct name -> ordered [(field, type)] — declare-before-use.
        self.structs: Dict[str, List[Tuple[str, Tuple[str, int]]]] = {}

    # -- token helpers -------------------------------------------------------

    def peek(self) -> Tuple[str, str]:
        return self.toks[self.i]

    def next(self) -> Tuple[str, str]:
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, value: str) -> None:
        kind, val = self.next()
        if val != value:
            raise WgslError(f"Expected {value!r}, got {val!r}")

    def accept(self, value: str) -> bool:
        if self.peek()[1] == value:
            self.i += 1
            return True
        return False

    # -- grammar --------------------------------------------------------------

    def parse_program(self) -> List[Tuple[str, List[str], List[ast.stmt]]]:
        fns = []
        while self.peek()[0] != "eof":
            if self.peek()[1] == "struct":
                self.parse_struct()
                continue
            if self.peek()[1] != "fn":
                raise WgslError(
                    f"Expected 'fn' or 'struct' at top level, got "
                    f"{self.peek()[1]!r}"
                )
            fns.append(self.parse_fn())
        if not fns:
            raise WgslError("No WGSL functions found")
        return fns

    def parse_struct(self):
        """``struct Name { field: type, ... }`` — ',' or ';' member
        separators, optional trailing separator (both WGSL syntaxes)."""
        self.next()  # 'struct'
        kind, name = self.next()
        if kind != "name":
            raise WgslError(f"Expected struct name, got {name!r}")
        if name in self.structs or name in _TYPES or name in _VEC_TYPES \
                or name in _MAT_TYPES:
            raise WgslError(f"Duplicate or reserved type name: {name!r}")
        self.expect("{")
        fields: List[Tuple[str, Tuple[str, int]]] = []
        while not self.accept("}"):
            k, fname = self.next()
            if k != "name":
                raise WgslError(
                    f"Expected struct member name, got {fname!r}"
                )
            self.expect(":")
            fields.append((fname, self._parse_type()))
            if self.peek()[1] in (",", ";"):
                self.next()
        if not fields:
            raise WgslError(f"struct {name!r} has no members")
        if len(set(f for f, _ in fields)) != len(fields):
            raise WgslError(f"struct {name!r} has duplicate members")
        self.structs[name] = fields

    def parse_fn(self):
        self.expect("fn")
        kind, name = self.next()
        if kind != "name":
            raise WgslError(f"Expected function name, got {name!r}")
        self.expect("(")
        params: List[str] = []
        param_types: List[Tuple[str, int]] = []
        while not self.accept(")"):
            k, pname = self.next()
            if k != "name":
                raise WgslError(f"Expected parameter name, got {pname!r}")
            self.expect(":")
            param_types.append(self._parse_type())
            params.append(pname)
            if self.peek()[1] == ",":
                self.next()
        self.expect("->")
        self._parse_type()
        body = self.parse_block()
        return name, params, body, param_types

    def _parse_type(self):
        """Parse a type; returns ("scalar", 0) | ("vec", n) |
        ("array", n) | ("mat", c*10 + r) so declarations without
        initialisers can zero-init correctly."""
        kind, val = self.next()
        if val in _TYPES:
            return ("scalar", 0)
        if val in _MAT_TYPES:
            if self.accept("<"):
                _, elem = self.next()
                if elem != "f32":
                    raise WgslError(
                        f"Unsupported matrix element type: {elem!r} "
                        "(f32 only)"
                    )
                self.expect(">")
            c, r = _MAT_TYPES[val]
            return ("mat", c * 10 + r)
        if val in _VEC_TYPES:
            if self.accept("<"):
                _, elem = self.next()
                if elem not in _TYPES:
                    raise WgslError(
                        f"Unsupported vector element type: {elem!r}"
                    )
                self.expect(">")
            return ("vec", _VEC_TYPES[val])
        if val == "array":
            self.expect("<")
            _, elem = self.next()
            if elem not in _TYPES:
                raise WgslError(
                    f"Unsupported array element type: {elem!r} (arrays of "
                    "scalars only)"
                )
            self.expect(",")
            nk, nv = self.next()
            if nk != "num" or not nv.rstrip("fhui").isdigit():
                raise WgslError(
                    f"array size must be an integer literal, got {nv!r}"
                )
            n = int(nv.rstrip("fhui"))
            if not 1 <= n <= 256:
                raise WgslError(f"Unsupported array size: {n}")
            self.expect(">")
            return ("array", n)
        if val in self.structs:
            # Declared-before-use struct type; the index keys the
            # per-parse struct table (see _register_structs).
            return ("struct", list(self.structs).index(val))
        raise WgslError(f"Unsupported WGSL type: {val!r}")

    def parse_block(self) -> List[ast.stmt]:
        self.expect("{")
        stmts: List[ast.stmt] = []
        while not self.accept("}"):
            stmts.extend(self.parse_stmt())
        return stmts

    def parse_stmt(self) -> List[ast.stmt]:
        kind, val = self.peek()

        if val in ("let", "var", "const"):
            stmt = self.parse_decl()
            self.expect(";")
            return [stmt]

        if val == "return":
            self.next()
            if self._in_continuing:
                # WGSL forbids returning out of a continuing block (naga
                # rejects it the same way).
                raise WgslError(
                    "'return' is not allowed in a continuing block"
                )
            value = self.parse_expr()
            self.expect(";")
            return [_loc(ast.Return(value=value))]

        if val == "if":
            return [self.parse_if()]

        if val == "while":
            self.next()
            test = self.parse_paren_or_bare_expr()
            body = self._parse_loop_body_block()
            return self._build_loop(init=[], cond=test, body=body, update=[])

        if val == "for":
            return self.parse_for()

        if val == "loop":
            return self.parse_loop()

        if val == "switch":
            return self.parse_switch()

        if val == "break":
            self.next()
            if self.peek()[1] == "if":
                raise WgslError(
                    "'break if' is only valid as the last statement of a "
                    "loop's continuing block"
                )
            self.expect(";")
            if (
                self._in_continuing
                and self._switch_depth <= self._continuing_switch_base
            ):
                # A break here would exit the continuing block itself;
                # only a break bound to a switch opened inside the
                # continuing stays contained (WGSL behavior rules).
                raise WgslError(
                    "only 'break if' may exit a continuing block"
                )
            if self._loop_depth == 0 and self._switch_depth == 0:
                raise WgslError("'break' outside a loop or switch")
            return [_marker(_BREAK_MARKER)]

        if val == "continue":
            self.next()
            self.expect(";")
            if self._in_continuing:
                # continue always binds to the loop (even through a
                # switch), which would re-enter the continuing block.
                raise WgslError(
                    "'continue' is not allowed in a continuing block"
                )
            if self._loop_depth == 0:
                raise WgslError("'continue' outside a loop")
            return [_marker(_CONTINUE_MARKER)]

        if val == "discard":
            raise WgslError(
                "'discard' is a fragment-shader statement and is invalid in "
                "the compute functions this API compiles"
            )

        if kind == "name":
            stmt = self.parse_assign_stmt()
            self.expect(";")
            return [stmt]

        raise WgslError(f"Unsupported WGSL statement starting at {val!r}")

    def parse_decl(self) -> ast.stmt:
        """``let/var/const name (: type)? (= expr)?`` without the ';'."""
        self.next()
        _, name = self.next()
        ty = ("scalar", 0)
        annotated = False
        if self.accept(":"):
            ty = self._parse_type()
            annotated = True
        if self.accept("="):
            value = self.parse_expr()
            if annotated:
                # Enforce the annotation against the initializer at
                # trace time (naga rejects the mismatch; see
                # _decl_check / __wgsl_structcheck__).
                if ty[0] == "struct":
                    value = _loc(
                        ast.Call(
                            func=_loc(
                                ast.Name(
                                    id="__wgsl_structcheck__",
                                    ctx=ast.Load(),
                                )
                            ),
                            args=[
                                value,
                                _loc(ast.Constant(value=float(ty[1]))),
                            ],
                            keywords=[],
                        )
                    )
                else:
                    kind_code = {
                        "scalar": 0, "vec": 1, "array": 2, "mat": 3,
                    }[ty[0]]
                    value = _loc(
                        ast.Call(
                            func=_loc(
                                ast.Name(
                                    id="__wgsl_declcheck__", ctx=ast.Load()
                                )
                            ),
                            args=[
                                value,
                                _loc(ast.Constant(value=float(kind_code))),
                                _loc(ast.Constant(value=float(ty[1]))),
                            ],
                            keywords=[],
                        )
                    )
        elif ty[0] == "scalar":
            value = ast.Constant(value=0.0)
        elif ty[0] == "struct":
            # Zero-value: the struct's own constructor with no args
            # (fills recursive zero members).
            value = _loc(
                ast.Call(
                    func=_loc(
                        ast.Name(
                            id=list(self.structs)[ty[1]], ctx=ast.Load()
                        )
                    ),
                    args=[],
                    keywords=[],
                )
            )
        else:
            # WGSL zero-value: vecN() splats 0.0; arrays take one
            # explicit zero per element (no splat form in the array
            # constructor); matCxR takes C*R zeros column-major.
            kind, n = ty
            if kind == "vec":
                ctor, nargs = _VEC_CTOR[f"vec{n}"], 1
            elif kind == "mat":
                c, r = divmod(n, 10)
                ctor, nargs = f"__wgsl_mat{c}x{r}__", c * r
            else:
                ctor, nargs = "__wgsl_arr__", n
            value = _loc(
                ast.Call(
                    func=_loc(ast.Name(id=ctor, ctx=ast.Load())),
                    args=[_loc(ast.Constant(value=0.0)) for _ in range(nargs)],
                    keywords=[],
                )
            )
        return self._assign(name, value)

    def parse_assign_stmt(self) -> ast.stmt:
        """``lvalue = expr`` / ``lvalue op= expr`` / ``lvalue++`` /
        ``lvalue--`` without the trailing ';'.  An lvalue is a name
        optionally followed by ONE component access or index
        (``v.x = …``, ``a[i] = …``); deeper paths would need nested
        aggregate types the scalar-element surface does not have."""
        _, name = self.next()
        path = None  # ("attr", name) | ("index", expr)
        while self.peek()[1] in (".", "["):
            if path is not None:
                raise WgslError(
                    "Nested component assignment is not supported "
                    "(arrays and vectors hold scalars)"
                )
            if self.accept("."):
                k, attr = self.next()
                if k != "name":
                    raise WgslError(
                        f"Expected member name after '.', got {attr!r}"
                    )
                path = ("attr", attr)
            else:
                self.expect("[")
                idx = self.parse_expr()
                self.expect("]")
                path = ("index", idx)

        def load():
            e = _loc(ast.Name(id=name, ctx=ast.Load()))
            if path is None:
                return e
            if path[0] == "attr":
                return _loc(ast.Attribute(value=e, attr=path[1], ctx=ast.Load()))
            return _loc(ast.Subscript(value=e, slice=path[1], ctx=ast.Load()))

        def store(value: ast.expr) -> ast.stmt:
            if path is None:
                return self._assign(name, value)
            base = _loc(ast.Name(id=name, ctx=ast.Load()))
            if path[0] == "attr":
                tgt = _loc(
                    ast.Attribute(value=base, attr=path[1], ctx=ast.Store())
                )
            else:
                tgt = _loc(
                    ast.Subscript(value=base, slice=path[1], ctx=ast.Store())
                )
            return _loc(ast.Assign(targets=[tgt], value=value))

        _, op = self.next()
        if op == "=":
            return store(self.parse_expr())
        if op in ("++", "--"):
            delta = _loc(ast.Constant(value=1.0))
            node_op = ast.Add() if op == "++" else ast.Sub()
            return store(_loc(ast.BinOp(left=load(), op=node_op, right=delta)))
        if op in ("+=", "-=", "*=", "/=", "%="):
            value = self.parse_expr()
            if op == "%=":
                return store(_wgsl_mod_call(load(), value))
            binop = {
                "+=": ast.Add,
                "-=": ast.Sub,
                "*=": ast.Mult,
                "/=": ast.Div,
            }[op]
            return store(_loc(ast.BinOp(left=load(), op=binop(), right=value)))
        raise WgslError(f"Unexpected token after identifier: {op!r}")

    def parse_for(self) -> List[ast.stmt]:
        """Desugar ``for (init; cond; update) { body }`` into
        ``init; while (cond) { body; update }`` — the tracing
        interpreter already lowers ``while`` (closing the last
        string-surface gap vs the reference's compile-anything WGSL
        acceptance, reference __init__.py:738-747).

        WGSL scopes a ``var``/``let`` declared in the for-header to the
        loop; the flat desugared scope would let it clobber a same-named
        outer variable, so header-declared loop variables are renamed to
        a unique internal name throughout the header and body (shadow
        semantics preserved: body references resolve to the loop
        variable, post-loop references to the outer one)."""
        self.expect("for")
        self.expect("(")
        init: List[ast.stmt] = []
        decl_name = None
        if not self.accept(";"):
            kind, val = self.peek()
            if val in ("let", "var", "const"):
                decl = self.parse_decl()
                decl_name = decl.targets[0].id
                init = [decl]
            else:
                init = [self.parse_assign_stmt()]
            self.expect(";")
        cond: Optional[ast.expr] = None
        if not self.accept(";"):
            cond = self.parse_expr()
            self.expect(";")
        update: List[ast.stmt] = []
        if self.peek()[1] != ")":
            update = [self.parse_assign_stmt()]
        self.expect(")")
        body = self._parse_loop_body_block()
        stmts = self._build_loop(init=init, cond=cond, body=body, update=update)
        if decl_name is not None:
            self._loop_seq = getattr(self, "_loop_seq", 0) + 1
            renamer = _RenameVar(
                decl_name, f"__wgsl_for_{decl_name}_{self._loop_seq}"
            )
            stmts = [renamer.visit(s) for s in stmts]
        return stmts

    def _parse_loop_body_block(self) -> List[ast.stmt]:
        """Parse a while/for/loop body: break/continue become valid, and a
        nested body is NOT a continuing block even if the loop is."""
        self._loop_depth += 1
        saved = self._in_continuing
        self._in_continuing = False
        try:
            return self.parse_block()
        finally:
            self._in_continuing = saved
            self._loop_depth -= 1

    def _fresh_flags(self) -> Tuple[str, str]:
        self._flag_seq += 1
        return (
            f"__wgsl_brk_{self._flag_seq}",
            f"__wgsl_cont_{self._flag_seq}",
        )

    def _build_loop(
        self,
        init: List[ast.stmt],
        cond: Optional[ast.expr],
        body: List[ast.stmt],
        update: List[ast.stmt],
    ) -> List[ast.stmt]:
        """``init; while (cond) { body; update }`` with structured jumps.

        Jump-free bodies keep the flat round-2 desugaring.  With jumps, a
        break flag joins the loop condition and a continue flag (reset each
        iteration) guards the statements a ``continue`` skips; the update
        still runs after a continue (C/WGSL for-semantics: continue jumps
        TO the update) but not after a break.  ``cond=None`` (a ``for``
        with an empty condition) is always-true and requires a break or a
        ``return`` in the body (the return-mask lowering in tracing.py
        stops returned lanes)."""
        has_break = _has_marker(body, (_BREAK_MARKER,))
        if cond is None and not has_break and not _contains_return(body):
            raise WgslError(
                "WGSL 'for' without a condition, break, or return cannot "
                "terminate"
            )
        # An infinite header with no break exits only via return-in-body:
        # control cannot fall through, so the function's value after the
        # loop is the masked return value.
        infinite = cond is None and not has_break
        if not has_break and not _has_marker(body, (_CONTINUE_MARKER,)):
            if cond is None:
                cond = _loc(ast.Constant(value=True))
            stmts = init + [
                _loc(ast.While(test=cond, body=body + update, orelse=[]))
            ]
            return stmts + [_masked_value_return()] if infinite else stmts
        brk, cont = self._fresh_flags()
        guarded = _flag_guard(body, brk=brk, cont=cont)
        new_body = [_assign_const(cont, 0.0)] + guarded
        if update:
            new_body.append(_guard_if([brk], list(update)))
        if cond is None:
            test: ast.expr = _flag_clear(brk)
        else:
            test = _loc(
                ast.BoolOp(op=ast.And(), values=[_flag_clear(brk), cond])
            )
        stmts = (
            init
            + [_assign_const(brk, 0.0)]
            + [_loc(ast.While(test=test, body=new_body, orelse=[]))]
        )
        return stmts + [_masked_value_return()] if infinite else stmts

    def parse_loop(self) -> List[ast.stmt]:
        """``loop { body (continuing { cstmts (break if cond;)? })? }``.

        The continuing block runs at the end of every iteration — including
        after a ``continue``, which jumps to it — but not after a break;
        ``break if`` is its (only legal) final jump.  Desugars to a
        break-flag-driven while: the loop variable updates a reference user
        would put in ``continuing`` keep their run-even-after-continue
        semantics by sitting outside the continue guard."""
        self.expect("loop")
        self.expect("{")
        self._loop_depth += 1
        saved = self._in_continuing
        self._in_continuing = False
        body: List[ast.stmt] = []
        cstmts: List[ast.stmt] = []
        break_if: Optional[ast.expr] = None
        has_continuing = False
        try:
            while not self.accept("}"):
                if self.peek()[1] == "continuing":
                    self.next()
                    has_continuing = True
                    cstmts, break_if = self.parse_continuing()
                    if self.peek()[1] != "}":
                        raise WgslError(
                            "'continuing' must be the last statement in a "
                            "loop body"
                        )
                    continue
                body.extend(self.parse_stmt())
        finally:
            self._in_continuing = saved
            self._loop_depth -= 1
        has_break = _has_marker(body, (_BREAK_MARKER,))
        if has_break is False and break_if is None and not _contains_return(
            body
        ):
            raise WgslError(
                "WGSL 'loop' without a break or return cannot terminate"
            )
        # Exits only via return-in-body: no fall-through, the value after
        # the loop is the masked return value (valid WGSL; naga accepts
        # a return-terminated loop without a trailing function return).
        return_only_exit = not has_break and break_if is None
        brk, cont = self._fresh_flags()
        guarded = _flag_guard(body, brk=brk, cont=cont)
        new_body = [_assign_const(cont, 0.0)] + guarded
        if has_continuing or break_if is not None:
            cbody = list(cstmts)
            if break_if is not None:
                cbody.append(
                    _loc(
                        ast.If(
                            test=break_if,
                            body=[_assign_const(brk, 1.0)],
                            orelse=[],
                        )
                    )
                )
            new_body.append(_guard_if([brk], cbody))
        stmts = [
            _assign_const(brk, 0.0),
            _loc(ast.While(test=_flag_clear(brk), body=new_body, orelse=[])),
        ]
        return stmts + [_masked_value_return()] if return_only_exit else stmts

    def parse_continuing(self) -> Tuple[List[ast.stmt], Optional[ast.expr]]:
        self.expect("{")
        saved = self._in_continuing
        saved_base = self._continuing_switch_base
        self._in_continuing = True
        self._continuing_switch_base = self._switch_depth
        stmts: List[ast.stmt] = []
        break_if: Optional[ast.expr] = None
        try:
            while not self.accept("}"):
                if self.peek()[1] == "break":
                    self.next()
                    if self.peek()[1] != "if":
                        raise WgslError(
                            "only 'break if' may jump inside a continuing "
                            "block"
                        )
                    self.expect("if")
                    break_if = self.parse_expr()
                    self.expect(";")
                    if self.peek()[1] != "}":
                        raise WgslError(
                            "'break if' must be the last statement of a "
                            "continuing block"
                        )
                    continue
                stmts.extend(self.parse_stmt())
        finally:
            self._in_continuing = saved
            self._continuing_switch_base = saved_base
        return stmts, break_if

    def parse_switch(self) -> List[ast.stmt]:
        """``switch sel { case v1, v2: { ... } default: { ... } }`` as an
        equality if/else chain over a selector temporary.

        WGSL cases never fall through, so ``break`` inside a case is an
        early exit from that case alone — consumed here with a case-local
        flag; ``continue`` markers pass through to the enclosing loop (the
        spec's binding rules).  A clause listing both values and
        ``default`` serves as both (body duplicated into the chain and the
        fallback).  Exactly one default clause is required, as in WGSL."""
        self.expect("switch")
        sel_expr = self.parse_paren_or_bare_expr()
        self.expect("{")
        clauses: List[Tuple[List[ast.expr], bool, List[ast.stmt]]] = []
        while not self.accept("}"):
            kind, val = self.next()
            if val == "case":
                values: List[ast.expr] = []
                is_default = False
                while True:
                    if self.peek()[1] == "default":
                        self.next()
                        is_default = True
                    else:
                        values.append(self.parse_expr())
                    if not self.accept(","):
                        break
                    if self.peek()[1] in (":", "{"):
                        break  # trailing comma
                self.accept(":")
                clauses.append((values, is_default, self._parse_case_block()))
            elif val == "default":
                self.accept(":")
                clauses.append(([], True, self._parse_case_block()))
            else:
                raise WgslError(
                    f"Expected 'case' or 'default' in switch, got {val!r}"
                )
        if sum(1 for _, d, _ in clauses if d) != 1:
            raise WgslError("switch must have exactly one 'default' clause")

        self._flag_seq += 1
        sel_name = f"__wgsl_sel_{self._flag_seq}"
        out: List[ast.stmt] = [
            _loc(
                ast.Assign(
                    targets=[_loc(ast.Name(id=sel_name, ctx=ast.Store()))],
                    value=sel_expr,
                )
            )
        ]

        def prep_body(body: List[ast.stmt]) -> List[ast.stmt]:
            if not _has_marker(body, (_BREAK_MARKER,)):
                return list(body)
            self._flag_seq += 1
            flag = f"__wgsl_swbrk_{self._flag_seq}"
            return [_assign_const(flag, 0.0)] + _flag_guard(
                body, brk=flag, cont=None
            )

        default_body = next(b for _, d, b in clauses if d)
        chain: List[ast.stmt] = prep_body(default_body)
        for values, _, body in reversed([c for c in clauses if c[0]]):
            tests = [
                _loc(
                    ast.Compare(
                        left=_loc(ast.Name(id=sel_name, ctx=ast.Load())),
                        ops=[ast.Eq()],
                        comparators=[v],
                    )
                )
                for v in values
            ]
            test = (
                tests[0]
                if len(tests) == 1
                else _loc(ast.BoolOp(op=ast.Or(), values=tests))
            )
            prepped = prep_body(body)
            chain = [
                _loc(
                    ast.If(
                        test=test,
                        body=prepped if prepped else [_loc(ast.Pass())],
                        orelse=chain,
                    )
                )
            ]
        return out + chain

    def _parse_case_block(self) -> List[ast.stmt]:
        # NOTE: _in_continuing stays set — a switch does not leave the
        # continuing block, so continue/return remain illegal inside it;
        # break becomes legal because it binds to this switch (tracked via
        # _continuing_switch_base).
        self._switch_depth += 1
        try:
            return self.parse_block()
        finally:
            self._switch_depth -= 1

    def parse_if(self) -> ast.stmt:
        self.expect("if")
        test = self.parse_paren_or_bare_expr()
        body = self.parse_block()
        orelse: List[ast.stmt] = []
        if self.accept("else"):
            if self.peek()[1] == "if":
                orelse = [self.parse_if()]
            else:
                orelse = self.parse_block()
        return _loc(ast.If(test=test, body=body, orelse=orelse))

    def parse_paren_or_bare_expr(self) -> ast.expr:
        if self.accept("("):
            e = self.parse_expr()
            self.expect(")")
            return e
        return self.parse_expr()

    @staticmethod
    def _assign(name: str, value: ast.expr) -> ast.stmt:
        return _loc(
            ast.Assign(
                targets=[_loc(ast.Name(id=name, ctx=ast.Store()))], value=value
            )
        )

    # -- expressions ------------------------------------------------------------

    def parse_expr(self) -> ast.expr:
        return self.parse_or()

    def parse_or(self) -> ast.expr:
        left = self.parse_and()
        vals = [left]
        while self.accept("||"):
            vals.append(self.parse_and())
        if len(vals) == 1:
            return left
        return _loc(ast.BoolOp(op=ast.Or(), values=vals))

    def parse_and(self) -> ast.expr:
        left = self.parse_bitor()
        vals = [left]
        while self.accept("&&"):
            vals.append(self.parse_bitor())
        if len(vals) == 1:
            return left
        return _loc(ast.BoolOp(op=ast.And(), values=vals))

    # Bitwise/shift precedence is C-like (| < ^ < & < cmp, shifts
    # between cmp and additive) — a strict superset of WGSL's grammar,
    # which simply REQUIRES parentheses when mixing these levels, so
    # every valid WGSL expression parses identically here.

    def parse_bitor(self) -> ast.expr:
        left = self.parse_bitxor()
        while self.peek()[1] == "|":
            self.next()
            left = _loc(
                ast.BinOp(
                    left=left, op=ast.BitOr(), right=self.parse_bitxor()
                )
            )
        return left

    def parse_bitxor(self) -> ast.expr:
        left = self.parse_bitand()
        while self.peek()[1] == "^":
            self.next()
            left = _loc(
                ast.BinOp(
                    left=left, op=ast.BitXor(), right=self.parse_bitand()
                )
            )
        return left

    def parse_bitand(self) -> ast.expr:
        left = self.parse_cmp()
        while self.peek()[1] == "&":
            self.next()
            left = _loc(
                ast.BinOp(
                    left=left, op=ast.BitAnd(), right=self.parse_cmp()
                )
            )
        return left

    _CMP_OPS = {
        "<": ast.Lt,
        ">": ast.Gt,
        "<=": ast.LtE,
        ">=": ast.GtE,
        "==": ast.Eq,
        "!=": ast.NotEq,
    }

    def parse_cmp(self) -> ast.expr:
        left = self.parse_shift()
        op = self.peek()[1]
        if op in self._CMP_OPS:
            self.next()
            right = self.parse_shift()
            return _loc(
                ast.Compare(
                    left=left, ops=[self._CMP_OPS[op]()], comparators=[right]
                )
            )
        return left

    def parse_shift(self) -> ast.expr:
        left = self.parse_add()
        while self.peek()[1] in ("<<", ">>"):
            op = self.next()[1]
            left = _loc(
                ast.BinOp(
                    left=left,
                    op=ast.LShift() if op == "<<" else ast.RShift(),
                    right=self.parse_add(),
                )
            )
        return left

    def parse_add(self) -> ast.expr:
        left = self.parse_mul()
        while self.peek()[1] in ("+", "-"):
            op = self.next()[1]
            right = self.parse_mul()
            left = _loc(
                ast.BinOp(
                    left=left,
                    op=ast.Add() if op == "+" else ast.Sub(),
                    right=right,
                )
            )
        return left

    def parse_mul(self) -> ast.expr:
        left = self.parse_unary()
        while self.peek()[1] in ("*", "/", "%"):
            op = self.next()[1]
            right = self.parse_unary()
            if op == "%":
                # WGSL '%' is trunc-mod (sign of the dividend), not
                # Python's floor-mod — route through the helper so WGSL
                # strings with negative operands keep reference semantics.
                left = _wgsl_mod_call(left, right)
            else:
                node_op = {"*": ast.Mult, "/": ast.Div}[op]()
                left = _loc(ast.BinOp(left=left, op=node_op, right=right))
        return left

    def parse_unary(self) -> ast.expr:
        tok = self.peek()[1]
        if tok == "-":
            self.next()
            return _loc(ast.UnaryOp(op=ast.USub(), operand=self.parse_unary()))
        if tok == "+":
            self.next()
            return self.parse_unary()
        if tok == "!":
            self.next()
            return _loc(ast.UnaryOp(op=ast.Not(), operand=self.parse_unary()))
        if tok == "~":
            self.next()
            return _loc(
                ast.UnaryOp(op=ast.Invert(), operand=self.parse_unary())
            )
        return self.parse_postfix()

    def parse_postfix(self) -> ast.expr:
        """Primary expression followed by member/swizzle access and
        indexing (``v.xy``, ``a[i]``), in any combination."""
        e = self.parse_primary()
        while True:
            if self.accept("."):
                k, attr = self.next()
                if k != "name":
                    raise WgslError(f"Expected member name after '.', got {attr!r}")
                e = _loc(ast.Attribute(value=e, attr=attr, ctx=ast.Load()))
            elif self.accept("["):
                idx = self.parse_expr()
                self.expect("]")
                e = _loc(ast.Subscript(value=e, slice=idx, ctx=ast.Load()))
            else:
                return e

    def parse_primary(self) -> ast.expr:
        kind, val = self.next()
        if kind == "num":
            text = val.rstrip("fhui")
            num = float(text) if ("." in text or "e" in text or "E" in text) else float(int(text))
            return _loc(ast.Constant(value=num))
        if val == "true":
            return _loc(ast.Constant(value=1.0))
        if val == "false":
            return _loc(ast.Constant(value=0.0))
        if val == "(":
            e = self.parse_expr()
            self.expect(")")
            return e
        if kind == "name":
            if val in _VEC_TYPES or val in _MAT_TYPES or val == "array":
                return self._parse_ctor(val)
            if self.peek()[1] == "(":
                self.next()
                args: List[ast.expr] = []
                while not self.accept(")"):
                    args.append(self.parse_expr())
                    if self.peek()[1] == ",":
                        self.next()
                return _loc(
                    ast.Call(
                        func=_loc(ast.Name(id=val, ctx=ast.Load())),
                        args=args,
                        keywords=[],
                    )
                )
            return _loc(ast.Name(id=val, ctx=ast.Load()))
        raise WgslError(f"Unexpected token in expression: {val!r}")

    def _parse_ctor(self, tyname: str) -> ast.expr:
        """``vecN<f32>(...)`` / ``vecN(...)`` / ``array<f32, N>(...)``
        constructor expressions.  vec constructors take a splat scalar,
        N scalars, or any scalar/vector mix totalling N components
        (validated at trace time, where swizzle widths are known); array
        constructors take exactly N scalars or zero args (zero-value)."""
        size = None
        if self.peek()[1] == "<":
            # Re-parse the generic suffix through _parse_type by backing
            # up to the type name token.
            self.i -= 1
            ty = self._parse_type()
            size = ty[1]
        elif tyname == "array":
            size = None  # inferred from the argument count
        self.expect("(")
        args: List[ast.expr] = []
        while not self.accept(")"):
            args.append(self.parse_expr())
            if self.peek()[1] == ",":
                self.next()
        if tyname == "array":
            if not args:
                if size is None:
                    raise WgslError(
                        "array() with no arguments needs an explicit "
                        "array<T, N> type"
                    )
                args = [_loc(ast.Constant(value=0.0)) for _ in range(size)]
            elif size is not None and len(args) != size:
                raise WgslError(
                    f"array<_, {size}> constructor got {len(args)} "
                    "arguments"
                )
            ctor = "__wgsl_arr__"
        elif tyname in _MAT_TYPES:
            c, r = _MAT_TYPES[tyname]
            if not args:
                # matCxR() zero-value: C*R zeros, column-major.
                args = [
                    _loc(ast.Constant(value=0.0)) for _ in range(c * r)
                ]
            ctor = f"__wgsl_mat{c}x{r}__"
        else:
            if not args:
                args = [_loc(ast.Constant(value=0.0))]
            ctor = _VEC_CTOR[tyname]
        return _loc(
            ast.Call(
                func=_loc(ast.Name(id=ctor, ctx=ast.Load())),
                args=args,
                keywords=[],
            )
        )


class _RenameVar(ast.NodeTransformer):
    """Rename every ``Name`` occurrence of one identifier (loop-variable
    scoping for desugared for-headers; WGSL has no nested function
    scopes, so a subtree-wide rename is exact shadow semantics)."""

    def __init__(self, old: str, new: str):
        self.old = old
        self.new = new

    def visit_Name(self, node):
        if node.id == self.old:
            node.id = self.new
        return node


def _loc(node):
    node.lineno = 1
    node.col_offset = 0
    node.end_lineno = 1
    node.end_col_offset = 0
    return node


def _register_structs(registry, struct_defs):
    """Per-parse struct machinery: one value constructor per declared
    struct (positional member values, or no args for the WGSL
    zero-value — recursive zeros) plus the annotated-declaration type
    check (``__wgsl_structcheck__``)."""
    order = list(struct_defs)

    def zero_value(ty):
        kind, n = ty
        if kind == "scalar":
            return 0.0
        if kind in ("vec", "array"):
            return _Vec((0.0,) * n)
        if kind == "mat":
            c, r = divmod(n, 10)
            return _Mat(_Vec((0.0,) * r) for _ in range(c))
        return registry[order[n]]()  # nested struct zero-value

    def field_matches(val, ty):
        kind, n = ty
        if kind == "scalar":
            return not isinstance(val, (_Vec, _Mat, _Struct))
        if kind in ("vec", "array"):
            return isinstance(val, _Vec) and len(val) == n
        if kind == "mat":
            return isinstance(val, _Mat) and val.shape == divmod(n, 10)
        return isinstance(val, _Struct) and val.tyname == order[n]

    for name, fields in struct_defs.items():

        def ctor(*args, _name=name, _fields=fields):
            if not args:
                args = [zero_value(ty) for _, ty in _fields]
            if len(args) != len(_fields):
                raise TraceError(
                    f"struct {_name} constructor takes "
                    f"{len(_fields)} member value(s), got {len(args)}"
                )
            for a, (fname, ty) in zip(args, _fields):
                if not field_matches(a, ty):
                    raise TraceError(
                        f"struct {_name} member '{fname}' type "
                        "mismatch in constructor"
                    )
            return _Struct(_name, [f for f, _ in _fields], args)

        ctor.__wgsl_vec_aware__ = True
        ctor.__name__ = name
        registry[name] = ctor

    def structcheck(value, idx):
        name = order[int(idx)]
        if not isinstance(value, _Struct) or value.tyname != name:
            got = (
                f"a {value.tyname} value"
                if isinstance(value, _Struct)
                else "not a struct value"
            )
            raise TraceError(
                f"declared struct {name} but the initializer is {got}"
            )
        return value

    structcheck.__wgsl_vec_aware__ = True
    registry["__wgsl_structcheck__"] = structcheck


def trace_wgsl_function(code: str) -> Callable:
    """Parse a WGSL string (one or more scalar functions) and return a
    jittable JAX scalar function for the FIRST definition.

    Raises:
        WgslError: on unsupported syntax or constructs.
    """
    parser = _Parser(_tokenize(code))
    fns = parser.parse_program()

    # Safety net: every jump marker must have been consumed by the loop or
    # switch it binds to during parsing.  A leftover marker would execute as
    # a silent no-op (the interpreter ignores bare expressions), turning a
    # front-end bug into wrong semantics instead of an error.
    for _name, _params, _body, _ptypes in fns:
        if _has_marker(_body, (_BREAK_MARKER, _CONTINUE_MARKER)):
            raise WgslError(
                "internal: unconsumed break/continue marker after parsing"
            )

    # Late-bound registry so functions can call each other regardless of
    # definition order (the reference IS wrappers call later-defined fns).
    registry: Dict[str, Callable] = {}
    if parser.structs:
        _register_structs(registry, parser.structs)

    def make_callable(params: List[str], body: List[ast.stmt]) -> Callable:
        fdef = _loc(
            ast.FunctionDef(
                name="wgsl_fn",
                args=ast.arguments(
                    posonlyargs=[],
                    args=[ast.arg(arg=p) for p in params],
                    kwonlyargs=[],
                    kw_defaults=[],
                    defaults=[],
                ),
                body=body,
                decorator_list=[],
            )
        )

        def call(*args):
            # WGSL builtins (sqrt/sin/select/mix/clamp/…) resolve from the
            # shared FUNC_MAP; user-defined functions shadow them.
            namespace = dict(_FUNC_MAP)
            namespace["inverseSqrt"] = _inverse_sqrt
            namespace["__wgsl_mod__"] = _trunc_mod
            # WGSL value-conversion builtins under the all-f32 model:
            # u32()/i32() truncate toward zero (per spec); f32() is the
            # identity.  Componentwise over vectors via _vec_map.
            namespace["f32"] = _cast_f32
            namespace["u32"] = _cast_int
            namespace["i32"] = _cast_int
            namespace.update(_VEC_FUNCS)
            namespace.update(registry)
            interp = _Interpreter(captured=namespace)
            return interp.run(fdef, args)

        # User functions take vec-typed parameters as the _Vec itself —
        # never componentwise-mapped by the interpreter's call dispatch.
        call.__wgsl_vec_aware__ = True
        return call

    for name, params, body, _ptypes in fns:
        registry[name] = make_callable(params, body)

    entry_name, entry_params, _, entry_ptypes = fns[0]
    if any(t[0] != "scalar" for t in entry_ptypes):
        raise WgslError(
            "the entry function must take scalar parameters (vectors and "
            "arrays may appear in locals and helper functions)"
        )
    entry = registry[entry_name]

    def traced(*args):
        return _as_scalar_f32(entry(*args))

    # Validate by abstract evaluation on scalar f32 inputs.
    probe = [jax.ShapeDtypeStruct((), jnp.float32)] * len(entry_params)
    try:
        out = jax.eval_shape(traced, *probe)
    except TraceError:
        raise
    except Exception as e:
        raise WgslError(f"Failed to trace WGSL function: {e}") from e
    if out.shape != ():
        raise WgslError("WGSL function must be scalar->scalar")

    traced.__tpu_mc_traced__ = True
    traced.__tpu_mc_key__ = ("wgsl", code)
    traced.__tpu_mc_arity__ = len(entry_params)
    traced.__name__ = entry_name
    return traced
