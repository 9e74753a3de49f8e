"""WGSL matrices (matCxR<f32>) and bitwise/integer operators (round 5).

The reference accepts any WGSL naga compiles
(python/wgpu_montecarlo/__init__.py:738-747); matrices close the last
enumerable value-type slice of that surface, bitwise ops the last
operator slice.  Matrices are trace-time aggregates of scalar lane
values (tracing._Mat — columns of _Vec), so matrix-typed locals stay
Pallas-eligible; bitwise ops run on the front-end's f32-modeled
integers through int32 conversions (no uint bitcasts).

Dual-render checks: every arithmetic identity is evaluated once through
the WGSL front-end and once by a numpy float32 oracle on the same
operands.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from tpu_montecarlo import Distribution, MonteCarloIntegrator
from tpu_montecarlo.tracing import TraceError
from tpu_montecarlo.wgsl_frontend import WgslError, trace_wgsl_function


def _f(code):
    return trace_wgsl_function(code)


def _run(code, x):
    return float(_f(code)(jnp.float32(x)))


class TestMatrixAlgebra:
    def test_mat_vec_matches_numpy(self):
        # m columns (1,2),(3,4) => numpy array [[1,3],[2,4]] (R x C).
        rng = np.random.default_rng(3)
        for _ in range(10):
            vals = rng.uniform(-2, 2, 6).astype(np.float32)
            a, b, c, d, vx, vy = [float(v) for v in vals]
            code = (
                "fn f(x: f32) -> f32 {\n"
                f"  let m = mat2x2<f32>({a}, {b}, {c}, {d});\n"
                f"  let v = m * vec2<f32>({vx}, {vy});\n"
                "  return v.x + 10.0 * v.y; }"
            )
            m = np.array([[a, c], [b, d]], np.float32)
            v = m @ np.array([vx, vy], np.float32)
            got = _run(code, 0.0)
            assert got == pytest.approx(
                float(v[0] + 10.0 * v[1]), rel=1e-5
            )

    def test_vec_mat_is_transpose_product(self):
        code = (
            "fn f(x: f32) -> f32 {\n"
            "  let m = mat2x3<f32>(1.0, 2.0, 3.0, 4.0, 5.0, 6.0);\n"
            "  let w = vec3<f32>(1.0, 2.0, 3.0) * m;\n"
            "  return w.x + 10.0 * w.y; }"
        )
        # columns (1,2,3),(4,5,6); w_j = dot(v, col_j) = (14, 32)
        assert _run(code, 0.0) == pytest.approx(14.0 + 320.0)

    def test_mat_mat_matches_numpy(self):
        rng = np.random.default_rng(7)
        va = rng.uniform(-1, 1, 4).astype(np.float32)
        vb = rng.uniform(-1, 1, 4).astype(np.float32)
        code = (
            "fn f(x: f32) -> f32 {\n"
            f"  let a = mat2x2<f32>({va[0]}, {va[1]}, {va[2]}, {va[3]});\n"
            f"  let b = mat2x2<f32>({vb[0]}, {vb[1]}, {vb[2]}, {vb[3]});\n"
            "  let c = a * b;\n"
            "  return c[0].x + 10.0 * c[0].y + 100.0 * c[1].x "
            "+ 1000.0 * c[1].y; }"
        )
        A = np.array([[va[0], va[2]], [va[1], va[3]]], np.float32)
        B = np.array([[vb[0], vb[2]], [vb[1], vb[3]]], np.float32)
        C = A @ B  # column j of c == C[:, j]
        want = (
            C[0, 0] + 10 * C[1, 0] + 100 * C[0, 1] + 1000 * C[1, 1]
        )
        assert _run(code, 0.0) == pytest.approx(float(want), rel=1e-4)

    def test_rect_mat_mat_shapes(self):
        # (C1=2, R=3) x (C2=4, R2=2) -> mat4x3
        code = (
            "fn f(x: f32) -> f32 {\n"
            "  let a = mat2x3<f32>(1.0, 2.0, 3.0, 4.0, 5.0, 6.0);\n"
            "  let b = mat4x2<f32>(1.0, 0.0, 0.0, 1.0, 1.0, 1.0, "
            "2.0, -1.0);\n"
            "  let c = a * b;\n"
            "  return c[2].x + c[2].y + c[2].z + c[3].z; }"
        )
        # c[2] = a*(1,1) = (5,7,9); c[3] = a*(2,-1) = (-2,-1,0)
        assert _run(code, 0.0) == pytest.approx(5.0 + 7.0 + 9.0 + 0.0)

    def test_add_sub_scalar_ops(self):
        code = (
            "fn f(x: f32) -> f32 {\n"
            "  var m = mat2x2<f32>(1.0, 2.0, 3.0, 4.0);\n"
            "  m = (m + m) * 0.25 - m / 2.0;\n"  # == 0
            "  return m[0].x + m[0].y + m[1].x + m[1].y; }"
        )
        assert _run(code, 0.0) == 0.0

    def test_transpose_and_determinant(self):
        rng = np.random.default_rng(11)
        v = rng.uniform(-2, 2, 9).astype(np.float32)
        args = ", ".join(str(float(x)) for x in v)
        code = (
            "fn f(x: f32) -> f32 {\n"
            f"  let m = mat3x3<f32>({args});\n"
            "  let t = transpose(m);\n"
            "  return determinant(m) + 100.0 * t[0].y; }"
        )
        M = v.reshape(3, 3).T  # columns -> numpy (R, C)
        want = np.linalg.det(M.astype(np.float64)) + 100.0 * M[0, 1]
        assert _run(code, 0.0) == pytest.approx(float(want), abs=1e-3)

    def test_determinant_4x4(self):
        code = (
            "fn f(x: f32) -> f32 {\n"
            "  let m = mat4x4<f32>(2.0,0.0,0.0,0.0, 1.0,3.0,0.0,0.0, "
            "0.0,1.0,4.0,0.0, 0.0,0.0,1.0,5.0);\n"
            "  return determinant(m); }"
        )
        assert _run(code, 0.0) == pytest.approx(120.0)

    def test_column_ctor_and_store(self):
        code = (
            "fn f(x: f32) -> f32 {\n"
            "  var m = mat2x2<f32>(vec2<f32>(1.0, 2.0), "
            "vec2<f32>(3.0, 4.0));\n"
            "  m[0] = vec2<f32>(x, x);\n"
            "  let i = x;\n"
            "  return m[i - 1.0].y + m[1].x; }"  # i=1 -> col 0
        )
        assert _run(code, 1.0) == pytest.approx(1.0 + 3.0)

    def test_zero_value_and_annotated_decl(self):
        code = (
            "fn f(x: f32) -> f32 {\n"
            "  var m: mat2x2<f32>;\n"
            "  var n: mat2x2<f32> = mat2x2<f32>(x, x, x, x);\n"
            "  return m[0].x + n[1].y; }"
        )
        assert _run(code, 5.0) == 5.0

    def test_decl_shape_mismatch_rejected(self):
        with pytest.raises((TraceError, WgslError), match="declared mat"):
            _f(
                "fn f(x: f32) -> f32 { var m: mat2x2<f32> = "
                "mat3x3<f32>(1.0,0.0,0.0,0.0,1.0,0.0,0.0,0.0,1.0); "
                "return m[0].x; }"
            )

    def test_bad_ctor_count_rejected(self):
        with pytest.raises((TraceError, WgslError), match="constructor"):
            _f(
                "fn f(x: f32) -> f32 { let m = mat2x2<f32>(1.0, 2.0, "
                "3.0); return m[0].x; }"
            )

    def test_inner_dim_mismatch_rejected(self):
        with pytest.raises((TraceError, WgslError), match="dimensions"):
            _f(
                "fn f(x: f32) -> f32 {\n"
                "  let a = mat2x2<f32>(1.0, 2.0, 3.0, 4.0);\n"
                "  let b = mat2x3<f32>(1.0,2.0,3.0,4.0,5.0,6.0);\n"
                "  let c = a * b;\n  return c[0].x; }"
            )

    def test_helper_function_takes_matrix(self):
        # The FIRST function is the entry (scalar params); helpers
        # defined after it may take matrix/vector parameters.
        code = (
            "fn f(x: f32) -> f32 {\n"
            "  let m = mat2x2<f32>(2.0, 0.0, 0.0, 3.0);\n"
            "  return quad(m, vec2<f32>(x, 1.0)); }\n"
            "fn quad(m: mat2x2<f32>, v: vec2<f32>) -> f32 {\n"
            "  return dot(v, m * v); }"
        )
        assert _run(code, 2.0) == pytest.approx(2 * 4 + 3.0)

    def test_matrix_in_loop_carry(self):
        # g columns (1,1),(0,1) == [[1,0],[1,1]]: g^3 lower-left = 3,
        # i.e. column 0 component y.
        code = (
            "fn f(x: f32) -> f32 {\n"
            "  var m = mat2x2<f32>(1.0, 0.0, 0.0, 1.0);\n"
            "  let g = mat2x2<f32>(1.0, 1.0, 0.0, 1.0);\n"
            "  for (var i = 0.0; i < 3.0; i++) { m = m * g; }\n"
            "  return m[0].y; }"
        )
        assert _run(code, 0.0) == 3.0


class TestBitwiseOps:
    def test_fuzz_against_python_ints(self):
        rng = np.random.default_rng(5)
        ops = [
            ("&", lambda a, b: a & b),
            ("|", lambda a, b: a | b),
            ("^", lambda a, b: a ^ b),
            ("<<", lambda a, b: (a << (b & 31)) & 0x7FFFFF),
            (">>", lambda a, b: a >> (b & 31)),
        ]
        for _ in range(20):
            a = int(rng.integers(0, 1 << 16))
            b = int(rng.integers(0, 8))
            sym, fn = ops[int(rng.integers(0, len(ops)))]
            code = (
                f"fn f(x: f32) -> f32 {{ let a = u32(x); "
                f"return f32(a {sym} {b}u); }}"
            )
            want = fn(a, b)
            if sym == "<<" and (a << b) >= (1 << 23):
                continue  # past exact f32 integers
            assert _run(code, float(a)) == float(want), (sym, a, b)

    def test_invert(self):
        # ~ is int32 bitwise not: ~5 = -6 (two's complement model).
        assert _run(
            "fn f(x: f32) -> f32 { return f32(~i32(x)); }", 5.0
        ) == -6.0

    def test_shift_amount_masked(self):
        # WGSL masks shift amounts to the bit width: 1 << 33 == 1 << 1.
        assert _run(
            "fn f(x: f32) -> f32 { return f32(1u << 33u); }", 0.0
        ) == 2.0

    def test_vector_bitwise_componentwise(self):
        code = (
            "fn f(x: f32) -> f32 {\n"
            "  let v = vec2<f32>(x, 12.0);\n"
            "  let w = v & vec2<f32>(6.0, 10.0);\n"
            "  return w.x + 100.0 * w.y; }"
        )
        assert _run(code, 5.0) == float((5 & 6) + 100 * (12 & 10))

    def test_python_lambda_bool_and(self):
        # Python traced lambdas write (a < x) & (x < b): logical on
        # bools, not int32 bit math on 0/1 floats.
        integ = MonteCarloIntegrator()
        r = integ.integrate(
            [lambda x: (x > 0.25) & (x < 0.75)],
            Distribution.uniform(0.0, 1.0),
            n_samples=400_000, seed=3,
        )
        assert abs(r.values[0] - 0.5) < 0.01

    def test_bitwise_integrand_stays_kernel_eligible(self):
        # An integrand using &/>> runs through int32 conversions only —
        # kernel-safe, so the Pallas backend takes it without fallback.
        import warnings as _w

        code = (
            "fn f(x: f32) -> f32 {\n"
            "  let q = u32(x * 255.0);\n"
            "  return f32((q >> 4u) & 15u) / 15.0; }"
        )
        integ = MonteCarloIntegrator(backend="pallas")
        with _w.catch_warnings():
            _w.simplefilter("error")
            r = integ.integrate(
                [code], Distribution.uniform(0.0, 1.0),
                n_samples=400_000, seed=5,
            )
        assert 0.4 < r.values[0] < 0.6


class TestMatrixIntegration:
    def test_mat_integrand_end_to_end_pallas(self):
        # Quadratic form through a matrix local, integrated over U(0,1)^
        # via the 1-D surface: E[v' M v] with v = (x, 1).
        import warnings as _w

        code = (
            "fn f(x: f32) -> f32 {\n"
            "  let m = mat2x2<f32>(2.0, 0.0, 0.0, 3.0);\n"
            "  let v = vec2<f32>(x, 1.0);\n"
            "  return dot(v, m * v); }"
        )
        integ = MonteCarloIntegrator(backend="pallas")
        with _w.catch_warnings():
            _w.simplefilter("error")
            r = integ.integrate(
                [code], Distribution.uniform(0.0, 1.0),
                n_samples=1_000_000, seed=9,
            )
        # E[2x^2 + 3] = 2/3 + 3
        assert r.values[0] == pytest.approx(2.0 / 3.0 + 3.0, abs=0.01)

    def test_entry_params_stay_scalar(self):
        with pytest.raises(WgslError, match="scalar"):
            _f(
                "fn f(m: mat2x2<f32>) -> f32 { return m[0].x; }"
            )


class TestStructs:
    """WGSL struct types (round 5): ordered field records over any
    supported member type (scalars/vectors/matrices/arrays/nested
    structs) — trace-time aggregates (tracing._Struct), so struct
    locals stay Pallas-eligible."""

    def test_construct_access_store(self):
        code = (
            "struct Ray { o: vec2<f32>, d: vec2<f32>, t: f32 }\n"
            "fn f(x: f32) -> f32 {\n"
            "  var r: Ray = Ray(vec2<f32>(0.0, 1.0), "
            "vec2<f32>(x, 2.0), 3.0);\n"
            "  r.t = 10.0;\n"
            "  let p = r.o + r.d * r.t;\n"
            "  return p.x + p.y; }"
        )
        # p = (0,1) + (2,2)*10 = (20,21)
        assert _run(code, 2.0) == 41.0

    def test_nested_struct_and_zero_value(self):
        code = (
            "struct Inner { v: vec2<f32>, s: f32 }\n"
            "struct Outer { a: Inner, b: f32 }\n"
            "fn f(x: f32) -> f32 {\n"
            "  var o: Outer;\n"  # zero-value fills nested zeros
            "  o.b = x;\n"
            "  o.a = Inner(vec2<f32>(1.0, 2.0), 3.0);\n"
            "  return o.a.v.y + o.a.s + o.b; }"
        )
        assert _run(code, 4.0) == 9.0

    def test_helper_fn_takes_and_returns_struct(self):
        code = (
            "struct P { x: f32, y: f32 }\n"
            "fn f(t: f32) -> f32 {\n"
            "  let p = mk(t);\n"
            "  return norm2(p); }\n"
            "fn mk(t: f32) -> P { return P(t, 2.0 * t); }\n"
            "fn norm2(p: P) -> f32 { return p.x * p.x + p.y * p.y; }"
        )
        assert _run(code, 2.0) == 4.0 + 16.0

    def test_struct_in_branch_merge(self):
        code = (
            "struct S { a: f32, b: f32 }\n"
            "fn f(x: f32) -> f32 {\n"
            "  var s = S(1.0, 2.0);\n"
            "  if (x > 0.0) { s = S(10.0, 20.0); }\n"
            "  return s.a + s.b; }"
        )
        assert _run(code, 1.0) == 30.0
        assert _run(code, -1.0) == 3.0

    def test_struct_in_loop_carry(self):
        code = (
            "struct Acc { total: f32, n: f32 }\n"
            "fn f(x: f32) -> f32 {\n"
            "  var a = Acc(0.0, 0.0);\n"
            "  for (var i = 1.0; i <= x; i++) {\n"
            "    a = Acc(a.total + i, a.n + 1.0);\n"
            "  }\n"
            "  return a.total / a.n; }"
        )
        assert _run(code, 4.0) == 2.5

    def test_struct_with_matrix_member(self):
        code = (
            "struct Xf { m: mat2x2<f32>, off: vec2<f32> }\n"
            "fn f(x: f32) -> f32 {\n"
            "  let t = Xf(mat2x2<f32>(2.0, 0.0, 0.0, 3.0), "
            "vec2<f32>(1.0, 1.0));\n"
            "  let v = t.m * vec2<f32>(x, x) + t.off;\n"
            "  return v.x + v.y; }"
        )
        assert _run(code, 1.0) == pytest.approx(3.0 + 4.0)

    def test_type_mismatch_rejected(self):
        with pytest.raises(
            (TraceError, WgslError), match="declared struct"
        ):
            _f(
                "struct A { x: f32 }\nstruct B { y: f32 }\n"
                "fn f(v: f32) -> f32 { var a: A = B(v); return a.x; }"
            )

    def test_unknown_member_rejected(self):
        with pytest.raises((TraceError, WgslError), match="no member"):
            _f(
                "struct A { x: f32 }\n"
                "fn f(v: f32) -> f32 { var a = A(v); return a.z; }"
            )

    def test_ctor_arity_and_member_types_checked(self):
        with pytest.raises((TraceError, WgslError), match="constructor"):
            _f(
                "struct A { x: f32, y: f32 }\n"
                "fn f(v: f32) -> f32 { let a = A(v); return a.x; }"
            )
        with pytest.raises((TraceError, WgslError), match="mismatch"):
            _f(
                "struct A { x: vec2<f32> }\n"
                "fn f(v: f32) -> f32 { let a = A(v); return a.x.x; }"
            )

    def test_no_struct_operators(self):
        with pytest.raises((TraceError, WgslError), match="operator"):
            _f(
                "struct A { x: f32 }\n"
                "fn f(v: f32) -> f32 { let a = A(v) + A(v); return a.x; }"
            )

    def test_struct_integrand_end_to_end_pallas(self):
        import warnings as _w

        code = (
            "struct Particle { pos: f32, vel: f32 }\n"
            "fn f(x: f32) -> f32 {\n"
            "  var p = Particle(x, 2.0 * x);\n"
            "  p.pos = p.pos + 0.5 * p.vel;\n"
            "  return p.pos * p.pos; }"
        )
        integ = MonteCarloIntegrator(backend="pallas")
        with _w.catch_warnings():
            _w.simplefilter("error")
            r = integ.integrate(
                [code], Distribution.uniform(0.0, 1.0),
                n_samples=1_000_000, seed=11,
            )
        # p.pos = 2x -> E[4x^2] = 4/3
        assert r.values[0] == pytest.approx(4.0 / 3.0, abs=0.01)
