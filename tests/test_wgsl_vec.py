"""WGSL vector/array surface: vec2/vec3/vec4, array<T, N>, swizzles,
component stores, vector builtins, and control flow carrying vectors.

The reference passes ANY WGSL string through to naga unexamined
(reference: python/wgpu_montecarlo/__init__.py:738-747), so vector and
array locals compile there; this suite pins the front-end's coverage
of that surface.  Vectors lower to tuples of SCALAR components (pure
elementwise dataflow, no stacked axes), so the same integrands must also
run through the Pallas kernel tier — asserted here in interpreter mode.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from tpu_montecarlo import Distribution, MonteCarloIntegrator, integrate
from tpu_montecarlo.sampling import DistKind
from tpu_montecarlo.tracing import TraceError
from tpu_montecarlo.wgsl_frontend import trace_wgsl_function
from tpu_montecarlo.ops.integrate_pallas import build_integrate_fn_pallas
from tpu_montecarlo.utils.dispatch import make_integrate_plan

_DUMMY = jnp.zeros((8, 128), jnp.float32)


def _f(code):
    return trace_wgsl_function(code)


class TestConstructors:
    def test_typed_components(self):
        f = _f("fn f(x: f32) -> f32 { let v = vec3<f32>(x, 2.0, 3.0);"
               " return v.x + v.y + v.z; }")
        assert float(f(1.0)) == pytest.approx(6.0)

    def test_inferred_type(self):
        f = _f("fn f(x: f32) -> f32 { let v = vec2(x, 4.0); return v.x * v.y; }")
        assert float(f(2.5)) == pytest.approx(10.0)

    def test_scalar_splat(self):
        f = _f("fn f(x: f32) -> f32 { let v = vec4<f32>(x);"
               " return v.x + v.y + v.z + v.w; }")
        assert float(f(1.5)) == pytest.approx(6.0)

    def test_mixed_vec_scalar_flatten(self):
        f = _f("fn f(x: f32) -> f32 { let a = vec2<f32>(x, 2.0 * x);"
               " let v = vec4<f32>(a, 1.0, 2.0); return v.x + v.y + v.z + v.w; }")
        assert float(f(1.0)) == pytest.approx(6.0)

    def test_zero_value_declaration(self):
        f = _f("fn f(x: f32) -> f32 { var v: vec3<f32>; v.y = x;"
               " return v.x + v.y + v.z; }")
        assert float(f(7.0)) == pytest.approx(7.0)

    def test_component_count_mismatch_raises(self):
        with pytest.raises(TraceError):
            _f("fn f(x: f32) -> f32 { let v = vec3<f32>(x, 1.0);"
               " return v.x; }")


class TestSwizzles:
    def test_multi_component_swizzle(self):
        f = _f("fn f(x: f32) -> f32 { let v = vec3<f32>(x, 2.0, 3.0);"
               " let w = v.zyx; return w.x * 100.0 + w.y * 10.0 + w.z; }")
        assert float(f(1.0)) == pytest.approx(321.0)

    def test_repeated_swizzle(self):
        f = _f("fn f(x: f32) -> f32 { let v = vec2<f32>(x, 5.0);"
               " let w = v.yyx; return w.x + w.y + w.z; }")
        assert float(f(2.0)) == pytest.approx(12.0)

    def test_rgba_aliases(self):
        f = _f("fn f(x: f32) -> f32 { let v = vec4<f32>(x, 2.0, 3.0, 4.0);"
               " return v.r + v.g + v.b + v.a; }")
        assert float(f(1.0)) == pytest.approx(10.0)

    def test_bad_swizzle_raises(self):
        with pytest.raises(TraceError):
            _f("fn f(x: f32) -> f32 { let v = vec2<f32>(x, 1.0); return v.q; }")

    def test_swizzle_out_of_range_raises(self):
        with pytest.raises(TraceError):
            _f("fn f(x: f32) -> f32 { let v = vec2<f32>(x, 1.0); return v.z; }")


class TestComponentStores:
    def test_component_write(self):
        f = _f("fn f(x: f32) -> f32 { var v = vec3<f32>(1.0, 2.0, 3.0);"
               " v.y = x; return v.x + v.y + v.z; }")
        assert float(f(10.0)) == pytest.approx(14.0)

    def test_compound_component_update(self):
        f = _f("fn f(x: f32) -> f32 { var v = vec2<f32>(x, 3.0);"
               " v.x += 2.0; v.y *= x; return v.x + v.y; }")
        assert float(f(2.0)) == pytest.approx(10.0)

    def test_multi_component_store_raises(self):
        with pytest.raises(TraceError):
            _f("fn f(x: f32) -> f32 { var v = vec3<f32>(x);"
               " v.xy = vec2<f32>(1.0, 2.0); return v.x; }")


class TestArrays:
    def test_constructor_and_static_index(self):
        f = _f("fn f(x: f32) -> f32 { let a = array<f32, 3>(x, 2.0, 3.0);"
               " return a[0] + a[1] * a[2]; }")
        assert float(f(4.0)) == pytest.approx(10.0)

    def test_zero_value_array(self):
        f = _f("fn f(x: f32) -> f32 { var a: array<f32, 4>; a[2] = x;"
               " return a[0] + a[1] + a[2] + a[3]; }")
        assert float(f(5.0)) == pytest.approx(5.0)

    def test_dynamic_index_read(self):
        f = _f("fn f(x: f32) -> f32 { let a = array<f32, 4>(10.0, 20.0, 30.0, 40.0);"
               " return a[x]; }")
        for i, want in enumerate([10.0, 20.0, 30.0, 40.0]):
            assert float(f(float(i))) == pytest.approx(want)

    def test_dynamic_index_clamps(self):
        # Under jit the index is a tracer (as in the kernels), taking the
        # dynamic select-chain path, which clamps to the edge components.
        import jax

        f = jax.jit(_f("fn f(x: f32) -> f32 {"
                       " let a = array<f32, 3>(10.0, 20.0, 30.0);"
                       " return a[x]; }"))
        assert float(f(-2.0)) == pytest.approx(10.0)
        assert float(f(9.0)) == pytest.approx(30.0)

    def test_dynamic_index_write_in_loop(self):
        f = _f("""
        fn f(x: f32) -> f32 {
            var a: array<f32, 4>;
            for (var i = 0.0; i < 4.0; i++) { a[i] = x * (i + 1.0); }
            var s = 0.0;
            for (var i = 0.0; i < 4.0; i++) { s += a[i]; }
            return s;
        }
        """)
        assert float(f(2.0)) == pytest.approx(20.0)

    def test_ctor_count_mismatch_raises(self):
        with pytest.raises(TraceError):
            _f("fn f(x: f32) -> f32 { let a = array<f32, 3>(x, 1.0);"
               " return a[0]; }")

    def test_array_of_vectors_rejected(self):
        with pytest.raises(TraceError):
            _f("fn f(x: f32) -> f32 { var a: array<vec2<f32>, 2>;"
               " return x; }")


class TestArithmetic:
    def test_vec_vec_and_scalar_broadcast(self):
        f = _f("fn f(x: f32) -> f32 {"
               " let v = vec2<f32>(x, 2.0) + vec2<f32>(1.0, 1.0);"
               " let w = 2.0 * v - 1.0;"
               " let u = 6.0 / w;"
               " return u.x + u.y + (-v).x; }")
        # v=(x+1,3), w=(2x+1,5), u=(6/(2x+1), 1.2)
        x = 1.0
        assert float(f(x)) == pytest.approx(6.0 / (2 * x + 1) + 1.2 - (x + 1))

    def test_size_mismatch_raises(self):
        with pytest.raises(TraceError):
            _f("fn f(x: f32) -> f32 {"
               " let v = vec2<f32>(x) + vec3<f32>(1.0); return v.x; }")

    def test_vector_condition_raises(self):
        with pytest.raises(TraceError):
            _f("fn f(x: f32) -> f32 { let v = vec2<f32>(x);"
               " if (v == v) { return 1.0; } return 0.0; }")

    def test_compare_any_all_select(self):
        f = _f("""
        fn f(x: f32) -> f32 {
            let v = vec3<f32>(x, 2.0, 3.0);
            let big = v > vec3<f32>(2.5);
            let s = select(vec3<f32>(0.0), v, big);
            return f32(any(big)) + 10.0 * f32(all(big)) + s.x + s.y + s.z;
        }
        """)
        # x=4: big=(T,F,T) -> any=1, all=0, s=(4,0,3)
        assert float(f(4.0)) == pytest.approx(1.0 + 0.0 + 7.0)
        # x=0: big=(F,F,T) -> any=1, s=(0,0,3)
        assert float(f(0.0)) == pytest.approx(1.0 + 3.0)


class TestVectorBuiltins:
    def test_dot_length_distance_normalize(self):
        f = _f("""
        fn f(x: f32) -> f32 {
            let v = vec3<f32>(x, 4.0, 0.0);
            let n = normalize(v);
            return dot(v, n) + length(v.xy) + distance(v, vec3<f32>(x, 0.0, 3.0));
        }
        """)
        v = np.array([3.0, 4.0, 0.0])
        want = np.linalg.norm(v) + np.hypot(3.0, 4.0) + 5.0
        assert float(f(3.0)) == pytest.approx(want, rel=1e-5)

    def test_scalar_length_distance(self):
        f = _f("fn f(x: f32) -> f32 { return length(x) + distance(x, 10.0); }")
        assert float(f(-3.0)) == pytest.approx(3.0 + 13.0)

    def test_cross(self):
        f = _f("fn f(x: f32) -> f32 {"
               " let c = cross(vec3<f32>(x, 0.0, 0.0), vec3<f32>(0.0, 1.0, 0.0));"
               " return c.z + c.x + c.y; }")
        assert float(f(2.0)) == pytest.approx(2.0)

    def test_cross_requires_vec3(self):
        with pytest.raises(TraceError):
            _f("fn f(x: f32) -> f32 {"
               " let c = cross(vec2<f32>(x), vec2<f32>(1.0)); return c.x; }")

    def test_elementwise_builtins_map(self):
        f = _f("""
        fn f(x: f32) -> f32 {
            let v = clamp(vec2<f32>(x, -x), vec2<f32>(-1.0), vec2<f32>(1.0));
            let w = abs(v) + sqrt(vec2<f32>(4.0, 9.0)) + pow(vec2<f32>(2.0), vec2<f32>(3.0, 2.0));
            let m = mix(vec2<f32>(0.0), w, 0.5);
            return m.x + m.y + floor(max(v, vec2<f32>(0.25)).x * 4.0);
        }
        """)
        # x=2: v=(1,-1); w=(1+2+8, 1+3+4)=(11,8); m=(5.5,4); floor(1*4)=4
        assert float(f(2.0)) == pytest.approx(5.5 + 4.0 + 4.0)


class TestControlFlow:
    def test_if_else_merges_vec(self):
        f = _f("""
        fn f(x: f32) -> f32 {
            var v = vec2<f32>(x, 1.0);
            if (x > 0.0) { v = v * 2.0; } else { v.y = -5.0; }
            return v.x + v.y;
        }
        """)
        assert float(f(3.0)) == pytest.approx(8.0)
        assert float(f(-3.0)) == pytest.approx(-8.0)

    def test_while_carries_vec(self):
        f = _f("""
        fn f(x: f32) -> f32 {
            var p = vec2<f32>(x, 0.0);
            var i = 0.0;
            while (i < 3.0) { p = vec2<f32>(p.y + 1.0, p.x * 2.0); i++; }
            return p.x * 100.0 + p.y;
        }
        """)
        p = [1.0, 0.0]
        for _ in range(3):
            p = [p[1] + 1.0, p[0] * 2.0]
        assert float(f(1.0)) == pytest.approx(p[0] * 100.0 + p[1])

    def test_helper_early_return_vec(self):
        f = _f("""
        fn f(x: f32) -> f32 {
            let v = pick(x);
            return v.x + 10.0 * v.y;
        }
        fn pick(x: f32) -> vec2<f32> {
            if (x > 0.0) { return vec2<f32>(1.0, 2.0); }
            return vec2<f32>(-1.0, -2.0);
        }
        """)
        assert float(f(1.0)) == pytest.approx(21.0)
        assert float(f(-1.0)) == pytest.approx(-21.0)

    def test_vec_param_helper(self):
        f = _f("""
        fn f(x: f32) -> f32 { return sum3(vec3<f32>(x, 2.0 * x, 1.0)); }
        fn sum3(v: vec3<f32>) -> f32 { return v.x + v.y + v.z; }
        """)
        assert float(f(2.0)) == pytest.approx(7.0)

    def test_entry_vec_param_rejected(self):
        with pytest.raises(TraceError):
            _f("fn f(v: vec2<f32>) -> f32 { return v.x; }")


WGSL_VEC_INTEGRAND = """
fn f(x: f32) -> f32 {
    let p = vec3<f32>(x, x * x, 1.0);
    let w = vec3<f32>(0.5, 2.0, 0.25);
    var acc = dot(p, w);
    var a = array<f32, 3>(1.0, 2.0, 3.0);
    a[1] = length(p.xy);
    if (acc > 1.0) { acc = acc + a[1] * 0.0; }
    return acc + a[0] - 1.0 + 0.0 * a[2];
}
"""


def _vec_integrand_np(x):
    return 0.5 * x + 2.0 * x * x + 0.25 + 0.0 + 1.0 - 1.0


class TestEndToEnd:
    def test_integrate_uniform_xla(self):
        res = integrate(
            [WGSL_VEC_INTEGRAND],
            Distribution.uniform(0.0, 1.0),
            n_samples=200_000,
            seed=42,
        )
        # E[0.5x + 2x^2 + 0.25] over U(0,1) = 0.25 + 2/3 + 0.25
        assert res[0] == pytest.approx(0.25 + 2.0 / 3.0 + 0.25, abs=0.01)

    def test_pallas_interpret_kernel(self):
        fn = _f(WGSL_VEC_INTEGRAND)
        plan = make_integrate_plan(100_000, target_threads=1024)
        run = build_integrate_fn_pallas([fn], DistKind.UNIFORM, plan,
                                        interpret=True)
        vals = np.asarray(
            run(np.uint32(42), jnp.asarray([0.0, 1.0], jnp.float32),
                _DUMMY, _DUMMY)
        )
        assert vals[0] == pytest.approx(0.25 + 2.0 / 3.0 + 0.25, abs=0.02)

    def test_backends_agree_bitwise(self):
        integ = MonteCarloIntegrator()
        r1 = integ.integrate(
            [WGSL_VEC_INTEGRAND], Distribution.uniform(0.0, 1.0),
            n_samples=50_000, seed=7,
        )
        r2 = integ.integrate(
            [WGSL_VEC_INTEGRAND], Distribution.uniform(0.0, 1.0),
            n_samples=50_000, seed=7,
        )
        assert r1[0] == r2[0]


class TestDeclarationStrictness:
    """Round-5 advisor fixes: annotated declarations are enforced
    against their initializers, swizzle character sets cannot mix,
    vectors cannot hide inside scalar slots, and dynamic indices
    truncate like WGSL's u32() conversion."""

    def _reject(self, src, match):
        from tpu_montecarlo.wgsl_frontend import WgslError

        with pytest.raises((TraceError, WgslError), match=match):
            trace_wgsl_function(src)

    def test_vec_decl_size_mismatch(self):
        self._reject(
            "fn f(x: f32) -> f32 { var v: vec2<f32> = "
            "vec3<f32>(x, x, x); return v.x; }",
            "declared vec2",
        )

    def test_scalar_decl_vec_initializer(self):
        self._reject(
            "fn f(x: f32) -> f32 { var v: f32 = vec2<f32>(x, x); "
            "return v; }",
            "declared a scalar",
        )

    def test_array_decl_size_mismatch(self):
        self._reject(
            "fn f(x: f32) -> f32 { var a: array<f32, 3> = "
            "array<f32, 2>(x, x); return a[0]; }",
            "declared array",
        )

    def test_annotated_match_passes(self):
        f = _f(
            "fn f(x: f32) -> f32 { var v: vec3<f32> = "
            "vec3<f32>(x, x, x); return v.z; }"
        )
        assert float(f(jnp.float32(2.0))) == 2.0

    def test_unannotated_decl_unchecked(self):
        # Type inference: no annotation, any initializer binds.
        f = _f(
            "fn f(x: f32) -> f32 { let v = vec3<f32>(x, 1.0, 2.0); "
            "return v.y; }"
        )
        assert float(f(jnp.float32(0.0))) == 1.0

    def test_mixed_swizzle_sets_rejected(self):
        self._reject(
            "fn f(x: f32) -> f32 { var v = vec2<f32>(x, x); "
            "return v.xg; }",
            "mixes",
        )

    def test_rgba_swizzle_still_works(self):
        f = _f(
            "fn f(x: f32) -> f32 { var v = vec3<f32>(x, 2.0, 3.0); "
            "return v.g + v.b; }"
        )
        assert float(f(jnp.float32(0.0))) == 5.0

    def test_vec_into_component_rejected(self):
        self._reject(
            "fn f(x: f32) -> f32 { var v = vec2<f32>(x, x); "
            "v.x = vec2<f32>(9.0, 9.0); return v.x; }",
            "Cannot assign",
        )

    def test_vec_into_array_element_rejected(self):
        self._reject(
            "fn f(x: f32) -> f32 { var a = array<f32, 2>(x, x); "
            "a[0] = vec2<f32>(9.0, 9.0); return a[0]; }",
            "Cannot assign",
        )

    def test_dynamic_index_truncates(self):
        # WGSL's u32(i/2) truncates: i=1 reads element 0 (the old
        # round-to-nearest read element 1).
        g = _f(
            "fn g(x: f32) -> f32 { var a = array<f32, 2>(10.0, 20.0); "
            "let i = x; return a[i / 2.0]; }"
        )
        assert float(g(jnp.float32(1.0))) == 10.0
        assert float(g(jnp.float32(2.0))) == 20.0

    def test_dynamic_index_store_truncates(self):
        g = _f(
            "fn g(x: f32) -> f32 { var a = array<f32, 2>(0.0, 0.0); "
            "let i = x; a[i / 2.0] = 7.0; return a[0] - a[1]; }"
        )
        assert float(g(jnp.float32(1.0))) == 7.0  # wrote element 0
        assert float(g(jnp.float32(2.0))) == -7.0  # wrote element 1
