"""Every math builtin the tracer admits, through the Triton integrate kernel.

Two checks per builtin: the interpreted kernel equals its plain-jnp
reference on the same counter stream (the kernel plumbing carries the
function unchanged), and the kernel lowers for the GPU — Triton IR is
generated here on the CPU, so a builtin the Triton route cannot lower
fails in this tier instead of on the card.  There are no matrix products
on these paths, so TF32 never enters.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from tpu_montecarlo.ops.integrate_pallas import build_integrate_fn_pallas
from tpu_montecarlo.sampling import DistKind
from tpu_montecarlo.tracing import trace_function
from tpu_montecarlo.utils.dispatch import make_integrate_plan

# One representative integrand per traceable name, argument-ranged to
# stay in-domain for x ~ N(0, 1).
EXPRS = {
    "abs": lambda x: np.abs(x),
    "sin": lambda x: np.sin(x),
    "cos": lambda x: np.cos(x),
    "tan": lambda x: np.tan(x * 0.4),
    "asin": lambda x: np.arcsin(np.clip(x, -0.9, 0.9)),
    "acos": lambda x: np.arccos(np.clip(x, -0.9, 0.9)),
    "atan": lambda x: np.arctan(x),
    "atan2": lambda x: np.arctan2(x, 1.0 + x * x),
    "sinh": lambda x: np.sinh(np.clip(x, -4.0, 4.0)),
    "cosh": lambda x: np.cosh(np.clip(x, -4.0, 4.0)),
    "tanh": lambda x: np.tanh(x),
    "asinh": lambda x: np.arcsinh(x),
    "acosh": lambda x: np.arccosh(1.0 + np.abs(x)),
    "atanh": lambda x: np.arctanh(np.clip(x, -0.9, 0.9)),
    "sqrt": lambda x: np.sqrt(np.abs(x)),
    "cbrt": lambda x: np.cbrt(x),
    "exp": lambda x: np.exp(-x * x),
    "exp2": lambda x: np.exp2(np.clip(x, -10.0, 10.0)),
    "expm1": lambda x: np.expm1(np.clip(x, -4.0, 4.0)),
    "log": lambda x: np.log(np.abs(x) + 0.1),
    "log2": lambda x: np.log2(np.abs(x) + 0.1),
    "log10": lambda x: np.log10(np.abs(x) + 0.1),
    "log1p": lambda x: np.log1p(np.abs(x)),
    "floor": lambda x: np.floor(x),
    "ceil": lambda x: np.ceil(x),
    "round": lambda x: np.round(x),
    "trunc": lambda x: np.trunc(x),
    "sign": lambda x: np.sign(x),
    "copysign": lambda x: np.copysign(1.0 + x * x, x),
    "fmod": lambda x: np.fmod(x, 0.75),
    "hypot": lambda x: np.hypot(x, 1.0 - x),
    "degrees": lambda x: np.degrees(x),
    "radians": lambda x: np.radians(x),
    "minimum": lambda x: np.minimum(x, 0.25),
    "maximum": lambda x: np.maximum(x, -0.25),
    "clip": lambda x: np.clip(x, -1.0, 1.0),
    "power": lambda x: np.power(np.abs(x) + 0.1, 2.5),
    "heaviside": lambda x: np.heaviside(x, 0.5),
    "square": lambda x: np.square(x),
    "where": lambda x: np.where(x > 0.0, x, -2.0 * x),
}

_DUMMY = jnp.zeros(1, jnp.float32)
_PARAMS = jnp.asarray([0.0, 1.0], jnp.float32)


def _builders(name, **kw):
    traced = (trace_function(EXPRS[name]),)
    plan = make_integrate_plan(65_536)
    return (
        build_integrate_fn_pallas(traced, DistKind.NORMAL, plan, **kw),
        traced,
        plan,
    )


@pytest.mark.parametrize("name", sorted(EXPRS))
def test_kernel_matches_reference(name):
    kern, traced, plan = _builders(name, interpret=True)
    ref = build_integrate_fn_pallas(
        traced, DistKind.NORMAL, plan, reference=True
    )
    got = np.asarray(kern(np.uint32(5), _PARAMS, _DUMMY, _DUMMY))
    want = np.asarray(ref(np.uint32(5), _PARAMS, _DUMMY, _DUMMY))
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", sorted(EXPRS))
def test_lowers_for_gpu(name):
    kern, _, _ = _builders(name, interpret=False)
    text = (
        kern.trace(np.uint32(5), _PARAMS, _DUMMY, _DUMMY)
        .lower(lowering_platforms=("cuda",))
        .as_text()
    )
    assert "triton" in text
