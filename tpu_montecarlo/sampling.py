"""Device samplers and closed-form densities.

Counter-based (threefry) random streams via ``jax.random`` feed analytic
sampling transforms — uniform affine, normal, exponential inverse-transform
with the reference's 1e-7 clamp — and vectorised inverse-CDF table lookup
for custom distributions (reference samplers: src/distribution.rs:80-158).

Everything here is pure jittable JAX; the Pallas kernels have their own
in-kernel RNG but reuse the same transform conventions.
"""

from __future__ import annotations

from enum import IntEnum
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from .tables import LOG_PDF_FLOOR

__all__ = [
    "DistKind",
    "DistSpec",
    "dist_spec_of",
    "sample_block",
    "log_pdf",
    "pdf_from_table",
    "log_pdf_from_table",
    "ANALYTIC_EXT",
    "ANALYTIC_KINDS",
]


class DistKind(IntEnum):
    """Sampling family codes (reference: src/engine.rs:35, dist codes 0..3).

    Codes 4+ are extended analytic families beyond the reference's four
    (reference factory surface: python/wgpu_montecarlo/__init__.py:254-608);
    each is one ``ANALYTIC_EXT`` registry row — an exact inverse-CDF
    transform plus a closed-form log density — consumed generically by
    every backend (XLA, the 1-D/nd Pallas kernels, QMC, MCMC)."""

    UNIFORM = 0
    NORMAL = 1
    EXPONENTIAL = 2
    CUSTOM = 3
    LOGNORMAL = 4
    CAUCHY = 5
    LAPLACE = 6
    LOGISTIC = 7
    GUMBEL = 8
    WEIBULL = 9
    PARETO = 10


class DistSpec(NamedTuple):
    """Static + dynamic description of a distribution for the compute ops.

    ``kind`` is static (changes the traced program); ``params`` is a (2,)
    float32 array (param1/param2 like the reference's 16-byte POD,
    src/engine.rs:30-37).  For CUSTOM, ``x_table`` carries the host-built
    uniform-u inverse-CDF table the device samples from (tables.py
    compute_inverse_cdf_table — TPU-friendly index arithmetic replaces the
    reference's 12-iteration device binary search, distribution.rs:128-158);
    ``cdf_table`` is unused by the device and kept for parity plumbing.
    """

    kind: DistKind
    params: np.ndarray  # (2,) float32
    x_table: Optional[np.ndarray] = None
    cdf_table: Optional[np.ndarray] = None
    # True when the CDF has flat (zero-density) runs: the uniform-u inverse
    # table would sample inside them, so the exact searchsorted inverse
    # must be used (x_table then holds the ORIGINAL x grid, not the
    # inverse table).  Static — part of every compiled-program cache key.
    exact_inverse: bool = False
    # True when the table is heavy-tailed enough that ANY uniform-u
    # resampled inverse (including the kernel's gap-respecting stratified
    # tables) measurably biases the moments (tables.inverse_table_distorts)
    # — such distributions must route to the XLA searchsorted sampler.
    # Implies exact_inverse.
    heavy_tail: bool = False


def dist_spec_of(dist) -> DistSpec:
    """Build a DistSpec from a ``Distribution`` (param packing parity with
    reference parse_dist_params, src/lib.rs:436-502).  Cached on the
    Distribution, so repeat calls do not rebuild or re-upload
    tables/params."""
    from .distributions import DistributionType
    from .tables import compute_inverse_cdf_table

    cached = getattr(dist, "_cached_spec", None)
    if cached is not None:
        return cached
    spec = _build_spec(dist, DistributionType, compute_inverse_cdf_table)
    dist._cached_spec = spec
    return spec


def _build_spec(dist, DistributionType, compute_inverse_cdf_table) -> DistSpec:
    t = dist.dist_type
    if t == DistributionType.UNIFORM:
        p = (dist.params["min"], dist.params["max"])
        return DistSpec(DistKind.UNIFORM, np.asarray(p, np.float32))
    if t == DistributionType.NORMAL:
        p = (dist.params["mean"], dist.params["std"])
        return DistSpec(DistKind.NORMAL, np.asarray(p, np.float32))
    if t == DistributionType.EXPONENTIAL:
        p = (dist.params["lambda"], 0.0)
        return DistSpec(DistKind.EXPONENTIAL, np.asarray(p, np.float32))
    ext_kind = getattr(DistKind, t.name, None)
    ext = ANALYTIC_EXT.get(ext_kind)
    if ext is not None:
        p = tuple(dist.params[n] for n in ext.param_names)
        return DistSpec(ext_kind, np.asarray(p, np.float32))
    if t == DistributionType.CUSTOM:
        if dist._x_table is None or dist._cdf_table is None:
            raise ValueError("Custom distribution requires x/cdf tables")
        from .tables import needs_exact_inverse

        cdf = np.asarray(dist._cdf_table, np.float32)
        _, pdf_vals = dist.get_or_compute_pdf_table()
        if needs_exact_inverse(cdf, pdf_vals):
            # Zero-density spans: keep the exact searchsorted inverse.
            # A table can be BOTH gapped and heavy-tailed (a mixture of
            # separated heavy-tailed modes); the Pallas kernels' gap-
            # respecting (t, dt) tables are still uniform-u resampled, so
            # their outermost slabs bias tail moments exactly like the
            # plain resampled inverse's.  Vet the actual device-table
            # model and set heavy_tail so _pallas_eligible reroutes to
            # the XLA searchsorted sampler when it distorts.
            from .tables import (
                find_zero_density_gaps,
                gapped_inverse_tables,
                sample_intervals_distort,
            )

            gaps = find_zero_density_gaps(dist._x_table, cdf, pdf_vals)
            t, dt = gapped_inverse_tables(dist._x_table, cdf, gaps)
            heavy = sample_intervals_distort(
                dist._x_table, cdf, t[:-1], t[:-1] + dt[:-1]
            )
            return DistSpec(
                DistKind.CUSTOM,
                np.zeros(2, np.float32),
                np.asarray(dist._x_table, np.float32),
                cdf,
                exact_inverse=True,
                heavy_tail=heavy,
            )
        inv = getattr(dist, "_inv_cdf_table", None)
        if inv is None:
            from .tables import inverse_table_distorts

            inv = compute_inverse_cdf_table(dist._x_table, dist._cdf_table)
            if inverse_table_distorts(dist._x_table, dist._cdf_table, inv):
                # Heavy-tailed table: the resampled inverse's outermost
                # uniform slabs would bias the moments (Student-t(5)
                # measured E[X^2] 1.95 vs 1.667) — keep the knot-exact
                # searchsorted inverse, like zero-density spans above.
                dist._inv_cdf_table = False
            else:
                dist._inv_cdf_table = inv
        if dist._inv_cdf_table is False:
            return DistSpec(
                DistKind.CUSTOM,
                np.zeros(2, np.float32),
                np.asarray(dist._x_table, np.float32),
                cdf,
                exact_inverse=True,
                heavy_tail=True,
            )
        return DistSpec(DistKind.CUSTOM, np.zeros(2, np.float32), inv, cdf)
    raise ValueError(f"Unknown distribution type: {t}")


def ensure_param_batch_family(
    kind, role: str = "", feature: str = "param_batch"
) -> None:
    """Single source of the runtime-parameter family rule: CUSTOM
    distributions sample/evaluate through host-built per-distribution
    tables, so only analytic families can take runtime parameter rows.
    Raised identically by the API entry points (param_batch,
    expectation_fn), pack_param_batch, and (defensively) the kernel
    builders."""
    if kind == DistKind.CUSTOM:
        subject = (
            f"the {role} distribution samples/evaluates"
            if role
            else "custom distributions sample/evaluate"
        )
        raise ValueError(
            f"{feature} applies to analytic families only "
            "(uniform/normal/exponential and the extended closed-form "
            f"families): {subject} through host-built per-distribution "
            "tables"
        )


_SQRT2 = np.float32(np.sqrt(2.0))


def normal_from_u01(u):
    """Standard normal via inverse-CDF: ``sqrt(2) * erfinv(2u - 1)``.

    One erf_inv per sample (vs the amortised log+sqrt+sin+cos pair of
    Box-Muller), and the canonical choice for the QMC path —
    the inverse CDF is monotone, so a 1-D low-discrepancy stream maps to
    a perfectly stratified normal stream (Box-Muller pairs scramble that
    structure across 2-D).  ``u`` may come from a [0, 1) or (0, 1]
    generator (both conventions exist in this codebase); the symmetric
    clamp keeps erfinv off its poles at u=0 and u=1, truncating the
    sampled tails at ~5.2 sigma — the 24-bit-mantissa Box-Muller radius
    it replaces truncated at 5.77 sigma, both statistically invisible at
    the framework's tolerances (P(|Z| > 5.2) ~ 2e-7).
    """
    u = jnp.clip(u, 1e-7, np.float32(1.0 - 1e-7))
    return _SQRT2 * jax.lax.erf_inv(2.0 * u - 1.0)


# ---------------------------------------------------------------------------
# Extended analytic families.
#
# Each family is ONE registry row: an exact inverse-CDF transform and a
# closed-form log density, both written in elementwise primitives that
# XLA and the Pallas Triton route both lower.  Every dispatch site (XLA
# transform_from_u / analytic_log_pdf, the Pallas 1-D and nd integrate
# and MCMC kernels, the QMC streams, stderr pilot grids) consults the
# registry generically, so adding a family is one entry here plus one
# Distribution factory.
#
# Uniform-draw convention: every inv_cdf clamps u into
# [1e-7, 1 - 1e-7] internally, so it accepts both the [0, 1) and the
# (0, 1] generators in this codebase.  The clamp truncates the sampled
# tails at the 1e-7 quantiles — same order as the normal sampler's
# ~5.2 sigma truncation (normal_from_u01) and statistically invisible
# at the framework's tolerances.
# ---------------------------------------------------------------------------

_U_LO = np.float32(1e-7)
_U_HI = np.float32(1.0 - 1e-7)
_PI_F = np.float32(np.pi)


def _clip_u(u):
    return jnp.clip(u, _U_LO, _U_HI)


class AnalyticExt(NamedTuple):
    """Registry row for an extended analytic family.

    ``inv_cdf(u, p1, p2) -> x`` and ``log_pdf(x, p1, p2) -> f32`` must
    be pure jittable JAX in kernel-safe primitives; log_pdf must return
    FINITE values everywhere (floored at LOG_PDF_FLOOR, the reference's
    out-of-support convention, src/shader_gen.rs:543-571)."""

    name: str
    param_names: Tuple[str, str]
    inv_cdf: Callable
    log_pdf: Callable


def _lognormal_inv(u, p1, p2):
    # p1 = mu, p2 = sigma (of log X): exp of the inverse-CDF normal.
    return jnp.exp(p1 + p2 * normal_from_u01(u))


def _lognormal_logpdf(x, p1, p2):
    safe = jnp.maximum(x, np.float32(1e-30))
    lx = jnp.log(safe)
    z = (lx - p1) / p2
    val = -0.5 * z * z - lx - jnp.log(p2 * _SQRT_2PI)
    return jnp.maximum(
        jnp.where(x > 0, val, LOG_PDF_FLOOR), LOG_PDF_FLOOR
    )


def _cauchy_inv(u, p1, p2):
    # p1 = location, p2 = scale.
    return p1 + p2 * jnp.tan(_PI_F * (_clip_u(u) - np.float32(0.5)))


def _cauchy_logpdf(x, p1, p2):
    # Split the log so |z| > 1e15 takes 2*log|z| instead of squaring
    # (z*z overflows f32 past 1.8e19, which is mathematically harmless —
    # log(inf) floors — but raises a host-side RuntimeWarning on the
    # numpy path); the branches agree to f32 precision at the crossover
    # (log(1 + z^2) == 2 log|z| well before 1e15).
    az = jnp.abs((x - p1) / p2)
    zc = jnp.minimum(az, np.float32(1e15))
    log_term = jnp.where(
        az > np.float32(1e15),
        2.0 * jnp.log(jnp.maximum(az, np.float32(1e-30))),
        jnp.log1p(zc * zc),
    )
    return jnp.maximum(
        -(jnp.log(_PI_F * p2) + log_term), LOG_PDF_FLOOR
    )


def _laplace_inv(u, p1, p2):
    # p1 = location, p2 = diversity b; double-exponential folding of the
    # exponential inverse transform.  After the clip, 1 - 2|t| >= 2e-7.
    t = _clip_u(u) - np.float32(0.5)
    mag = -jnp.log(1.0 - 2.0 * jnp.abs(t))
    return p1 + p2 * jnp.where(t >= 0, mag, -mag)


def _laplace_logpdf(x, p1, p2):
    return jnp.maximum(
        -jnp.abs(x - p1) / p2 - jnp.log(2.0 * p2), LOG_PDF_FLOOR
    )


def _logistic_inv(u, p1, p2):
    # p1 = location, p2 = scale: the logit transform.
    uc = _clip_u(u)
    return p1 + p2 * jnp.log(uc / (1.0 - uc))


def _softplus(t):
    # log(1 + e^t) without overflow: max(t, 0) + log1p(e^-|t|).
    return jnp.maximum(t, 0.0) + jnp.log1p(jnp.exp(-jnp.abs(t)))


def _logistic_logpdf(x, p1, p2):
    z = (x - p1) / p2
    return jnp.maximum(
        -z - 2.0 * _softplus(-z) - jnp.log(p2), LOG_PDF_FLOOR
    )


def _gumbel_inv(u, p1, p2):
    # p1 = location, p2 = scale (max-Gumbel convention).
    return p1 - p2 * jnp.log(-jnp.log(_clip_u(u)))


def _gumbel_logpdf(x, p1, p2):
    z = (x - p1) / p2
    # exp(-z) overflows f32 for z << 0: the intermediate -inf is floored
    # (a density below e^-100 is indistinguishable from 0 in f32).
    return jnp.maximum(-(z + jnp.exp(-z)) - jnp.log(p2), LOG_PDF_FLOOR)


def _weibull_inv(u, p1, p2):
    # p1 = shape k, p2 = scale lambda: an Exp(1) draw raised to 1/k
    # (x = lambda * E^(1/k); u and 1-u are exchangeable uniforms).  The
    # power is exp(log(e)/k); e >= 1e-7 after the clip.
    e = -jnp.log(_clip_u(u))
    return p2 * jnp.exp(jnp.log(e) / p1)


def _weibull_logpdf(x, p1, p2):
    t = jnp.maximum(x, np.float32(1e-30)) / p2
    lt = jnp.log(t)
    val = jnp.log(p1 / p2) + (p1 - 1.0) * lt - jnp.exp(p1 * lt)
    return jnp.maximum(
        jnp.where(x > 0, val, LOG_PDF_FLOOR), LOG_PDF_FLOOR
    )


def _pareto_inv(u, p1, p2):
    # p1 = x_min, p2 = tail index alpha: x = x_min * u^(-1/alpha).
    return p1 * jnp.exp(-jnp.log(_clip_u(u)) / p2)


def _pareto_logpdf(x, p1, p2):
    safe = jnp.maximum(x, p1)
    val = jnp.log(p2) + p2 * jnp.log(p1) - (p2 + 1.0) * jnp.log(safe)
    return jnp.maximum(
        jnp.where(x >= p1, val, LOG_PDF_FLOOR), LOG_PDF_FLOOR
    )


ANALYTIC_EXT = {
    DistKind.LOGNORMAL: AnalyticExt(
        "lognormal", ("mu", "sigma"), _lognormal_inv, _lognormal_logpdf
    ),
    DistKind.CAUCHY: AnalyticExt(
        "cauchy", ("loc", "scale"), _cauchy_inv, _cauchy_logpdf
    ),
    DistKind.LAPLACE: AnalyticExt(
        "laplace", ("loc", "scale"), _laplace_inv, _laplace_logpdf
    ),
    DistKind.LOGISTIC: AnalyticExt(
        "logistic", ("loc", "scale"), _logistic_inv, _logistic_logpdf
    ),
    DistKind.GUMBEL: AnalyticExt(
        "gumbel", ("loc", "scale"), _gumbel_inv, _gumbel_logpdf
    ),
    DistKind.WEIBULL: AnalyticExt(
        "weibull", ("shape", "scale"), _weibull_inv, _weibull_logpdf
    ),
    DistKind.PARETO: AnalyticExt(
        "pareto", ("x_min", "alpha"), _pareto_inv, _pareto_logpdf
    ),
}

#: Every family that samples from closed-form transforms (no host
#: tables) — the families eligible for param_batch / expectation_fn.
ANALYTIC_KINDS: Tuple[DistKind, ...] = (
    DistKind.UNIFORM,
    DistKind.NORMAL,
    DistKind.EXPONENTIAL,
) + tuple(ANALYTIC_EXT)


def next_below_f32(hi):
    """Largest float32 strictly below ``hi`` (finite hi), via bit
    arithmetic (portable to every backend and the Pallas kernels)."""
    h = jnp.asarray(hi, jnp.float32)
    bits = jax.lax.bitcast_convert_type(h, jnp.int32)
    dec = jnp.where(
        h > 0,
        bits - 1,
        jnp.where(h < 0, bits + 1, jnp.int32(-2147483647)),  # -denorm_min
    )
    return jax.lax.bitcast_convert_type(dec, jnp.float32)


def sample_block(
    key: jax.Array,
    shape: Tuple[int, ...],
    kind: DistKind,
    params: jax.Array,
    x_table: Optional[jax.Array] = None,
    cdf_table: Optional[jax.Array] = None,
    exact_inverse: bool = False,
) -> jax.Array:
    """Draw a block of float32 samples from the distribution.

    Transform conventions match the reference WGSL samplers:
      * uniform: affine ``min + u * (max - min)`` (distribution.rs:80-82)
      * normal:  ``mean + std * z`` (Box-Muller on GPU; here the
        counter-based normal from jax.random — same distribution)
      * exponential: ``-log(max(u, 1e-7)) / lambda`` (distribution.rs:120-124)
      * custom: inverse-CDF lookup with linear interpolation between table
        knots (distribution.rs:128-158)
    """
    if kind == DistKind.NORMAL:
        z = jax.random.normal(key, shape, jnp.float32)
        return params[0] + params[1] * z
    u = jax.random.uniform(key, shape, jnp.float32)
    return transform_from_u(
        u, kind, params, x_table, cdf_table, exact_inverse
    )


def sample_block_antithetic(
    key: jax.Array,
    shape: Tuple[int, ...],
    kind: DistKind,
    params: jax.Array,
    x_table: Optional[jax.Array] = None,
    cdf_table: Optional[jax.Array] = None,
    exact_inverse: bool = False,
) -> Tuple[jax.Array, jax.Array]:
    """Draw an antithetic PAIR of float32 sample blocks: element ``i`` of
    the second block is the mirror of element ``i`` of the first through
    the distribution's monotone inverse CDF (``u`` and ``1 - u``; the
    NORMAL pair reflects ``z`` about the mean, the exact equivalent).
    Pair averages are unbiased with variance at most the iid sampler's
    for monotone integrands (classic antithetic variates) — a variance
    reduction surface the reference lacks.  Same per-sample transforms
    as :func:`sample_block`, so the estimator semantics match."""
    if kind == DistKind.NORMAL:
        z = jax.random.normal(key, shape, jnp.float32)
        return params[0] + params[1] * z, params[0] - params[1] * z
    u = jax.random.uniform(key, shape, jnp.float32)
    return (
        transform_from_u(u, kind, params, x_table, cdf_table, exact_inverse),
        transform_from_u(
            1.0 - u, kind, params, x_table, cdf_table, exact_inverse
        ),
    )


def transform_from_u(
    u: jax.Array,
    kind: DistKind,
    params: jax.Array,
    x_table: Optional[jax.Array] = None,
    cdf_table: Optional[jax.Array] = None,
    exact_inverse: bool = False,
) -> jax.Array:
    """Map uniform draws ``u`` to samples — the shared non-NORMAL
    transform tail used by both the pseudo-random path (sample_block) and
    the QMC path (ops/integrate_xla._qmc_sample_chunk), so the two
    sampling semantics cannot drift apart.  ``u`` may come from a [0, 1)
    or a (0, 1] generator; the EXPONENTIAL clamp handles either."""
    if kind == DistKind.UNIFORM:
        x = params[0] + u * (params[1] - params[0])
        # u < 1 guarantees x < max mathematically; float32 rounding can
        # still land exactly on max, where the half-open pdf is zero (an
        # IS weight would then divide by q=0) — clamp just below.  The
        # clamp is a measure-zero correction and its bit arithmetic has
        # no AD rule, so it is excluded from the gradient path
        # (expectation_fn differentiates this transform in params).
        return jnp.minimum(
            x, jax.lax.stop_gradient(next_below_f32(params[1]))
        )
    if kind == DistKind.EXPONENTIAL:
        return -jnp.log(jnp.maximum(u, 1e-7)) / params[0]
    ext = ANALYTIC_EXT.get(kind)
    if ext is not None:
        return ext.inv_cdf(u, params[0], params[1]).astype(jnp.float32)
    if kind == DistKind.CUSTOM:
        if exact_inverse:
            # CDF with flat runs: the exact (discontinuous) inverse keeps
            # samples out of zero-density spans (reference bsearch
            # semantics, distribution.rs:128-158); slower searchsorted.
            return jnp.interp(u, cdf_table, x_table).astype(jnp.float32)
        # x_table here is the uniform-u inverse-CDF table: sampling is
        # index arithmetic + two small-table lookups (no searchsorted).
        m = x_table.shape[0]
        pos = u * jnp.float32(m - 1)
        i0 = jnp.clip(pos.astype(jnp.int32), 0, m - 2)
        frac = pos - i0.astype(jnp.float32)
        x0 = jnp.take(x_table, i0)
        x1 = jnp.take(x_table, i0 + 1)
        return (x0 + frac * (x1 - x0)).astype(jnp.float32)
    raise ValueError(f"Unknown DistKind: {kind}")


_SQRT_2PI = np.float32(2.50662827463)


def analytic_log_pdf(kind: DistKind, p1, p2, x):
    """Closed-form log densities for the analytic families from scalar
    params — the SINGLE source of the MCMC acceptance-ratio conventions
    (reference src/shader_gen.rs:543-571: half-open uniform [p1, p2),
    -100 floor out of support), shared by the XLA backend (log_pdf) and
    the Pallas MCMC kernel so the two cannot drift apart."""
    if kind == DistKind.UNIFORM:
        inside = jnp.logical_and(p1 <= x, x < p2)
        return jnp.where(inside, -jnp.log(p2 - p1), LOG_PDF_FLOOR)
    if kind == DistKind.NORMAL:
        z = (x - p1) / p2
        return -0.5 * z * z - jnp.log(p2 * _SQRT_2PI)
    if kind == DistKind.EXPONENTIAL:
        return jnp.where(x >= 0.0, jnp.log(p1) - p1 * x, LOG_PDF_FLOOR)
    ext = ANALYTIC_EXT.get(kind)
    if ext is not None:
        return ext.log_pdf(x, p1, p2)
    raise ValueError(f"No analytic log-pdf for {kind}")


def log_pdf(
    kind: DistKind,
    params: jax.Array,
    x: jax.Array,
    x_table: Optional[jax.Array] = None,
    log_pdf_table: Optional[jax.Array] = None,
    uniform: bool = False,
) -> jax.Array:
    """Closed-form log-densities for analytic families, table lookup for
    CUSTOM; out-of-support values map to the -100 floor.  Matches the MCMC
    acceptance-ratio conventions (reference: src/shader_gen.rs:543-571)."""
    x = jnp.asarray(x, jnp.float32)
    if kind == DistKind.CUSTOM:
        return log_pdf_from_table(x, x_table, log_pdf_table, uniform=uniform)
    return analytic_log_pdf(kind, params[0], params[1], x)


def _uniform_grid_interp(x, x_table, values):
    """Linear interpolation over a UNIFORM x grid: pure index arithmetic +
    two takes instead of searchsorted (the TPU-friendly path; grids built
    by tables.py are always uniform)."""
    n = x_table.shape[0]
    x0 = x_table[0]
    step = (x_table[n - 1] - x0) / jnp.float32(n - 1)
    pos = (x - x0) / step
    i0 = jnp.clip(pos.astype(jnp.int32), 0, n - 2)
    frac = jnp.clip(pos - i0.astype(jnp.float32), 0.0, 1.0)
    v0 = jnp.take(values, i0)
    v1 = jnp.take(values, i0 + 1)
    return v0 + frac * (v1 - v0)


def pdf_from_table(
    x: jax.Array,
    x_table: jax.Array,
    pdf_table: jax.Array,
    uniform: bool = False,
) -> jax.Array:
    """Linear-interp PDF lookup; 0.0 outside the table's x-range (reference:
    src/distribution.rs:173-281).  Pass ``uniform=True`` (static) when the
    grid spacing is constant to skip the searchsorted."""
    if uniform:
        vals = _uniform_grid_interp(x, x_table, pdf_table)
    else:
        vals = jnp.interp(x, x_table, pdf_table)
    inside = jnp.logical_and(x >= x_table[0], x <= x_table[-1])
    return jnp.where(inside, vals, 0.0).astype(jnp.float32)


def log_pdf_from_table(
    x: jax.Array,
    x_table: jax.Array,
    log_pdf_table: jax.Array,
    uniform: bool = False,
) -> jax.Array:
    """Linear-interp log-PDF lookup; -100 outside the table's x-range
    (reference: src/distribution.rs:367-475)."""
    if uniform:
        vals = _uniform_grid_interp(x, x_table, log_pdf_table)
    else:
        vals = jnp.interp(x, x_table, log_pdf_table)
    inside = jnp.logical_and(x >= x_table[0], x <= x_table[-1])
    return jnp.where(inside, vals, LOG_PDF_FLOOR).astype(jnp.float32)
