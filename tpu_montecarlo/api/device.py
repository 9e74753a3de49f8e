"""Device staging: per-Distribution caches of device-resident parameter
words and inverse-CDF / pdf / log-pdf tables."""

from __future__ import annotations

from typing import Optional

import numpy as np

import jax.numpy as jnp

from ..sampling import DistKind
from ..tables import is_uniform_grid

_DUMMY_TABLE = np.zeros(1, dtype=np.float32)


_DEVICE_DUMMY = None


def _tbl(arr):
    # The shared dummy is uploaded once per process.
    global _DEVICE_DUMMY
    if arr is None:
        if _DEVICE_DUMMY is None:
            _DEVICE_DUMMY = jnp.asarray(_DUMMY_TABLE)
        return _DEVICE_DUMMY
    return jnp.asarray(arr, jnp.float32)


def _device_args_of(distribution, spec):
    """Per-Distribution cache of the device-resident (params, x_table,
    cdf_table) triple so repeat calls skip host->device uploads."""
    cached = getattr(distribution, "_device_args", None)
    if cached is None:
        cached = (
            jnp.asarray(spec.params),
            _tbl(spec.x_table),
            _tbl(spec.cdf_table),
        )
        distribution._device_args = cached
    return cached


def _mcmc_prop_inverse(distribution, spec):
    """Error-bounded DOWNSAMPLED inverse-CDF table for the MCMC kernels'
    i.i.d. proposal draws (sampler-mode logq paths only, non-gapped).

    A smaller table stays in cache for the per-step lookups.  Under
    sampler-mode logq the MH acceptance uses the sampler's own
    exact density (mcmc_pallas._Chains.propose), so the chain stays
    exactly invariant for the target at ANY inverse resolution — a
    coarser table only makes the proposal a slightly coarser
    approximation of the requested distribution.  The resolution is the
    smallest power-of-two u-grid (floor 256 entries) whose resampled
    inverse stays within 2e-4 * span WASSERSTEIN-1 distance of the full
    table's sampler (W1 between two inverse-CDF samplers is exactly
    the mean |x_c(u) - x(u)| over uniform u) — a mass-aware bound: a
    sup-norm bound is dominated by the steep last ~0.1% of u where the
    per-cell mass is ~1/size (measured Beta(2,5): sup 4.8e-2 * span at
    2048 entries vs W1 1.2e-4 * span already at 512; endpoints are
    interpolation knots, so the support span is preserved exactly).

    Stateful (resume-capable) runs keep the full-resolution table: they
    carry table-mode logq, whose fidelity pipeline is calibrated
    against the full inverse.  Cached per Distribution."""
    cached = getattr(distribution, "_mcmc_inv_table", None)
    if cached is None:
        x = np.asarray(spec.x_table, np.float64)
        m = x.shape[0]
        u_full = np.linspace(0.0, 1.0, m)
        span = float(x[-1] - x[0])
        tol = 2e-4 * span if span > 0 else 0.0
        best = x
        size = 256
        while size < m:
            u_c = np.linspace(0.0, 1.0, size)
            x_c = np.interp(u_full, u_c, np.interp(u_c, u_full, x))
            if np.trapezoid(np.abs(x_c - x), u_full) <= tol:
                best = np.interp(u_c, u_full, x)
                break
            size *= 2
        cached = jnp.asarray(best, jnp.float32)
        distribution._mcmc_inv_table = cached
    return cached


def _device_gapped_tables(
    distribution, spec, stratified: bool, segments: Optional[int] = None
):
    """Device-resident gap-respecting inverse tables for zero-density-span
    (exact_inverse) custom distributions, cached per Distribution.

    ``stratified=True``: (segments, 128) (value, slope) tables for the
    stratified integrate sampler (``segments`` is the kernel's
    ``run.strata``); ``False``: flat m-knot tables for the MCMC
    proposal's i.i.d. indexed lookup.  Both jump each gap
    exactly at a knot so the device never emits a sample inside a gap
    (the semantics of the reference's knot-exact binary search,
    src/distribution.rs:128-158)."""
    key = ("strat", segments) if stratified else ("inv",)
    cache = getattr(distribution, "_device_gapped_cache", None)
    if cache is None:
        cache = {}
        distribution._device_gapped_cache = cache
    cached = cache.get(key)
    if cached is None:
        from ..tables import (
            find_zero_density_gaps,
            gapped_inverse_tables,
            gapped_stratified_tables,
        )

        _, pdf_vals = distribution.get_or_compute_pdf_table()
        gaps = find_zero_density_gaps(
            spec.x_table, spec.cdf_table, pdf_vals
        )
        if stratified:
            kwargs = {} if segments is None else {"segments": segments}
            t, dt = gapped_stratified_tables(
                spec.x_table, spec.cdf_table, gaps, **kwargs
            )
        else:
            t, dt = gapped_inverse_tables(spec.x_table, spec.cdf_table, gaps)
        cached = (jnp.asarray(t), jnp.asarray(dt))
        cache[key] = cached
    return cached


def _device_log_tables_of(distribution, role: str = "target"):
    """Per-Distribution cache of the device-resident log-pdf tables (XLA
    backend).  Proposal tables get the floor-edge guard
    (tables.guard_proposal_log_floor): the reference interpolates its log
    tables straight into the -100 floor, which makes boundary-trapezoid
    states absorbing for the independence sampler — a correctness fix
    beyond reference behavior, applied to the q-table only (the target
    table defines the distribution being sampled and stays verbatim)."""
    attr = (
        "_device_log_tables" if role == "target" else "_device_log_tables_q"
    )
    cached = getattr(distribution, attr, None)
    if cached is None:
        lx, lp = distribution.get_log_pdf_table()
        if role != "target":
            from ..tables import guard_proposal_log_floor

            lp = guard_proposal_log_floor(lp)
        cached = (jnp.asarray(lx, jnp.float32), jnp.asarray(lp, jnp.float32))
        setattr(distribution, attr, cached)
    return cached


def _uniform_log_tables(distribution):
    """(x, log_pdf) tables on a uniform grid for in-kernel MCMC lookups.

    Host-built grids are already uniform; irregular from_pdf_table grids
    resample the PDF (error-bounded in density space — a log-space bound is
    unattainable near the -100 floor cliffs, and density-space errors of
    ~1e-3 of the peak are statistically invisible to MH) and take logs
    after, exactly how host-built log tables are made.  Returns None when
    the bound cannot be met — MCMC then routes to the XLA backend.  Cached
    per Distribution."""
    lx, lp = distribution.get_log_pdf_table()
    if is_uniform_grid(lx):
        return lx, lp
    cached = getattr(distribution, "_uniform_log_tables", False)
    if cached is False:
        mode = _uniform_table_mode(
            distribution,
            ("table",) + tuple(distribution.get_or_compute_pdf_table()),
        )
        if mode is None:
            cached = None
        else:
            from ..tables import log_pdf_from_pdf

            cached = (mode[1], log_pdf_from_pdf(mode[2]))
        distribution._uniform_log_tables = cached
    return cached


def _proposal_kernel_log_tables(distribution):
    """Uniform-grid log tables fit to serve as the Pallas MCMC PROPOSAL's
    q-table, or None when no uniform grid can represent the sampling
    density faithfully (the workload then routes to the XLA backend).

    Pipeline: resample irregular grids (density-space, error-bounded),
    then STRICT-validate the resampled log values against the ORIGINAL
    log table at every original non-floor knot (an absolute density bound
    alone can hide multi-nat log errors in low-density regions — the
    absorbing-trap shape), then guard the floor edges
    (tables.guard_proposal_log_floor), then strict-downsample.  Cached per
    Distribution."""
    cached = getattr(distribution, "_prop_kernel_log_tables", False)
    if cached is not False:
        return cached
    from ..tables import downsample_log_table, guard_proposal_log_floor

    lx, lp = distribution.get_log_pdf_table()
    result = None
    uniform = _uniform_log_tables(distribution)
    if uniform is not None:
        ulx, ulp = uniform
        ok = True
        if ulx is not lx:
            # Validate the resample AFTER guarding both tables, probing
            # the union of the two knot sets — checking only at original
            # knots is blind to resampled knots planted between them
            # (observed: log(tiny-interpolated-pdf) knots just inside a
            # gap edge, reading ~10 nats below the guarded edge value).
            gorig = guard_proposal_log_floor(lp)
            gulp = guard_proposal_log_floor(ulp)
            probe = np.union1d(np.asarray(lx), np.asarray(ulx))
            a = np.interp(probe, lx, gorig)
            b = np.interp(probe, ulx, gulp)
            mask = a > -90.0
            ok = not np.any(np.abs(b - a)[mask] > 0.01)
            ulp = gulp
        else:
            ulp = guard_proposal_log_floor(ulp)
        if ok:
            result = downsample_log_table(ulx, ulp, strict=True)
    distribution._prop_kernel_log_tables = result
    return result


def _device_uniform_log_tables(distribution, role: str = "target"):
    """Device-resident uniform-grid log tables for the Pallas MCMC kernel
    (resampled to a uniform grid if needed, then error-bounded DOWNSAMPLED:
    smaller tables stay cache-resident for the per-step lookups).  Proposal
    tables go through the fidelity pipeline of
    ``_proposal_kernel_log_tables`` — their values must match the
    sampling density everywhere the sampler emits."""
    attr = (
        "_device_log_tables_u"
        if role == "target"
        else "_device_log_tables_uq"
    )
    cached = getattr(distribution, attr, None)
    if cached is None:
        from ..tables import downsample_log_table

        if role == "target":
            lx, lp = _uniform_log_tables(distribution)
            lx, lp = downsample_log_table(lx, lp)
        else:
            lx, lp = _proposal_kernel_log_tables(distribution)
        cached = (jnp.asarray(lx, jnp.float32), jnp.asarray(lp, jnp.float32))
        setattr(distribution, attr, cached)
    return cached


def _uniform_table_mode(distribution, mode, role: str = "target"):
    """Give a table pdf-mode a uniform x-grid for in-kernel lookup.

    Already-uniform grids pass through; irregular user grids (from_pdf_table)
    are resampled host-side with an error bound, cached per Distribution.
    ``role="proposal"`` (IS denominator tables) additionally RELATIVE-
    validates the resampled values against the original at every original
    positive-density knot — an absolute density bound alone can hide
    large relative errors in low-density regions, and a q-table reading r
    times too low inflates every weight there by 1/r.  Returns the
    (possibly resampled) mode, or None when the bound cannot be met —
    callers then take the XLA closure path.  Traced modes pass through
    untouched."""
    if mode is None or mode[0] != "table":
        return mode
    if is_uniform_grid(mode[1]):
        return mode
    # The resample itself is role-independent; cache it once and apply the
    # per-role validation on top (also cached).
    resampled = getattr(distribution, "_uniform_pdf_tables", False)
    if resampled is False:
        from ..tables import resample_uniform_table

        resampled = resample_uniform_table(mode[1], mode[2])
        distribution._uniform_pdf_tables = resampled
    if role == "target":
        cached = resampled
    else:
        cached = getattr(distribution, "_uniform_pdf_tables_q", False)
        if cached is False:
            cached = resampled
            if cached is not None:
                x0 = np.asarray(mode[1], np.float64)
                v0 = np.asarray(mode[2], np.float64)
                back = np.interp(x0, cached[0], cached[1])
                pos = v0 > 0
                if np.any(np.abs(back - v0)[pos] > 1e-3 * v0[pos]):
                    cached = None
            distribution._uniform_pdf_tables_q = cached
    if cached is None:
        return None
    return ("table", cached[0], cached[1])


def _device_mode_tables(distribution, mode, role: str = "target"):
    """Device-resident (x_grid, pdf_values) for an in-kernel IS weight
    table, cached per Distribution.  Error-bounded DOWNSAMPLED first: the
    smaller tables stay cache-resident for the in-kernel weight lookups
    (the XLA closure path keeps the full-resolution tables).  Proposal (denominator) tables use the
    relative bound — see tables.downsample_pdf_table."""
    attr = (
        "_device_pdf_tables_u"
        if role == "target"
        else "_device_pdf_tables_uq"
    )
    cached = getattr(distribution, attr, None)
    if cached is None:
        from ..tables import downsample_pdf_table

        xt, pt = downsample_pdf_table(
            mode[1], mode[2], relative=role != "target"
        )
        cached = (jnp.asarray(xt, jnp.float32), jnp.asarray(pt, jnp.float32))
        setattr(distribution, attr, cached)
    return cached


def _table_shapes(spec):
    return (
        None if spec.x_table is None else spec.x_table.shape,
        None if spec.cdf_table is None else spec.cdf_table.shape,
        spec.exact_inverse,
    )
