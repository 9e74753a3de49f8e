"""Quasi-Monte Carlo point generation (shared by the Pallas kernel and
the XLA sweep).

A capability beyond the reference (which is plain MC throughout,
src/distribution.rs:62-73): ``method="qmc"`` replaces the pseudo-random
uniforms with the base-2 van der Corput radical inverse of the GLOBAL
sample index, randomised by a seed-derived Cranley-Patterson rotation —
u(g) = frac(bitrev32(g) * 2^-32 + shift).  The u -> x transform
pipeline (affine / inverse-CDF normal / inverse-CDF tables) is unchanged,
so every distribution family keeps its sampling semantics while smooth integrands
converge at ~O(log N / N) instead of O(N^-1/2).

Design notes, TPU-first:
  * bit reversal is five masked shift/or steps on uint32 lanes — pure VPU
    work, no tables, no gathers; measured at full sampler throughput.
  * the rotation is a uint32 wraparound add BEFORE the float conversion:
    an exact torus rotation at 2^-32 resolution (then truncated to the
    f32-safe 24-bit mantissa, like the PRNG path).
  * per-seed rotations make distinct seeds independent unbiased
    estimates (seed batches = batched rotations of one point set), and
    keep the fixed-seed reproducibility contract.
  * NORMAL inverts the normal CDF of the 1-D stream directly
    (sampling.normal_from_u01): the inverse CDF is monotone, so the
    low-discrepancy structure of vdc(g) carries to the normal samples
    exactly — strictly better equidistribution than routing the stream
    through Box-Muller pairs (which scrambles 1-D structure across a
    2-D radius/angle map), and cheaper on the VPU.

The index stream g is the plan's global sample counter (program, loop,
row, lane), so estimates are bit-reproducible for a fixed (seed, plan)
and the union over all programs covers 0..actual-1 exactly once.
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

__all__ = [
    "bitrev32",
    "derive_segment_shift",
    "derive_shift",
    "qmc_u01_halfopen",
    "qmc_u01_open",
    "sobol_bits",
    "sobol_direction_numbers",
    "sobol_u01_halfopen",
    "sobol_u01_open",
    "QMC_MAX_SAMPLES",
    "SOBOL_MAX_DIMS",
]

# g must fit a uint32 counter; one SEGMENT is one full 2^32-point van der
# Corput cycle.  Runs past this size split the index space into segments
# automatically, each under its own seed-derived rotation
# (derive_segment_shift) — partial sums over independently-rotated full
# cycles are unbiased and keep the low-discrepancy rate per segment, so
# a single call scales to arbitrarily many samples.
QMC_MAX_SAMPLES = 1 << 32

_INV_2POW24 = np.float32(1.0 / (1 << 24))


def bitrev32(x):
    """Bit-reverse each uint32 lane (5 masked swap steps)."""
    x = x.astype(jnp.uint32)
    x = ((x & jnp.uint32(0x55555555)) << 1) | (
        (x & jnp.uint32(0xAAAAAAAA)) >> 1
    )
    x = ((x & jnp.uint32(0x33333333)) << 2) | (
        (x & jnp.uint32(0xCCCCCCCC)) >> 2
    )
    x = ((x & jnp.uint32(0x0F0F0F0F)) << 4) | (
        (x & jnp.uint32(0xF0F0F0F0)) >> 4
    )
    x = ((x & jnp.uint32(0x00FF00FF)) << 8) | (
        (x & jnp.uint32(0xFF00FF00)) >> 8
    )
    return (x << 16) | (x >> 16)


def _pcg_mix(x):
    """PCG output mix — uint32 lanes in, well-mixed uint32 out.  The
    single source of truth: the interpreter-tier CounterRng delegates
    here (ops/integrate_pallas.py)."""
    x = x * jnp.uint32(747796405) + jnp.uint32(2891336453)
    word = (
        (x >> ((x >> jnp.uint32(28)) + jnp.uint32(4))) ^ x
    ) * jnp.uint32(277803737)
    return (word >> jnp.uint32(22)) ^ word


def derive_shift(seed, tag: int):
    """Seed-derived uint32 rotation for QMC dimension ``tag``."""
    s = jnp.asarray(seed).astype(jnp.uint32)
    return _pcg_mix(
        s ^ jnp.uint32(0x9E3779B9) ^ jnp.uint32((tag * 0x85EBCA6B) & 0xFFFFFFFF)
    )


def derive_segment_shift(base_shift, seg):
    """Per-segment rotation for auto-split runs past one vdc cycle.

    Segment 0 keeps ``base_shift`` unchanged, so sub-2^32 runs are
    bit-identical to the unsegmented path; higher segments re-mix the
    base rotation with the segment index (scalar uint32 PCG, as
    derive_shift runs in-kernel), making each
    cycle an independent Cranley-Patterson rotation of the point set."""
    seg_u = jnp.asarray(seg).astype(jnp.uint32)
    mixed = _pcg_mix(base_shift ^ (seg_u * jnp.uint32(0x9E3779B9)))
    return jnp.where(seg_u == jnp.uint32(0), base_shift, mixed)


def _mantissa24(bits):
    """Top 24 bits as int32 (after the >>8 the value fits int32
    exactly)."""
    import jax

    return jax.lax.bitcast_convert_type(bits >> 8, jnp.int32)


def qmc_u01_halfopen(idx, shift):
    """[0, 1) rotated radical-inverse uniforms for a uint32 index block."""
    bits = bitrev32(idx) + shift
    return _mantissa24(bits).astype(jnp.float32) * _INV_2POW24


def qmc_u01_open(idx, shift):
    """(0, 1] variant (for log-consuming transforms)."""
    bits = bitrev32(idx) + shift
    return (_mantissa24(bits) + 1).astype(jnp.float32) * _INV_2POW24


# ---------------------------------------------------------------------------
# Sobol dimensions (multi-dimensional QMC)
#
# The 1-D stream above IS Sobol dimension 0 (the base-2 radical inverse);
# higher dimensions come from direction numbers generated by primitive
# polynomials over GF(2) with the Joe-Kuo initial values, the standard
# construction for multi-dimensional digital nets.  Point j of dimension d
# is the XOR of the direction numbers selected by the set bits of j — pure
# uint32 shift/and/xor math (no gathers), with the same Cranley-Patterson rotation + 24-bit mantissa
# pipeline as the 1-D stream.
# ---------------------------------------------------------------------------

SOBOL_MAX_DIMS = 32

# (degree s, polynomial a, m_1..m_s) for dimensions 2..16 (1-indexed à la
# Joe & Kuo's new-joe-kuo-6 table; dimension 1 is the radical inverse).
# Any odd m_k < 2^k yields a valid base-2 digital sequence; these initial
# values are the standard choices optimising low-dimensional projections.
_JOE_KUO = (
    (1, 0, (1,)),
    (2, 1, (1, 3)),
    (3, 1, (1, 3, 1)),
    (3, 2, (1, 1, 1)),
    (4, 1, (1, 1, 3, 3)),
    (4, 4, (1, 3, 5, 13)),
    (5, 2, (1, 1, 5, 5, 17)),
    (5, 4, (1, 1, 5, 5, 5)),
    (5, 7, (1, 1, 7, 11, 19)),
    (5, 11, (1, 1, 5, 1, 1)),
    (5, 13, (1, 1, 1, 3, 11)),
    (5, 14, (1, 3, 5, 5, 31)),
    (6, 1, (1, 1, 3, 3, 9, 7)),
    (6, 13, (1, 1, 5, 13, 3, 15)),
    (6, 16, (1, 3, 3, 9, 25, 25)),
)

# Dimensions 17..32: generated offline by tools/gen_sobol_dims.py —
# the remaining primitive polynomials of degrees 6-7 (primitivity
# verified by multiplicative order), with initial values searched to
# minimise the worst pairwise dyadic t-value against ALL previously
# accepted dimensions over 2^12 points (the same two-dimensional-
# projection criterion Joe & Kuo optimised; their published values are
# unavailable offline).  Searched worst pairwise t <= 5, most <= 4;
# tests/test_nd.py asserts the per-dimension and pairwise balance of
# every baked dimension.
_JOE_KUO_EXT = (
    (6, 19, (1, 3, 7, 13, 17, 3)),
    (6, 22, (1, 3, 1, 13, 17, 63)),
    (6, 25, (1, 1, 5, 11, 7, 5)),
    (7, 1, (1, 3, 5, 3, 31, 55, 67)),
    (7, 4, (1, 3, 1, 3, 13, 9, 55)),
    (7, 7, (1, 3, 3, 11, 3, 39, 109)),
    (7, 8, (1, 1, 3, 15, 23, 57, 9)),
    (7, 14, (1, 1, 1, 1, 29, 3, 37)),
    (7, 19, (1, 1, 1, 5, 7, 31, 115)),
    (7, 21, (1, 1, 3, 1, 13, 53, 45)),
    (7, 28, (1, 3, 1, 15, 21, 45, 65)),
    (7, 31, (1, 1, 7, 15, 21, 27, 91)),
    (7, 32, (1, 1, 1, 13, 11, 5, 101)),
    (7, 37, (1, 3, 3, 5, 19, 7, 15)),
    (7, 41, (1, 1, 7, 13, 17, 17, 109)),
    (7, 42, (1, 1, 1, 1, 9, 41, 91)),
)

_ALL_DIMS = _JOE_KUO + _JOE_KUO_EXT


def sobol_direction_numbers(dim: int) -> np.ndarray:
    """(32,) uint32 direction numbers for Sobol dimension ``dim``
    (0-based).  Dimension 0 is the radical inverse (v_k = 2^(31-k));
    higher dimensions run the GF(2) recurrence
    m_k = (XOR_i 2^i a_i m_{k-i}) ^ 2^s m_{k-s} ^ m_{k-s}."""
    if not 0 <= dim < SOBOL_MAX_DIMS:
        raise ValueError(
            f"QMC supports up to {SOBOL_MAX_DIMS} dimensions, got dim {dim}"
        )
    if dim == 0:
        return (np.uint32(1) << np.arange(31, -1, -1, dtype=np.uint32)).astype(
            np.uint32
        )
    s, a, m_init = _ALL_DIMS[dim - 1]
    m = list(m_init)
    for k in range(s, 32):
        value = m[k - s] ^ (m[k - s] << s)
        for i in range(1, s):
            if (a >> (s - 1 - i)) & 1:
                value ^= m[k - i] << i
        m.append(value)
    v = np.zeros(32, np.uint32)
    for k in range(32):
        v[k] = np.uint32(m[k]) << np.uint32(31 - k)
    return v


def sobol_bits(idx, v32):
    """uint32 Sobol integer for each lane of a uint32 index block:
    XOR of ``v32``'s entries selected by the set bits of the index.
    32 shift/and/multiply/xor steps, all lane-wise (in-kernel safe)."""
    idx = idx.astype(jnp.uint32)
    x = jnp.zeros_like(idx)
    for b in range(32):
        bit = (idx >> jnp.uint32(b)) & jnp.uint32(1)
        x = x ^ (jnp.uint32(int(v32[b])) * bit)
    return x


def sobol_u01_halfopen(idx, shift, v32):
    """[0, 1) rotated Sobol uniforms for one dimension."""
    bits = sobol_bits(idx, v32) + shift
    return _mantissa24(bits).astype(jnp.float32) * _INV_2POW24


def sobol_u01_open(idx, shift, v32):
    """(0, 1] variant (for log-consuming transforms)."""
    bits = sobol_bits(idx, v32) + shift
    return (_mantissa24(bits) + 1).astype(jnp.float32) * _INV_2POW24
