"""Vectorized fixed-point `cossin` (DDS/NCO) and `atan2`.

Reimplementations of reference src/cossin.rs:14-67 and
src/atan2.rs:12-82.  Both are branch-free elementwise kernels: octant
folds become masked selects, the per-sample LUT access becomes a gather
from a 128-entry (cossin) / 16-entry (atan2) constant table.
Bit-exact with the reference by construction (same LUTs, same truncating
shifts); see tests/test_trig.py for the error-bound gates mirrored from
the reference test suite.

Phase convention: 32-bit wrapping phase, i32::MIN = -pi, i32::MAX just
below +pi.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .. import luts

_ALIGN_MSB = 32 - 16 - 1  # 15: 16+1 bits cos/sin, 15 bits dphi
# Fixed point pi/4 in Q16, truncated like Rust's `as` cast (cossin.rs:39).
_PI4 = int(np.float64(np.pi / 4) * (1 << 16))


def _u32(x):
    return x.astype(jnp.uint32)


def _i32(x):
    return x.astype(jnp.int32)


def _cossin_lut_planes():
    """The packed LUT split into u8 planes (cos lo/hi, sin lo/hi), used
    by the one-hot-matmul lookup.  u8 values are exact even in bf16 or
    TF32 matmul passes (a default-precision f32 matmul may round its
    operands to either, which would round u16-sized planes)."""
    t = luts.cossin_table().astype(np.int64)
    return np.stack(
        [t & 0xFF, (t >> 8) & 0xFF, (t >> 16) & 0xFF, (t >> 24) & 0xFF],
        axis=1,
    ).astype(np.float32)


def _lut_lookup_dot(idx):
    """128-entry LUT lookup as a one-hot matmul.

    A (N, 128) one-hot against the (128, 4) u8-plane table is exact
    (single non-zero term, values <= 255 exact in bf16) on every
    backend.  XLA materializes the one-hot; kept as a correctness
    cross-check, not a fast path.
    Returns (cos_plane, sin_plane) as i32.
    """
    oh = jax.nn.one_hot(idx, 1 << luts.COSSIN_DEPTH, dtype=jnp.float32)
    planes = jnp.einsum(
        "...k,kp->...p",
        oh,
        jnp.asarray(_cossin_lut_planes()),
        preferred_element_type=jnp.float32,
    ).astype(jnp.int32)
    return (
        planes[..., 0] + (planes[..., 1] << 8),
        planes[..., 2] + (planes[..., 3] << 8),
    )


def _lut_lookup_tree(idx):
    """128-entry LUT lookup as a 7-level binary select tree.

    127 selects + 7 bit-tests versus the flat chain's 128 compares +
    128 selects (~1.9x fewer ops).  Level 0 selects between pairs
    of scalar table constants by idx bit 0; each higher level halves
    the candidate set by the next bit.  Bit-identical to the chain.
    """
    packed_i32 = luts.cossin_table().view(np.int32)  # bit reinterpret
    bits = [(idx & (1 << k)) != 0 for k in range(7)]
    level = [
        jnp.where(
            bits[0], jnp.int32(packed_i32[2 * j + 1]),
            jnp.int32(packed_i32[2 * j]),
        )
        for j in range(64)
    ]
    for k in range(1, 7):
        level = [
            jnp.where(bits[k], level[2 * j + 1], level[2 * j])
            for j in range(len(level) // 2)
        ]
    u = level[0].astype(jnp.uint32)
    return (u & 0xFFFF).astype(jnp.int32), (u >> 16).astype(jnp.int32)


def _lut_lookup_select(idx):
    """128-entry LUT lookup as an unrolled compare/select chain.

    One fused elementwise pass (no materialized one-hot, no gather):
    128 compares + 127 selects per element, selecting the
    PACKED u32 entry (both planes at once).  Scalar table entries fold
    into the instruction stream as constants.
    """
    packed_i32 = luts.cossin_table().view(np.int32)  # bit reinterpret
    acc = jnp.zeros_like(idx)
    for j in range(packed_i32.shape[0]):
        acc = jnp.where(idx == j, jnp.int32(packed_i32[j]), acc)
    u = acc.astype(jnp.uint32)
    return (u & 0xFFFF).astype(jnp.int32), (u >> 16).astype(jnp.int32)


def cossin(phase, *, lookup: str | None = None):
    """Compute (cos, sin) of a 32-bit phase, i32 amplitude ~(1<<31 - 1<<15).

    Vectorized port of the MiSoC-derived octant-folded midpoint-LUT DDS
    (src/cossin.rs:14-67): 7-bit LUT with first-order interpolation.
    9e-6 max / 4e-6 RMS quadrature error over 20-bit phase.

    Args:
      phase: int32 array (any shape), wrapping phase.
      lookup: LUT access strategy — all bit-identical:
        "gather" (XLA gather, the default), "select" (unrolled
        compare/select chain, no gather), "dot" (one-hot matmul).

    Returns:
      (cos, sin) int32 arrays of the same shape.
    """
    lookup = lookup or "gather"
    phase = jnp.asarray(phase, dtype=jnp.int32)
    lut = jnp.asarray(luts.cossin_table())  # uint32[128]
    depth = luts.COSSIN_DEPTH

    octant = _u32(phase)
    # Fold octants with phase inversion: phase = !phase when bit 29 set.
    phase = jnp.where((octant & (1 << 29)) != 0, ~phase, phase)

    # Strip octant bits, align the in-octant angle to DEPTH + ALIGN_MSB bits.
    p_u = (_u32(phase) << 3) >> (32 - depth - _ALIGN_MSB)
    p = _i32(p_u)

    idx = p >> _ALIGN_MSB
    p = p & ((1 << _ALIGN_MSB) - 1)
    # LUT entries are midpoint samples: interpolate about the midpoint.
    p = p - (1 << (_ALIGN_MSB - 1))

    dphi = (p * _PI4) >> 16

    if lookup == "dot":
        cos_plane, sin = _lut_lookup_dot(idx)
        cos = cos_plane + (1 << 16)
    elif lookup == "tree":
        cos_plane, sin = _lut_lookup_tree(idx)
        cos = cos_plane + (1 << 16)
    elif lookup == "select":
        cos_plane, sin = _lut_lookup_select(idx)
        cos = cos_plane + (1 << 16)
    else:
        packed = lut[idx]
        # Unpack the excess-encoded cos (extra bit: 1/2 < cos <= 1) and sin.
        cos = _i32(packed & 0xFFFF) + (1 << 16)
        sin = _i32(packed >> 16)

    dcos = (sin * dphi) >> depth
    dsin = (cos * dphi) >> (depth + 1)

    cos = (cos << (_ALIGN_MSB - 1)) - dcos
    sin = (sin << _ALIGN_MSB) + dsin

    # Unmap octants (gray-ish decode of the top three bits).
    octant = octant ^ (octant >> 1)
    swap = (octant & (1 << 29)) != 0
    cos, sin = (
        jnp.where(swap, sin, cos),
        jnp.where(swap, cos, sin),
    )
    cos = jnp.where((octant & (1 << 30)) != 0, -cos, cos)
    sin = jnp.where((octant & (1 << 31)) != 0, -sin, sin)
    return cos, sin


# --- atan2 ------------------------------------------------------------------

# 11th-order odd minimax polynomial coefficients for atan on the first
# octant, Q32<32> bit patterns (src/atan2.rs:33-40).
_ATANI = np.array(
    [
        0x0517C2CD,
        -0x06C6496B,
        0x0FBDB021,
        -0x25B32E0A,
        0x43B34C81,
        -0x3BC823DD,
    ],
    dtype=np.int32,
)


def _mul_q31(x, y):
    """Unsigned Q31 multiply without rounding bias: (x*y) >> 31 on u64
    (src/atan2.rs:6-9)."""
    wide = x.astype(jnp.uint64) * y.astype(jnp.uint64)
    return (wide >> 31).astype(jnp.uint32)


def _divi(y, x, *, lookup: str = "gather"):
    """y/x in Q31 for 0 <= y <= x: normalize x to [1, 2) in Q1.31, seed a
    reciprocal from the 16-entry base+slope LUT, refine with one Newton
    step (src/atan2.rs:12-29)."""
    base_t, slope_t = luts.atan2_divi_table()

    x_safe = jnp.where(x == 0, jnp.uint32(1), x)
    shift = jax.lax.clz(x_safe)
    y = y << shift
    xn = x_safe << shift

    frac_bits = 31 - luts.ATAN2_DIVI_DEPTH  # 27
    rem = xn & jnp.uint32((1 << frac_bits) - 1)
    idx = (xn << 1) >> (1 + frac_bits)
    if lookup == "select":
        # 16-way unrolled compare/select
        base = jnp.zeros_like(idx)
        slope = jnp.zeros_like(idx.astype(jnp.int32))
        for j in range(base_t.shape[0]):
            m = idx == j
            base = jnp.where(m, jnp.uint32(base_t[j]), base)
            slope = jnp.where(m, jnp.int32(slope_t[j]), slope)
    else:
        base = jnp.asarray(base_t)[idx]
        slope = jnp.asarray(slope_t)[idx]
    step = ((slope.astype(jnp.int64) * rem.astype(jnp.int64)) >> frac_bits).astype(
        jnp.uint32
    )
    r0 = base + step  # wrapping u32 add
    r = _mul_q31(y, _mul_q31(r0, -_mul_q31(xn, r0)))
    return jnp.where(x == 0, jnp.uint32(0), r)


def _atani(x):
    """atan(x) on the first octant via an 11th-order odd polynomial in
    Q-format Horner form (src/atan2.rs:32-48). x is u32 Q31 in [0, 1]."""
    atani = jnp.asarray(_ATANI)
    x2 = ((x.astype(jnp.int64) * x.astype(jnp.int64)) >> 32).astype(jnp.int32)
    r = jnp.zeros_like(x2)
    for i in range(_ATANI.shape[0] - 1, -1, -1):
        # Q32<32> multiply: widen, >> 32, truncate back; wrapping add.
        r = ((r.astype(jnp.int64) * x2.astype(jnp.int64)) >> 32).astype(
            jnp.int32
        ) + atani[i]
    return ((r.astype(jnp.int64) * x.astype(jnp.int64)) >> 28).astype(jnp.uint32)


def atan2(y, x, *, lookup: str | None = None):
    """Full-circle fixed-point atan2 (src/atan2.rs:66-82).

    Octant reduction with saturating negation and an XOR unmap key, then
    reciprocal-LUT division and polynomial atan.  Result maps the circle
    to i32: i32::MIN = -pi (== +pi), i32::MAX one count below +pi.
    Max error 2.3e-6 rad, RMS 1.3e-6 rad; exact on the axes
    (atan2(0,1)=0, atan2(1,0)=0x3fff_ffff).

    Args:
      y, x: int32 arrays.

    Returns:
      int32 array of angles.
    """
    lookup = lookup or "gather"
    y = jnp.asarray(y, dtype=jnp.int32)
    x = jnp.asarray(x, dtype=jnp.int32)
    imin = jnp.int32(-2147483648)
    imax = jnp.int32(2147483647)

    k = jnp.zeros(jnp.broadcast_shapes(y.shape, x.shape), dtype=jnp.uint32)
    y, x = jnp.broadcast_to(y, k.shape), jnp.broadcast_to(x, k.shape)

    neg_y = y < 0
    y = jnp.where(neg_y, jnp.where(y == imin, imax, -y), y)
    k = jnp.where(neg_y, k ^ jnp.uint32(0xFFFFFFFF), k)

    neg_x = x < 0
    x = jnp.where(neg_x, jnp.where(x == imin, imax, -x), x)
    k = jnp.where(neg_x, k ^ jnp.uint32(0x7FFFFFFF), k)

    swap = y > x
    y, x = jnp.where(swap, x, y), jnp.where(swap, y, x)
    k = jnp.where(swap, k ^ jnp.uint32(0x3FFFFFFF), k)

    r = _atani(_divi(_u32(y), _u32(x), lookup=lookup))
    return _i32(r ^ k)
