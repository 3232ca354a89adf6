"""Complex arithmetic on last-axis-2 arrays and (re, im) pairs.

Equivalent of reference src/complex.rs.  Rather than a wrapper
type, complex tensors are either a (re, im) tuple of arrays (preferred:
keeps XLA layouts simple and fuses well) or an array with a trailing
length-2 axis.  The fixed-point late-quantize multiply
(complex.rs:117-153) is the hot path used by mixers/discriminators: i32
operands, i64 intermediates, one truncating shift at the end.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .. import fxp
from .trig import atan2, cossin


def mul(a_re, a_im, b_re, b_im):
    """True complex multiply, elementwise (complex.rs:106-115)."""
    return a_re * b_re - a_im * b_im, a_re * b_im + a_im * b_re


def conj(re, im):
    return re, -im


def mul_q(a_re, a_im, b_re, b_im, f: int, *, dtype=jnp.int32):
    """Mixed ``Complex<Q<f>> * Complex<T>`` late-quantize multiply
    (complex.rs:117-134): all four products accumulate in i64, the
    truncating ``>> f`` happens once per output component.
    """
    ar = fxp.mul_wide(a_re, b_re, dtype=dtype)
    ai = fxp.mul_wide(a_im, b_im, dtype=dtype)
    br = fxp.mul_wide(a_re, b_im, dtype=dtype)
    bi = fxp.mul_wide(a_im, b_re, dtype=dtype)
    return (
        fxp.quantize(ar - ai, f, dtype=dtype),
        fxp.quantize(br + bi, f, dtype=dtype),
    )


def norm_sqr_i32(re, im):
    """|z|^2 with i64 result (complex.rs:204-217)."""
    re = jnp.asarray(re, dtype=jnp.int32)
    im = jnp.asarray(im, dtype=jnp.int32)
    return re.astype(jnp.int64) ** 2 + im.astype(jnp.int64) ** 2


def from_angle_i32(angle):
    """Unit complex from wrapping i32 angle via the DDS
    (complex.rs:237-240)."""
    return cossin(angle)


def arg_i32(re, im):
    """Angle of (re, im), i32 circle convention 1<<31 == pi
    (complex.rs:254-256)."""
    return atan2(im, re)


# --- float helpers (complex.rs:173-202) -------------------------------------


def from_angle(angle):
    """Unit complex from a float angle in radians."""
    return jnp.cos(angle), jnp.sin(angle)


def arg(re, im):
    """Float angle of (re, im)."""
    return jnp.arctan2(im, re)


def norm_sqr(re, im):
    return re * re + im * im


def div(a_re, a_im, b_re, b_im):
    """Complex division via conjugate multiply (complex.rs:193-198)."""
    n = norm_sqr(b_re, b_im)
    rr, ri = mul(a_re, a_im, b_re, -b_im)
    return rr / n, ri / n


def ilog2_i32(re, im):
    """Integer log2 of |z|^2 (complex.rs:219-224)."""
    ns = norm_sqr_i32(re, im)
    # floor(log2(ns)): position of the highest set bit of an i64 >= 1
    return (63 - jax.lax.clz(ns.astype(jnp.uint64)).astype(jnp.int32)).astype(
        jnp.int32
    )
