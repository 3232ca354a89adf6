"""Fixed-point (Q-format) tensor numerics.

Equivalent of the reference `dsp-fixedpoint` crate
(dsp-fixedpoint/src/lib.rs, ops.rs).  Instead of a wrapper type, Q-format
values are plain integer arrays plus a static fractional-bit count ``f``
threaded through as a Python int.  All semantics are bit-exact with the
reference:

* widening multiply then *truncating* arithmetic right shift (no rounding
  bias) — ``Q*Q`` keeps the LHS scale (ops.rs:145-153), ``T*Q``/``apply``
  quantizes via ``trunc`` (lib.rs:297-327);
* float→Q encodes with round-half-away-from-zero
  (num_traits_impl.rs:30-62 ``.round()``), Q→float is exact scaling;
* wrapping two's-complement arithmetic throughout (jnp integer ops wrap).

Shapes are arrays; ``f`` is static so everything stays jit-friendly.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

_INT_INFO = {
    jnp.dtype("int8"): (jnp.int8, jnp.int16),
    jnp.dtype("int16"): (jnp.int16, jnp.int32),
    jnp.dtype("int32"): (jnp.int32, jnp.int64),
    # int64 (the reference Q64 aliases, lib.rs:473-492) has no native
    # accumulator dtype in XLA; q_mul/mul_wide/quantize emulate the
    # 128-bit product in 32-bit limbs (see _mul_i64_wide).
    jnp.dtype("int64"): (jnp.int64, None),
}


def widen_dtype(dtype) -> jnp.dtype:
    """The accumulator dtype for a base integer dtype (i32 -> i64).

    Raises ValueError for int64: its accumulator is emulated in limbs
    (pairs of (hi i64, lo u64)), not a dtype — use `mul_wide`, which
    returns such a pair for int64, or `q_mul`, which handles it
    internally.
    """
    base, acc = _INT_INFO[jnp.dtype(dtype)]
    if acc is None:
        raise ValueError(
            "int64 has no native accumulator dtype; its 128-bit products"
            " are emulated in limbs (mul_wide returns a (hi, lo) pair)"
        )
    return jnp.dtype(acc)


class I128(tuple):
    """An emulated 128-bit accumulator: ``(hi i64, lo u64)`` pair.

    The int64 `mul_wide` returns this instead of a wider dtype (XLA has
    no i128).  ``+``/``-``/unary ``-`` perform the limb arithmetic with
    carries — a bare tuple would silently CONCATENATE under the
    accumulate-then-quantize MAC pattern every `mul_wide` call site
    uses.  Registered as a JAX pytree (flattens to its two limbs) so it
    crosses jit/scan boundaries like the plain pair it replaces.
    """

    __slots__ = ()

    def __new__(cls, hi, lo):
        return tuple.__new__(cls, (hi, lo))

    @property
    def hi(self):
        return self[0]

    @property
    def lo(self):
        return self[1]

    def __add__(self, other):
        return i128_add(self, other)

    __radd__ = __add__

    def __neg__(self):
        return i128_neg(self)

    def __sub__(self, other):
        return i128_add(self, i128_neg(other))

    def __rsub__(self, other):
        return i128_add(i128_neg(self), other)


def _register_i128():
    import jax

    jax.tree_util.register_pytree_node(
        I128,
        lambda v: ((v[0], v[1]), None),
        lambda _, leaves: I128(*leaves),
    )


_register_i128()


def i128_add(a, b):
    """Limb add of two (hi i64, lo u64) pairs (accepts 0 for sum())."""
    if isinstance(b, int) and b == 0:
        return I128(*a) if not isinstance(a, I128) else a
    if isinstance(a, int) and a == 0:
        return I128(*b) if not isinstance(b, I128) else b
    ahi, alo = a
    bhi, blo = b
    lo = alo + blo
    return I128(
        ahi + bhi + (lo < alo).astype(jnp.int64), lo
    )


def i128_neg(a):
    """Two's-complement negate of a (hi i64, lo u64) pair (accepts 0)."""
    if isinstance(a, int) and a == 0:
        return 0
    ahi, alo = a
    lo = jnp.uint64(0) - alo
    hi = -ahi - (alo != 0).astype(jnp.int64)
    return I128(hi, lo)


def _mul_i64_wide(a, b):
    """Full signed 128-bit product of two i64 arrays as I128 (hi i64,
    lo u64).

    32-bit limb decomposition of the unsigned product plus the two's-
    complement correction ``hi -= (a<0 ? b : 0) + (b<0 ? a : 0)`` — the
    XLA-graph form of the 128-bit MAC (also the lane-bank Q64 body) and
    native/golden.c's __int128 model.
    """
    a = jnp.asarray(a, jnp.int64)
    b = jnp.asarray(b, jnp.int64)
    au = a.astype(jnp.uint64)
    bu = b.astype(jnp.uint64)
    m32 = jnp.uint64(0xFFFFFFFF)
    a0, a1 = au & m32, au >> 32
    b0, b1 = bu & m32, bu >> 32
    p00 = a0 * b0
    p01 = a0 * b1
    p10 = a1 * b0
    p11 = a1 * b1
    mid = (p00 >> 32) + (p01 & m32) + (p10 & m32)
    lo = (p00 & m32) | (mid << 32)
    hi = p11 + (p01 >> 32) + (p10 >> 32) + (mid >> 32)
    hi = hi - jnp.where(a < 0, bu, jnp.uint64(0))
    hi = hi - jnp.where(b < 0, au, jnp.uint64(0))
    return I128(hi.astype(jnp.int64), lo)


def _shr_i128_to_i64(hi, lo, f: int):
    """Truncating arithmetic right shift of a (hi, lo) 128-bit value by
    ``f`` (may be negative = left shift), low 64 bits of the result."""
    if f == 0:
        return lo.astype(jnp.int64)
    if f < 0:
        s = -f
        return (lo << s).astype(jnp.int64) if s < 64 else jnp.zeros_like(
            lo, jnp.int64
        )
    if f < 64:
        return (
            (lo >> f) | (hi.astype(jnp.uint64) << (64 - f))
        ).astype(jnp.int64)
    return hi >> min(f - 64, 63)


def shs(x, f: int):
    """Signed shift: positive ``f`` shifts left, negative shifts right.

    Arithmetic (sign-preserving, truncating toward -inf) on signed ints,
    matching `Shift::shs` (dsp-fixedpoint/src/lib.rs:60-90).
    """
    if f >= 0:
        return x << f
    return x >> (-f)


def q_mul(a, b, f: int, *, dtype=jnp.int32):
    """``Q<f> * Q<f'> -> Q<f>`` with the *rhs* scale ``f`` shifted out.

    Widens both operands to the accumulator dtype, multiplies, then does a
    truncating arithmetic right shift by ``f`` and wraps back to ``dtype``
    (ops.rs:145-153: result keeps the LHS scale, shift is by the RHS F).
    """
    if jnp.dtype(dtype) == jnp.dtype("int64"):
        hi, lo = _mul_i64_wide(a, b)
        return _shr_i128_to_i64(hi, lo, f)
    acc = widen_dtype(dtype)
    wide = a.astype(acc) * b.astype(acc)
    return shs(wide, -f).astype(dtype)


def q_apply(c, x, f: int, *, dtype=jnp.int32):
    """Apply Q-format gain ``c`` (f fractional bits) to raw integer ``x``.

    ``(c_wide * x_wide) >> f`` truncated back to ``dtype`` — the
    reference's ``Q::apply``/``T*Q`` (lib.rs:315-327, 449-456).
    """
    return q_mul(c, x, f, dtype=dtype)


def q_div(a, b, f_rhs: int, *, dtype=jnp.int32):
    """``Q<f> / Q<f1> -> Q<f>`` (ops.rs:163-178).

    For f1 > 0: widen the numerator, shift left by f1, integer-divide
    by the widened denominator, narrow.  For f1 <= 0: shift the
    numerator right by -f1 in the base width and divide there.  Integer
    division truncates toward zero (Rust `/`), hence `lax.div` — jnp's
    ``//`` floors and would differ on negative quotients.
    """
    import jax

    a = jnp.asarray(a, dtype)
    b = jnp.asarray(b, dtype)
    if f_rhs > 0:
        if jnp.dtype(dtype) == jnp.dtype("int64"):
            # Documented rejection: a 128/64 long division has no XLA
            # primitive and the limb emulation is not worth it for a
            # cold builder path — rescale to f_rhs <= 0 or use int32.
            raise NotImplementedError(
                "q_div with dtype=int64 and f_rhs > 0 needs a 128-bit "
                "numerator; rescale the operands or use f_rhs <= 0"
            )
        acc = widen_dtype(dtype)
        return jax.lax.div(
            shs(a.astype(acc), f_rhs), b.astype(acc)
        ).astype(dtype)
    return jax.lax.div(shs(a, f_rhs), b)


def q_sum(x, axis=None):
    """Sum of Q values: raw-bit wrapping sum at the same scale
    (ops.rs:219-224 `iter::Sum`)."""
    x = jnp.asarray(x)
    return jnp.sum(x, axis=axis, dtype=x.dtype)


def mul_wide(a, b, *, dtype=jnp.int32):
    """Widening multiply without the quantizing shift (``Q::mul_wide``,
    lib.rs:302-313). Returns the accumulator-dtype product — for int64
    an `I128` limb pair whose ``+`` is the carry-propagating 128-bit
    add, so the usual accumulate-then-`quantize` MAC pattern works
    unchanged."""
    if jnp.dtype(dtype) == jnp.dtype("int64"):
        return _mul_i64_wide(a, b)
    acc = widen_dtype(dtype)
    return a.astype(acc) * b.astype(acc)


def quantize(acc, f: int, *, dtype=jnp.int32):
    """Accumulator -> base: truncating shift by ``f`` then wrap-cast down
    (``Q::quantize`` = ``trunc`` + ``down``, lib.rs:286-300).  For
    int64, ``acc`` is the (hi, lo) pair from `mul_wide`."""
    if jnp.dtype(dtype) == jnp.dtype("int64"):
        hi, lo = acc
        return _shr_i128_to_i64(hi, lo, f)
    return shs(acc, -f).astype(dtype)


def scale(x, f_from: int, f_to: int):
    """Rescale raw bits between fractional-bit counts (``Q::scale``,
    lib.rs:248-260): truncating signed shift by ``f_to - f_from``."""
    return shs(x, f_to - f_from)


def round_half_away(x):
    """Rust ``f64::round`` semantics: round half away from zero.

    numpy's ``round`` is half-to-even and must not be used for encoding.
    """
    return np.trunc(x + np.copysign(0.5, x))


def from_float(value, f: int, *, dtype=jnp.int32):
    """Encode float(s) as Q<f> bits with round-half-away-from-zero
    (num_traits_impl.rs:30-45). Works on numpy/python scalars and arrays;
    returns a numpy array (static coefficient path).

    Rust float->int ``as`` casts saturate at the type bounds (NaN -> 0);
    the reference relies on this when quantizing out-of-range
    coefficients (e.g. the gain-1000 Q30 lowpass doctest,
    coefficients.rs:289-301), so we saturate too.
    """
    np_dtype = np.dtype(jnp.dtype(dtype).name)
    info = np.iinfo(np_dtype)
    v = np.asarray(value, dtype=np.float64) * np.float64(2.0) ** f
    v = round_half_away(v)
    v = np.where(np.isnan(v), 0.0, v)
    v = np.clip(v, float(info.min), float(info.max))
    return v.astype(np_dtype)


def to_float(bits, f: int, *, float_dtype=jnp.float64):
    """Exact Q<f> -> float scaling (``as_f64``, lib.rs:378-393)."""
    return jnp.asarray(bits).astype(float_dtype) * (2.0 ** -f)


def delta(f: int) -> float:
    """Step between adjacent representable values (``Q::DELTA``)."""
    return 2.0 ** -f


def q_min(dtype=jnp.int32) -> int:
    return int(jnp.iinfo(dtype).min)


def q_max(dtype=jnp.int32) -> int:
    return int(jnp.iinfo(dtype).max)


def saturating_neg_i32(x):
    """-x with i32::MIN saturating to i32::MAX (used by atan2 octant fold,
    src/atan2.rs:67-79)."""
    imin = jnp.int32(-2147483648)
    imax = jnp.int32(2147483647)
    return jnp.where(x == imin, imax, -x).astype(jnp.int32)


# --- wire formats (dsp-fixedpoint/src/serde.rs) ------------------------------


def q_to_wire(bits, f: int, *, mode: str = "raw"):
    """Serialize Q<f> raw bits for a config/checkpoint wire format.

    Mirrors the reference serde adapters (serde.rs:12-110):
    * ``"raw"`` — the transparent default: the raw integer bits
      (serde.rs derives `#[serde(transparent)]`-style raw ints);
    * ``"f32"`` / ``"f64"`` — the `as_f32`/`as_f64` scaled wire modules:
      the value as a scaled float (exact for f64 and any |bits| < 2^53).

    Returns a plain numpy array (JSON-friendly via ``.tolist()``).
    """
    bits = np.asarray(bits)
    if mode == "raw":
        return bits
    if mode == "f32":
        return (bits.astype(np.float64) * 2.0 ** -f).astype(np.float32)
    if mode == "f64":
        return bits.astype(np.float64) * 2.0 ** -f
    raise ValueError(f"unknown wire mode {mode!r}")


def q_from_wire(wire, f: int, *, mode: str = "raw", dtype=jnp.int32):
    """Deserialize a wire value back to Q<f> raw bits.

    Raw mode wraps to the storage dtype (serde transparent raw ints);
    float modes re-encode with round-half-away + saturation — the same
    `from_f32/f64` path the reference's scaled modules use
    (serde.rs:42-110, num_traits_impl.rs:30-62).
    """
    np_dtype = np.dtype(jnp.dtype(dtype).name)
    if mode == "raw":
        return np.asarray(wire).astype(np.int64).astype(np_dtype)
    if mode in ("f32", "f64"):
        return from_float(np.asarray(wire, np.float64), f, dtype=dtype)
    raise ValueError(f"unknown wire mode {mode!r}")
