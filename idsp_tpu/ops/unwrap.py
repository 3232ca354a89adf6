"""Phase wrap detection, unwrapping, and wrap-to-saturation mapping.

Equivalent of reference src/unwrap.rs.  The per-sample
`Unwrapper` recurrence is linear (extended phase = cumulative sum of
wrapped diffs), so the block path is a closed-form ``cumsum`` —
an associative scan XLA parallelizes — rather than a sequential loop.
`ClampWrap` carries a tiny nonlinear state and is provided as a scan
step (used inside the PLL, src/pll.rs:64,94).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


def overflowing_sub(y, x, *, dtype=jnp.int32):
    """Wrapped difference ``y - x`` plus overflow signum in {-1, 0, +1}
    (src/unwrap.rs:73-80).

    wrap = sign((delta >= 0) - (y >= x)) — positive overflow gives +1,
    negative gives -1.
    """
    y = jnp.asarray(y, dtype=dtype)
    x = jnp.asarray(x, dtype=dtype)
    delta = y - x
    a = (delta >= 0).astype(jnp.int8)
    b = (y >= x).astype(jnp.int8)
    return delta, (a - b).astype(jnp.int8)


def saturating_scale(lo, hi, shift: int):
    """Monotone hi:lo recombination into one downscaled i32
    (src/unwrap.rs:90-101): ``(lo >> shift) + (hi << (32-shift))`` with
    saturation when ``hi`` exceeds the representable band."""
    lo = jnp.asarray(lo, dtype=jnp.int32)
    hi = jnp.asarray(hi, dtype=jnp.int32)
    assert 0 < shift <= 32
    hi_range = jnp.int32(-1 << (shift - 1))
    imin = jnp.int32(-2147483648)
    mid = (lo >> shift) + (hi << (32 - shift))
    return jnp.where(
        hi <= hi_range,
        imin - hi_range,
        jnp.where(-hi <= hi_range, hi_range - imin, mid),
    )


def unwrap_diffs(x, y0, *, dtype=jnp.int32, wide_dtype=jnp.int64):
    """Block `Unwrapper` (src/unwrap.rs:139-158).

    Per sample the reference returns the wrapped diff ``dx = x - y_prev``
    (i32, wrapping) and accumulates ``y += dx`` in a wide register.  In
    closed form: dx[0] = x[0] - (y0 wrapped), dx[i] = x[i] - x[i-1], and
    y[i] = y0 + cumsum(dx) — a parallel prefix sum, not a scan loop.

    Args:
      x: (..., n) wrapped phase stream (i32).
      y0: (...,) wide initial extended phase (i64).

    Returns:
      (dx, y): wrapped diffs (i32) and extended phases (i64) per sample;
      carry y[..., -1] into the next block.
    """
    x = jnp.asarray(x, dtype=dtype)
    y0 = jnp.asarray(y0, dtype=wide_dtype)
    prev = jnp.concatenate(
        [y0[..., None].astype(dtype), x[..., :-1]], axis=-1
    )
    dx = x - prev
    y = y0[..., None] + jnp.cumsum(dx.astype(wide_dtype), axis=-1)
    return dx, y


def wraps(y, s: int, *, dtype=jnp.int32):
    """Rounded wrap count from the extended phase (src/unwrap.rs:119-127):
    ``(y >> s) + ((y >> (s-1)) & 1)``."""
    y = jnp.asarray(y)
    return ((y >> s) + ((y >> (s - 1)) & 1)).astype(dtype)


class ClampWrapState(NamedTuple):
    """State of the wrap-to-saturation mapper (src/unwrap.rs:166-171)."""

    x0: jax.Array  # last input
    clamp: jax.Array  # accumulated wrap indicator in {-1, 0, +1} (int8)


def clamp_wrap_init(shape=(), dtype=jnp.int32) -> ClampWrapState:
    return ClampWrapState(
        x0=jnp.zeros(shape, dtype=dtype),
        clamp=jnp.zeros(shape, dtype=jnp.int8),
    )


def clamp_wrap_step(state: ClampWrapState, x, *, dtype=jnp.int32):
    """One `ClampWrap::process` (src/unwrap.rs:184-194): saturate the
    output on wraps until a corresponding un-wrap."""
    info = jnp.iinfo(dtype)
    _, wrap = overflowing_sub(x, state.x0, dtype=dtype)
    # clamp += wrap, saturating the sum into {-1, 0, 1} via signum.
    clamp = jnp.sign(state.clamp.astype(jnp.int8) + wrap).astype(jnp.int8)
    y = jnp.where(
        clamp < 0,
        jnp.asarray(info.min, dtype),
        jnp.where(clamp > 0, jnp.asarray(info.max, dtype), x),
    )
    return ClampWrapState(x0=jnp.asarray(x, dtype=dtype), clamp=clamp), y


def clamp_wrap_block(state: ClampWrapState, xs, *, dtype=jnp.int32):
    """Scan `clamp_wrap_step` over the leading time axis of ``xs``."""

    def step(s, x):
        s, y = clamp_wrap_step(s, x, dtype=dtype)
        return s, y

    return jax.lax.scan(step, state, xs)
