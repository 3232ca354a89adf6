"""Unity-DC-gain 1st/2nd-order integer lowpass.

Equivalent of reference src/lowpass.rs: i32 I/O with i64
state, a double-update trick that creates a Nyquist zero while keeping
the LSB significant, and clean saturation toward the i32 range.

Gains (lowpass.rs:28-46): N=1 takes `[k]`, k = pi*2^31*f0/fn (warped);
N=2 takes `[k^2 >> 32, -k/q]`, q = 1/sqrt(2) for Butterworth.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class LowpassState(NamedTuple):
    p: jax.Array  # (..., N) i64 wide state


def init(n: int, shape=()) -> LowpassState:
    assert n in (1, 2)
    return LowpassState(p=jnp.zeros(shape + (n,), jnp.int64))


def gains1(f0: float) -> np.ndarray:
    """First-order gain `[k]` from the relative corner frequency
    (pre-warped, lowpass.rs:31-37)."""
    k = np.pi * (1 << 31) * f0
    return np.array([min(int(round(k)), (1 << 31) - 1)], dtype=np.int32)


def gains2(f0: float, q: float = 1.0 / np.sqrt(2.0)) -> np.ndarray:
    """Second-order gains `[k^2 >> 32, -k/q]` (lowpass.rs:39-41)."""
    k = np.pi * (1 << 31) * f0
    return np.array(
        [int(round(k * k / (1 << 32))), -int(round(k / q))], dtype=np.int32
    )


def _sat_sub_i32(a, b):
    """a - b saturating in i32 (lowpass.rs:55 `saturating_sub`)."""
    d = a.astype(jnp.int64) - b.astype(jnp.int64)
    return jnp.clip(d, -(2**31), 2**31 - 1).astype(jnp.int32)


def step(k, state: LowpassState, x):
    """One sample (lowpass.rs:48-77). k: (..., N) i32; x: (...,) i32."""
    n = state.p.shape[-1]
    p = state.p
    hi0 = (p[..., 0] >> 32).astype(jnp.int32)
    d = _sat_sub_i32(jnp.asarray(x, jnp.int32), hi0).astype(jnp.int64) * k[
        ..., 0
    ].astype(jnp.int64)
    if n == 1:
        p0 = p[..., 0] + d
        y = (p0 >> 32).astype(jnp.int32)
        p0 = p0 + d
        return LowpassState(p=p0[..., None]), y
    elif n == 2:
        d = d + (p[..., 1] >> 32) * k[..., 1].astype(jnp.int64)
        p1 = p[..., 1] + d
        p0 = p[..., 0] + p1
        y = (p0 >> 32).astype(jnp.int32)
        p0 = p0 + p1
        p1 = p1 + d
        return LowpassState(p=jnp.stack([p0, p1], axis=-1)), y
    raise NotImplementedError("only N=1 and N=2 lowpass orders exist")


def block(k, state: LowpassState, xs, *, unroll: int = 8):
    """Scan over time axis 0 of xs."""
    return jax.lax.scan(lambda s, x: step(k, s, x), state, xs, unroll=unroll)
