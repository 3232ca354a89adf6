"""Type-2, order-3 sampled-phase PLL.

Equivalent of reference src/pll.rs: all wrapping i32/i64
arithmetic, Q32<32> lead-lag coefficients, wrap-clamped phase error
(anti-windup during acquisition), Nyquist zero, wide lead-lag state with
first-order noise shaping, and a DC pole for the frequency.

The per-sample update is nonlinear (the clamp), so time stays a
recurrence; banks of PLLs run channels side by side (state is 7
words/channel; on the GPU in the lane-bank kernel, `pll_pallas`).
Stable for loop gains 7e-5..5e-2 of the sample rate (pll.rs:15).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import fxp
from ..ops import unwrap


def coefficients_from_zpk(zero: float, pole: float, gain: float) -> np.ndarray:
    """`ba = [gain, -gain*zero, -(1-pole)]` quantized to Q32<32> with
    the saturating f32 cast of the reference (pll.rs:41-48)."""
    vals = np.array(
        [np.float32(gain), np.float32(-gain * zero), np.float32(-(1.0 - pole))],
        dtype=np.float32,
    )
    return fxp.from_float(vals, 32)


def coefficients_from_bandwidth(bw: float, split: float = 4.0) -> np.ndarray:
    """Single-parameter loop design (pll.rs:50-57): ~1.5 dB peaking and
    62 deg margin at split=4."""
    a = np.float32(bw) * np.float32(2.0 * math.pi)
    z = np.float32(1.0) - a / np.float32(split)
    p = np.float32(1.0) - a * np.float32(split)
    k = -a * a * np.float32(split)
    return coefficients_from_zpk(float(z), float(p), float(k))


class PllState(NamedTuple):
    """pll.rs:61-87. All per-channel scalars (leading batch axes ok)."""

    clamp: unwrap.ClampWrapState
    z0: jax.Array  # i32, after clamp
    y0: jax.Array  # i32, after Nyquist zero
    f0: jax.Array  # i64, lead-lag wide state
    f: jax.Array  # i64, DC pole (frequency accumulator)
    y: jax.Array  # i32, output phase


def init(shape=()) -> PllState:
    return PllState(
        clamp=unwrap.clamp_wrap_init(shape),
        z0=jnp.zeros(shape, jnp.int32),
        y0=jnp.zeros(shape, jnp.int32),
        f0=jnp.zeros(shape, jnp.int64),
        f=jnp.zeros(shape, jnp.int64),
        y=jnp.zeros(shape, jnp.int32),
    )


def frequency(state: PllState):
    """Current frequency estimate (pll.rs:84-86)."""
    return (state.f >> 32).astype(jnp.int32)


def step(ba, state: PllState, x):
    """One update (pll.rs:90-107). x: wrapping i32 input phase."""
    ba = jnp.asarray(ba, jnp.int32)
    # advance output phase (oscillator DC pole)
    y = state.y + frequency(state)
    # wrap-clamped phase error, halved
    clamp_state, ze = unwrap.clamp_wrap_step(state.clamp, x + y)
    z0 = ze >> 1
    # Nyquist zero
    y0 = z0 + state.z0
    # lead-lag with wide state and first-order noise shaping: the wide
    # products are kept unquantized; a1 multiplies the state's high word
    # plus the (unsigned) low word scaled back — pll.rs:99-102.
    b0 = ba[..., 0].astype(jnp.int64)
    b1 = ba[..., 1].astype(jnp.int64)
    a1 = ba[..., 2].astype(jnp.int64)
    f0_hi = (state.f0 >> 32).astype(jnp.int32).astype(jnp.int64)
    f0_lo = (state.f0 & 0xFFFFFFFF).astype(jnp.int64)  # as u32
    f0 = (
        state.f0
        + b0 * y0.astype(jnp.int64)
        + b1 * state.y0.astype(jnp.int64)
        + a1 * f0_hi
        + ((a1 * f0_lo) >> 32)
    )
    # DC pole
    f = state.f + f0
    new_state = PllState(clamp=clamp_state, z0=z0, y0=y0, f0=f0, f=f, y=y)
    return new_state, y


def block(ba, state: PllState, xs, *, unroll: int = 8):
    """Scan over time axis 0; channels on trailing axes."""
    ba = jnp.asarray(ba, jnp.int32)
    return jax.lax.scan(lambda s, x: step(ba, s, x), state, xs, unroll=unroll)
