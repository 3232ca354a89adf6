"""Normal-form (Rader-Gold / coupled) second-order section.

Equivalent of reference src/iir/normal.rs: a conjugate-pole
rotation update (constant pole resolution across the plane, unlike
direct forms near the real axis) with a second-order FIR prefix.  The
state reuses the DF1 layout: y[0], y[1] hold the I/Q components of the
rotating state.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np

from .. import fxp
from .biquad import Df1State, df1_init


def from_cookbook(ba: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(b[3], pole (re, im)) from cookbook `[[b],[a]]` coefficients
    (normal.rs:63-77): the conjugate roots of a0 z^2 + a1 z + a2."""
    ba = np.asarray(ba, dtype=np.float64)
    a0i = 1.0 / ba[1][0]
    b = np.array([ba[0][0] * a0i, ba[0][1] * a0i, ba[0][2] * a0i])
    p2 = -0.5 * ba[1][1]
    pq = ba[1][0] * ba[1][2] - p2**2
    assert pq >= 0.0, "poles must be complex-conjugate"
    p = np.array([p2 * a0i, np.sqrt(pq) * a0i])
    return b, p


def step(b, p, state: Df1State, x0):
    """One float update (normal.rs:38-58).

    y1' = b0 x0 + b1 x1 + b2 x2 + p_re*y1 - p_im*y0
    y0' = p_im*y1 + p_re*y0        (the emitted output)
    """
    y1 = (
        b[..., 0] * x0
        + b[..., 1] * state.x[..., 0]
        + b[..., 2] * state.x[..., 1]
        + p[..., 0] * state.y[..., 1]
        - p[..., 1] * state.y[..., 0]
    )
    y0 = p[..., 1] * state.y[..., 1] + p[..., 0] * state.y[..., 0]
    return (
        Df1State(
            x=jnp.stack([x0, state.x[..., 0]], axis=-1),
            y=jnp.stack([y0, y1], axis=-1),
        ),
        y0,
    )


def step_q(b, p, f: int, state: Df1State, x0, *, dtype=jnp.int32):
    """Fixed-point variant: wide MACs, one truncating shift per output
    (the `Q<i32,i64,F>` instantiation of normal.rs:38-58)."""
    acc1 = (
        fxp.mul_wide(b[..., 0], x0, dtype=dtype)
        + fxp.mul_wide(b[..., 1], state.x[..., 0], dtype=dtype)
        + fxp.mul_wide(b[..., 2], state.x[..., 1], dtype=dtype)
        + fxp.mul_wide(p[..., 0], state.y[..., 1], dtype=dtype)
        - fxp.mul_wide(p[..., 1], state.y[..., 0], dtype=dtype)
    )
    y1 = fxp.quantize(acc1, f, dtype=dtype)
    acc0 = fxp.mul_wide(p[..., 1], state.y[..., 1], dtype=dtype) + fxp.mul_wide(
        p[..., 0], state.y[..., 0], dtype=dtype
    )
    y0 = fxp.quantize(acc0, f, dtype=dtype)
    return (
        Df1State(
            x=jnp.stack([x0, state.x[..., 0]], axis=-1),
            y=jnp.stack([y0, y1], axis=-1),
        ),
        y0,
    )


def init(shape=(), dtype=jnp.float32) -> Df1State:
    return df1_init(shape, dtype)


def block(b, p, state: Df1State, xs, *, unroll: int = 8):
    return jax.lax.scan(
        lambda s, x: step(b, p, s, x), state, xs, unroll=unroll
    )
