"""Wrapping phase accumulator — closed form.

The reference `Accu` (src/accu.rs:15-62) is a per-sample iterator
``state += step``.  Here the whole phase ramp is computed in closed
form — ``phase0 + step * (1..n)`` with wrapping i32 arithmetic — which is
embarrassingly parallel and the key reformulation that lets the DDS run
at block rate instead of sample rate.
"""

from __future__ import annotations

import jax.numpy as jnp


def ramp(state, step, n: int, *, dtype=jnp.int32):
    """The next ``n`` accumulator outputs after ``state``.

    Matches n successive ``Accu::next()`` calls (src/accu.rs:34-37):
    out[i] = state + step * (i + 1), wrapping.

    Args:
      state: scalar or (...,) array of initial states (exclusive).
      step: scalar or (...,) array of steps, broadcastable with state.
      n: static number of samples.

    Returns:
      (..., n) array of wrapped accumulator values.
    """
    state = jnp.asarray(state, dtype=dtype)
    step = jnp.asarray(step, dtype=dtype)
    idx = (jnp.arange(1, n + 1, dtype=jnp.int64) & 0xFFFFFFFF).astype(dtype)
    return state[..., None] + step[..., None] * idx


def advance(state, step, n: int, *, dtype=jnp.int32):
    """State after ``n`` steps (wrapping): carry for the next block."""
    state = jnp.asarray(state, dtype=dtype)
    step = jnp.asarray(step, dtype=dtype)
    n_w = jnp.asarray(n & 0xFFFFFFFF, dtype=jnp.int64).astype(dtype)
    return state + step * n_w


def ramp_t(state, step, n: int, *, dtype=jnp.int32):
    """Time-major `ramp`: out[i, ...] = state + step * (i + 1).

    Identical values to ``ramp(...).swapaxes(-1, -2)`` but built
    directly in (n, ...) layout — the swapaxes form materializes a
    full transposed copy, this one fuses into its consumer.
    """
    state = jnp.asarray(state, dtype=dtype)
    step = jnp.asarray(step, dtype=dtype)
    idx = (jnp.arange(1, n + 1, dtype=jnp.int64) & 0xFFFFFFFF).astype(dtype)
    return state[None] + step[None] * idx[(...,) + (None,) * state.ndim]
