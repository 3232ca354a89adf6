"""Chamberlin state-variable filter (float).

Equivalent of reference src/iir/svf.rs: simultaneous
lowpass/highpass/bandpass (and band-reject = hp + lp) outputs from a
3-element state.  f = 2*sin(pi*f0), q = 1/Q.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp


class SvfState(NamedTuple):
    lp: jax.Array
    hp: jax.Array
    bp: jax.Array

    @property
    def br(self):
        """Band-reject output (svf.rs:19-22)."""
        return self.hp + self.lp


def init(shape=(), dtype=jnp.float32) -> SvfState:
    z = jnp.zeros(shape, dtype)
    return SvfState(lp=z, hp=z, bp=z)


def coefficients(f0: float, q: float) -> tuple[float, float]:
    """(f, qi) from relative frequency and Q (svf.rs:33-45)."""
    return 2.0 * math.sin(math.pi * f0), 1.0 / q


def step(f, qi, state: SvfState, x):
    """One update (svf.rs:47-60); all outputs available in the state."""
    lp = state.bp * f + state.lp
    hp = x - lp - state.bp * qi
    bp = hp * f + state.bp
    return SvfState(lp=lp, hp=hp, bp=bp), lp


def block(f, qi, state: SvfState, xs, *, unroll: int = 8):
    """Scan over time axis 0; emits (state, SvfState-of-arrays)."""
    f = jnp.asarray(f, state.lp.dtype)
    qi = jnp.asarray(qi, state.lp.dtype)

    def body(s, x):
        s2, _ = step(f, qi, s, x)
        return s2, s2

    return jax.lax.scan(body, state, xs, unroll=unroll)
