"""Normal-form (Rader-Gold) SOS channel banks on the sequential
lane-bank kernel: the coupled conjugate-pole rotation update (reference
src/iir/normal.rs:38-58), with `normal.step_q` / `normal.step` as the
kernel body — bit-identical to scanning them (the float bank up to FMA
contraction on the card).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from . import normal
from .biquad import Df1State
from .seq_bank import seq_bank


def normal_bank_q(b, p, state: Df1State, xs, f: int = 29, *,
                  interpret: bool = False):
    """Fixed-point normal-form SOS bank.

    Args:
      b: (3,) i32 Q<f> FIR prefix coefficients (static).
      p: (2,) i32 Q<f> pole (re, im) (static).
      state: Df1State with x/y of shape (c, 2) — the y rows hold the
        rotating I/Q components (normal.py docstring).
      xs: (t, c) i32.

    Returns (state, ys) bit-identical to scanning `normal.step_q`.
    """
    b_s = tuple(int(v) for v in np.asarray(b).reshape(-1)[:3])
    p_s = tuple(int(v) for v in np.asarray(p).reshape(-1)[:2])
    return _normal_bank_q(b_s, p_s, state, xs, f, interpret=interpret)


@functools.partial(jax.jit, static_argnames=("b", "p", "f", "interpret"))
def _normal_bank_q(b, p, state, xs, f, *, interpret):
    step = functools.partial(
        normal.step_q, np.asarray(b, np.int32), np.asarray(p, np.int32), f
    )
    return seq_bank(step, state, xs, interpret=interpret)


def normal_bank_f32(b, p, state: Df1State, xs, *, interpret: bool = False):
    """Float normal-form SOS bank (normal.rs:38-58); matches
    `normal.block`."""
    b_s = tuple(float(v) for v in np.asarray(b).reshape(-1)[:3])
    p_s = tuple(float(v) for v in np.asarray(p).reshape(-1)[:2])
    return _normal_bank_f32(b_s, p_s, state, xs, interpret=interpret)


@functools.partial(jax.jit, static_argnames=("b", "p", "interpret"))
def _normal_bank_f32(b, p, state, xs, *, interpret):
    step = functools.partial(
        normal.step, np.asarray(b, np.float32), np.asarray(p, np.float32)
    )
    state = jax.tree.map(lambda a: a.astype(jnp.float32), state)
    return seq_bank(step, state, xs.astype(jnp.float32), interpret=interpret)
