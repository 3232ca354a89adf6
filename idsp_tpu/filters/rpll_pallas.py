"""Reciprocal-PLL channel bank on the sequential lane-bank kernel.

The RPLL update (reference src/rpll.rs:47-77) consumes an *optional*
timestamp per update cycle; the event-driven input rides the kernel as
one i64 word per sample, ``(timestamp << 1) | valid``, unpacked in the
step.  The body is `rpll.step`, so the bank is bit-identical to
`rpll.block`.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from . import rpll
from .rpll import RpllConfig, RpllState
from .seq_bank import seq_bank


def rpll_bank(cfg: RpllConfig, state: RpllState, xs, valids, *,
              interpret: bool = False):
    """RPLL channel bank.

    Args:
      cfg: static RpllConfig (dt2, shift_frequency, shift_phase).
      state: RpllState with (c,) fields.
      xs: (t, c) i32 timestamps.
      valids: (t, c) bool (or 0/1 int) timestamp-present mask.

    Returns (state, (phase, frequency)) bit-identical to `rpll.block`.
    """
    return _rpll_bank(cfg, state, xs, valids, interpret=interpret)


@functools.partial(jax.jit, static_argnames=("cfg", "interpret"))
def _rpll_bank(cfg, state, xs, valids, *, interpret):
    def step(s, word):
        x = (word >> 1).astype(jnp.int32)
        return rpll.step(cfg, s, x, (word & 1) != 0)

    words = (xs.astype(jnp.int64) << 1) | (valids != 0).astype(jnp.int64)
    return seq_bank(step, state, words, interpret=interpret)
