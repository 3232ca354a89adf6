"""Integer lowpass channel bank on the sequential lane-bank kernel.

The body is `lowpass.step` (lowpass.rs:48-77, i64 wide state,
saturating input subtraction), so the bank is bit-identical to
`lowpass.block`.
"""

from __future__ import annotations

import functools

import jax
import numpy as np

from . import lowpass
from .lowpass import LowpassState
from .seq_bank import seq_bank


def lowpass_bank(k, state: LowpassState, xs, *, dec: int = 1,
                 interpret: bool = False):
    """Integer lowpass bank (N=1 or N=2).

    Args:
      k: (N,) i32 gains (static; `lowpass.gains1/gains2`).
      state: LowpassState with p (c, N) i64.
      xs: (t, c) i32.
      dec: keep-1-in-dec output decimation (== ``ys[::dec]``); the state
        carries the full-rate recurrence exactly.

    Returns (state, ys) bit-identical to `lowpass.block` (decimated when
    dec > 1); ys is (t // dec, c).
    """
    k_static = tuple(int(v) for v in np.asarray(k).reshape(-1))
    return _lowpass_bank(k_static, state, xs, dec=int(dec),
                         interpret=interpret)


@functools.partial(jax.jit, static_argnames=("k", "dec", "interpret"))
def _lowpass_bank(k, state, xs, *, dec, interpret):
    step = functools.partial(lowpass.step, np.asarray(k, np.int32))
    return seq_bank(step, state, xs, dec=dec, interpret=interpret)
