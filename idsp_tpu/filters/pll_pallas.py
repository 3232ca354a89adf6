"""Type-2 order-3 PLL channel bank on the sequential lane-bank kernel.

The PLL update (reference src/pll.rs:90-107) is nonlinear per sample
(the wrap-clamp), so time stays serial; the kernel's body is
`pll.step`, so the bank is bit-identical to `pll.block`.
"""

from __future__ import annotations

import functools

import jax
import numpy as np

from . import pll
from .pll import PllState
from .seq_bank import seq_bank


def pll_bank(ba, state: PllState, xs, *, interpret: bool = False):
    """PLL channel bank.

    Args:
      ba: (3,) i32 Q32<32> lead-lag coefficients [b0, b1, a1] (static).
      state: PllState with (c,)-shaped leaves.
      xs: (t, c) i32 wrapping phase inputs.

    Returns (state, ys) bit-identical to `pll.block`.
    """
    ba_static = tuple(int(v) for v in np.asarray(ba).reshape(-1)[:3])
    return _pll_bank(ba_static, state, xs, interpret=interpret)


@functools.partial(jax.jit, static_argnames=("ba", "interpret"))
def _pll_bank(ba, state, xs, *, interpret):
    step = functools.partial(pll.step, np.asarray(ba, np.int32))
    return seq_bank(step, state, xs, interpret=interpret)
