"""Wave-digital allpass chains (channel banks) on the sequential
lane-bank kernel.  Adapter types and coefficients are static; the body
is `wdf.step`, so every bank is bit-identical to `wdf.block` /
`wdf.chain_block` / `wdf.pair_block`.
"""

from __future__ import annotations

import functools

import jax
import numpy as np

from . import wdf
from .seq_bank import seq_bank
from .wdf import Tpa, WdfState


def _freeze(stages) -> tuple:
    return tuple(
        (tuple(Tpa(t) for t in tpas),
         tuple(int(v) for v in np.asarray(a).reshape(-1)))
        for tpas, a in stages
    )


def wdf_bank(tpas, a, state: WdfState, xs, *, interpret: bool = False):
    """Adapter-chain WDF over a channel bank.

    Args:
      tpas: list of Tpa (static).
      a: (N,) i32 Q32<32> coefficients (static).
      state: WdfState with z of shape (c, N).
      xs: (t, c) i32.

    Returns (state, ys) bit-identical to `wdf.block`.
    """
    (new,), ys = _chain_bank(_freeze([(tpas, a)]), (state,), xs,
                             interpret=interpret)
    return new, ys


def wdf_chain_bank(stages, states, xs, *, interpret: bool = False):
    """Serial chain of WDF adapter chains in one kernel
    (`wdf.chain_block` semantics).

    Args:
      stages: list of (tpas, a) with static adapter types/coefficients.
      states: list of WdfState, z shape (c, n_i).
      xs: (t, c) i32.

    Returns (new_states, ys).
    """
    new, ys = _chain_bank(_freeze(stages), tuple(states), xs,
                          interpret=interpret)
    return list(new), ys


def _chain_step(stages):
    coefs = [(list(tpas), np.asarray(a, np.int32)) for tpas, a in stages]

    def step(sts, x):
        out = []
        for (tpas, a), s in zip(coefs, sts):
            s, x = wdf.step(tpas, a, s, x)
            out.append(s)
        return tuple(out), x

    return step


@functools.partial(jax.jit, static_argnames=("stages", "interpret"))
def _chain_bank(stages, states, xs, *, interpret):
    return seq_bank(_chain_step(stages), states, xs, interpret=interpret)


def wdf_pair_bank(branch0, branch1, states, xs, *, interpret: bool = False):
    """Complementary allpass pair (`wdf.pair_block`): both branch chains
    in one kernel, then the butterfly.

    Returns ((s0, s1), (sum, diff)) bit-identical to `wdf.pair_block`.
    """
    s0, s1, y0, y1 = _pair_bank(
        _freeze(branch0), _freeze(branch1), tuple(states[0]),
        tuple(states[1]), xs, interpret=interpret,
    )
    return (list(s0), list(s1)), (y0 + y1, y0 - y1)


@functools.partial(jax.jit, static_argnames=("b0", "b1", "interpret"))
def _pair_bank(b0, b1, s0, s1, xs, *, interpret):
    step0, step1 = _chain_step(b0), _chain_step(b1)

    def step(sts, x):
        a, y0 = step0(sts[0], x)
        b, y1 = step1(sts[1], x)
        return (a, b), (y0, y1)

    (s0, s1), (y0, y1) = seq_bank(step, (s0, s1), xs, interpret=interpret)
    return s0, s1, y0, y1
