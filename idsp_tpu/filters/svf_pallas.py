"""Chamberlin SVF channel bank on the sequential lane-bank kernel.

The body is `svf.step` (svf.rs:47-60).  The simultaneous lowpass /
highpass / bandpass / band-reject outputs are exposed as a static
``output`` selector; the final state carries all three responses.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from . import svf
from .seq_bank import seq_bank
from .svf import SvfState

_OUTPUTS = ("lp", "hp", "bp", "br")


def svf_bank(f, qi, state: SvfState, xs, *, output: str = "lp",
             interpret: bool = False):
    """Float SVF bank.

    Args:
      f, qi: static floats (`svf.coefficients`), shared across channels.
      state: SvfState with lp/hp/bp of shape (c,).
      xs: (t, c) f32.
      output: which response to emit ("lp", "hp", "bp", or "br" =
        hp + lp, svf.rs:19-22).

    Returns (state, ys) matching the corresponding field of
    ``svf.block(f, qi, state, xs)`` (bit-identical in interpret mode;
    up to FMA contraction on the card, like every float bank).
    """
    assert output in _OUTPUTS
    return _svf_bank(float(f), float(qi), state, xs, str(output),
                     interpret=interpret)


@functools.partial(jax.jit, static_argnames=("f", "qi", "output", "interpret"))
def _svf_bank(f, qi, state, xs, output, *, interpret):
    fv, qv = np.float32(f), np.float32(qi)

    def step(s, x):
        s, _ = svf.step(fv, qv, s, x)
        return s, s.br if output == "br" else getattr(s, output)

    state = jax.tree.map(lambda a: a.astype(jnp.float32), state)
    return seq_bank(step, state, xs.astype(jnp.float32), interpret=interpret)
