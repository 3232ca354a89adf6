"""Lock-in amplifier / demodulator.

Equivalent of reference src/lockin.rs: mix the input with a
local-oscillator IQ, then filter I and Q through two states of ONE
shared filter config (the canonical coefficient-shared-lanes pattern).

The mixer is fully vectorized; the filter is whatever stage you pass
(integer `lowpass`, `biquad`, ...).  The phase-input variant derives the
LO from the `cossin` DDS at Q32<32> (lockin.rs:30-39).
"""

from __future__ import annotations

import jax.numpy as jnp

from .. import fxp
from ..ops.trig import cossin
from . import lowpass as lp


def mix(x, lo_re, lo_im, *, f: int = 32):
    """Demodulation mix: i32 sample times Q32<f> LO IQ, truncating
    (`x * lo.re()`, `x * lo.im()` with `i32 * Q32<32>` apply
    semantics)."""
    x = jnp.asarray(x, jnp.int32)
    return (
        fxp.q_apply(lo_re, x, f),
        fxp.q_apply(lo_im, x, f),
    )


def mix_phase(x, phase):
    """Mix against the DDS LO at the given wrapping phase
    (lockin.rs:30-39)."""
    lo_re, lo_im = cossin(phase)
    return mix(x, lo_re, lo_im)


def lockin_lowpass_block(k, states, xs, phases, *, unroll: int = 8):
    """Phase-input lock-in with the integer `Lowpass` as the filter.

    xs, phases: (t, ...) time-major. states: (i_state, q_state) lowpass
    states.  Returns ((i_state, q_state), (i, q)).
    """
    i_in, q_in = mix_phase(xs, phases)
    si, sq = states
    si2, yi = lp.block(k, si, i_in, unroll=unroll)
    sq2, yq = lp.block(k, sq, q_in, unroll=unroll)
    return (si2, sq2), (yi, yq)


def lockin_init_lowpass(n: int = 1, shape=()):
    """Two states of one shared lowpass config (I and Q lanes)."""
    return (lp.init(n, shape), lp.init(n, shape))


def lockin_block(filter_block, states, xs, phases):
    """Generic lock-in: any filter stage with signature
    ``filter_block(state, xs) -> (state, ys)`` shared across the I and
    Q lanes (the reference's `Lockin<C>` over any `SplitProcess`,
    lockin.rs:17-27)."""
    i_in, q_in = mix_phase(xs, phases)
    si, sq = states
    si2, yi = filter_block(si, i_in)
    sq2, yq = filter_block(sq, q_in)
    return (si2, sq2), (yi, yq)


def lockin_biquad_q_block(ba, f, states, xs, phases, *, unroll: int = 8):
    """Lock-in with a shared fixed-point biquad as the post-mix filter."""
    from . import biquad as bq

    return lockin_block(
        lambda s, x: bq.df1_process_q(ba, f, s, x, unroll=unroll),
        states,
        xs,
        phases,
    )
