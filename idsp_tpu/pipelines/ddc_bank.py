"""Wideband multi-channel DDC bank with per-channel PLL carrier tracking.

BASELINE config #5: a wideband input stream feeds C digital
downconverters (C = 1024 in the headline config), each with its own NCO
frequency, a shared-coefficient I/Q lowpass, decimation, and a
per-channel PLL tracking the residual carrier phase.

Structure:
* NCO phases are closed-form wrapping ramps (no scan) -> `cossin` DDS,
  (t, c) vectorized.
* The mix is the fixed-point late-quantize complex multiply.
* The I/Q lowpass is the integer `Lowpass<2>` on 2c I|Q lanes (one
  shared gain config — the `Lanes` pattern), keeping 1 output in d.
* The lowpass (or biquad) and the PLL are per-lane recurrences: they run
  through `dispatch.lane_scan` (the lane-bank kernel on the GPU).

Sharding: channels are embarrassingly parallel — shard (t, c) arrays on
the c axis (`parallel.channel_sharding`); time-block sharding composes
via the carried state like any stage in `parallel.stream`.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from .. import dispatch
from ..filters import biquad, lowpass, pll
from ..ops import accu
from ..ops.trig import atan2, cossin
from .ddc_chain import mix


class DdcBankState(NamedTuple):
    nco_phase: jax.Array  # (c,) i32
    lp_i: lowpass.LowpassState  # (c, N) i64
    lp_q: lowpass.LowpassState
    pll: pll.PllState  # per-channel


def init(n_channels: int, lp_order: int = 2) -> DdcBankState:
    return DdcBankState(
        nco_phase=jnp.zeros((n_channels,), jnp.int32),
        lp_i=lowpass.init(lp_order, (n_channels,)),
        lp_q=lowpass.init(lp_order, (n_channels,)),
        pll=pll.init((n_channels,)),
    )


class DdcBankBiquadState(NamedTuple):
    """Variant state with a Q32 biquad as the channel filter instead of
    the integer Lowpass."""

    nco_phase: jax.Array
    bq: object  # biquad.Df1State over (2c,) I|Q lanes
    pll: object


def init_biquad(n_channels: int) -> DdcBankBiquadState:
    from ..filters import biquad as bq

    return DdcBankBiquadState(
        nco_phase=jnp.zeros((n_channels,), jnp.int32),
        bq=bq.df1_init((2 * n_channels,), jnp.int32),
        pll=pll.init((n_channels,)),
    )


def _pll(pll_ba, state, ph, scan):
    step = partial(pll.step, np.asarray(pll_ba, np.int64).astype(np.int32))
    return scan(step, state, ph)


_STATIC = ("decimate", "f", "ba_q", "pll_ba", "lo_mode")


def _biquad_block(state, x, nco_steps, ba_q, pll_ba, decimate, f, lo_mode,
                  scan):
    t = x.shape[0]
    c = state.nco_phase.shape[0]
    assert t % decimate == 0

    miq = mix(x, state.nco_phase, nco_steps, lo_mode)
    step = partial(biquad.df1_step_q, np.asarray(ba_q, np.int64)
                   .astype(np.int32), f)
    bq_state, yiq_d = scan(step, state.bq, miq, dec=decimate)
    yi_d = yiq_d[:, :c]
    yq_d = yiq_d[:, c:]

    pll_state, _ = _pll(pll_ba, state.pll, atan2(yq_d, yi_d), scan)
    new_state = DdcBankBiquadState(
        nco_phase=accu.advance(state.nco_phase, nco_steps, t),
        bq=bq_state,
        pll=pll_state,
    )
    return new_state, (yi_d, yq_d, pll.frequency(pll_state))


@partial(jax.jit, static_argnames=_STATIC)
def ddc_bank_block_biquad(
    state: DdcBankBiquadState,
    x,
    nco_steps,
    ba_q,
    pll_ba,
    *,
    decimate: int = 16,
    f: int = 29,
    lo_mode: str = "exact",
):
    """DDC bank with a Q32 DF1 biquad as the channel filter.

    Same structure as `ddc_bank_block` with the I/Q lowpass replaced by
    the Q32<f> DF1 on the 2c I|Q lanes, decimated by keeping 1 output in
    ``decimate``.  ``ba_q`` and ``pll_ba`` are STATIC tuples of ints
    (trace-time constants).

    ``lo_mode="fast"`` mixes with the coarse/fine factored LO
    (ops/fastlo.py) instead of the exact LUT `cossin` — the documented
    SNR-gated fast path (mix LSB-rounding noise ~-130 dBc, far below
    the PLL tracking floor); "exact" is bit-exact with the reference
    semantics.
    """
    return _biquad_block(state, x, nco_steps, ba_q, pll_ba, decimate, f,
                         lo_mode, dispatch.lane_scan)


@partial(jax.jit, static_argnames=_STATIC)
def ddc_bank_block_biquad_reference(state, x, nco_steps, ba_q, pll_ba, *,
                                    decimate: int = 16, f: int = 29,
                                    lo_mode: str = "exact"):
    """`ddc_bank_block_biquad` with every recurrence as `lax.scan`."""
    return _biquad_block(state, x, nco_steps, ba_q, pll_ba, decimate, f,
                         lo_mode, dispatch.scan)


def _lowpass_block(state, x, nco_steps, lp_gains, pll_ba, decimate, lo_mode,
                   scan):
    gains = np.asarray(lp_gains, np.int64).astype(np.int32)
    t = x.shape[0]
    c = state.nco_phase.shape[0]
    assert t % decimate == 0

    miq = mix(x, state.nco_phase, nco_steps, lo_mode)
    # one I|Q lowpass bank on 2c lanes, keeping 1 output in `decimate`
    lp_iq = lowpass.LowpassState(
        p=jnp.concatenate([state.lp_i.p, state.lp_q.p], axis=0)
    )
    lp_iq, yiq_d = scan(partial(lowpass.step, gains), lp_iq, miq,
                        dec=decimate)
    yi_d, yq_d = yiq_d[:, :c], yiq_d[:, c:]

    # per-channel PLL on the residual carrier phase
    pll_state, y_pll = _pll(pll_ba, state.pll, atan2(yq_d, yi_d), scan)

    new_state = DdcBankState(
        nco_phase=accu.advance(state.nco_phase, nco_steps, t),
        lp_i=lowpass.LowpassState(p=lp_iq.p[:c]),
        lp_q=lowpass.LowpassState(p=lp_iq.p[c:]),
        pll=pll_state,
    )
    return new_state, (yi_d, yq_d, y_pll, pll.frequency(pll_state))


_LP_STATIC = ("decimate", "lp_gains", "pll_ba", "lo_mode")


@partial(jax.jit, static_argnames=_LP_STATIC)
def ddc_bank_block(
    state: DdcBankState,
    x,
    nco_steps,
    lp_gains,
    pll_ba,
    *,
    decimate: int = 16,
    lo_mode: str = "exact",
):
    """Process one block. x: (t,) i32 wideband samples; t must be a
    multiple of `decimate`.

    ``lp_gains`` and ``pll_ba`` are STATIC tuples of ints (trace-time
    constants).  ``lo_mode="fast"`` mixes with the SNR-gated
    coarse/fine LO (ops/fastlo.py).

    Returns (state, (i, q, phase, frequency)) at the decimated rate,
    each (t/decimate, c).
    """
    return _lowpass_block(state, x, nco_steps, lp_gains, pll_ba, decimate,
                          lo_mode, dispatch.lane_scan)


@partial(jax.jit, static_argnames=_LP_STATIC)
def ddc_bank_block_reference(state, x, nco_steps, lp_gains, pll_ba, *,
                             decimate: int = 16, lo_mode: str = "exact"):
    """`ddc_bank_block` with every recurrence as `lax.scan`."""
    return _lowpass_block(state, x, nco_steps, lp_gains, pll_ba, decimate,
                          lo_mode, dispatch.scan)


def make_tone_bank(steps, n, amplitude=1 << 27, offsets=None):
    """Fixture: a sum of per-channel carriers with small frequency
    offsets (what each channel's PLL should acquire)."""
    steps = np.asarray(steps, np.int64)
    if offsets is None:
        offsets = np.zeros_like(steps)
    phases = accu.ramp(
        jnp.zeros(len(steps), jnp.int32),
        jnp.asarray((steps + offsets).astype(np.int32)),
        n,
    )  # (c, t)
    re, _ = cossin(phases)
    tones = (re.astype(jnp.int64) * amplitude) >> 31
    return jnp.sum(tones, axis=0).astype(jnp.int32)
