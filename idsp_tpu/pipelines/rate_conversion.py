"""Multi-stage rate-conversion cascade (BASELINE config #4).

16x HBF decimation followed by 16x HBF interpolation (optionally with a
CIC stage for non-power-of-two factors), streaming with carried
overlap-save tails — the tails are exactly what `parallel.stream`
exchanges across devices when the time axis is sharded.

Quality gate: a passband tone survives the down/up round trip with the
HBF_TAPS cascade's 0.2 uB ripple; out-of-band content is suppressed by
>= 140 dB (hbf.rs:303-307).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from ..filters import cic, hbf


class RateConvState(NamedTuple):
    dec: tuple  # HBF decimation cascade states
    int_: tuple  # HBF interpolation cascade states


def init(depth: int = 4, shape=(), dtype=jnp.float32, taps=hbf.HBF_TAPS):
    return RateConvState(
        dec=hbf.hbf_dec_cascade_init(depth, shape, dtype, taps),
        int_=hbf.hbf_int_cascade_init(depth, shape, dtype, taps),
    )


def round_trip(state: RateConvState, x, taps=hbf.HBF_TAPS):
    """Decimate by 2**depth then interpolate back (..., t) -> (..., t).

    The interpolator cascade has DC gain 2**depth; compensate so the
    round trip is unity-gain in the passband.
    """
    depth = len(state.dec)
    st_dec, low = hbf.hbf_dec_cascade(state.dec, x, taps)
    st_int, y = hbf.hbf_int_cascade(state.int_, low, taps)
    return RateConvState(dec=st_dec, int_=st_int), y / (1 << depth)


def init_t(depth: int = 4, shape=(), dtype=jnp.float32,
           taps=hbf.HBF_TAPS):
    """Time-major (t, c) states for `round_trip_t`."""
    return RateConvState(
        dec=hbf.hbf_dec_cascade_init(depth, shape, dtype, taps, axis=0),
        int_=hbf.hbf_int_cascade_init(depth, shape, dtype, taps, axis=0),
    )


def round_trip_t(state: RateConvState, x, taps=hbf.HBF_TAPS):
    """Time-major round trip: x (t, c) -> (state, (t, c))."""
    depth = len(state.dec)
    st_dec, low = hbf.hbf_dec_cascade(state.dec, x, taps, axis=0)
    st_int, y = hbf.hbf_int_cascade(state.int_, low, taps, axis=0)
    return RateConvState(dec=st_dec, int_=st_int), y / (1 << depth)


def group_delay(depth: int, taps=hbf.HBF_TAPS) -> int:
    """Total round-trip delay in input samples: each linear-phase stage
    delays by half its response length at its own rate."""
    d = 0.0
    # decimation stages run highest rate first: taps[depth-1] .. taps[0]
    rate = 1
    for i in range(depth):
        t = taps[depth - 1 - i]
        d += (hbf.fir_len(len(t), False)) / 2 * rate * 2  # dec stage at 2x out rate
        rate *= 2
    # interpolation mirrors it
    rate = 1 << depth
    for i in range(depth):
        t = taps[i]
        d += (hbf.fir_len(len(t), False)) / 2 * rate / 2 * 2
        rate //= 2
    return int(round(d))


def cic_hbf_decimate(
    cic_state: cic.CicState,
    hbf_states,
    x,
    cic_rate: int,
    hbf_depth: int,
    taps=hbf.HBF_TAPS,
):
    """Composite non-power-of-two decimator: CIC by (cic_rate+1) first
    (wide transition band at high rate), then the HBF cascade for the
    clean transition (the pairing recommended in hbf.rs:27)."""
    cic_state, mid = cic.decimate_block(cic_state, x, cic_rate)
    hbf_states, y = hbf.hbf_dec_cascade(
        hbf_states, mid.astype(jnp.float32), taps
    )
    return (cic_state, hbf_states), y


def cic_hbf_decimate_t(
    cic_state: cic.CicState,
    hbf_states,
    x,
    cic_rate: int,
    hbf_depth: int,
    taps=hbf.HBF_TAPS,
):
    """Time-major composite decimator ((t, c) blocks)."""
    cic_state, mid = cic.decimate_block(cic_state, x, cic_rate, axis=0)
    hbf_states, y = hbf.hbf_dec_cascade(
        hbf_states, mid.astype(jnp.float32), taps, axis=0
    )
    return (cic_state, hbf_states), y
