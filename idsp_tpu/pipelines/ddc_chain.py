"""The headline DDC chain: NCO mix -> Q32 DF1 lowpass -> HBF decimate-by-8.

Per channel: conjugate mix of the shared wideband input with the
channel's NCO, a Q32<29> DF1 biquad lowpass on the I and Q lanes, and
the 3-stage half-band decimator (`hbf.hbf_dec_cascade`, time-major).
The I and Q lanes ride side by side as one (t, 2c) bank.

* ``lo_mode="exact"`` mixes with the LUT `cossin` (bit-exact with the
  reference semantics); ``"fast"`` with the coarse/fine factored LO
  (`ops.fastlo`), the documented SNR-gated fast path.
* The DF1 is a per-lane recurrence and runs through
  `dispatch.lane_scan` (the lane-bank kernel on the GPU).  The mix and
  the half-band cascade are plain XLA.

`block_reference` is the same composition on the `lax.scan` DF1, the
oracle the chain is compared with bit for bit.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import dispatch, fxp
from ..filters import biquad, hbf
from ..ops import accu
from ..ops.fastlo import fastlo_mix
from ..ops.trig import cossin

#: half-band stages (decimation 2**DEPTH)
DEPTH = 3


class DdcChainState(NamedTuple):
    nco_phase: jax.Array  # (c,) i32
    bq: biquad.Df1State  # over the (2c,) I|Q lanes
    hbf: tuple  # HbfDecState per stage, time-major, (.., 2c) f32


def init(n_channels: int) -> DdcChainState:
    return DdcChainState(
        nco_phase=jnp.zeros((n_channels,), jnp.int32),
        bq=biquad.df1_init((2 * n_channels,), jnp.int32),
        hbf=hbf.hbf_dec_cascade_init(DEPTH, (2 * n_channels,), axis=0),
    )


def lowpass_coefficients(cutoff: float = 0.02, f: int = 29) -> tuple:
    """Q32<f> DF1 lowpass as a static tuple of ints."""
    from ..design import Filter

    ba = biquad.quantize_ba(
        biquad.from_cookbook(Filter().critical_frequency(cutoff).lowpass()),
        f,
    )
    return tuple(int(v) for v in np.asarray(ba).reshape(-1))


def mix(x, nco_phase, steps, lo_mode: str):
    """(t, 2c) i32 I|Q mix of the (t,) input with each channel's NCO."""
    t = x.shape[0]
    if lo_mode == "fast":
        # the largest power-of-two fine table length dividing t
        return fastlo_mix(x, nco_phase, steps, math.gcd(t, 128))
    if lo_mode != "exact":
        raise ValueError(f"lo_mode must be 'exact' or 'fast', not {lo_mode!r}")
    lo_re, lo_im = cossin(accu.ramp_t(nco_phase, steps, t))
    xi = x[:, None]
    return jnp.concatenate(
        [fxp.q_apply(lo_re, xi, 32), fxp.q_apply(-lo_im, xi, 32)], axis=1
    )


def _block(state, x, steps, lo_mode, df1):
    c = state.nco_phase.shape[0]
    t = x.shape[0]
    with jax.named_scope("mix"):
        miq = mix(x, state.nco_phase, steps, lo_mode)
    with jax.named_scope("df1"):
        bq, yiq = df1(state.bq, miq)
    with jax.named_scope("hbf"):
        hb, ziq = hbf.hbf_dec_cascade(state.hbf, yiq, axis=0)
    new_state = DdcChainState(
        nco_phase=accu.advance(state.nco_phase, steps, t), bq=bq, hbf=hb
    )
    return new_state, (ziq[:, :c], ziq[:, c:])


@functools.partial(jax.jit, static_argnames=("ba_q", "f", "lo_mode"))
def block(state: DdcChainState, x, steps, ba_q, *, f: int = 29,
          lo_mode: str = "fast"):
    """One block of the chain.

    Args:
      state: `DdcChainState` for c channels.
      x: (t,) i32 wideband input, t % 8 == 0.
      steps: (c,) i32 NCO frequency words.
      ba_q: static tuple of 5 Q32<f> DF1 coefficients.

    Returns (state, (i, q)), each (t / 8, c) f32.
    """
    step = functools.partial(biquad.df1_step_q, np.asarray(ba_q, np.int32), f)
    return _block(
        state, x, steps, lo_mode,
        lambda s, m: dispatch.lane_scan(step, s, m, out_dtype=jnp.float32),
    )


@functools.partial(jax.jit, static_argnames=("ba_q", "f", "lo_mode"))
def block_reference(state: DdcChainState, x, steps, ba_q, *, f: int = 29,
                    lo_mode: str = "fast"):
    """`block` with the DF1 as `lax.scan`: the oracle it is compared
    with bit for bit."""
    step = functools.partial(biquad.df1_step_q, np.asarray(ba_q, np.int32), f)
    return _block(
        state, x, steps, lo_mode,
        lambda s, m: dispatch.scan(step, s, m, out_dtype=jnp.float32),
    )


def state_specs(axis: str) -> DdcChainState:
    """PartitionSpecs that split a `DdcChainState` over channels: each
    device holds its own channels' state, I|Q lanes of its channels
    side by side (a device-major lane order)."""
    from jax.sharding import PartitionSpec as P

    lanes = biquad.Df1State(x=P(axis), y=P(axis))
    tails = tuple(
        hbf.HbfDecState(odd=P(None, axis), even=P(None, axis))
        for _ in range(DEPTH)
    )
    return DdcChainState(nco_phase=P(axis), bq=lanes, hbf=tails)


def channel_sharded(mesh, axis: str = "dp", **static):
    """`block` with the channels split over ``axis`` of ``mesh``.

    The (t,) input is replicated, ``steps`` and the state are split by
    channel (`state_specs`), and each device runs the chain on its own
    channels; no collective is needed.  The (i, q) outputs come back in
    channel order, equal to the one-device `block`.
    """
    from jax.sharding import PartitionSpec as P

    specs = state_specs(axis)
    return jax.jit(jax.shard_map(
        functools.partial(block, **static),
        mesh=mesh,
        in_specs=(specs, P(), P(axis)),
        out_specs=(specs, (P(None, axis), P(None, axis))),
    ))
