"""Fixed-point FM discriminator receiver.

Equivalent of reference examples/fm_disc.rs: the DSP identity
``arg(x[n] * conj(x[n-1])) ~= dphi[n]`` with a Q32<30> deemphasis
biquad.  The discriminator (conjugate product + atan2 + carrier
subtract) is fully vectorized (the one-sample delay is a shifted slice,
not a scan); only the deemphasis biquad is a per-lane recurrence
(`dispatch.lane_scan`: the lane-bank kernel on the GPU) — and the whole
receiver is one jittable function over blocks, with a small carry for
block streaming.

Acceptance gates (fm_disc.rs:151-157): corr > 0.999, gain in (0.95,
1.05), rms < 5e-4.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import dispatch
from ..design import Filter
from ..filters import biquad
from ..ops import complex as cplx
from ..ops.trig import cossin


class FmDiscState(NamedTuple):
    """Block-streaming carry: previous IQ sample + deemphasis biquad."""

    prev_re: jax.Array  # i32
    prev_im: jax.Array  # i32
    prev_valid: jax.Array  # bool: False before the first sample
    deemph: biquad.Df1State


def init_state(shape=()) -> FmDiscState:
    return FmDiscState(
        prev_re=jnp.zeros(shape, jnp.int32),
        prev_im=jnp.zeros(shape, jnp.int32),
        prev_valid=jnp.zeros(shape, bool),
        deemph=biquad.df1_init(shape, jnp.int32),
    )


def deemphasis_coefficients(cutoff: float, f: int = 30) -> np.ndarray:
    """Q32<30> lowpass deemphasis, same builder as the reference
    (fm_disc.rs:43-45)."""
    ba = Filter().critical_frequency(cutoff).lowpass()
    return biquad.quantize_ba(biquad.from_cookbook(ba), f)


def discriminate(state: FmDiscState, x_re, x_im, carrier):
    """Discriminator (fm_disc.rs:31-39): late-quantized conjugate
    product of Q32<32> IQ against the previous sample, `arg` via
    `atan2`, then wrapping carrier subtraction; the first overall
    sample outputs 0.  Returns the (t, ...) i32 phase steps."""
    prev_re = jnp.concatenate([state.prev_re[None], x_re[:-1]], axis=0)
    prev_im = jnp.concatenate([state.prev_im[None], x_im[:-1]], axis=0)
    # z = x * conj(prev): Complex<Q32<32>> * Complex<i32> (complex.rs:117-134)
    z_re, z_im = cplx.mul_q(x_re, x_im, prev_re, -prev_im, 32)
    dphi = cplx.arg_i32(z_re, z_im) - jnp.asarray(carrier, jnp.int32)
    valid = jnp.concatenate(
        [state.prev_valid[None], jnp.ones_like(x_re[:-1], dtype=bool)], axis=0
    )
    return jnp.where(valid, dphi, 0)


def _next_state(state: FmDiscState, x_re, x_im, deemph) -> FmDiscState:
    return FmDiscState(
        prev_re=x_re[-1],
        prev_im=x_im[-1],
        prev_valid=jnp.ones_like(state.prev_valid),
        deemph=deemph,
    )


@partial(jax.jit, static_argnames=("f",))
def fm_receiver(state: FmDiscState, x_re, x_im, carrier, ba_q, f: int = 30):
    """Process one block of IQ (time on axis 0, optional channel axes
    after): `discriminate`, then the Q32<30> DF1 deemphasis biquad
    (fm_disc.rs:41-48)."""
    dphi = discriminate(state, x_re, x_im, carrier)

    # the deemphasis recurrence per channel lane; the (traced)
    # coefficients ride in the carry, broadcast to every lane
    def step(carry, x):
        ba, st = carry
        st, y = biquad.df1_step_q(ba, f, st, x)
        return (ba, st), y

    ba = jnp.broadcast_to(jnp.asarray(ba_q, jnp.int32), dphi.shape[1:] + (5,))
    (_, deemph), y = dispatch.lane_scan(step, (ba, state.deemph), dphi)
    return _next_state(state, x_re, x_im, deemph), y


@partial(jax.jit, static_argnames=("f",))
def fm_receiver_reference(state: FmDiscState, x_re, x_im, carrier, ba_q,
                          f: int = 30):
    """`fm_receiver` with the deemphasis as `lax.scan`
    (`biquad.df1_process_q`): the oracle it is compared with."""
    dphi = discriminate(state, x_re, x_im, carrier)
    deemph, y = biquad.df1_process_q(
        jnp.asarray(ba_q, jnp.int32), f, state.deemph, dphi
    )
    return _next_state(state, x_re, x_im, deemph), y


# --- fixture + metrics (fm_disc.rs:55-140) ----------------------------------


def fm_signal(carrier: int, deviation: int, message_freq: float, n: int):
    """Synthetic FM IQ via the cossin DDS (fm_disc.rs:57-74).

    The message is an f32 sine; per-sample frequency is
    carrier + trunc(deviation * msg); phase is its wrapping cumsum.
    Returns ((re, im) i32 arrays, message f32 array).
    """
    i = jnp.arange(n, dtype=jnp.float32)
    msg = jnp.sin(jnp.float32(2.0 * np.pi) * jnp.float32(message_freq) * i)
    dev = (jnp.float32(deviation) * msg).astype(jnp.int32)  # trunc like `as`
    step = jnp.asarray(np.int32(np.uint32(carrier).astype(np.int64) & 0xFFFFFFFF))
    freq = step + dev
    phase = jnp.cumsum(freq.astype(jnp.int64)).astype(jnp.int32)
    re, im = cossin(phase)
    return (re, im), msg


def lowpass_reference(cutoff: float, x):
    """Float f32 DF1 lowpass of the message (fm_disc.rs:92-100)."""
    ba = biquad.from_cookbook(
        Filter().critical_frequency(cutoff).lowpass()
    ).astype(np.float32)
    st = biquad.df1_init((), jnp.float32)
    _, y = biquad.df1_process(jnp.asarray(ba), st, jnp.asarray(x, jnp.float32))
    return y


def measure_fm(y, m, skip: int):
    """corr / gain / rms metrics (fm_disc.rs:78-124)."""
    y = np.asarray(y, np.float64)[skip:]
    m = np.asarray(m, np.float64)[skip:]
    gain = float((y * m).sum() / (m * m).sum())
    rms = float(np.sqrt(((y - gain * m) ** 2).sum()) / len(y))
    corr = float((y * m).sum() / (np.sqrt((y * y).sum()) * np.sqrt((m * m).sum())))
    return {"corr": corr, "gain": gain, "rms": rms}


def run_fm_disc(n: int = 4096):
    """Full example run with the reference's constants
    (fm_disc.rs:126-140)."""
    carrier_u = 0x1934_1234
    deviation = 0x0450_0000
    message_freq = 0.004
    cutoff = 0.02
    scale = 2.0 * np.pi / 2.0**32

    (re, im), msg = fm_signal(carrier_u, deviation, message_freq, n)
    ba_q = jnp.asarray(deemphasis_coefficients(cutoff))
    carrier_i = np.int32(np.array(carrier_u, dtype=np.uint32).astype(np.int64) - (1 << 32) if carrier_u >= 1 << 31 else carrier_u)
    _, y_bits = fm_receiver(init_state(), re, im, carrier_i, ba_q)
    y = np.asarray(y_bits, np.float64) * scale

    m = np.asarray(
        lowpass_reference(cutoff, np.asarray(msg) * (deviation * scale)),
        np.float64,
    )
    return measure_fm(y, m, 1024)
