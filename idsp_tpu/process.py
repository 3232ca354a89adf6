"""Elementary stream processors and rate/shape adapters.

Equivalent of the reference `dsp-process` elementary layer
(dsp-process/src/basic.rs, adapters.rs).  The reference's per-sample
`Process` impls become closed-form block transforms: delays are carried
tails + shifted slices, integrators are wrapping cumsums (parallel
prefix sums), rate changes are reshapes/strided slices.  All functions
take time on the LAST axis and return (new_state, y) when stateful.

The config/state split and composition wrappers (`Split`, `Minor`,
`Major`, `Lanes`) live in `idsp_tpu.stream`; lanes are `jax.vmap`.
"""

from __future__ import annotations

import jax.numpy as jnp

# --- stateless elementary processors (basic.rs:11-186) ----------------------


def butterfly(a, b, *, plus=True):
    """Sum-and-difference (basic.rs:74-83): [a+b, a-b] (or the reverse
    pairing for the minus variant)."""
    return (a + b, a - b) if plus else (a - b, a + b)


def gain(x, k):
    """`Gain` (basic.rs:128-186): multiply; for Q gains use
    `fxp.q_apply`."""
    return x * k


def offset(x, o):
    return x + o


def clamp(x, lo, hi):
    return jnp.clip(x, lo, hi)


# --- delay-line processors (basic.rs:225-515) --------------------------------


def delay_init(n: int, shape=(), dtype=jnp.float32):
    """Carried tail for an n-sample delay (`Buffer` as delay line,
    basic.rs:225-311)."""
    return jnp.zeros(shape + (n,), dtype)


def delay_block(state, x):
    """y[t] = x[t - n]: prepend the tail, emit, carry the new tail."""
    n = state.shape[-1]
    ext = jnp.concatenate([state, x], axis=-1)
    t = x.shape[-1]
    return ext[..., t:], ext[..., :t]


def nyquist_block(state, x):
    """`Nyquist` (basic.rs:412-453): y = x + x[t-n] — a gain-2 zero at
    Nyquist for n=1 (moving sum)."""
    state, delayed = delay_block(state, x)
    return state, x + delayed


def comb_block(state, x):
    """`Comb` (basic.rs:469-515): y = x - x[t-n]."""
    state, delayed = delay_block(state, x)
    return state, x - delayed


def integrator_init(shape=(), dtype=jnp.int32):
    return jnp.zeros(shape, dtype)


def integrator_block(state, x):
    """`Integrator` (basic.rs:456-467): wrapping running sum, emitting
    the post-add value.  Closed form: carry + cumsum."""
    y = state[..., None] + jnp.cumsum(x, axis=-1)
    return y[..., -1], y


# --- shape adapters (basic.rs:198-405, adapters.rs) --------------------------


def chunk(x, n: int):
    """Group the time axis into frames of n (`Buffer` as chunker /
    `Chunk`): (..., t) -> (..., t//n, n)."""
    t = x.shape[-1]
    assert t % n == 0
    return x.reshape(*x.shape[:-1], t // n, n)


def dechunk(x):
    """(..., m, n) -> (..., m*n) (`Buffer` as dechunker)."""
    return x.reshape(*x.shape[:-2], x.shape[-2] * x.shape[-1])


def downsample(x, r: int, phase: int = 0):
    """`Downsample` (adapters.rs:70-83): keep every r-th sample starting
    at `phase`.  Block length must be a multiple of r for a static
    output shape."""
    assert x.shape[-1] % r == 0
    return x[..., phase::r]


def hold(x, r: int):
    """`Hold` (adapters.rs:107-118): zero-order hold upsampling by r."""
    return jnp.repeat(x, r, axis=-1)


def interpolate_zero_stuff(x, r: int, phase: int = 0):
    """`Interpolator` with a zero-stuffing inner (adapters.rs:26-35):
    place each input at `phase` within its r-slot frame, zeros
    elsewhere."""
    out = jnp.zeros(x.shape[:-1] + (x.shape[-1], r), x.dtype)
    out = out.at[..., phase].set(x)
    return out.reshape(*x.shape[:-1], x.shape[-1] * r)


def decimate_select(x, r: int, index: int = 0):
    """`Decimator` (adapters.rs:157-222): exactly one output per
    r-frame, taken at `index` (the tick contract, checked statically)."""
    assert 0 <= index < r
    return downsample(x, r, index)


def rate_select(x, r: int, slot: int):
    """`Rate<I>` slot select (basic.rs:198-215): pick slot i of each
    r-frame."""
    return decimate_select(x, r, slot)


def rate_place(x, r: int, slot: int):
    """`Rate<I>` slot place: the zero-stuffing dual."""
    return interpolate_zero_stuff(x, r, slot)
