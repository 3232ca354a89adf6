"""Biquad channel banks on the sequential lane-bank kernel.

Each bank runs one biquad architecture over a (t, c) channel bank, the
whole time loop in one GPU kernel (`filters.seq_bank`), with the scan
step of `filters.biquad` as its body — so every bank is bit-identical
to scanning that step (float banks up to FMA contraction on the card).

Coefficients are baked as trace-time constants (static ints/floats);
the ``_coef`` variants take them as runtime data instead (a shared (5,)
vector or per-channel (5, c) planes), so a retune never recompiles.

``interpret=True`` runs the kernel on the CPU (tests).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from . import biquad
from .biquad import Df1State
from .seq_bank import seq_bank


def _ints(v, n=None) -> tuple:
    flat = np.asarray(v).reshape(-1)
    return tuple(int(x) for x in (flat if n is None else flat[:n]))


def _clamp(clamp):
    return None if clamp is None else tuple(int(v) for v in clamp)


# --- static-coefficient banks ------------------------------------------------


def df1_bank_q(ba, state: Df1State, xs, f: int = 29, *,
               interpret: bool = False, out_dtype=None):
    """Q32<f> DF1 biquad over a channel bank.

    Args:
      ba: (5,) i32 Q<f> coefficients (shared, baked as constants).
      state: Df1State with x/y of shape (c, 2).
      xs: (t, c) i32.
      out_dtype: optional output dtype (e.g. f32 for a float FIR next);
        the state update stays exact i32.

    Returns (state, ys) bit-identical to `biquad.df1_process_q`.
    """
    return _df1_bank(_ints(ba, 5), state, xs, f, dec=1,
                     out_dtype=_dtype(out_dtype), interpret=interpret)


def df1_bank_q_dec(ba, state: Df1State, xs, f: int = 29, *, d: int = 16,
                   interpret: bool = False, out_dtype=None):
    """`df1_bank_q` keeping 1 output in ``d`` (``ys[::d]``); the carried
    state is the full-rate recurrence, exact.  ys is (t // d, c)."""
    return _df1_bank(_ints(ba, 5), state, xs, f, dec=int(d),
                     out_dtype=_dtype(out_dtype), interpret=interpret)


def _dtype(dt):
    return None if dt is None else jnp.dtype(dt)


@functools.partial(
    jax.jit, static_argnames=("ba", "f", "dec", "out_dtype", "interpret")
)
def _df1_bank(ba, state, xs, f, *, dec, out_dtype, interpret):
    step = functools.partial(biquad.df1_step_q, np.asarray(ba, np.int32), f)
    return seq_bank(step, state, xs, dec=dec, out_dtype=out_dtype,
                    interpret=interpret)


def sos_bank_q(ba_stages, states, xs, f: int = 29, *,
               interpret: bool = False):
    """N-stage fixed-point SOS cascade over a channel bank, all stages
    advancing per time step in one kernel.

    Args:
      ba_stages: (N, 5) i32 coefficients (static).
      states: N Df1State, each (c, 2).
      xs: (t, c) i32.

    Returns (new_states, ys) bit-identical to chaining `df1_process_q`
    stage-major (the reference `sos` path, py.rs:51-74).
    """
    ba = tuple(_ints(row) for row in np.asarray(ba_stages).reshape(-1, 5))
    new, ys = _sos_bank(ba, tuple(states), xs, f, interpret=interpret)
    return list(new), ys


@functools.partial(jax.jit, static_argnames=("ba", "f", "interpret"))
def _sos_bank(ba, states, xs, f, *, interpret):
    coefs = [np.asarray(row, np.int32) for row in ba]

    def step(sts, x):
        out = []
        for b, s in zip(coefs, sts):
            s, x = biquad.df1_step_q(b, f, s, x)
            out.append(s)
        return tuple(out), x

    return seq_bank(step, states, xs, interpret=interpret)


def df1_bank_f32(ba, state: Df1State, xs, *, interpret: bool = False):
    """Float DF1 biquad bank with the sequential semantics of
    `df1_process` (unlike the reassociating `df1_block_float`)."""
    ba_s = tuple(float(v) for v in np.asarray(ba).reshape(-1)[:5])
    return _df1_bank_f32(ba_s, state, xs, interpret=interpret)


@functools.partial(jax.jit, static_argnames=("ba", "interpret"))
def _df1_bank_f32(ba, state, xs, *, interpret):
    step = functools.partial(biquad.df1_step, np.asarray(ba, np.float32))
    state = jax.tree.map(lambda a: a.astype(jnp.float32), state)
    return seq_bank(step, state, xs.astype(jnp.float32), interpret=interpret)


def df1_clamp_bank_q(ba, state: Df1State, xs, f: int = 29, *,
                     u: int = 0, lo: int, hi: int, interpret: bool = False):
    """Q32 DF1 with summing-junction offset + output clamp (anti-windup,
    biquad.rs:394-404).  Bit-identical to scanning
    ``clamp_step(df1_step_q(...))``."""
    return _clamp_bank(_ints(ba, 5), state, xs, f, (int(u), int(lo), int(hi)),
                       interpret=interpret)


@functools.partial(jax.jit, static_argnames=("ba", "f", "clamp", "interpret"))
def _clamp_bank(ba, state, xs, f, clamp, *, interpret):
    b = np.asarray(ba, np.int32)
    u, lo, hi = (np.int32(v) for v in clamp)

    def step(s, x):
        return biquad.clamp_step(biquad.df1_step_q(b, f, s, x), u, lo, hi)

    return seq_bank(step, state, xs, interpret=interpret)


def df1_wide_bank(ba, state, xs, f: int = 29, *, clamp=None,
                  interpret: bool = False):
    """Wide-state (i64 feedback) DF1 bank (biquad.rs:456-472; clamp
    variant :474-480, ``clamp=(u, lo, hi)`` static ints).

    Bit-identical to scanning `df1_wide_step` / `df1_wide_clamp_step`.
    """
    return _wide_bank(_ints(ba, 5), state, xs, f, _clamp(clamp),
                      interpret=interpret)


def _wide_step(b, f, clamp):
    if clamp is None:
        return functools.partial(biquad.df1_wide_step, b, f)
    u, lo, hi = (np.int32(v) for v in clamp)
    return lambda s, x: biquad.df1_wide_clamp_step(b, f, s, x, u, lo, hi)


@functools.partial(jax.jit, static_argnames=("ba", "f", "clamp", "interpret"))
def _wide_bank(ba, state, xs, f, clamp, *, interpret):
    step = _wide_step(np.asarray(ba, np.int32), f, clamp)
    return seq_bank(step, state, xs, interpret=interpret)


def df1_dither_bank(ba, state, xs, f: int = 29, *, clamp=None,
                    interpret: bool = False):
    """Error-feedback (noise-shaping) DF1 bank (biquad.rs:511-530; clamp
    variant :532-538).  Bit-identical to scanning `df1_dither_step` /
    `df1_dither_clamp_step`."""
    return _dither_bank(_ints(ba, 5), state, xs, f, _clamp(clamp),
                        interpret=interpret)


def _dither_step(b, f, clamp):
    if clamp is None:
        return functools.partial(biquad.df1_dither_step, b, f)
    u, lo, hi = (np.int32(v) for v in clamp)
    return lambda s, x: biquad.df1_dither_clamp_step(b, f, s, x, u, lo, hi)


@functools.partial(jax.jit, static_argnames=("ba", "f", "clamp", "interpret"))
def _dither_bank(ba, state, xs, f, clamp, *, interpret):
    step = _dither_step(np.asarray(ba, np.int32), f, clamp)
    return seq_bank(step, state, xs, interpret=interpret)


def df1_bank_q64(ba, state: Df1State, xs, f: int = 61, *,
                 interpret: bool = False):
    """Q64<f> DF1 bank: i64 storage, 128-bit accumulation (the
    reference's `Q64<61>` row).  Bit-identical to `df1_process_q64`."""
    return _q64_bank(_ints(ba, 5), state, xs, f, interpret=interpret)


@functools.partial(jax.jit, static_argnames=("ba", "f", "interpret"))
def _q64_bank(ba, state, xs, f, *, interpret):
    step = functools.partial(biquad.df1_step_q64, np.asarray(ba, np.int64), f)
    return seq_bank(step, state, xs.astype(jnp.int64), interpret=interpret)


def df1_bank_q16(ba, state: Df1State, xs, f: int = 13, *,
                 interpret: bool = False):
    """Q16<f> DF1 bank: i16 storage, i32 accumulator (the reference's
    `Q16<13>` row).  Bit-identical to scanning
    ``biquad.df1_step_q(ba, f, s, x, dtype=jnp.int16)``."""
    return _q16_bank(_ints(ba, 5), state, xs, f, interpret=interpret)


@functools.partial(jax.jit, static_argnames=("ba", "f", "interpret"))
def _q16_bank(ba, state, xs, f, *, interpret):
    b = np.asarray(ba, np.int16)

    def step(s, x):
        return biquad.df1_step_q(b, f, s, x, dtype=jnp.int16)

    return seq_bank(step, state, xs, interpret=interpret)


# --- runtime-coefficient banks (retune without recompile) --------------------
#
# The coefficients ride in the kernel's carry as per-lane (c, 5) data,
# read once and passed through unchanged.


def _planes(ba_planes, c):
    """Shared (5,) or per-channel (5, c) coefficients -> (c, 5) i32."""
    ba = jnp.asarray(ba_planes, jnp.int32)
    if ba.ndim == 1:
        ba = jnp.broadcast_to(ba[:, None], (5, c))
    return ba.T


def df1_bank_q_coef(ba_planes, state: Df1State, xs, f: int = 29, *,
                    interpret: bool = False):
    """DF1 bank with *runtime* coefficients: a (5,) vector shared across
    channels (the reference's atomic-swap property, biquad.rs:34-36) or
    (5, c) per-channel filters.  Bit-identical to `df1_bank_q`."""
    return _coef_bank(_planes(ba_planes, xs.shape[1]), state, xs, f, None,
                      kind="plain", interpret=interpret)


def df1_clamp_bank_q_coef(ba_planes, state: Df1State, xs, f: int = 29, *,
                          u: int = 0, lo: int, hi: int,
                          interpret: bool = False):
    """Clamped DF1 bank with runtime coefficients; the clamp bounds stay
    static (range constants, biquad.rs:121-157)."""
    return _coef_bank(_planes(ba_planes, xs.shape[1]), state, xs, f,
                      (int(u), int(lo), int(hi)), kind="clamp",
                      interpret=interpret)


def df1_wide_bank_coef(ba_planes, state, xs, f: int = 29, *, clamp=None,
                       interpret: bool = False):
    """Wide-state DF1 bank with runtime coefficients.  Bit-identical to
    `df1_wide_bank`."""
    return _coef_bank(_planes(ba_planes, xs.shape[1]), state, xs, f,
                      _clamp(clamp), kind="wide", interpret=interpret)


def df1_dither_bank_coef(ba_planes, state, xs, f: int = 29, *, clamp=None,
                         interpret: bool = False):
    """Noise-shaping DF1 bank with runtime coefficients.  Bit-identical
    to `df1_dither_bank`."""
    return _coef_bank(_planes(ba_planes, xs.shape[1]), state, xs, f,
                      _clamp(clamp), kind="dither", interpret=interpret)


@functools.partial(
    jax.jit, static_argnames=("f", "clamp", "kind", "interpret")
)
def _coef_bank(ba, state, xs, f, clamp, *, kind, interpret):
    def step(carry, x):
        b, s = carry
        if kind == "plain":
            s, y = biquad.df1_step_q(b, f, s, x)
        elif kind == "clamp":
            u, lo, hi = (np.int32(v) for v in clamp)
            s, y = biquad.clamp_step(biquad.df1_step_q(b, f, s, x), u, lo, hi)
        elif kind == "wide":
            s, y = _wide_step(b, f, clamp)(s, x)
        else:
            s, y = _dither_step(b, f, clamp)(s, x)
        return (b, s), y

    (_, state), ys = seq_bank(step, (ba, state), xs, interpret=interpret)
    return state, ys
