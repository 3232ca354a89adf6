"""Biquad IIR (second-order sections) over five state architectures.

Equivalent of reference src/iir/biquad.rs.  Coefficients are
``ba = [b0, b1, b2, a1, a2]`` with the recurrence sign convention of the
reference (biquad.rs:96-116):

    y0 = (b0*x0 + b1*x1 + b2*x2 + a1*y1 + a2*y2) >> F        (fixed point)
    y0 =  b0*x0 + b1*x1 + b2*x2 + a1*y1 + a2*y2              (float)

Cookbook `[[b0,b1,b2],[a0,a1,a2]]` literature coefficients normalize via
`from_cookbook` (biquad.rs:544-566: divide by a0, negate a1/a2).

Architectures (biquad.rs:258-538):

* DF1 (float or Q32): 2+2 delay line, single summing junction, atomic
  coefficient swap.
* DF2T (float only): 2-element state.
* DF1 wide: i64 y-state with split-word a*y multiply — full-precision
  feedback.
* DF1 dither: first-order error feedback (noise shaping) on the
  truncation.
* Clamp variants: offset u + output clamp before feedback (anti-windup).

Block paths:

* Float biquads use an associative-scan formulation (the 2nd-order
  recurrence as an affine 2x2 matrix scan) — O(log n) depth.
  Bit-identical to the sequential float scan is NOT guaranteed (FP
  reassociation); equivalence is gated at tolerance in tests.
* Fixed-point paths quantize inside the recurrence (truncation is
  nonlinear), so time stays sequential (`lax.scan`); throughput comes
  from running channels side by side, in the lane-bank kernel on the
  GPU (`idsp_tpu.filters.biquad_pallas`).

All step functions are elementwise in any leading batch (channel) shape:
state arrays have shape (..., 2) etc., and x has shape (...,).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import fxp


# --- coefficients -----------------------------------------------------------


def from_cookbook(ba: np.ndarray) -> np.ndarray:
    """Normalize `[[b0,b1,b2],[a0,a1,a2]]` cookbook coefficients to the
    recurrence form `[b0,b1,b2,a1,a2]/a0` with flipped feedback signs
    (biquad.rs:544-566)."""
    ba = np.asarray(ba, dtype=np.float64)
    inv_a0 = 1.0 / ba[..., 1, 0]
    return np.stack(
        [
            ba[..., 0, 0] * inv_a0,
            ba[..., 0, 1] * inv_a0,
            ba[..., 0, 2] * inv_a0,
            -ba[..., 1, 1] * inv_a0,
            -ba[..., 1, 2] * inv_a0,
        ],
        axis=-1,
    )


def quantize_ba(ba5: np.ndarray, f: int, *, dtype=jnp.int32) -> np.ndarray:
    """Quantize normalized float coefficients to Q<f> bits
    (round-half-away encode, num_traits_impl.rs:30-45)."""
    return fxp.from_float(ba5, f, dtype=dtype)


def proportional(k):
    """[k, 0, 0, 0, 0] (biquad.rs:185-198)."""
    ba = np.zeros(5, dtype=np.asarray(k).dtype)
    ba[0] = k
    return ba


def identity(dtype=np.float64):
    return proportional(np.asarray(1.0, dtype=dtype))


def hold(dtype=np.float64):
    """Ingest input, maintain output: [0,0,0,1,0] (biquad.rs:199-212)."""
    ba = np.zeros(5, dtype=dtype)
    ba[3] = 1.0
    return ba


def forward_gain(ba5):
    """b0+b1+b2 (biquad.rs:215-225)."""
    return ba5[..., 0] + ba5[..., 1] + ba5[..., 2]


def from_zpk(zeros, poles, gain, *, complex_zeros=False, complex_poles=False):
    """Biquad from a zero pair, pole pair, and gain (biquad.rs:590-619).

    Pairs are (x, y): real pairs give roots x and y; complex pairs give
    x ± jy.  Matches `Pair::coeff` + `from_zpk`.
    """

    def coeff(pair, is_complex):
        x, y = pair
        if is_complex:
            return x + x, x * x + y * y
        return x + y, x * y

    b = [c * gain for c in coeff(zeros, complex_zeros)]
    a = coeff(poles, complex_poles)
    return np.array([gain, -b[0], b[1], a[0], -a[1]], dtype=np.float64)


# --- DF1 --------------------------------------------------------------------


class Df1State(NamedTuple):
    """[x1, x2] and [y1, y2] delay lines (biquad.rs:258-303)."""

    x: jax.Array  # (..., 2)
    y: jax.Array  # (..., 2)


def df1_init(shape=(), dtype=jnp.float32) -> Df1State:
    return Df1State(
        x=jnp.zeros(shape + (2,), dtype),
        y=jnp.zeros(shape + (2,), dtype),
    )


def df1_set_y(state: Df1State, y0) -> Df1State:
    """Bump-less transfer: seed both output taps (biquad.rs:295-302)."""
    y0 = jnp.asarray(y0, state.y.dtype)
    return state._replace(y=jnp.stack([y0, y0], axis=-1))


def df1_step(ba, state: Df1State, x0):
    """Float DF1 step (biquad.rs:366-383)."""
    y0 = (
        ba[..., 0] * x0
        + ba[..., 1] * state.x[..., 0]
        + ba[..., 2] * state.x[..., 1]
        + ba[..., 3] * state.y[..., 0]
        + ba[..., 4] * state.y[..., 1]
    )
    return (
        Df1State(
            x=jnp.stack([x0, state.x[..., 0]], axis=-1),
            y=jnp.stack([y0, state.y[..., 0]], axis=-1),
        ),
        y0,
    )


def df1_step_q(ba, f: int, state: Df1State, x0, *, dtype=jnp.int32):
    """Fixed-point DF1 step: 5 wide MACs in the accumulator, one
    truncating shift (biquad.rs:366-383 with `Q<i32,i64,F>` coeffs)."""
    acc = (
        fxp.mul_wide(ba[..., 0], x0, dtype=dtype)
        + fxp.mul_wide(ba[..., 1], state.x[..., 0], dtype=dtype)
        + fxp.mul_wide(ba[..., 2], state.x[..., 1], dtype=dtype)
        + fxp.mul_wide(ba[..., 3], state.y[..., 0], dtype=dtype)
        + fxp.mul_wide(ba[..., 4], state.y[..., 1], dtype=dtype)
    )
    y0 = fxp.quantize(acc, f, dtype=dtype)
    return (
        Df1State(
            x=jnp.stack([x0, state.x[..., 0]], axis=-1),
            y=jnp.stack([y0, state.y[..., 0]], axis=-1),
        ),
        y0,
    )


def clamp_step(step_out, u, lo, hi):
    """Offset + clamp applied at the summing junction with the clamped
    output overwritten into the feedback state (biquad.rs:394-404)."""
    state, y0 = step_out
    y0 = jnp.clip(y0 + u, lo, hi)
    y = jnp.stack([y0, state.y[..., 1]], axis=-1)
    return state._replace(y=y), y0


# --- DF2T (float) -----------------------------------------------------------


class Df2tState(NamedTuple):
    s: jax.Array  # (..., 2)


def df2t_init(shape=(), dtype=jnp.float32) -> Df2tState:
    return Df2tState(s=jnp.zeros(shape + (2,), dtype))


def df2t_step(ba, state: Df2tState, x0):
    """DF2T step (biquad.rs:418-428)."""
    y0 = state.s[..., 0] + ba[..., 0] * x0
    s0 = state.s[..., 1] + ba[..., 1] * x0 + ba[..., 3] * y0
    s1 = ba[..., 2] * x0 + ba[..., 4] * y0
    return Df2tState(s=jnp.stack([s0, s1], axis=-1)), y0


def df2t_clamp_step(ba, state: Df2tState, x0, u, lo, hi):
    """DF2T with offset+clamp at the junction (biquad.rs:430-440)."""
    y0 = jnp.clip(state.s[..., 0] + ba[..., 0] * x0 + u, lo, hi)
    s0 = state.s[..., 1] + ba[..., 1] * x0 + ba[..., 3] * y0
    s1 = ba[..., 2] * x0 + ba[..., 4] * y0
    return Df2tState(s=jnp.stack([s0, s1], axis=-1)), y0


# --- DF1 wide (i64 feedback state) ------------------------------------------


class Df1WideState(NamedTuple):
    x: jax.Array  # (..., 2) i32
    y: jax.Array  # (..., 2) i64


def df1_wide_init(shape=()) -> Df1WideState:
    return Df1WideState(
        x=jnp.zeros(shape + (2,), jnp.int32),
        y=jnp.zeros(shape + (2,), jnp.int64),
    )


def df1_wide_step(ba, f: int, state: Df1WideState, x0):
    """Wide-state DF1 step (biquad.rs:456-472).

    The b*x products accumulate normally; a*y uses the split-word
    multiply: (y_lo_unsigned * a) >> 32 + y_hi_signed * a, keeping the
    full i64 output word in feedback (first-order noise shaping built
    into the state).  acc is left-shifted by 32-F, the output is the
    high word.
    """
    b_acc = (
        fxp.mul_wide(ba[..., 0], x0)
        + fxp.mul_wide(ba[..., 1], state.x[..., 0])
        + fxp.mul_wide(ba[..., 2], state.x[..., 1])
    )
    a3 = ba[..., 3].astype(jnp.int64)
    a4 = ba[..., 4].astype(jnp.int64)
    y0w, y1w = state.y[..., 0], state.y[..., 1]

    def split_mul(yw, a):
        lo = (yw & 0xFFFFFFFF).astype(jnp.int64)  # unsigned low word
        hi = (yw >> 32).astype(jnp.int32).astype(jnp.int64)
        return ((lo * a) >> 32) + hi * a

    acc = b_acc + split_mul(y0w, a3) + split_mul(y1w, a4)
    acc = acc << (32 - f)
    return (
        Df1WideState(
            x=jnp.stack([x0, state.x[..., 0]], axis=-1),
            y=jnp.stack([acc, y0w], axis=-1),
        ),
        (acc >> 32).astype(jnp.int32),
    )


def df1_wide_clamp_step(ba, f: int, state: Df1WideState, x0, u, lo, hi):
    """Clamped wide DF1 (biquad.rs:474-480): the clamped output replaces
    the high word of the wide feedback state."""
    state, y0 = df1_wide_step(ba, f, state, x0)
    y0 = jnp.clip(y0 + u, lo, hi).astype(jnp.int32)
    y0w = (y0.astype(jnp.int64) << 32) | (state.y[..., 0] & 0xFFFFFFFF)
    y = jnp.stack([y0w, state.y[..., 1]], axis=-1)
    return state._replace(y=y), y0


# --- DF1 dither (error feedback) --------------------------------------------


class Df1DitherState(NamedTuple):
    xy: Df1State  # i32 delay lines
    e: jax.Array  # (...,) u32 error feedback


def df1_dither_init(shape=()) -> Df1DitherState:
    return Df1DitherState(
        xy=df1_init(shape, jnp.int32),
        e=jnp.zeros(shape, jnp.uint32),
    )


def df1_dither_step(ba, f: int, state: Df1DitherState, x0):
    """DF1 with first-order error feedback (biquad.rs:511-530): the
    truncated fraction re-enters the accumulator next sample."""
    xy = state.xy
    acc = (
        state.e.astype(jnp.int64)
        + fxp.mul_wide(ba[..., 0], x0)
        + fxp.mul_wide(ba[..., 1], xy.x[..., 0])
        + fxp.mul_wide(ba[..., 2], xy.x[..., 1])
        + fxp.mul_wide(ba[..., 3], xy.y[..., 0])
        + fxp.mul_wide(ba[..., 4], xy.y[..., 1])
    )
    acc = acc << (32 - f)
    e = (acc.astype(jnp.uint64) & 0xFFFFFFFF).astype(jnp.uint32) >> (32 - f)
    y0 = (acc >> 32).astype(jnp.int32)
    return (
        Df1DitherState(
            xy=Df1State(
                x=jnp.stack([x0, xy.x[..., 0]], axis=-1),
                y=jnp.stack([y0, xy.y[..., 0]], axis=-1),
            ),
            e=e,
        ),
        y0,
    )


def df1_dither_clamp_step(ba, f: int, state: Df1DitherState, x0, u, lo, hi):
    """Clamped dithered DF1 (biquad.rs:532-538)."""
    state, y0 = df1_dither_step(ba, f, state, x0)
    y0 = jnp.clip(y0 + u, lo, hi).astype(jnp.int32)
    xy = state.xy._replace(y=jnp.stack([y0, state.xy.y[..., 1]], axis=-1))
    return state._replace(xy=xy), y0


# --- Q64 (i64 storage, emulated i128 accumulator) ---------------------------


# The 128-bit limb helpers live in fxp (one authoritative
# implementation; a second copy here once diverged-by-construction —
# the Q64 bit-exactness convention depends on every path sharing it).
_mul_i64_i64_hi_lo = fxp._mul_i64_wide
_add_i128 = fxp.i128_add
_shr_i128_to_i64 = fxp._shr_i128_to_i64


def df1_step_q64(ba, f: int, state: Df1State, x0):
    """Q64-class DF1 step: i64 storage, 128-bit accumulation
    (the reference's `Q64<61>` row, tests/embedded/README.md:63,
    `Q<i64, i128, F>` per dsp-fixedpoint/src/lib.rs:473-492)."""
    hi_lo = _mul_i64_i64_hi_lo(ba[..., 0], x0)
    for i, v in (
        (1, state.x[..., 0]),
        (2, state.x[..., 1]),
        (3, state.y[..., 0]),
        (4, state.y[..., 1]),
    ):
        hi_lo = _add_i128(hi_lo, _mul_i64_i64_hi_lo(ba[..., i], v))
    y0 = _shr_i128_to_i64(hi_lo[0], hi_lo[1], f)
    return (
        Df1State(
            x=jnp.stack([x0, state.x[..., 0]], axis=-1),
            y=jnp.stack([y0, state.y[..., 0]], axis=-1),
        ),
        y0,
    )


def df1_process_q64(ba, f: int, state, xs, *, unroll: int = 8):
    ba = jnp.asarray(ba, jnp.int64)
    return jax.lax.scan(
        lambda s, x: df1_step_q64(ba, f, s, jnp.asarray(x, jnp.int64)),
        state, xs, unroll=unroll,
    )


# --- block paths ------------------------------------------------------------


def _affine_combine(a, b):
    """Compose affine maps s -> M s + v for the 2nd-order feedback
    recurrence, with the 2x2 matrix and 2-vector held as SIX separate
    (n, ...) component arrays rather than trailing (2, 2) axes."""
    a11, a12, a21, a22, u1, u2 = a
    b11, b12, b21, b22, w1, w2 = b
    return (
        b11 * a11 + b12 * a21,
        b11 * a12 + b12 * a22,
        b21 * a11 + b22 * a21,
        b21 * a12 + b22 * a22,
        b11 * u1 + b12 * u2 + w1,
        b21 * u1 + b22 * u2 + w2,
    )


def df1_block_float(ba, state: Df1State, xs):
    """Fused float DF1 over a block: FIR feed-forward as a shifted-window
    sum, then the 2nd-order feedback as an associative affine scan.

    xs: (n, ...) time-major.  Returns (state, ys) matching `df1_step`
    scanned over xs up to FP reassociation.
    """
    n = xs.shape[0]
    x1 = jnp.concatenate([state.x[None, ..., 0], xs[:-1]], axis=0)
    x2 = jnp.concatenate(
        [state.x[None, ..., 1], state.x[None, ..., 0], xs[:-2]], axis=0
    )[:n]
    v = ba[..., 0] * xs + ba[..., 1] * x1 + ba[..., 2] * x2

    # per-step affine map: M = [[a1, a2], [1, 0]], v = [v, 0]
    shape = v.shape
    a1 = jnp.broadcast_to(ba[..., 3], shape)
    a2 = jnp.broadcast_to(ba[..., 4], shape)
    one = jnp.ones_like(v)
    zero = jnp.zeros_like(v)
    elems = (a1, a2, one, zero, v, zero)

    m11, m12, m21, m22, v1, v2 = jax.lax.associative_scan(
        _affine_combine, elems, axis=0
    )
    y1_0 = state.y[..., 0]
    y2_0 = state.y[..., 1]
    ys = m11 * y1_0 + m12 * y2_0 + v1  # current outputs y[k]
    ys_prev = m21 * y1_0 + m22 * y2_0 + v2  # y[k-1]

    new_state = Df1State(
        x=jnp.stack(
            [xs[-1], xs[-2] if n >= 2 else state.x[..., 0]], axis=-1
        ),
        y=jnp.stack([ys[-1], ys_prev[-1]], axis=-1),
    )
    return new_state, ys


# --- cascades ---------------------------------------------------------------


def cascade_init(n_stages: int, shape=(), dtype=jnp.float32) -> Df1State:
    """Interleaved cascade state: x (..., 2) + y (..., n_stages, 2)
    (biquad.rs:321-364 `DirectForm<T, N>`)."""
    return Df1State(
        x=jnp.zeros(shape + (2,), dtype),
        y=jnp.zeros(shape + (n_stages, 2), dtype),
    )


def cascade_step(ba, state: Df1State, x0):
    """One sample through an N-stage float cascade (biquad.rs:339-364).
    ba: (n_stages, ..., 5)."""
    n = ba.shape[0]
    x = state.x
    ys = []
    cur = x0
    prev_x = x
    for i in range(n):
        y = state.y[..., i, :]
        y0 = (
            ba[i, ..., 0] * cur
            + ba[i, ..., 1] * prev_x[..., 0]
            + ba[i, ..., 2] * prev_x[..., 1]
            + ba[i, ..., 3] * y[..., 0]
            + ba[i, ..., 4] * y[..., 1]
        )
        new_prev = jnp.stack([cur, prev_x[..., 0]], axis=-1)
        if i == 0:
            new_x = new_prev
        prev_x = y
        ys.append(jnp.stack([y0, y[..., 0]], axis=-1))
        cur = y0
    return Df1State(x=new_x, y=jnp.stack(ys, axis=-2)), cur


def cascade_step_q(ba, f: int, state: Df1State, x0, *, dtype=jnp.int32):
    """Fixed-point cascade step (the `sos` path, src/py.rs:51-74 /
    biquad.rs:339-364): each stage quantizes at its summing junction."""
    n = ba.shape[0]
    ys = []
    cur = x0
    prev_x = state.x
    new_x = state.x
    for i in range(n):
        y = state.y[..., i, :]
        acc = (
            fxp.mul_wide(ba[i, ..., 0], cur, dtype=dtype)
            + fxp.mul_wide(ba[i, ..., 1], prev_x[..., 0], dtype=dtype)
            + fxp.mul_wide(ba[i, ..., 2], prev_x[..., 1], dtype=dtype)
            + fxp.mul_wide(ba[i, ..., 3], y[..., 0], dtype=dtype)
            + fxp.mul_wide(ba[i, ..., 4], y[..., 1], dtype=dtype)
        )
        y0 = fxp.quantize(acc, f, dtype=dtype)
        new_prev = jnp.stack([cur, prev_x[..., 0]], axis=-1)
        if i == 0:
            new_x = new_prev
        prev_x = y
        ys.append(jnp.stack([y0, y[..., 0]], axis=-1))
        cur = y0
    return Df1State(x=new_x, y=jnp.stack(ys, axis=-2)), cur


# --- scan drivers -----------------------------------------------------------


def process(step_fn, state, xs, *, unroll: int = 8):
    """Scan ``step_fn(state, x) -> (state, y)`` over time axis 0 of xs."""
    return jax.lax.scan(step_fn, state, xs, unroll=unroll)


def df1_process(ba, state, xs, *, unroll: int = 8):
    return jax.lax.scan(
        lambda s, x: df1_step(ba, s, x), state, xs, unroll=unroll
    )


def df1_process_q(ba, f: int, state, xs, *, unroll: int = 8):
    return jax.lax.scan(
        lambda s, x: df1_step_q(ba, f, s, x), state, xs, unroll=unroll
    )
