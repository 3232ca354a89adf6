"""Half-band FIR filters and power-of-two rate-change cascades.

Equivalent of reference src/hbf.rs.  The reference processes
ring-buffered blocks with an explicit scratch pipeline (`Major`/
`ChunkIn`); here each stage is a vectorized symmetric-FIR over a
tail-extended block (overlap-save): the carried state is exactly the
impulse-response tail (hbf.rs:93-101 `copy_within`), and the convolution
is M shifted-slice multiply-adds fused by XLA (M = 2..23).

Conventions:
* time on the LAST axis (lanes) by default; leading axes are channels.
  Every block/cascade also takes ``axis=0`` for a time-major (t, c)
  layout (shifted slices along the major axis) — used by the DDC chain
  to skip the (t, c) -> (c, t) transpose.
* a decimator consumes 2n samples -> n, an interpolator n -> 2n.
* tap tables `HBF_TAPS` / `HBF_TAPS_98` are the published filter
  designs from the reference (hbf.rs:258-349; scipy remez, 140 dB /
  98 dB stopband) — data constants, cited.

Four linear-phase FIR types (hbf.rs:70-138): odd/even x symmetric/
antisymmetric, with the shared small-to-large-tap summation order of
`get` (hbf.rs:46-68) to minimize FP cancellation.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

# --- tap tables (hbf.rs:258-349) --------------------------------------------

#: 140 dB-stopband half-band cascade taps (hbf.rs:308-349), lowest rate
#: first; stage i has one-sided tap count (23, 10, 5, 4, 3).
HBF_TAPS: tuple[np.ndarray, ...] = tuple(
    np.array(t, dtype=np.float32)
    for t in (
        [
            7.60375795e-07, -3.77494111e-06, 1.26458559e-05, -3.43188253e-05,
            8.10687478e-05, -1.72971467e-04, 3.40845059e-04, -6.29522864e-04,
            1.10128831e-03, -1.83933299e-03, 2.95124926e-03, -4.57290964e-03,
            6.87374176e-03, -1.00656257e-02, 1.44199840e-02, -2.03025100e-02,
            2.82462332e-02, -3.91128509e-02, 5.44795658e-02, -7.77002672e-02,
            1.17523452e-01, -2.06185388e-01, 6.34588695e-01,
        ],
        [
            -1.12811343e-05, 1.12724671e-04, -6.07439343e-04, 2.31904511e-03,
            -7.00322950e-03, 1.78225473e-02, -4.01209836e-02, 8.43315989e-02,
            -1.83189521e-01, 6.26346521e-01,
        ],
        [0.0007686, -0.00768669, 0.0386536, -0.14002434, 0.60828885],
        [-0.00261331, 0.02476858, -0.12112638, 0.59897111],
        [0.01186105, -0.09808109, 0.58622005],
    )
)

#: 98 dB-stopband variant (hbf.rs:258-292), tap counts (15, 6, 3, 3, 2).
HBF_TAPS_98: tuple[np.ndarray, ...] = tuple(
    np.array(t, dtype=np.float32)
    for t in (
        [
            7.02144012e-05, -2.43279582e-04, 6.35026936e-04, -1.39782541e-03,
            2.74613582e-03, -4.96403839e-03, 8.41806912e-03, -1.35827601e-02,
            2.11004053e-02, -3.19267647e-02, 4.77024289e-02, -7.18014345e-02,
            1.12942004e-01, -2.03279594e-01, 6.33592923e-01,
        ],
        [-0.00086943, 0.00577837, -0.02201674, 0.06357869, -0.16627679, 0.61979312],
        [0.01414651, -0.10439639, 0.59026742],
        [0.01227974, -0.09930782, 0.58702834],
        [-0.06291796, 0.5629161],
    )
)

#: Passband width in units of the lowest sample rate (hbf.rs:352).
HBF_PASSBAND = 0.4


def fir_len(m: int, odd: bool) -> int:
    """Response length minus one: LEN = 2M - 1 + odd (hbf.rs:78)."""
    return 2 * m - 1 + int(odd)


def symmetric_fir(taps, x_ext, *, odd: bool, sym: bool, axis: int = -1):
    """Linear-phase FIR over a tail-extended block (hbf.rs:46-68).

    ``x_ext`` has ``n + LEN`` samples on the time axis; returns n outputs
    y[j] = sum_i c[i]*(x[j+L-i] +/- x[j+i]) (+ x[j+M] center for odd
    symmetric).  Taps run small (far from center) to large (center).

    ``axis`` selects the time axis: -1 (lanes; channels lead) or 0
    (time-major (t, c) — shifted slices run along the major axis, letting the
    chain skip the (t, c) -> (c, t) transpose entirely).
    """
    taps = np.asarray(taps)
    m = taps.shape[0]
    ln = fir_len(m, odd)
    n = x_ext.shape[axis] - ln
    acc = None
    for i in range(m):
        a = jax.lax.slice_in_dim(x_ext, i, i + n, axis=axis)
        b = jax.lax.slice_in_dim(x_ext, ln - i, ln - i + n, axis=axis)
        term = (b + a if sym else b - a) * taps[i]
        acc = term if acc is None else acc + term
    if odd and sym:
        acc = acc + jax.lax.slice_in_dim(x_ext, m, m + n, axis=axis)
    return acc


def fir_init(m: int, odd: bool, shape=(), dtype=jnp.float32, axis: int = -1):
    """Tail state for a plain (non-rate-changing) FIR stage: LEN samples
    on the time axis (last, or first for the time-major layout)."""
    ln = (fir_len(m, odd),)
    return jnp.zeros(ln + shape if axis == 0 else shape + ln, dtype)


def fir_block(taps, state, x, *, odd: bool, sym: bool, axis: int = -1):
    """Streaming FIR: prepend the carried tail, convolve, carry the new
    tail (the overlap-save form of hbf.rs:93-101).

    Returns (new_state, y) with y the same length as x.
    """
    ext = jnp.concatenate([state, x], axis=axis)
    y = symmetric_fir(taps, ext, odd=odd, sym=sym, axis=axis)
    ln = state.shape[axis]
    ne = ext.shape[axis]
    return jax.lax.slice_in_dim(ext, ne - ln, ne, axis=axis), y


# --- half-band decimator / interpolator (hbf.rs:140-236) --------------------


class HbfDecState(NamedTuple):
    """Odd-sample FIR tail (2M-1) + even-sample delay tail (M-1)."""

    odd: jax.Array
    even: jax.Array


def hbf_dec_init(m: int, shape=(), dtype=jnp.float32,
                 axis: int = -1) -> HbfDecState:
    if axis == 0:
        return HbfDecState(
            odd=jnp.zeros((2 * m - 1,) + shape, dtype),
            even=jnp.zeros((max(m - 1, 0),) + shape, dtype),
        )
    return HbfDecState(
        odd=jnp.zeros(shape + (2 * m - 1,), dtype),
        even=jnp.zeros(shape + (max(m - 1, 0),), dtype),
    )


def hbf_dec_block(taps, state: HbfDecState, x, *, axis: int = -1):
    """Decimate-by-2 (hbf.rs:156-192): even samples bypass through a
    center-tap delay of M-1, odd samples run the symmetric FIR.

    x: 2n full-rate samples on the time axis; returns (state, n).
    """
    taps = np.asarray(taps)
    m = taps.shape[0]
    n2 = x.shape[axis]
    even_new = jax.lax.slice_in_dim(x, 0, n2, stride=2, axis=axis)
    odd_new = jax.lax.slice_in_dim(x, 1, n2, stride=2, axis=axis)
    odd_ext = jnp.concatenate([state.odd, odd_new], axis=axis)
    even_ext = jnp.concatenate([state.even, even_new], axis=axis)
    y = symmetric_fir(taps, odd_ext, odd=False, sym=True, axis=axis)
    n = odd_new.shape[axis]
    y = y + jax.lax.slice_in_dim(even_ext, 0, n, axis=axis)
    return (
        HbfDecState(
            odd=jax.lax.slice_in_dim(
                odd_ext, n, odd_ext.shape[axis], axis=axis
            ),
            even=jax.lax.slice_in_dim(
                even_ext, n, even_ext.shape[axis], axis=axis
            ),
        ),
        y,
    )


class HbfIntState(NamedTuple):
    """Input FIR tail (2M-1 samples at the low rate)."""

    x: jax.Array


def hbf_int_init(m: int, shape=(), dtype=jnp.float32,
                 axis: int = -1) -> HbfIntState:
    if axis == 0:
        return HbfIntState(x=jnp.zeros((2 * m - 1,) + shape, dtype))
    return HbfIntState(x=jnp.zeros(shape + (2 * m - 1,), dtype))


def hbf_int_block(taps, state: HbfIntState, x, *, axis: int = -1):
    """Interpolate-by-2 (hbf.rs:208-236): FIR output in the even output
    slots, the M-delayed input (identity center tap) in the odd slots.

    x: n low-rate samples on the time axis; returns (state, 2n).
    """
    taps = np.asarray(taps)
    m = taps.shape[0]
    ext = jnp.concatenate([state.x, x], axis=axis)
    fir = symmetric_fir(taps, ext, odd=False, sym=True, axis=axis)
    n = x.shape[axis]
    center = jax.lax.slice_in_dim(ext, m, m + n, axis=axis)
    if axis == 0:
        y = jnp.stack([fir, center], axis=1).reshape(
            (2 * n,) + fir.shape[1:]
        )
        new_tail = jax.lax.slice_in_dim(ext, n, ext.shape[0], axis=0)
    else:
        y = jnp.stack([fir, center], axis=-1).reshape(
            *fir.shape[:-1], 2 * n
        )
        new_tail = ext[..., n:]
    return HbfIntState(x=new_tail), y


# --- cascades (hbf.rs:359-539) ----------------------------------------------


def hbf_dec_cascade_init(depth: int, shape=(), dtype=jnp.float32,
                         taps=HBF_TAPS, axis: int = -1):
    """States for a 2**depth decimation cascade (highest rate first)."""
    return tuple(
        hbf_dec_init(len(taps[d]), shape, dtype, axis=axis)
        for d in reversed(range(depth))
    )


def hbf_dec_cascade(states, x, taps=HBF_TAPS, *, axis: int = -1):
    """Decimate by 2**depth (depth = len(states)).

    Stage order is highest-rate/fewest-taps first (the reference's
    `HBF_DEC_CASCADE` nesting, hbf.rs:385-421): taps[depth-1] .. taps[0].
    """
    depth = len(states)
    new_states = []
    cur = x
    for i, st in enumerate(states):
        t = taps[depth - 1 - i]
        st2, cur = hbf_dec_block(t, st, cur, axis=axis)
        new_states.append(st2)
    return tuple(new_states), cur


def hbf_int_cascade_init(depth: int, shape=(), dtype=jnp.float32,
                         taps=HBF_TAPS, axis: int = -1):
    """States for a 2**depth interpolation cascade (lowest rate first)."""
    return tuple(
        hbf_int_init(len(taps[d]), shape, dtype, axis=axis)
        for d in range(depth)
    )


def hbf_int_cascade(states, x, taps=HBF_TAPS, *, axis: int = -1):
    """Interpolate by 2**depth: lowest-rate/most-taps stage first
    (hbf.rs:476-512)."""
    new_states = []
    cur = x
    for i, st in enumerate(states):
        st2, cur = hbf_int_block(taps[i], st, cur, axis=axis)
        new_states.append(st2)
    return tuple(new_states), cur


def hbf_dec_response_length(depth: int, taps=HBF_TAPS) -> int:
    """Effective tap count of the decimation cascade (hbf.rs:424-448)."""
    assert depth <= len(taps)
    n = 0
    for d in reversed(range(depth)):
        n //= 2
        n += fir_len(len(taps[d]), False)
    return n


def hbf_int_response_length(depth: int, taps=HBF_TAPS) -> int:
    """Effective tap count of the interpolation cascade
    (hbf.rs:515-539)."""
    assert depth <= len(taps)
    n = 0
    for d in range(depth):
        n += fir_len(len(taps[d]), False)
        n *= 2
    return n
