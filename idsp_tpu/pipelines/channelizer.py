"""Maximally decimated polyphase analysis channel bank.

Equivalent of reference examples/polyphase_channelizer.rs,
generalized from the fixed 4-channel DFT4 to any power-of-two M (the
BASELINE #5 wideband bank uses M=1024): the polyphase FIR is M parallel
decimated FIRs (one per phase) over the frame axis — shifted-slice FMAs
like the HBF stages — and the DFT across channels is a matmul against
the M x M DFT matrix or an FFT for large M.

Sign convention matches the reference's hand-unrolled DFT4
(polyphase_channelizer.rs:77-101): y[m] = sum_k x_k * exp(-j*2*pi*k*m/M)
(unnormalized forward DFT).
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp


def prototype(m: int = 4, taps: int = 8) -> np.ndarray:
    """Hamming-windowed sinc prototype, DC-normalized
    (polyphase_channelizer.rs:29-44)."""
    n = m * taps
    fc = 0.5 / m * 0.9
    mid = (n - 1) / 2.0
    i = np.arange(n, dtype=np.float64)
    x = 2.0 * np.pi * fc * (i - mid)
    sinc = np.where(x == 0.0, 1.0, np.sin(x) / np.where(x == 0.0, 1.0, x))
    w = 0.54 - 0.46 * np.cos(2.0 * np.pi * i / (n - 1))
    h = 2.0 * fc * sinc * w
    return (h / h.sum()).astype(np.float32)


class BankState(NamedTuple):
    """Polyphase FIR history: (taps-1) carried frames, each (M, 2) IQ."""

    hist: jax.Array  # (..., taps-1, m, 2)


def init(m: int = 4, taps: int = 8, shape=(), dtype=jnp.float32) -> BankState:
    return BankState(hist=jnp.zeros(shape + (taps - 1, m, 2), dtype))


def _precision(dtype):
    """f32 operands multiply in full f32 (the GPU default would round
    them to TF32); bf16 operands are the explicit fast opt-in."""
    if jnp.dtype(dtype) == jnp.float32:
        return jax.lax.Precision.HIGHEST
    return jax.lax.Precision.DEFAULT


@lru_cache(maxsize=None)
def _dft_matrix(m: int) -> np.ndarray:
    """(m, m) forward (negative-exponent) DFT matrix."""
    k = np.arange(m)
    w = np.exp(-2j * np.pi * np.outer(k, k) / m)
    return w.astype(np.complex64)


class PlanesState(NamedTuple):
    """Polyphase FIR history as separate I/Q planes: (..., taps-1, m)
    each (m contiguous, frames major; no trailing size-2 axis)."""

    hist_r: jax.Array
    hist_i: jax.Array


def init_planes(m: int = 4, taps: int = 8, shape=(),
                dtype=jnp.float32) -> PlanesState:
    z = jnp.zeros(shape + (taps - 1, m), dtype)
    return PlanesState(hist_r=z, hist_i=z)


def channelize_planes(state: PlanesState, zr, zi, proto=None, *,
                      m: int = 4, taps: int = 8, dft: str = "matmul",
                      twiddle_dtype=jnp.float32):
    """Plane-layout analysis bank.

    Args:
      zr, zi: (..., n, m) I/Q planes of the frame stream (m polyphase
        branches on the minor axis).
      dft: "matmul" (one real (n, 2m) x (2m, 2m) block matmul) or "fft".
      twiddle_dtype: matmul-path precision.  f32 runs the product in
        full f32 (``Precision.HIGHEST``: no TF32 rounding of the
        operands); bf16 rounds the DFT matrix AND the FIR-accumulated
        data planes to bf16, i.e. ~2^-8 relative error on each — fine
        for the reference's >=10x bin-power gate
        (polyphase_channelizer.rs:166-178) but NOT for high-dynamic-range
        bins; opt-in for that reason.

    Returns (state, yr, yi) with y planes shaped like the inputs.
    The math matches `channelize` exactly (same FIR order, same
    einsum contractions) — only the memory layout differs.
    """
    if proto is None:
        proto = prototype(m, taps)
    coeff = np.asarray(proto, np.float32).reshape(taps, m)
    n = zr.shape[-2]

    extr = jnp.concatenate([state.hist_r, zr], axis=-2)
    exti = jnp.concatenate([state.hist_i, zi], axis=-2)
    accr = accti = None
    # y[t] = sum_tap coeff[tap] * frame[t - tap]; tap 0 = newest frame.
    for tap in range(taps):
        cr = jnp.asarray(coeff[tap])
        slr = jax.lax.slice_in_dim(
            extr, taps - 1 - tap, taps - 1 - tap + n, axis=-2)
        sli = jax.lax.slice_in_dim(
            exti, taps - 1 - tap, taps - 1 - tap + n, axis=-2)
        tr, ti = slr * cr, sli * cr
        accr = tr if accr is None else accr + tr
        accti = ti if accti is None else accti + ti
    new_state = PlanesState(
        hist_r=jax.lax.slice_in_dim(extr, n, taps - 1 + n, axis=-2),
        hist_i=jax.lax.slice_in_dim(exti, n, taps - 1 + n, axis=-2),
    )

    if dft == "fft":
        z = accr + 1j * accti
        zf = jnp.fft.fft(z.astype(jnp.complex64), axis=-1)
        return (new_state, zf.real.astype(jnp.float32),
                zf.imag.astype(jnp.float32))

    # DFT across the channel axis: y[m] = sum_k x[k] e^{-2pi i k m / M},
    # as ONE real (n, 2m) x (2m, 2m) block matmul
    #   [yr yi] = [ar ai] @ [[wr, wi], [-wi, wr]]
    # — same FLOPs as the four (n,m)x(m,m) real matmuls, one pass over
    # the planes.  The plane dataflow still matches the tensor-parallel
    # path `channelize_tp` (tested in tests/test_aux.py).
    w = _dft_matrix(m)
    wr = np.real(w).astype(np.float32)
    wi = np.imag(w).astype(np.float32)
    tw = jnp.dtype(twiddle_dtype)
    wblk = jnp.asarray(np.block([[wr, wi], [-wi, wr]])).astype(tw)
    ab = jnp.concatenate([accr, accti], axis=-1).astype(tw)
    y = jnp.einsum("...k,km->...m", ab, wblk,
                   preferred_element_type=jnp.float32,
                   precision=_precision(tw))
    return (new_state, y[..., :m], y[..., m:])


def channelize(state: BankState, x, proto=None, *, m: int = 4, taps: int = 8,
               dft: str = "matmul"):
    """Process (..., n_frames, m, 2) input frames (polyphase FIR + DFT).

    The frame-major input is the reference's `View::from_frames` layout
    (polyphase_channelizer.rs:103-119).  Returns (state, y) with y of
    the same shape: per frame, M channel IQ pairs.

    Internally this splits into I/Q planes at the boundary and runs
    `channelize_planes`; the stack/split costs one transpose pair, so
    large-M callers should feed planes directly.

    ``dft``: "matmul" (real-plane matmuls in full f32 — exact control of
    summation order, matches `channelize_tp`) or "fft" (jnp.fft along
    the branch axis — O(M log M); same negative-exponent convention,
    differs from matmul only by f32 summation order).
    """
    pst = PlanesState(hist_r=state.hist[..., 0], hist_i=state.hist[..., 1])
    pst, yr, yi = channelize_planes(
        pst, x[..., 0], x[..., 1], proto, m=m, taps=taps, dft=dft)
    new_hist = jnp.stack([pst.hist_r, pst.hist_i], axis=-1)
    y = jnp.stack([yr, yi], axis=-1)
    return BankState(hist=new_hist), y


def channelize_tp(state: BankState, x_local, axis_name: str, *, m: int,
                  taps: int = 8, proto=None, out_mode: str = "replicated"):
    """Tensor-parallel channelizer: the DFT *contraction* axis (the
    polyphase branches k) sharded over the mesh.

    Each device runs the polyphase FIR on its ``m/n_dev`` branch slice
    and contributes a partial DFT for ALL output channels; one `psum`
    combines the partials — the canonical TP-matmul pattern (shard the
    contraction axis, all-reduce the output), applied to the
    channelizer's DFT (polyphase_channelizer.rs:77-101).

    Runs inside `shard_map`.  Args:
      state: per-device BankState with hist (..., taps-1, m_loc, 2).
      x_local: (..., n, m_loc, 2) — this device's branch slice of the
        (..., n, m, 2) frame stream.

    Returns (state, y).  ``out_mode="replicated"`` (default) psums the
    partials so y is the full (..., n, m, 2) on every device;
    ``out_mode="scatter"`` uses `psum_scatter` over the output-channel
    axis instead, returning this device's (..., n, m/n_dev, 2) slice —
    1/n_dev the collective bytes on the wire (reduce-scatter vs
    all-reduce), the right choice when the consumer is itself
    channel-sharded (VERDICT r4 #6).  Matches `channelize` up to float
    summation order (the collective reassociates the k-sum across
    devices).
    """
    import jax.numpy as _jnp

    n_dev = jax.lax.axis_size(axis_name)
    idx = jax.lax.axis_index(axis_name)
    assert m % n_dev == 0 or n_dev == 1
    m_loc = x_local.shape[-2]
    if proto is None:
        proto = prototype(m, taps)
    coeff_full = jnp.asarray(
        np.asarray(proto, np.float32).reshape(taps, m)
    )
    coeff = jax.lax.dynamic_slice_in_dim(
        coeff_full, idx * m_loc, m_loc, axis=1
    )  # (taps, m_loc)

    n = x_local.shape[-3]
    ext = jnp.concatenate([state.hist, x_local], axis=-3)
    acc = None
    for tap in range(taps):
        sl = jax.lax.slice_in_dim(
            ext, taps - 1 - tap, taps - 1 - tap + n, axis=-3
        )
        term = sl * coeff[tap][:, None]
        acc = term if acc is None else acc + term
    new_hist = jax.lax.slice_in_dim(ext, n, taps - 1 + n, axis=-3)

    # partial DFT from our k rows, real/imag planes (complex psum under
    # shard_map is avoided)
    w = _dft_matrix(m)
    wr = jax.lax.dynamic_slice_in_dim(
        jnp.asarray(np.real(w).astype(np.float32)), idx * m_loc, m_loc, 0
    )
    wi = jax.lax.dynamic_slice_in_dim(
        jnp.asarray(np.imag(w).astype(np.float32)), idx * m_loc, m_loc, 0
    )
    zr = acc[..., 0]
    zi = acc[..., 1]  # (..., n, m_loc)
    hi = jax.lax.Precision.HIGHEST
    yr = _jnp.einsum("...k,km->...m", zr, wr, precision=hi) - _jnp.einsum(
        "...k,km->...m", zi, wi, precision=hi
    )
    yi = _jnp.einsum("...k,km->...m", zr, wi, precision=hi) + _jnp.einsum(
        "...k,km->...m", zi, wr, precision=hi
    )
    stacked = jnp.stack([yr, yi], axis=-1)
    if out_mode == "scatter":
        y = jax.lax.psum_scatter(
            stacked, axis_name, scatter_dimension=stacked.ndim - 2,
            tiled=True)
    elif out_mode == "replicated":
        y = jax.lax.psum(stacked, axis_name)
    else:
        raise ValueError(f"unknown out_mode {out_mode!r}")
    return BankState(hist=new_hist), y


def frames_from_stream(x_iq, m: int):
    """(..., n*m, 2) interleaved IQ stream -> (..., n, m, 2) frames."""
    t = x_iq.shape[-2]
    assert t % m == 0
    return x_iq.reshape(*x_iq.shape[:-2], t // m, m, 2)


def planes_from_stream(x_re, x_im, m: int):
    """(..., n*m) I/Q plane streams -> ((..., n, m), (..., n, m)) frames
    — the `channelize_planes` input layout (pure reshapes)."""
    t = x_re.shape[-1]
    assert t % m == 0
    shp = x_re.shape[:-1] + (t // m, m)
    return x_re.reshape(shp), x_im.reshape(shp)


def tone(freq: float, n: int):
    """Unit complex tone fixture (polyphase_channelizer.rs:124-128)."""
    i = np.arange(n, dtype=np.float64)
    ph = 2.0 * np.pi * freq * i
    return jnp.asarray(
        np.stack([np.cos(ph), np.sin(ph)], axis=-1).astype(np.float32)
    )


def channel_powers(freq: float, m: int = 4, taps: int = 8, n: int = 4096):
    """Mean per-channel power of a tone (polyphase_channelizer.rs:
    133-146), skipping the first 128 frames."""
    x = frames_from_stream(tone(freq, n), m)
    st = init(m, taps)
    _, y = channelize(st, x, m=m, taps=taps)
    y = np.asarray(y, np.float64)[128:]
    p = (y**2).sum(axis=-1).mean(axis=0)
    return p
