"""Dither PRNGs: xorshift32, uniform bytes, triangular (TPDF) dither.

Equivalent of reference src/dither.rs.  The xorshift32
recurrence (Marsaglia 13/17/5, dither.rs:24-31) is *linear over GF(2)*,
so a whole block of states can be produced with a logarithmic-depth
doubling scheme instead of a sequential scan: starting from the seed
state vector, repeatedly apply the 2^k-step transition (itself just k
squarings of the xorshift update on u32 words) to double the number of
known states.  This keeps the generator bit-exact with the reference
sequence while running wide across lanes.
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np


def _xorshift32_once(x):
    """One xorshift32 update on u32 word(s) (dither.rs:24-31)."""
    x = x ^ (x << 13)
    x = x ^ (x >> 17)
    x = x ^ (x << 5)
    return x


@lru_cache(maxsize=None)
def _step_matrix_pow(k: int) -> np.ndarray:
    """Column bit-matrix of the 2^k-step xorshift32 transition.

    mat[j] = T^(2^k) applied to the basis state (1 << j).  Because the
    map is GF(2)-linear, T^n(x) = XOR of mat[j] over set bits j of x.
    """
    if k == 0:
        basis = np.uint32(1) << np.arange(32, dtype=np.uint32)
        x = basis.copy()
        x ^= x << np.uint32(13)
        x ^= x >> np.uint32(17)
        x ^= x << np.uint32(5)
        return x
    prev = _step_matrix_pow(k - 1)
    # Square the matrix: apply T^(2^(k-1)) to each of its own columns.
    return _apply_matrix_np(prev, prev)


def _apply_matrix_np(mat: np.ndarray, x: np.ndarray) -> np.ndarray:
    out = np.zeros_like(x)
    for j in range(32):
        bit = (x >> np.uint32(j)) & np.uint32(1)
        out ^= bit * mat[j]
    return out


def _apply_matrix(mat, x):
    """XOR-accumulate matrix columns selected by the bits of x (batched)."""
    out = jnp.zeros_like(x)
    for j in range(32):
        bit = (x >> j) & jnp.uint32(1)
        out = out ^ (bit * mat[j])
    return out


def xorshift32_block(seed, n: int):
    """The first ``n`` xorshift32 outputs after ``seed``, bit-exact with
    n calls of `XorShift32::sample` (dither.rs:24-31).

    Zero seeds are remapped to 1 (the all-zero state is absorbing,
    dither.rs:17-21).

    Args:
      seed: scalar or (...,) uint32 array of per-lane seeds.
      n: static number of samples per lane.

    Returns:
      (..., n) uint32 samples; ``out[..., -1]`` is the carry seed for the
      next block.
    """
    seed = jnp.asarray(seed, dtype=jnp.uint32)
    seed = jnp.where(seed == 0, jnp.uint32(1), seed)
    # states[..., 0] = T(seed); double until >= n entries.
    states = _xorshift32_once(seed)[..., None]
    k = 0
    while states.shape[-1] < n:
        mat = jnp.asarray(_step_matrix_pow(k))
        states = jnp.concatenate([states, _apply_matrix(mat, states)], axis=-1)
        k += 1
    return states[..., :n]


def uniform_bytes_block(seed, n: int):
    """``n`` uniform bytes per lane, matching `Uniform` (dither.rs:50-62):
    each u32 sample yields 4 bytes, LSB first."""
    words = xorshift32_block(seed, (n + 3) // 4)
    shifts = jnp.arange(4, dtype=jnp.uint32) * 8
    bytes_ = ((words[..., :, None] >> shifts) & jnp.uint32(0xFF)).astype(jnp.uint8)
    flat = bytes_.reshape(*bytes_.shape[:-2], -1)
    return flat[..., :n]


def triangular_block(seed, n: int):
    """``n`` TPDF dither samples in [-256, 255], matching `Triangular`
    (dither.rs:78-83): difference of two successive uniform bytes
    reinterpreted as i8."""
    b = uniform_bytes_block(seed, 2 * n).astype(jnp.int8).astype(jnp.int16)
    return b[..., 0::2] - b[..., 1::2]


def xorshift32_scan(seed, n: int):
    """Sequential-reference path (lax.scan) for equivalence testing."""
    seed = jnp.asarray(seed, dtype=jnp.uint32)
    seed = jnp.where(seed == 0, jnp.uint32(1), seed)

    def step(s, _):
        s = _xorshift32_once(s)
        return s, s

    _, ys = jax.lax.scan(step, seed, None, length=n)
    return jnp.moveaxis(ys, 0, -1)
