"""Cascaded integrator-comb (CIC) interpolators/decimators.

Equivalent of reference src/cic.rs.  Order N, comb delay M,
runtime rate change R-1 (R = rate+1 fast samples per slow sample).

The reference is a per-sample `Process` with an index countdown; here
the block path exploits linearity: integrators are N chained *wrapping
cumsums* (parallel prefix sums), combs are shifted differences at the
slow rate, and the rate change is a strided slice / repeat.  A
sequential step path mirrors the reference exactly and the two are
equivalence-tested bit-for-bit (the reference's own modular-equivalence
pattern, cic.rs:305-387).

Block-processing constraint: block lengths must be a multiple of the
rate ratio R so the decimation/interpolation phase stays static under
jit (the reference's `tick()` contract, cic.rs:86-91, aligned to
blocks).

Decimator arithmetic wraps (overflow OK given >= gain_log2 headroom
bits, cic.rs:175-199); interpolator integrators must not overflow
(cic.rs:149-172).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class CicState(NamedTuple):
    """Combs (N, M) at the slow rate, integrators (N,) at the fast rate,
    plus the ZOH (cic.rs:13-27). Leading channel axes allowed."""

    combs: jax.Array  # (..., N, M)
    integrators: jax.Array  # (..., N)
    zoh: jax.Array  # (...,)


def init(n: int, m: int = 1, shape=(), dtype=jnp.int32) -> CicState:
    assert m > 0, "comb delay must be non-zero"
    return CicState(
        combs=jnp.zeros(shape + (n, m), dtype),
        integrators=jnp.zeros(shape + (n,), dtype),
        zoh=jnp.zeros(shape, dtype),
    )


def gain(rate: int, n: int, m: int = 1) -> int:
    """(M*(rate+1))**N (cic.rs:104-106)."""
    return (m * (rate + 1)) ** n


def gain_log2(rate: int, n: int, m: int = 1) -> int:
    """Upper bound on log2(gain) (cic.rs:112-114)."""
    v = m * rate + (m - 1)
    return (32 - _clz32(v)) * n


def _clz32(v: int) -> int:
    return 32 - v.bit_length() if v > 0 else 32


def response_length(rate: int, n: int) -> int:
    """rate * N (cic.rs:117-119)."""
    return rate * n


def settle_interpolate(rate: int, n: int, m: int, x, shape=(), dtype=jnp.int32):
    """Settled interpolator state for constant input x (cic.rs:121-133)."""
    st = init(n, m, shape, dtype)
    x = jnp.asarray(x, dtype)
    combs = st.combs
    if n > 0:
        combs = combs.at[..., 0, :].set(x[..., None])
        integ = st.integrators.at[..., -1].set(x * gain(rate, n, m))
    else:
        return st._replace(zoh=x)
    return CicState(combs=combs, integrators=integ, zoh=st.zoh)


def settle_decimate(rate: int, n: int, m: int, x, shape=(), dtype=jnp.int32):
    """Settled decimator state (cic.rs:135-142).

    Not implemented in the reference either (`unimplemented!()`); kept
    for API parity."""
    raise NotImplementedError("settle_decimate is unimplemented (as in the reference)")


def _comb_chain(combs, x, axis: int = -1):
    """Run the comb cascade on a slow-rate block. combs: (..., N, M)
    carried delay lines; x: (..., t) for axis=-1 or (t, ...) for
    axis=0 (time-major: only the tiny (M,) delay rows are transposed,
    never the data block). Returns (new_combs, y)."""
    n = combs.shape[-2]
    cur = x
    new_rows = []
    for i in range(n):
        row = combs[..., i, :]  # (..., M) delay line, row[..., 0] oldest
        if axis == 0:
            t = cur.shape[0]
            ext = jnp.concatenate(
                [jnp.moveaxis(row, -1, 0), cur], axis=0
            )  # (M + t, ...)
            y = cur - ext[:t]
            new_rows.append(jnp.moveaxis(ext[t:], 0, -1))
        else:
            t = cur.shape[-1]
            ext = jnp.concatenate([row, cur], axis=-1)
            y = cur - ext[..., :t]  # x - delayed by M
            new_rows.append(ext[..., t:])
        cur = y
    new_combs = (
        jnp.stack(new_rows, axis=-2) if new_rows else combs
    )
    return new_combs, cur


def _integrator_chain(integrators, x, axis: int = -1):
    """N chained wrapping cumsums on a fast-rate block. integrators:
    (..., N) carried values; x: (..., t) or (t, ...) for axis=0."""
    n = integrators.shape[-1]
    cur = x
    finals = []
    for i in range(n):
        c0 = integrators[..., i]
        if axis == 0:
            cur = c0[None] + jnp.cumsum(cur, axis=0)
            finals.append(cur[-1])
        else:
            cur = c0[..., None] + jnp.cumsum(cur, axis=-1)
            finals.append(cur[..., -1])
    new_int = jnp.stack(finals, axis=-1) if finals else integrators
    return new_int, cur


def decimate_block(state: CicState, x, rate: int, *, axis: int = -1):
    """Decimate a fast-rate block (..., t) by R = rate+1 (cic.rs:175-199).

    t must be a multiple of R; the slow-rate output has t//R samples.
    Phase convention: with a fresh state the reference emits on the
    first fast sample (index 0), i.e. outputs are taken at fast
    positions 0, R, 2R, ... of the stream continuation.

    ``axis=0`` takes time on the leading axis ((t, ...channels) blocks,
    e.g. straight off the lane-bank kernels) with no data transpose;
    bit-identical to the channel-last path.
    """
    r = rate + 1
    t = x.shape[axis]
    assert t % r == 0, "block length must be a multiple of rate+1"
    new_int, integ = _integrator_chain(state.integrators, x, axis)
    sampled = integ[::r] if axis == 0 else integ[..., ::r]
    new_combs, y = _comb_chain(state.combs, sampled, axis)
    zoh = y[-1] if axis == 0 else y[..., -1]
    return CicState(combs=new_combs, integrators=new_int, zoh=zoh), y


def interpolate_block(state: CicState, x, rate: int, *, axis: int = -1):
    """Interpolate a slow-rate block (..., t) by R = rate+1
    (cic.rs:149-172): combs at the slow rate, ZOH upsampling, then N
    integrators at the fast rate.  Output has t*R samples.  ``axis=0``
    is the transpose-free time-major path (see decimate_block)."""
    r = rate + 1
    new_combs, c = _comb_chain(state.combs, x, axis)
    zoh = jnp.repeat(c, r, axis=0 if axis == 0 else -1)
    new_int, y = _integrator_chain(state.integrators, zoh, axis)
    last = c[-1] if axis == 0 else c[..., -1]
    return CicState(combs=new_combs, integrators=new_int, zoh=last), y


# --- sequential reference paths (bit-exact mirrors of the per-sample
# implementation, used for equivalence tests) --------------------------------


def decimate_step(state: CicState, x, index, rate: int):
    """One fast-rate sample (cic.rs:175-199). Returns
    (state, index, (emitted?, y))."""
    new_int, y = _integrator_chain(state.integrators, x[..., None])
    y = y[..., 0]
    emit = index == 0
    new_combs, yc = _comb_chain(state.combs, y[..., None])
    yc = yc[..., 0]
    combs = jax.tree.map(
        lambda new, old: jnp.where(emit, new, old), new_combs, state.combs
    )
    zoh = jnp.where(emit, yc, state.zoh)
    index2 = jnp.where(emit, rate, index - 1)
    return (
        CicState(combs=combs, integrators=new_int, zoh=zoh),
        index2,
        (emit, yc),
    )


def interpolate_step(state: CicState, x_opt, index, rate: int):
    """One fast-rate tick with optional slow-rate input (x, valid)
    (cic.rs:149-172)."""
    x, valid = x_opt
    new_combs, yc = _comb_chain(state.combs, x[..., None])
    yc = yc[..., 0]
    combs = jax.tree.map(
        lambda new, old: jnp.where(valid, new, old), new_combs, state.combs
    )
    zoh = jnp.where(valid, yc, state.zoh)
    index2 = jnp.where(valid, rate, index - 1)
    new_int, y = _integrator_chain(state.integrators, zoh[..., None])
    return (
        CicState(combs=combs, integrators=new_int, zoh=zoh),
        index2,
        y[..., 0],
    )
