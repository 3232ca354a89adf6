"""Wave-digital allpass filters (two-port adapter chains).

Equivalent of reference src/iir/wdf.rs: a chain of two-port
adapters, each one of eight architectures (A/B/B1/X/C/C1/D/Z) chosen so
the quantized coefficient lands in -0.5 <= a <= 0 (which just fits
Q32<32>).  Combined in complementary pairs they form very cheap
half-band IIR filters.

Per-sample dataflow (wdf.rs:155-171): stage i consumes [x_i, z_i] and
produces [w_i, x_{i+1}]; w_0 is the output, w_i (i>=1) updates
z_{i-1}, and the final x_N lands in z_{N-1}.  The adapter chain is
short (N <= ~10) and unrolls at trace time; time is a scan, channels
vectorize.
"""

from __future__ import annotations

from enum import IntEnum
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import fxp


class Tpa(IntEnum):
    """Two-port adapter architectures (wdf.rs:15-32), one nibble each."""

    Z = 0x0
    A = 0xA
    B = 0xB
    B1 = 0xE
    X = 0x1
    C = 0xC
    C1 = 0xF
    D = 0xD


def quantize(tpas: list[Tpa], g: np.ndarray) -> np.ndarray:
    """Quantize allpass pole coefficients per adapter type
    (wdf.rs:51-63): map g to a in [-0.5, 0] and encode as Q32<32>."""
    g = np.asarray(g, dtype=np.float64)
    a = np.empty_like(g)
    for i, t in enumerate(tpas):
        if t == Tpa.A:
            a[i] = g[i] - 1.0
        elif t in (Tpa.B, Tpa.B1):
            a[i] = -g[i]
        elif t in (Tpa.C, Tpa.C1):
            a[i] = g[i]
        elif t == Tpa.D:
            a[i] = -1.0 - g[i]
        else:
            a[i] = 0.0
        if not (-0.5 <= a[i] <= 0.0):
            raise ValueError(
                f"adapter {t.name} coefficient {a[i]} outside [-0.5, 0]"
            )
    return fxp.from_float(a, 32)


def nibbles(m: int, n: int) -> list[Tpa]:
    """Decode the packed configuration word (one nibble per stage,
    lowest nibble = stage 0, wdf.rs:104-113)."""
    out = []
    for _ in range(n):
        out.append(Tpa(m & 0xF) if (m & 0xF) in list(Tpa) else Tpa.Z)
        m >>= 4
    return out


def _adapt(tpa: Tpa, x0, x1, a):
    """One two-port adapter (wdf.rs:65-101): i32 wrapping arithmetic
    with the truncating `c * a` Q32<32> apply."""

    def mul(c):
        return fxp.q_apply(a, c, 32)

    if tpa == Tpa.A:
        c = x1 - x0
        y = mul(c) + x1
        return y + c, y
    if tpa == Tpa.B:
        c = x0 - x1
        y = mul(c) + x1
        return y, y + c
    if tpa == Tpa.B1:
        c = x0 - x1
        y = mul(c)
        return y + x1, y + x0
    if tpa == Tpa.X:
        return x1, x0
    if tpa == Tpa.C:
        c = x1 - x0
        y = mul(c) - x1
        return y, y + c
    if tpa == Tpa.C1:
        c = x1 - x0
        y = mul(c)
        return y - x1, y - x0
    if tpa == Tpa.D:
        c = x0 - x1
        y = mul(c) - x1
        return y + c, y
    return x0, x1  # Z: terminate


class WdfState(NamedTuple):
    z: jax.Array  # (..., N) i32


def init(n: int, shape=()) -> WdfState:
    return WdfState(z=jnp.zeros(shape + (n,), jnp.int32))


def step(tpas: list[Tpa], a, state: WdfState, x):
    """One sample through the adapter chain (wdf.rs:155-171)."""
    n = len(tpas)
    x = jnp.asarray(x, jnp.int32)
    z_new = list(jnp.moveaxis(state.z, -1, 0))
    y = None
    cur = x
    for i, t in enumerate(tpas):
        w, nxt = _adapt(t, cur, state.z[..., i], a[..., i])
        if i == 0:
            y = w
        else:
            z_new[i - 1] = w
        cur = nxt
    z_new[n - 1] = cur
    return WdfState(z=jnp.stack(z_new, axis=-1)), y


def block(tpas: list[Tpa], a, state: WdfState, xs, *, unroll: int = 8):
    """Scan over time axis 0."""
    a = jnp.asarray(a, jnp.int32)
    return jax.lax.scan(
        lambda s, x: step(tpas, a, s, x), state, xs, unroll=unroll
    )


def chain_block(stages, states, xs, *, unroll: int = 8):
    """Serial cascade of adapter chains (`[Wdf; K]` arrays in the
    reference bench configs). stages: list of (tpas, a)."""
    new_states = []
    cur = xs
    for (tpas, a), st in zip(stages, states):
        st2, cur = block(tpas, a, st, cur, unroll=unroll)
        new_states.append(st2)
    return new_states, cur


def pair_block(branch0, branch1, states, xs, *, unroll: int = 8):
    """Complementary allpass pair (`Pair` + `Add`/`Sub`,
    dsp-process/src/lib.rs:41-67, tests/embedded/src/bin/biquad.rs:
    120-173): sum gives the (gain-2) lowpass, difference the highpass.

    branch0/branch1: lists of (tpas, a) serial stages.
    Returns ((s0, s1), (sum, diff))."""
    s0, s1 = states
    s0, y0 = chain_block(branch0, s0, xs, unroll=unroll)
    s1, y1 = chain_block(branch1, s1, xs, unroll=unroll)
    return (s0, s1), (y0 + y1, y0 - y1)
