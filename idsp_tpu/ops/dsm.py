"""MASH-(1)^K delta-sigma modulator.

Equivalent of reference src/dsm.rs:22-58.  The accumulator
chain is K cascaded wrapping u32 integrators whose carries drive a
carry-difference recombination network.  Stage ``a[0]`` is a plain
cumulative sum of the input; each later stage integrates the previous
stage's output — all linear, so the block path is K chained ``cumsum``s
(parallel prefix sums) plus an elementwise recombination, not a
sequential scan.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class DsmState(NamedTuple):
    a: jax.Array  # (K,) or (..., K) u32 accumulators
    c: jax.Array  # (K,) or (..., K) i8 previous recombination terms


def init(k: int, shape=()) -> DsmState:
    return DsmState(
        a=jnp.zeros(shape + (k,), dtype=jnp.uint32),
        c=jnp.zeros(shape + (k,), dtype=jnp.int8),
    )


def _recombine(d, c_in):
    """Carry-difference network (src/dsm.rs:52-57) on a carry word ``d``
    whose bit (K-1-i) is stage i's carry. Returns (y, c_out)."""
    k = c_in.shape[-1]
    y = d & 1
    cs = []
    for i in range(k - 1):
        d = d >> 1
        c_prev = c_in[..., i]
        y, c_new = (d & 1) + y - c_prev, y
        cs.append(c_new)
    if k >= 1:
        cs.append(c_in[..., k - 1] * 0)  # last slot unused, keep shape
    c_out = jnp.stack(cs, axis=-1) if cs else c_in
    return y, c_out


def step(state: DsmState, x):
    """One `Dsm::process` (src/dsm.rs:44-57). x: u32; returns i8-range y."""
    k = state.a.shape[-1]
    a = state.a
    new_a = []
    xi = jnp.asarray(x, dtype=jnp.uint32)
    d = jnp.zeros(jnp.broadcast_shapes(xi.shape, a.shape[:-1]), jnp.int8)
    for i in range(k):
        s = a[..., i] + xi
        carry = (s < xi).astype(jnp.int8)  # wrapping-add overflow
        d = (d << 1) | carry
        new_a.append(s)
        xi = s
    a2 = jnp.stack(new_a, axis=-1) if new_a else a
    y, c2 = _recombine(d, state.c)
    return DsmState(a=a2, c=c2), y.astype(jnp.int8)


def block(state: DsmState, xs):
    """Block path: K chained wrapping cumsums + elementwise recombination.

    ``xs`` has time on the last axis.  Stage outputs
    a_i[t] = a_i0 + cumsum(a_{i-1}[t]) (mod 2^32); carries are detected
    per-step as (a_i[t] < increment) in u32.  Bit-exact with `step`
    (equivalence-tested) but runs as parallel prefix sums.
    """
    k = state.a.shape[-1]
    xs = jnp.asarray(xs, dtype=jnp.uint32)
    carries = []
    cur = xs
    a_fin = []
    for i in range(k):
        a0 = state.a[..., i]
        total = a0[..., None].astype(jnp.uint64) + jnp.cumsum(
            cur.astype(jnp.uint64), axis=-1
        )
        a_i = total.astype(jnp.uint32)  # wrapped stage value
        carry = (a_i < cur).astype(jnp.int8)
        carries.append(carry)
        a_fin.append(a_i[..., -1])
        cur = a_i
    d = jnp.zeros_like(carries[0]) if k else jnp.zeros(xs.shape, jnp.int8)
    for c in carries:
        d = (d << 1) | c

    # Recombination is a short per-sample chain over K << time; scan over
    # time with the tiny (K,) carry.
    def rec_step(c_carry, d_t):
        y, c2 = _recombine(d_t, c_carry)
        return c2, y

    d_t_first = jnp.moveaxis(d, -1, 0)
    c_fin, ys = jax.lax.scan(rec_step, state.c, d_t_first)
    ys = jnp.moveaxis(ys, 0, -1).astype(jnp.int8)
    a2 = jnp.stack(a_fin, axis=-1) if k else state.a
    return DsmState(a=a2, c=c_fin), ys
