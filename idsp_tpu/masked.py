"""Masked event-stream adapters: the (valid, value) Option calculus.

The reference lifts processors over `Option<X>` streams and enforces a
runtime exactly-one-tick contract on chunked decimation
(dsp-process/src/adapters.rs:26-35 `Interpolator`, :70-83 `Downsample`,
:107-118 `Hold`, :157-222 `Decimator`/`TryDecimator` with
`DecimatorError::{NoTick, ExtraTick}`, :240-257 `Map`).  Here an
`Option<X>` stream is a pair of dense arrays ``(valid: bool, value)``
(`Masked`); XLA cannot raise, so contract violations become per-frame
ERROR CODES the caller checks (the reference's `TryDecimator` analog) —
and `decimate` aggregates them into a counter for streaming loops.

These are general: `mask_lift` turns ANY step function into a masked
step (state advances only on valid samples), which is exactly the
structure RPLL's timestamp input uses (`filters/rpll.py`).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

#: tick-contract codes (adapters.rs:171-178)
OK = 0
NO_TICK = 1
EXTRA_TICK = 2


class Masked(NamedTuple):
    """An Option stream: ``value[i]`` is meaningful iff ``valid[i]``."""

    valid: jax.Array  # bool
    value: jax.Array


def masked_update(valid, new_tree, old_tree):
    """Keep ``new`` where valid else ``old`` — the masked state-advance
    primitive shared by `mask_lift` and the RPLL timestamp branch."""
    return jax.tree.map(
        lambda n, o: jnp.where(valid, n, o), new_tree, old_tree
    )


def mask_lift(step):
    """Lift ``step(config, state, x) -> (state, y)`` over Option input
    (adapters.rs `Map`/`Interpolator` inner contract): the state
    advances only on valid samples; the output is a `Masked` whose
    value is undefined where invalid (mirroring `None`)."""

    def lifted(config, state, mx: Masked):
        new_state, y = step(config, state, mx.value)
        return (
            masked_update(mx.valid, new_state, state),
            Masked(valid=mx.valid, value=y),
        )

    return lifted


def _hold_op(a, b):
    """Associative take-last-valid combine."""
    av, ax = a
    bv, bx = b
    return av | bv, jnp.where(bv, bx, ax)


def hold(carry, m: Masked, *, axis: int = -1):
    """Zero-order hold over an Option stream (adapters.rs:107-118):
    each output is the most recent valid value, starting from
    ``carry``.  Parallel (associative scan), O(t log t) — the array form
    of the per-sample `if let Some(x) { self.0 = x }`.

    Returns (new_carry, y) with y dense, same shape as ``m.value``.
    """
    v, h = jax.lax.associative_scan(
        _hold_op, (m.valid, m.value), axis=axis
    )
    carry_b = jnp.expand_dims(carry, axis=axis)
    y = jnp.where(v, h, carry_b)
    last = jax.lax.slice_in_dim(y, y.shape[axis] - 1, y.shape[axis],
                                axis=axis)
    return jnp.squeeze(last, axis=axis), y


def downsample(x, r: int, phase: int = 0, *, axis: int = -1) -> Masked:
    """Dense -> Option at rate 1/r (adapters.rs:70-83 `Downsample`):
    valid on the ``phase``-th slot of every r-frame."""
    t = x.shape[axis]
    idx = jnp.arange(t, dtype=jnp.int32)
    valid = (idx % r) == phase
    shape = [1] * x.ndim
    shape[axis] = t
    return Masked(
        valid=jnp.broadcast_to(valid.reshape(shape), x.shape), value=x
    )


def interpolate(x, r: int, phase: int = 0, *, fill=0,
                axis: int = -1) -> Masked:
    """Low-rate dense -> high-rate Option (adapters.rs:26-35
    `Interpolator` input contract): each input appears at ``phase``
    within its r-slot output frame, the other slots are invalid."""
    if axis != -1:
        x = jnp.moveaxis(x, axis, -1)
    t = x.shape[-1]
    vals = jnp.full(x.shape + (r,), fill, x.dtype)
    vals = vals.at[..., phase].set(x)
    vals = vals.reshape(*x.shape[:-1], t * r)
    valid = jnp.zeros((t, r), bool).at[:, phase].set(True).reshape(t * r)
    valid = jnp.broadcast_to(valid, vals.shape)
    if axis != -1:
        vals = jnp.moveaxis(vals, -1, axis)
        valid = jnp.moveaxis(valid, -1, axis)
    return Masked(valid=valid, value=vals)


def try_decimate(m: Masked, r: int, *, axis: int = -1):
    """Chunk an Option stream into r-frames and enforce the
    exactly-one-tick contract (adapters.rs:157-222 `TryDecimator`).

    Returns ``(y, err)``: per frame, ``y`` is the FIRST valid value
    (the reference's `y.replace(..)` keeps the first and then errors)
    and ``err`` is OK / NO_TICK / EXTRA_TICK.  XLA cannot raise, so
    the codes are data the caller checks — `Decimator`'s panic is the
    caller asserting ``(err == OK).all()`` host-side.
    """
    if axis != -1:
        valid = jnp.moveaxis(m.valid, axis, -1)
        value = jnp.moveaxis(m.value, axis, -1)
    else:
        valid, value = m.valid, m.value
    t = valid.shape[-1]
    assert t % r == 0 and r > 0
    vf = valid.reshape(*valid.shape[:-1], t // r, r)
    xf = value.reshape(*value.shape[:-1], t // r, r)
    # first-valid via a static select chain (no gather)
    y = xf[..., r - 1]
    for j in range(r - 2, -1, -1):
        y = jnp.where(vf[..., j], xf[..., j], y)
    n = vf.sum(axis=-1)
    err = jnp.where(
        n == 0, jnp.int32(NO_TICK),
        jnp.where(n > 1, jnp.int32(EXTRA_TICK), jnp.int32(OK)),
    )
    if axis != -1:
        y = jnp.moveaxis(y, -1, axis)
        err = jnp.moveaxis(err, -1, axis)
    return y, err


def decimate(m: Masked, r: int, *, counters=None, axis: int = -1):
    """`Decimator` with streaming error COUNTERS instead of a panic:
    returns (y, counters') where counters is an i64 [no_tick,
    extra_tick] running total (zeros if None) — the long-running-loop
    form of the tick contract."""
    y, err = try_decimate(m, r, axis=axis)
    if counters is None:
        counters = jnp.zeros((2,), jnp.int64)
    counters = counters + jnp.stack(
        [
            (err == NO_TICK).sum().astype(jnp.int64),
            (err == EXTRA_TICK).sum().astype(jnp.int64),
        ]
    )
    return y, counters


def map_masked(fn, m: Masked) -> Masked:
    """Lift a pure elementwise fn over the Option stream
    (adapters.rs:240-257 `Map`): runs on every slot (cheap, branchless)
    but validity framing is preserved."""
    return Masked(valid=m.valid, value=fn(m.value))
