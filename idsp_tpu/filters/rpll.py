"""Reciprocal PLL: lock to noisy quantized timestamps.

Equivalent of reference src/rpll.rs: consumes optional
timestamps of a reference edge (at most one per update cycle of
1 << dt2 counter cycles) and reconstructs the phase and frequency of
the update rate relative to the reference.

The event-driven `Option<timestamp>` input becomes a masked
(value, valid) stream; the update is a sequential scan per channel
(data-dependent feedback), vectorized across channels.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import jax
import jax.numpy as jnp


@dataclass(frozen=True)
class RpllConfig:
    """rpll.rs:20-36."""

    dt2: int  # log2 counter-rate / update-rate ratio
    shift_frequency: int  # log2 frequency-lock settling time (counter periods)
    shift_phase: int  # log2 phase-lock settling time

    def __post_init__(self):
        assert self.shift_frequency >= self.dt2
        assert self.shift_phase >= self.dt2


class RpllState(NamedTuple):
    """rpll.rs:12-18."""

    x: jax.Array  # i32 previous timestamp
    ff: jax.Array  # u32 frequency estimate (frequency loop)
    f: jax.Array  # u32 frequency estimate (freq + phase loop)
    y: jax.Array  # i32 phase estimate


def init(shape=()) -> RpllState:
    return RpllState(
        x=jnp.zeros(shape, jnp.int32),
        ff=jnp.zeros(shape, jnp.uint32),
        f=jnp.zeros(shape, jnp.uint32),
        y=jnp.zeros(shape, jnp.int32),
    )


def step(cfg: RpllConfig, state: RpllState, x, valid):
    """One update cycle (rpll.rs:47-77). x: i32 timestamp, valid: bool.

    Returns (state, (phase, frequency)) — the `Accu` of the estimate.
    """
    x = jnp.asarray(x, jnp.int32)
    # advance phase
    y = state.y + state.f.astype(jnp.int32)

    # --- timestamp branch (masked) ---
    dx = x - state.x
    # phase of the reference using the current frequency estimate (u64)
    p_sig_64 = state.ff.astype(jnp.uint64) * dx.astype(jnp.uint32).astype(
        jnp.uint64
    )
    bias = jnp.uint64(1 << (cfg.shift_frequency - 1))
    p_sig = ((p_sig_64 + bias) >> cfg.shift_frequency).astype(jnp.uint32)
    p_ref = jnp.uint32(1 << (32 + cfg.dt2 - cfg.shift_frequency))
    ff2 = state.ff + (p_ref - p_sig)
    # counter cycles between the timestamp and "now"
    dt = ((-x) & ((1 << cfg.dt2) - 1)).astype(jnp.uint32)
    # reference phase estimate "now" — uses f from BEFORE this update
    y_ref = ((state.f >> cfg.dt2) * dt).astype(jnp.int32)
    dy = (y_ref - y) >> (cfg.shift_phase - cfg.dt2)
    f2 = ff2 + dy.astype(jnp.uint32)

    # the timestamp branch is a masked state advance — the general
    # Option-stream primitive (idsp_tpu.masked.masked_update); the
    # phase accumulator y advances every cycle regardless.
    from ..masked import masked_update

    new_state = masked_update(
        valid,
        RpllState(x=x, ff=ff2, f=f2, y=y),
        RpllState(x=state.x, ff=state.ff, f=state.f, y=y),
    )
    return new_state, (y, new_state.f.astype(jnp.int32))


def block(cfg: RpllConfig, state: RpllState, xs, valids, *, unroll: int = 4):
    """Scan over update cycles (time on axis 0)."""

    def body(s, xv):
        x, v = xv
        return step(cfg, s, x, v)

    return jax.lax.scan(body, state, (xs, valids), unroll=unroll)


def block_masked(cfg: RpllConfig, state: RpllState, m, *,
                 unroll: int = 4):
    """`block` taking the framework's `masked.Masked` event stream
    (timestamps where valid) — RPLL's input IS an Option stream
    (rpll.rs:47: `x: Option<i32>`); this is the typed entry point the
    masked adapters (`masked.downsample`, edge detectors, ...)
    compose with."""
    return block(cfg, state, m.value, m.valid, unroll=unroll)
