"""Streaming/block processing model — the config/state split.

This is the semantic core of the reference's `dsp-process` crate
(dsp-process/src/process.rs:34-142) re-designed for JAX:

* A *stage* is a pair of pure functions over pytrees:
  ``step(config, state, x) -> (state, y)`` (one sample) and optionally a
  fused ``block(config, state, xs) -> (state, ys)`` fast path.
* Config is an immutable pytree (shared across lanes, swappable without
  touching state — the reference's `SplitProcess` atomic-retune
  property); state is the scan carry (and the checkpoint payload).
* ``block`` defaults to `lax.scan` of ``step`` over the leading time
  axis; linear stages override it with closed forms (cumsum, conv,
  associative scan) that XLA parallelizes.
* Lanes (the reference `Lanes`/`Parallel`, compose.rs:239-513) are
  `jax.vmap` over state with broadcast config.
* Serial composition (`a * b`, split.rs:95-101) is `chain`.

Time-axis convention: ``block`` takes time on axis 0 (scan order);
helpers below move axes for lane-major layouts.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Sequence

import jax
import jax.numpy as jnp

Config = Any
State = Any
StepFn = Callable[[Config, State, Any], tuple[State, Any]]
BlockFn = Callable[[Config, State, Any], tuple[State, Any]]


@dataclasses.dataclass(frozen=True)
class Stage:
    """A streaming processor: (config, init, step, optional fused block)."""

    step: StepFn
    block: BlockFn | None = None

    def scan(self, config, state, xs, *, unroll: int = 1):
        """Sequential reference path: lax.scan of `step` over axis 0."""

        def body(s, x):
            return self.step(config, s, x)

        return jax.lax.scan(body, state, xs, unroll=unroll)

    def __call__(self, config, state, xs):
        """Run the fused block path if present, else the scan."""
        if self.block is not None:
            return self.block(config, state, xs)
        return self.scan(config, state, xs)


def scan_stage(step: StepFn) -> Stage:
    return Stage(step=step)


def chain(*stages_with_cfg: tuple[Stage, Config]):
    """Serial composition: y of stage i feeds stage i+1 (split.rs:95-101).

    Returns ``(states, xs) -> (states, ys)`` over tuples of states.
    """

    def run(states: Sequence[State], xs):
        out_states = []
        cur = xs
        for (stage, cfg), st in zip(stages_with_cfg, states):
            st2, cur = stage(cfg, st, cur)
            out_states.append(st2)
        return tuple(out_states), cur

    return run


def lanes(stage: Stage, *, in_axes=0, out_axes=0):
    """One shared config, N states — `Lanes` (compose.rs:448-513) as vmap.

    The returned callable maps ``(config, states, xs)`` where states/xs
    carry a leading lane axis and config is broadcast.
    """

    def run(config, states, xs):
        return jax.vmap(
            lambda s, x: stage(config, s, x), in_axes=(in_axes, in_axes),
            out_axes=(out_axes, out_axes),
        )(states, xs)

    return run


def frame_major(x, n_lanes: int):
    """View a flat interleaved stream as (time, lane) — `FrameMajor`
    (dsp-process/src/view.rs:9-17)."""
    return x.reshape(-1, n_lanes)


def lane_major(x, n_lanes: int):
    """View a flat stream as (lane, time) — `LaneMajor`."""
    return x.reshape(n_lanes, -1)


class BlockCarry(NamedTuple):
    """Generic carried tail state for overlap-save FIR block processing."""

    tail: jax.Array


def delay_line_block(xs, tail):
    """Prepend a carried tail to a block and return (extended, new_tail).

    The array analog of the reference's ring-buffer `copy_within` tail
    carry (src/hbf.rs:93-101): the last ``len(tail)`` input samples of
    the extended block become the next block's tail.
    """
    ext = jnp.concatenate([tail, xs], axis=0)
    n = tail.shape[0]
    return ext, ext[ext.shape[0] - n :]
