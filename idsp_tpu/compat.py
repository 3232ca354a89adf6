"""Array-in/array-out compatibility surface.

The same four entry points the reference exposes to Python via PyO3
(src/py.rs:1-109) — here they ARE the native API, on jnp arrays:

* ``cossin(p)``: i32[N] phases -> i32[N, 2] (cos, sin)
* ``atan2(xy)``: i32[N, 2] [[x, y]] -> i32[N] angles
* ``sos(sos, xy)``: quantize (N, 6) f64 cookbook SOS rows to Q32<29>
  and filter an i32 array through the cascade (stage-major DF1)
* ``sos_clamp_wide(sos, xy)``: (N, 9) rows [b0,b1,b2,a0,a1,a2,u,min,
  max] through clamped wide-state DF1 stages

These double as the golden-vector bridge: scripts written against
`idsp._idsp` run unchanged against `idsp_tpu.compat`.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from . import dispatch
from .filters import biquad
from .ops import trig


def cossin(p):
    """i32[N] -> i32[N, 2] (py.rs:10-28)."""
    c, s = trig.cossin(jnp.asarray(p, jnp.int32))
    return jnp.stack([c, s], axis=-1)


def atan2(xy):
    """i32[N, 2] of [x, y] -> i32[N] (py.rs:30-46): atan2(y, x)."""
    xy = jnp.asarray(xy, jnp.int32)
    return trig.atan2(xy[..., 1], xy[..., 0])


def _round_sat_i32(v: float) -> int:
    v = float(np.trunc(v + np.copysign(0.5, v))) if np.isfinite(v) else v
    if np.isnan(v):
        return 0
    return int(np.clip(v, -(2**31), 2**31 - 1))


def sos(sos_rows, xy, *, f: int = 29):
    """Quantize (N, 6) cookbook SOS rows to Q32<f> and filter the i32
    array through the stage-major DF1 cascade (py.rs:48-74).

    Returns the filtered array (the reference mutates in place).  All
    stages advance per sample in one recurrence (`dispatch.lane_scan`),
    which equals the stage-major order exactly.
    """
    rows = np.asarray(sos_rows, np.float64).reshape(-1, 6)
    ba5 = biquad.from_cookbook(rows.reshape(-1, 2, 3))
    ba_q = biquad.quantize_ba(ba5, f)
    y = jnp.asarray(xy, jnp.int32)

    def step(states, x):
        out = []
        for ba, st in zip(ba_q, states):
            st, x = biquad.df1_step_q(ba, f, st, x)
            out.append(st)
        return tuple(out), x

    states = tuple(biquad.df1_init(y.shape[1:], jnp.int32) for _ in ba_q)
    return dispatch.lane_scan(step, states, y)[1]


def sos_clamp_wide(sos_rows, xy, *, f: int = 29):
    """(N, 9) rows [b0,b1,b2,a0,a1,a2,u,min,max] through clamped
    wide-error-feedback DF1 stages (py.rs:76-108)."""
    rows = np.asarray(sos_rows, np.float64).reshape(-1, 9)
    ba5 = biquad.from_cookbook(rows[:, :6].reshape(-1, 2, 3))
    ba_q = biquad.quantize_ba(ba5, f)
    bounds = [
        tuple(np.int32(_round_sat_i32(v)) for v in rows[i, 6:9])
        for i in range(len(ba_q))
    ]
    y = jnp.asarray(xy, jnp.int32)

    def step(states, x):
        out = []
        for ba, (u, lo, hi), st in zip(ba_q, bounds, states):
            st, x = biquad.df1_wide_clamp_step(ba, f, st, x, u, lo, hi)
            out.append(st)
        return tuple(out), x

    states = tuple(biquad.df1_wide_init(y.shape[1:]) for _ in ba_q)
    return dispatch.lane_scan(step, states, y)[1]
