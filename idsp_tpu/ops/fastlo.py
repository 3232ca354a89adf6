"""Coarse/fine factored local oscillator — the documented fast LO path.

The exact NCO (`ops.trig.cossin`, reference src/cossin.rs:14-67) costs a
LUT lookup, interpolation and octant fold per sample.  This module is the
framework's sanctioned SNR-gated fast path (cf. the reference's own
quality-tiered tap sets, src/hbf.rs:238-349): factor the phase ramp by
angle addition and replace the per-sample table lookup with one complex
multiply.

For the ramp ``phase[n] = phase0 + step * n`` (wrapping i32, n = 1..t),
write ``n = a*k + b`` with ``b in [1, k]``:

    lo[n] = exp(j*w*(phase0 + step*a*k)) * exp(j*w*step*b)
          =        coarse[a]             *     fine[b-1]

with ``w = 2*pi/2^32``.  Only ``t/k + k`` trig evaluations per channel
remain (vs ``t``); at t=32768, k=128 that is a 90x reduction.  The
factor tables are tiny ((t/k, c) and (k, c)) and are evaluated from
exact wrapping int32 phase arithmetic with f32 trig by default (~2e-7
rad per factor; `trig_dtype=jnp.float64` reaches ~1e-16 at the cost of
f64 trig), plus the f32 rounding of the per-sample complex
multiply — both far *below* the exact LUT path's 4e-6 RMS
interpolation error.  The fast LO is
therefore gated by the reference's spectral acceptance suite (SFDR >
118 dB, SNR > 106 dB, spur < -120.4 dBc, src/cossin.rs:199-247) rather
than bit-exactness, and passes with >20 dB margin
(tests/test_fastlo.py).

The mix output is rounded to i32, so the downstream integer biquad path
is unchanged; the fast path differs from the exact path only in the
(sub-LSB-noise) mix rounding.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

# Gain-matching amplitude of the exact path: `cossin` returns i32
# phasors of amplitude ~(1<<31 - 1<<15) (src/cossin.rs:12-13) and the
# exact mix computes (lo * x) >> 32, i.e. an effective LO amplitude of
# (2^31 - 2^15)/2^32.
AMPLITUDE = float(2**31 - 2**15) / 2**32


def round_half_away(v):
    """Round-half-away-from-zero on f32 (the fxp float->Q convention,
    fxp.py / lib.rs:361-376), written with floor/where only so the same
    expression lowers in any backend."""
    return jnp.where(
        v >= 0,
        jnp.floor(v + jnp.float32(0.5)),
        -jnp.floor(-v + jnp.float32(0.5)),
    )


def _angle_trig(phase_i32, trig_dtype):
    """Unit cos/sin of a wrapping-i32 phase (i32::MIN = -pi), f32 out."""
    ang = phase_i32.astype(trig_dtype) * (np.pi / 2**31)
    return (jnp.cos(ang).astype(jnp.float32),
            jnp.sin(ang).astype(jnp.float32))


def fastlo_tables(phase0, steps, t: int, k: int, *,
                  trig_dtype=jnp.float32):
    """Coarse/fine factor tables for the ramp ``phase0 + steps*n``.

    Args:
      phase0: (c,) i32 phase before the first sample (sample n mixes
        with phase ``phase0 + steps*n``, n = 1..t — the bench/pipeline
        ramp convention).
      steps: (c,) i32 per-channel frequency words.
      t: total samples (t % k == 0).
      k: fine-table length (pick = the kernel time chunk).
      trig_dtype: dtype for the trig evaluation of the tiny tables
        (float32 default, ~2e-7 rad, passes every reference gate with
        margin and avoids f64 trig; float64 available
        for reference-quality tables).

    Returns (ca, sa, cb, sb): coarse (t//k, c) and fine (k, c) float32
    unit-amplitude factor planes; ``lo[a*k + b] = (ca+j*sa)[a] *
    (cb+j*sb)[b-1]``.
    """
    assert t % k == 0
    phase0 = jnp.asarray(phase0, jnp.int32)
    steps = jnp.asarray(steps, jnp.int32)
    a = jnp.arange(t // k, dtype=jnp.int32) * jnp.int32(k)
    b = jnp.arange(1, k + 1, dtype=jnp.int32)
    coarse_ph = phase0[None, :] + steps[None, :] * a[:, None]  # wraps
    fine_ph = steps[None, :] * b[:, None]  # wraps
    ca, sa = _angle_trig(coarse_ph, trig_dtype)
    cb, sb = _angle_trig(fine_ph, trig_dtype)
    return ca, sa, cb, sb


def fastlo_iq(phase0, steps, t: int, k: int = 128, *,
              trig_dtype=jnp.float32):
    """Full-rate fast LO planes (lo_re, lo_im) (t, c) f32, unit
    amplitude — the factored equivalent of
    ``cossin(phase0 + steps*arange(1, t+1)) / 2^31``."""
    ca, sa, cb, sb = fastlo_tables(phase0, steps, t, k,
                                   trig_dtype=trig_dtype)
    c = ca.shape[-1]
    lo_re = ca[:, None, :] * cb[None] - sa[:, None, :] * sb[None]
    lo_im = sa[:, None, :] * cb[None] + ca[:, None, :] * sb[None]
    return lo_re.reshape(t, c), lo_im.reshape(t, c)


def fastlo_mix(x, phase0, steps, k: int = 128, *,
               trig_dtype=jnp.float32, amplitude: float = AMPLITUDE):
    """Fast-path conjugate NCO mix: ``miq`` (t, 2c) i32.

    Drop-in for the exact mix

        lo = cossin(phase0 + steps*arange(1, t+1))
        miq = [q_apply(lo_re, x, 32) | q_apply(-lo_im, x, 32)]

    with rounded-f32 instead of truncated-i64 sample arithmetic: the
    result differs from the exact path by a few LSB of rounding noise
    at a ~-130 dBc floor (gated in tests/test_fastlo.py).
    """
    x = jnp.asarray(x, jnp.int32)
    t = x.shape[0]
    c = jnp.asarray(phase0).shape[0]
    ca, sa, cb, sb = fastlo_tables(phase0, steps, t, k,
                                   trig_dtype=trig_dtype)
    xh = x.astype(jnp.float32) * jnp.float32(amplitude)
    xh = xh.reshape(t // k, k, 1)
    lo_re = ca[:, None, :] * cb[None] - sa[:, None, :] * sb[None]
    lo_im = sa[:, None, :] * cb[None] + ca[:, None, :] * sb[None]
    mi = round_half_away(lo_re * xh).astype(jnp.int32).reshape(t, c)
    mq = round_half_away(-(lo_im * xh)).astype(jnp.int32).reshape(t, c)
    return jnp.concatenate([mi, mq], axis=1)
