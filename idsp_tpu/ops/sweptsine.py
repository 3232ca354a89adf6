"""Exponential swept-sine stimulus generator and inverse filter.

Equivalent of reference src/sweptsine.rs.  The sweep
recurrence ``state += rate * ((state + 2^31) >> 32)`` has a
state-dependent increment (a built-in first-order delta-sigma of the
exponential), so the frequency track is generated with a `lax.scan`
(test/stimulus-time only); the phase accumulation and IQ conversion on
top are closed-form/vectorized (cumsum + cossin).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import jax
import jax.numpy as jnp

from .trig import cossin

_Q = float(1 << 32)


class SweepError(ValueError):
    """Sweep parameter out of bounds (src/sweptsine.rs:122-128)."""


@dataclass(frozen=True)
class Sweep:
    """Exponential frequency sweep (src/sweptsine.rs:12-119).

    ``rate``: per-sample exponential increase (i32 Q32 of the state);
    ``state``: i64 frequency state including the delta-sigma residue.
    """

    rate: int
    state: int

    @staticmethod
    def fit(stop: float, harmonics: float, cycles: float) -> "Sweep":
        """Fit a sweep to a stop frequency (units of fs), harmonic count,
        and cycles per harmonic (src/sweptsine.rs:103-118)."""
        if not (0.0 <= stop <= 0.5):
            raise SweepError("stop out of bounds")
        # f32 math in the reference; reproduce the f32 rounding exactly.
        import numpy as np

        v = np.float32(_Q) * np.expm1(
            np.float32(stop) / (np.float32(cycles) * np.float32(harmonics)),
            dtype=np.float32,
        )
        rate = int(np.trunc(v + np.copysign(np.float32(0.5), v)))
        state = (rate * int(cycles)) << 32
        if state <= 0:
            raise SweepError("start out of bounds")
        return Sweep(rate=rate, state=state)

    def rate_continuous(self) -> float:
        """ln(1 + rate/2^32) (src/sweptsine.rs:42-45)."""
        return math.log1p(self.rate / _Q)

    def delay(self, harmonic: float) -> float:
        return math.log(harmonic) / self.rate_continuous()

    def octave(self) -> float:
        return math.log(2.0) / self.rate_continuous()

    def decade(self) -> float:
        return math.log(10.0) / self.rate_continuous()

    def cycles(self) -> float:
        return self.state / (_Q * self.rate)

    def state_continuous(self) -> float:
        return self.cycles() * self.rate_continuous()

    def continuous(self, t: float) -> float:
        """Integrated sweep at continuous time t (src/sweptsine.rs:77-81)."""
        return self.cycles() * math.exp(self.rate_continuous() * t)

    def inverse_filter(self, f):
        """Stimulus inverse filter X'(f) for swept-sine deconvolution
        (src/sweptsine.rs:93-101). f in units of fs; returns (re, im)."""
        f = jnp.asarray(f, dtype=jnp.float32)
        rate = jnp.float32(math.log1p(self.rate / _Q))
        fn = f / rate
        amp = 2.0 * rate * jnp.sqrt(fn)
        inv_cycles = jnp.float32(_Q * self.rate / self.state)
        turns = 0.125 - fn * (1.0 - jnp.log(fn * inv_cycles))
        tau = 2.0 * math.pi
        return amp * jnp.cos(tau * turns), amp * jnp.sin(tau * turns)

    def frequencies(self, n: int):
        """The first n per-sample frequency words (i64), matching n
        `Sweep::next` calls (src/sweptsine.rs:22-32)."""
        bias = jnp.int64(1 << 31)
        rate = jnp.int64(self.rate)

        def step(s, _):
            s2 = s + rate * ((s + bias) >> 32)
            return s2, s

        _, ys = jax.lax.scan(step, jnp.int64(self.state), None, length=n)
        return ys


def harmonic_impulse_responses(
    sweep: Sweep, y, n: int, n_harmonics: int, window: int
):
    """Swept-sine deconvolution into per-harmonic impulse responses.

    The reference documents the workflow on `inverse_filter`
    (src/sweptsine.rs:83-101): stimulate with `accu_osc(sweep)`, FFT the
    response, multiply by the inverse filter to get the transfer
    function, inverse-FFT to the impulse response; the k-th harmonic's
    (Hammerstein-kernel) response precedes the linear one by
    `sweep.delay(k)` samples — window each out.

    Args:
      sweep: the stimulus sweep.
      y: (nfft,) response to the `accu_osc` stimulus (real), already
        padded/truncated to the analysis length.
      n: stimulus length used (for delay bookkeeping).
      n_harmonics: number of harmonic responses to extract (>= 1).
      window: half-width of the rectangular extraction window.

    Returns:
      (n_harmonics, 2*window) array: row k-1 is the k-th harmonic
      impulse response (k=1 is linear).
    """
    import numpy as onp

    y = onp.asarray(y, onp.float64)
    nfft = len(y)
    yf = onp.fft.rfft(y)
    f = onp.arange(len(yf)) / nfft
    inv_re, inv_im = sweep.inverse_filter(jnp.asarray(f[1:], jnp.float32))
    inv = onp.concatenate(
        [[0.0 + 0.0j], onp.asarray(inv_re) + 1j * onp.asarray(inv_im)]
    )
    h = onp.fft.irfft(yf * inv, nfft)
    out = onp.zeros((n_harmonics, 2 * window))
    for k in range(1, n_harmonics + 1):
        # harmonic k sits delay(k) BEFORE the linear response (at 0)
        center = int(round(-sweep.delay(k))) % nfft if k > 1 else 0
        idx = (onp.arange(-window, window) + center) % nfft
        out[k - 1] = h[idx]
    return out


def accu_osc(sweep: Sweep, n: int):
    """Exponentially swept sine as IQ (src/sweptsine.rs:160-190).

    Integrates the frequency track (wrapping i64 cumsum — parallel
    prefix), takes the upper phase word, and converts phase to IQ with
    the `cossin` DDS.  Returns (re, im) i32 arrays of length n.
    """
    f = sweep.frequencies(n)
    phase = jnp.cumsum(f)  # wrapping i64
    return cossin((phase >> 32).astype(jnp.int32))
