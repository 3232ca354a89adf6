"""Real-input DDC / lock-in (float path).

Equivalent of reference examples/ddc_lockin.rs: quadrature
mix with a float LO then a shared-coefficient lowpass over the I/Q
lanes (the `Split::lanes()` pattern — one config, two states — becomes
a trailing lane axis the elementwise biquad broadcasts over).

Acceptance gates (ddc_lockin.rs:104-110): recovered DC IQ mean within
3e-3 of [0.5 cos(phi), 0.5 sin(phi)], rms < 6e-3.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..design import Filter
from ..filters import biquad


def quadrature_mix(x, lo_freq: float):
    """x[n] * exp(-j*w*n) in f32: returns (n, 2) IQ lanes
    (ddc_lockin.rs:22-33).  The phase ramp is closed-form (the
    reference's running `rem_euclid` accumulator reduces mod tau each
    step; a closed-form mod keeps f32 accuracy at least as good)."""
    n = x.shape[0]
    tau = 2.0 * np.pi
    phase = jnp.asarray(
        (np.arange(n, dtype=np.float64) * (tau * lo_freq)) % tau,
        jnp.float32,
    )
    c = jnp.cos(phase)
    s = jnp.sin(phase)
    return jnp.stack([x * c, -x * s], axis=-1)


def ddc(x, lo_freq: float, cutoff: float):
    """mix -> shared-config I/Q lowpass (ddc_lockin.rs:35-42)."""
    iq = quadrature_mix(x, lo_freq)
    ba = jnp.asarray(
        biquad.from_cookbook(
            Filter().critical_frequency(cutoff).lowpass()
        ).astype(np.float32)
    )
    st = biquad.df1_init((2,), jnp.float32)  # two lanes, one config
    _, y = biquad.df1_process(ba, st, iq)
    return y


def tone(freq: float, phase: float, n: int):
    """cos(tau*freq*i + phase) fixture (ddc_lockin.rs:58-62)."""
    i = np.arange(n, dtype=np.float64)
    return jnp.asarray(
        np.cos(2.0 * np.pi * freq * i + phase).astype(np.float32)
    )


def run_ddc(n: int = 16384):
    """Full example with the reference constants (ddc_lockin.rs:83-90)."""
    lo_freq = 0.173
    phi = 0.37
    expected = np.array([0.5 * np.cos(phi), 0.5 * np.sin(phi)])
    x = tone(lo_freq, phi, n)
    y = np.asarray(ddc(x, lo_freq, 0.002), np.float64)
    tail = y[12 * n // 16 :]
    mean = tail.mean(axis=0)
    rms = float(np.sqrt(((tail - expected) ** 2).sum(axis=1).mean()))
    return {"mean": mean, "expected": expected, "rms": rms}
