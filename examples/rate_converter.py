#!/usr/bin/env python
"""16x rate-conversion round-trip demo (BASELINE config #4).

Decimates a passband tone by 16 through the HBF_TAPS cascade, then
interpolates back up and checks the round trip: passband amplitude
within the cascade's ripple budget, out-of-band image suppression at
the 140 dB stopband (hbf.rs:303-307).

Run: python examples/rate_converter.py [n_samples]
"""

import sys

import numpy as np

sys.path.insert(0, ".")


import jax.numpy as jnp  # noqa: E402

from idsp_tpu.filters import hbf  # noqa: E402
from idsp_tpu.pipelines import rate_conversion  # noqa: E402


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 16384
    depth = 4
    c = 128
    f0 = 0.3 / (1 << depth)  # inside the low-rate 0.4 passband
    x = np.cos(2 * np.pi * f0 * np.arange(n)).astype(np.float32)
    xs = jnp.asarray(np.broadcast_to(x[:, None], (n, c)))

    st = rate_conversion.init_t(depth, (c,))
    st, y = rate_conversion.round_trip_t(st, xs)
    y = np.asarray(y[:, 0], dtype=np.float64)

    # coherent tone fit on the steady-state segment (robust to FFT
    # leakage), then gate the residual: everything the round trip added
    # — images, ripple distortion, f32 noise — relative to the tone
    delay = rate_conversion.group_delay(depth)
    settle = delay + hbf.hbf_int_response_length(depth)
    seg = y[settle:]
    m = len(seg)
    tt = np.arange(settle, settle + m)
    win = np.hanning(m)
    ph = np.exp(-2j * np.pi * f0 * tt)
    a = 2.0 * np.sum(win * seg * ph) / win.sum()
    resid = seg - (a * np.conj(ph)).real
    resid_db = 20 * np.log10(
        np.sqrt(np.mean((win * resid) ** 2) / np.mean((win * seg) ** 2))
    )

    print(f"samples: {n}  depth: {depth} (16x)")
    print(f"tone amplitude through round trip: {abs(a):.6f}"
          " (gate |1-a| < 1e-3)")
    print(f"residual after tone removal: {resid_db:.1f} dB (gate < -120 dB)")
    ok = abs(1.0 - abs(a)) < 1e-3 and resid_db < -120.0
    print("PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
