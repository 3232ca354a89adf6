#!/usr/bin/env python
"""Polyphase channelizer demo (reference examples/polyphase_channelizer.rs).

Routes tones at channel centers through the maximally-decimated
analysis bank and prints the bin-power isolation against the reference
gate (center channel >= 10x any other).

Run: python examples/channelizer.py [m_channels]
"""

import sys

import numpy as np

sys.path.insert(0, ".")


def main():
    import jax.numpy as jnp

    from idsp_tpu.pipelines import channelizer as chz

    m = int(sys.argv[1]) if len(sys.argv) > 1 else 16
    taps = 8
    n_fr = 256
    k = m // 3 or 1
    i = np.arange(n_fr * m, dtype=np.float64)
    tone = np.exp(2j * np.pi * (k / m) * i)
    x = np.stack([tone.real, tone.imag], axis=-1).astype(np.float32)
    st = chz.init(m, taps)
    _, y = chz.channelize(st, jnp.asarray(x.reshape(n_fr, m, 2)), m=m,
                          taps=taps)
    y = np.asarray(y, np.float64)
    p = (y[n_fr // 2:, :, 0] ** 2 + y[n_fr // 2:, :, 1] ** 2).mean(axis=0)
    ratio = p[k] / np.delete(p, k).max()
    print(f"channels: {m}, tone at channel {k}")
    print(f"isolation: {ratio:.1f}x  (gate >= 10x)")
    print("PASS" if ratio >= 10 else "FAIL")
    return 0 if ratio >= 10 else 1


if __name__ == "__main__":
    raise SystemExit(main())
