#!/usr/bin/env python
"""FM discriminator receiver demo (reference examples/fm_disc.rs).

Synthesizes an FM signal with the reference's constants, runs the
fixed-point receiver (cossin DDS fixture -> conjugate-product
discriminator -> atan2 -> Q32<30> deemphasis biquad), and prints the
fidelity metrics against the reference acceptance gates
(corr > 0.999, 0.95 < gain < 1.05, rms < 5e-4).

Run: python examples/fm_radio.py [n_samples]
"""

import sys

sys.path.insert(0, ".")

from idsp_tpu.pipelines import fm_disc  # noqa: E402


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 4096
    m = fm_disc.run_fm_disc(n)
    print(f"samples: {n}")
    print(f"corr: {m['corr']:.6f}   (gate > 0.999)")
    print(f"gain: {m['gain']:.4f}    (gate 0.95..1.05)")
    print(f"rms:  {m['rms']:.2e}  (gate < 5e-4)")
    ok = m["corr"] > 0.999 and 0.95 < m["gain"] < 1.05 and m["rms"] < 5e-4
    print("PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
