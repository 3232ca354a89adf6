#!/usr/bin/env python
"""DDC / lock-in demo (reference examples/ddc_lockin.rs).

Mixes a coherent tone down to DC and recovers its IQ with the
shared-coefficient lowpass; prints recovery error against the
reference gates (mean error < 3e-3, rms < 6e-3).

Run: python examples/lockin.py [n_samples]
"""

import sys

import numpy as np

sys.path.insert(0, ".")

from idsp_tpu.pipelines import ddc_lockin  # noqa: E402


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 16384
    r = ddc_lockin.run_ddc(n)
    err = np.abs(r["mean"] - r["expected"]).max()
    print(f"samples: {n}")
    print(f"recovered IQ: {r['mean']}")
    print(f"expected IQ:  {r['expected']}")
    print(f"mean error: {err:.2e}  (gate < 3e-3)")
    print(f"rms:        {r['rms']:.2e}  (gate < 6e-3)")
    ok = err < 3e-3 and r["rms"] < 6e-3
    print("PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
