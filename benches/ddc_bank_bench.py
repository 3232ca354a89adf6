"""BASELINE config #5: 1024-channel wideband DDC bank with per-channel
PLL carrier tracking.

Reports channel-samples/s (full-rate input samples x channels) for the
integer Lowpass2 channel filter and the Q32 biquad variant (NCO mix ->
filter -> decimate -> atan2 -> PLL), exact and fast LO.  Needs a GPU.

Run: python benches/ddc_bank_bench.py [--channels 1024] [--time 16384]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--channels", type=int, default=1024)
    ap.add_argument("--time", type=int, default=16384)
    ap.add_argument("--decimate", type=int, default=16)
    ap.add_argument("--trials", type=int, default=5)
    args = ap.parse_args(argv)

    from idsp_tpu import device

    device.enable_compile_cache()
    info = device.require_gpu()
    print(f"# device={info} card={device.card_line()}", flush=True)

    import jax.numpy as jnp

    from idsp_tpu.design import Filter
    from idsp_tpu.filters import biquad, lowpass, pll
    from idsp_tpu.pipelines import ddc_bank
    from idsp_tpu.profiling import measure_rate

    c, t, d = args.channels, args.time, args.decimate
    print(f"# c={c} t={t} dec={d}", flush=True)
    rng = np.random.default_rng(0)
    x = jnp.asarray(
        rng.integers(-(2**27), 2**27, size=(t,), dtype=np.int64).astype(
            np.int32
        )
    )
    steps = jnp.asarray(
        rng.integers(1 << 24, 1 << 30, size=(c,), dtype=np.int64).astype(
            np.int32
        )
    )
    lp_gains = tuple(int(v) for v in lowpass.gains2(0.004))
    pll_ba = tuple(
        int(v) for v in pll.coefficients_from_bandwidth(2e-2, 4.0)
    )
    ba_q = tuple(
        int(v)
        for v in biquad.quantize_ba(
            biquad.from_cookbook(Filter().critical_frequency(0.004).lowpass()),
            29,
        )
    )

    def bench(name, fn, state):
        sec, _ = measure_rate(fn, state, iters=(2, 12), trials=args.trials)
        print(f"{name:42s} {sec*1e3:8.3f} ms/block "
              f"({c * t / sec / 1e9:6.2f} G cs/s)", flush=True)

    for lo_mode in ("exact", "fast"):
        bench(
            f"ddc bank (Lowpass2 + PLL, {lo_mode} LO)",
            lambda s: ddc_bank.ddc_bank_block(
                s, x, steps, lp_gains, pll_ba, decimate=d, lo_mode=lo_mode
            ),
            ddc_bank.init(c),
        )
        bench(
            f"ddc bank (Q32 biquad + PLL, {lo_mode} LO)",
            lambda s: ddc_bank.ddc_bank_block_biquad(
                s, x, steps, ba_q, pll_ba, decimate=d, lo_mode=lo_mode
            ),
            ddc_bank.init_biquad(c),
        )


if __name__ == "__main__":
    main()
