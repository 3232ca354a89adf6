"""Headline benchmark: biquad+HBF DDC chain throughput on one card.

The chain is `pipelines.ddc_chain.block` (fast-LO NCO mix -> Q32<29> DF1
biquad lowpass on the I|Q lanes -> 3-stage HBF decimate-by-8), the same
function `chip_smoke.py` checks against the scan reference.  It runs at
c=512 and c=1024 channels, 32768 full-rate samples per block.

Rate currency: channels x full-rate input samples per second.  Time per
block is the median of iteration differences of chained blocks, each
run ending in `jax.block_until_ready` (`profiling.measure_rate`).
Baseline: the BASELINE.json north star of 1 Gsample/s per card.

Prints the device and the card's name and power limit, then ONE JSON
line {"metric", "value", "unit", "vs_baseline", ...}.  Exits non-zero
without a GPU.

Run: python bench.py
"""

import json
import sys

import numpy as np

T = 32768
CHANNELS = (512, 1024)


def main() -> int:
    from idsp_tpu import device

    device.enable_compile_cache()
    info = device.require_gpu()
    card = device.card_line()
    print(f"# device: {info['platform']} {info['kind']} x{info['count']}",
          flush=True)
    print(f"# card: {card}", flush=True)

    import jax.numpy as jnp

    from idsp_tpu.pipelines import ddc_chain
    from idsp_tpu.profiling import measure_rate

    rng = np.random.default_rng(0)
    x = jnp.asarray(
        rng.integers(-(2**27), 2**27, size=(T,), dtype=np.int64).astype(
            np.int32)
    )
    steps_all = jnp.asarray(
        rng.integers(1 << 24, 1 << 30, size=(max(CHANNELS),),
                     dtype=np.int64).astype(np.int32)
    )
    ba_q = ddc_chain.lowpass_coefficients()

    rates = {}
    for c in CHANNELS:
        steps = steps_all[:c]

        def run(state, c=c, steps=steps):
            return ddc_chain.block(state, x, steps, ba_q)

        sec, diffs = measure_rate(run, ddc_chain.init(c), trials=8)
        rates[c] = c * T / sec
        print(f"# c={c}: {sec * 1e3:.4f} ms/block "
              f"(trials: {', '.join(f'{d * 1e3:.4f}' for d in diffs)})",
              flush=True)

    baseline = 1e9
    rate = rates[CHANNELS[0]]
    print(json.dumps({
        "metric": "biquad_hbf_ddc_chain_samples_per_s",
        "value": rate,
        "unit": "samples/s",
        "vs_baseline": rate / baseline,
        "channels": CHANNELS[0],
        "c1024_samples_per_s": rates[1024],
        "c1024_vs_baseline": rates[1024] / baseline,
        "device": info,
        "card": card,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
