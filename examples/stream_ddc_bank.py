#!/usr/bin/env python
"""Streaming wideband DDC bank demo (BASELINE #5 + the host runtime).

A producer thread feeds synthetic wideband samples through the native
ring buffer; the StreamExecutor pumps blocks through the 1024-channel
DDC bank (NCO mix -> lowpass -> decimate -> per-channel PLL) with the
filter state carried across blocks, and prints sustained throughput.

Run: python examples/stream_ddc_bank.py [channels] [blocks]
"""

import sys
import time

import numpy as np

sys.path.insert(0, ".")


def main():
    import jax
    import jax.numpy as jnp

    from idsp_tpu.filters import lowpass, pll
    from idsp_tpu.pipelines import ddc_bank
    from idsp_tpu.runtime import StreamExecutor, producer_thread

    c = int(sys.argv[1]) if len(sys.argv) > 1 else 1024
    nb = int(sys.argv[2]) if len(sys.argv) > 2 else 8
    tb = 4096
    rng = np.random.default_rng(0)

    steps = jnp.asarray(
        rng.integers(1 << 24, 1 << 30, size=(c,), dtype=np.int64).astype(
            np.int32
        )
    )
    lp2 = tuple(int(v) for v in lowpass.gains2(0.004))
    pba = tuple(int(v) for v in pll.coefficients_from_bandwidth(2e-2, 4.0))

    block_fn = jax.jit(
        lambda s, x: ddc_bank.ddc_bank_block(
            s, x[:, 0], steps, lp2, pba, decimate=16
        )
    )
    ex = StreamExecutor(block_fn, ddc_bank.init(c), (tb, 1),
                        dtype=np.int32, timeout=120.0)
    xs = rng.integers(-(2**27), 2**27, size=(nb * tb, 1),
                      dtype=np.int64).astype(np.int32)
    t0 = time.perf_counter()
    producer_thread(ex.ring, xs)
    state, _ = ex.run(collect=False)
    dt = time.perf_counter() - t0
    rate = nb * tb * c / dt
    print(f"channels: {c}, blocks: {nb} x {tb} samples")
    print(f"sustained: {rate / 1e9:.3f} GS/s (aggregate, incl. compile)")
    print(f"blocks processed: {ex.blocks_processed}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
