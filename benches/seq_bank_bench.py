"""Lane-bank kernel against `lax.scan`: the Q32 DF1 alone and the chain.

For each width c (2c I|Q lanes, t samples):

* the Q32<29> DF1 as `lax.scan` (`biquad.df1_process_q`, what XLA makes
  of the plain version) and as the lane-bank kernel at 8 to 64 time
  steps per loop iteration, after checking the kernel bit-equal to the
  scan;
* the headline chain (`pipelines.ddc_chain`) with each DF1.

Times are seconds per block from `profiling.measure_rate` (median of
iteration differences, `block_until_ready`).  Prints one JSON line per
measurement and writes them all to ``--out``.  Needs a GPU.

    python benches/seq_bank_bench.py [--channels 512 1024] [--time 32768]
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--channels", type=int, nargs="+", default=[512, 1024])
    ap.add_argument("--time", type=int, default=32768)
    ap.add_argument("--chunks", type=int, nargs="+", default=[8, 16, 32, 64])
    ap.add_argument("--trials", type=int, default=5)
    ap.add_argument("--out", default="chiprun_out/seq_bank_bench.jsonl")
    args = ap.parse_args(argv)

    from idsp_tpu import device

    device.enable_compile_cache()
    info = device.require_gpu()
    card = device.card_line()
    print(f"# card: {card}", flush=True)

    import jax
    import jax.numpy as jnp
    import numpy as np

    from idsp_tpu import profiling
    from idsp_tpu.filters import biquad
    from idsp_tpu.filters.seq_bank import _seq_bank, chunk_steps
    from idsp_tpu.pipelines import ddc_chain

    ba_q = ddc_chain.lowpass_coefficients()
    ba = np.asarray(ba_q, np.int32)
    step = functools.partial(biquad.df1_step_q, ba, 29)
    rows = []

    def emit(**rec):
        rec.update(device=info, card=card)
        rows.append(rec)
        print(json.dumps(rec), flush=True)

    def rate(fn, state, *a):
        sec, diffs = profiling.measure_rate(
            fn, state, *a, iters=(2, 12), trials=args.trials
        )
        return sec, [float(d) for d in diffs]

    t = args.time
    rng = np.random.default_rng(0)
    for c in args.channels:
        lanes = 2 * c
        xs = jnp.asarray(rng.integers(-(2**27), 2**27, size=(t, lanes),
                                      dtype=np.int64).astype(np.int32))
        st = biquad.Df1State(
            x=jnp.asarray(rng.integers(-(2**27), 2**27, (lanes, 2)),
                          jnp.int32),
            y=jnp.asarray(rng.integers(-(2**27), 2**27, (lanes, 2)),
                          jnp.int32),
        )
        scan = jax.jit(lambda s, x: biquad.df1_process_q(ba, 29, s, x))
        s_ref, y_ref = scan(st, xs)
        sec, diffs = rate(scan, st, xs)
        emit(what="df1", impl="scan", c=c, t=t, seconds=sec, diffs=diffs,
             samples_per_s=c * t / sec)
        leaves, treedef = jax.tree.flatten(st)
        for k in args.chunks:
            def kern(s, x, k=k):
                lv, _ = jax.tree.flatten(s)
                return _seq_bank(step, treedef, tuple(lv), x, dec=1,
                                 out_dtype=None, interpret=False, chunk=k)

            kern = jax.jit(kern)
            s_k, y_k = kern(st, xs)
            exact = bool(jnp.array_equal(y_k, y_ref)) and all(
                bool(jnp.array_equal(a, b2))
                for a, b2 in zip(jax.tree.leaves(s_k), jax.tree.leaves(s_ref))
            )
            sec, diffs = rate(kern, st, xs)
            emit(what="df1", impl="kernel", chunk=k, c=c, t=t,
                 seconds=sec, diffs=diffs, samples_per_s=c * t / sec,
                 bit_exact=exact, default_chunk=chunk_steps(1))

        x = xs[:, 0]
        steps = jnp.asarray(rng.integers(1 << 24, 1 << 30, size=(c,)),
                            jnp.int32)
        cst = ddc_chain.init(c)
        outs = {}
        for name, fn in (("scan", ddc_chain.block_reference),
                         ("kernel", ddc_chain.block)):
            run = functools.partial(fn, ba_q=ba_q)
            compiled = jax.jit(run).lower(cst, x, steps).compile()
            mem = compiled.memory_analysis()
            out = outs[name] = run(cst, x, steps)
            sec, diffs = rate(run, cst, x, steps)
            emit(what="chain", impl=name, c=c, t=t, seconds=sec, diffs=diffs,
                 samples_per_s=c * t / sec,
                 temp_bytes=getattr(mem, "temp_size_in_bytes", None),
                 checksum=float(jnp.sum(out[1][0])))
        emit(what="chain_equal", c=c, t=t, bit_exact=all(
            bool(jnp.array_equal(a, b))
            for a, b in zip(jax.tree.leaves(outs["scan"]),
                            jax.tree.leaves(outs["kernel"]))))

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as fh:
        for r in rows:
            fh.write(json.dumps(r) + "\n")


if __name__ == "__main__":
    main()
