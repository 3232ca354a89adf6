"""Multi-card scaling harness (BASELINE.json north star: >= 80%
samples/s efficiency from 1 card to 4).

Runs the channel-sharded DDC chain (`pipelines.ddc_chain`: NCO mix ->
Q32 DF1 biquad -> HBF decimate-by-8) at 1/2/4/... devices, weak scaling
(fixed channels per device), and reports:

* samples/s per device count + weak-scaling efficiency vs 1 device;
* bytes moved over collectives per block (parsed from the compiled
  HLO), per collective kind — the channel-parallel chain should be
  zero; the sequence-parallel biquad pays ppermute + all_gather;
* the same table for the SP (time-sharded) float biquad, the
  collective-heavy path.

Uses whatever `jax.devices()` offers.  A rehearsal on virtual CPU
devices (``JAX_PLATFORMS=cpu
XLA_FLAGS=--xla_force_host_platform_device_count=4``) checks the
scaling machinery and collective volume; its times are CPU times, not
device numbers.

Usage: python benches/scaling.py [--devices 1,2,4]
"""

from __future__ import annotations

import argparse
import os
import re
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=str, default="1,2,4")
    ap.add_argument("--channels-per-device", type=int, default=128)
    ap.add_argument("--time", type=int, default=4096)
    ap.add_argument("--iters", type=int, default=3)
    return ap.parse_args(argv)


def _collective_bytes(compiled_text: str) -> dict:
    """Sum output bytes of collective ops in a compiled HLO dump.

    Crude but effective: every collective op line carries its result
    shape; bytes = product(dims) * dtype size.
    """
    sizes = {"f32": 4, "f64": 8, "s32": 4, "s64": 8, "u32": 4, "u64": 8,
             "s16": 2, "u16": 2, "s8": 1, "u8": 1, "pred": 1, "bf16": 2}
    out: dict[str, int] = {}
    pat = re.compile(
        r"=\s*(\w+)\[([\d,]*)\][^ ]*\s+(all-gather|collective-permute|"
        r"all-reduce|reduce-scatter|all-to-all)"
    )
    for m in pat.finditer(compiled_text):
        dtype, dims, kind = m.groups()
        nbytes = sizes.get(dtype, 4)
        for d in dims.split(","):
            if d.strip():
                nbytes *= int(d)
        out[kind] = out.get(kind, 0) + nbytes
    return out


def main(argv=None):
    args = _parse_args(argv)
    dev_counts = [int(v) for v in args.devices.split(",")]

    import jax

    import jax.numpy as jnp
    import numpy as np
    from jax import shard_map
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P

    from idsp_tpu import device
    from idsp_tpu.design import Filter
    from idsp_tpu.filters import biquad
    from idsp_tpu.parallel.stream import sharded_df1_float
    from idsp_tpu.pipelines import ddc_chain

    device.enable_compile_cache()
    sync = jax.block_until_ready

    cpd, t = args.channels_per_device, args.time
    rng = np.random.default_rng(0)
    ba5 = biquad.from_cookbook(Filter().critical_frequency(0.02).lowpass())
    ba_q = jnp.asarray(biquad.quantize_ba(ba5, 29))

    rows = []

    def add_row(name, nd, rate, eff, coll, samples_per_step):
        coll_s = (
            ", ".join(f"{k}={v / 1e3:.1f}kB" for k, v in sorted(coll.items()))
            or "none"
        )
        rows.append({
            "name": name, "nd": nd, "rate": rate, "eff": eff,
            "coll_s": coll_s, "t_step": samples_per_step / rate,
        })
        return coll_s

    ba_tuple = tuple(int(v) for v in np.asarray(ba_q))

    print(f"# device={device.describe()} cpd={cpd} t={t}", flush=True)

    # --- machinery baseline: a no-op shard_map step per device count,
    # the floor any row pays at that device count for dispatch and
    # mesh machinery.
    noop_step_s = {}
    for nd in dev_counts:
        if nd > len(jax.devices()):
            continue
        mesh = Mesh(np.array(jax.devices()[:nd]), ("mx",))
        buf = jnp.zeros((nd * cpd, 128), jnp.float32)
        fn = jax.jit(
            shard_map(
                lambda s: s + jnp.float32(1.0), mesh=mesh,
                in_specs=(P("mx"),), out_specs=P("mx"),
            )
        )
        out = fn(buf)
        sync(out)
        best = float("inf")
        for _ in range(3):
            b2 = buf
            t0 = time.perf_counter()
            for _ in range(max(args.iters * 8, 16)):
                b2 = fn(b2)
            sync(b2)
            best = min(best, time.perf_counter() - t0)
        noop_step_s[nd] = best / max(args.iters * 8, 16)
        print(f"noop shard_map x{nd}: {noop_step_s[nd] * 1e6:.0f} us/step",
              flush=True)

    base_rate = None
    for nd in dev_counts:
        if nd > len(jax.devices()):
            print(f"# skip {nd} devices (only {len(jax.devices())})")
            continue
        c = cpd * nd
        mesh = Mesh(np.array(jax.devices()[:nd]), ("dp",))
        steps = jnp.asarray(
            rng.integers(1 << 24, 1 << 30, size=(c,), dtype=np.int64).astype(
                np.int32
            )
        )
        x = jnp.asarray(
            rng.integers(-(2**27), 2**27, size=(t,), dtype=np.int64).astype(
                np.int32
            )
        )
        fn = ddc_chain.channel_sharded(mesh, "dp", ba_q=ba_tuple)
        gstate = ddc_chain.init(c)
        lowered = fn.lower(gstate, x, steps)
        compiled = lowered.compile()
        coll = _collective_bytes(compiled.as_text())

        out = fn(gstate, x, steps)
        sync(out)
        best = float("inf")
        for _ in range(3):
            st = gstate
            t0 = time.perf_counter()
            for _ in range(args.iters):
                st, z = fn(st, x, steps)
            sync(z)
            best = min(best, time.perf_counter() - t0)
        rate = c * t * args.iters / best
        if nd == dev_counts[0]:
            base_rate = rate / nd
        eff = rate / (nd * base_rate) if base_rate else float("nan")
        coll_s = add_row(f"dp chain x{nd}", nd, rate, eff, coll, c * t)
        print(f"dp chain x{nd}: {rate / 1e6:.1f} MS/s  eff={eff:.2f}"
              f"  collectives/block: {coll_s}", flush=True)

    # SP (time-sharded) float biquad — the collective-paying path
    sp_base = None
    for nd in dev_counts:
        if nd > len(jax.devices()):
            continue
        mesh = Mesh(np.array(jax.devices()[:nd]), ("sp",))
        c_sp = cpd
        tt = t  # fixed total length: strong scaling for SP
        xs = jnp.asarray(rng.normal(size=(tt, c_sp)))
        st = biquad.df1_init((c_sp,), jnp.float64)
        ba_f = jnp.asarray(ba5)

        def sp_fn(st, xs):
            return sharded_df1_float(ba_f, st, xs, "sp")

        fn = jax.jit(
            shard_map(
                sp_fn, mesh=mesh,
                in_specs=(P(), P("sp")),
                out_specs=(P(), P("sp")),
            )
        )
        compiled = fn.lower(st, xs).compile()
        coll = _collective_bytes(compiled.as_text())
        out = fn(st, xs)
        sync(out)
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            s2 = st
            for _ in range(args.iters):
                s2, ys = fn(s2, xs)
            sync(ys)
            best = min(best, time.perf_counter() - t0)
        rate = c_sp * tt * args.iters / best
        if sp_base is None:
            sp_base = rate
        eff = rate / sp_base
        coll_s = add_row(f"sp df1 x{nd}", nd, rate, eff, coll, c_sp * tt)
        print(f"sp df1 x{nd}: {rate / 1e6:.1f} MS/s  speedup={eff:.2f}"
              f"  collectives/block: {coll_s}", flush=True)

    # PP: S-stage pipelined SOS cascade, one stage per device, block
    # storage sharded over the pipe (O(nb/S) memory per device).  The
    # cascade DEEPENS with the device count at fixed stream length — an
    # ideal pipeline holds samples/s constant as stages are added, so
    # efficiency is rate(nd) / rate(1).
    pp_base = None
    for nd in dev_counts:
        if nd > len(jax.devices()):
            continue
        mesh = Mesh(np.array(jax.devices()[:nd]), ("pp",))
        nb = 4 * nd  # blocks divisible by the stage count
        tb = max(64, t // nb)
        bas = jnp.asarray(
            [
                biquad.quantize_ba(
                    biquad.from_cookbook(
                        Filter().critical_frequency(
                            0.02 + 0.01 * (i % 4)
                        ).lowpass()
                    ),
                    29,
                )
                for i in range(nd)
            ]
        )
        xb = jnp.asarray(
            rng.integers(
                -(2**24), 2**24, size=(nb, tb, cpd), dtype=np.int64
            ).astype(np.int32)
        )

        from jax import shard_map as _shard_map
        from idsp_tpu.parallel.pipeline import pipelined_sos_cascade_sharded

        # cyclic block sharding (block b on device b mod S) — the
        # state-rotating schedule's layout; see pipeline.py.
        xc = xb.reshape((nb // nd, nd, tb, cpd))
        fn = jax.jit(
            _shard_map(
                lambda ba, x: pipelined_sos_cascade_sharded(
                    ba, x[:, 0], nb, 29, "pp"
                )[:, None],
                mesh=mesh,
                in_specs=(P(), P(None, "pp")),
                out_specs=P(None, "pp"),
            )
        )
        compiled = fn.lower(bas, xc).compile()
        coll = _collective_bytes(compiled.as_text())
        out = fn(bas, xc)
        sync(out)
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(args.iters):
                ys = fn(bas, xc)
            sync(ys)
            best = min(best, time.perf_counter() - t0)
        rate = nb * tb * cpd * args.iters / best
        if pp_base is None:
            pp_base = rate
        eff = rate / pp_base
        coll_s = add_row(f"pp sos x{nd}", nd, rate, eff, coll,
                         nb * tb * cpd)
        print(f"pp sos x{nd} ({nd} stages): {rate / 1e6:.1f} MS/s"
              f"  eff={eff:.2f}  collectives/block: {coll_s}", flush=True)

    # TP: polyphase channelizer with the DFT contraction axis sharded
    # and psum'd partials — strong scaling of a fixed M-branch bank.
    from idsp_tpu.pipelines import channelizer

    tp_base = None
    m_ch = 256
    taps_ch = 8
    n_frames = max(8, t // m_ch)
    for nd in dev_counts:
        if nd > len(jax.devices()) or m_ch % nd:
            continue
        mesh = Mesh(np.array(jax.devices()[:nd]), ("tp",))
        xf = jnp.asarray(
            rng.normal(size=(n_frames, m_ch, 2)).astype(np.float32)
        )
        st_tp = channelizer.init(m_ch, taps_ch)

        from jax import shard_map as _shard_map

        def mk_tp(out_mode, ospec):
            return jax.jit(
                _shard_map(
                    lambda st, x: channelizer.channelize_tp(
                        st, x, "tp", m=m_ch, taps=taps_ch,
                        out_mode=out_mode,
                    ),
                    mesh=mesh,
                    in_specs=(P(None, "tp", None), P(None, "tp", None)),
                    out_specs=(P(None, "tp", None), ospec),
                )
            )

        fn = mk_tp("replicated", P())
        compiled = fn.lower(st_tp, xf).compile()
        coll = _collective_bytes(compiled.as_text())
        out = fn(st_tp, xf)
        sync(out)
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            s2 = st_tp
            for _ in range(args.iters):
                s2, ys = fn(s2, xf)
            sync(ys)
            best = min(best, time.perf_counter() - t0)
        rate = n_frames * m_ch * args.iters / best
        if tp_base is None:
            tp_base = rate
        eff = rate / tp_base
        coll_s = add_row(f"tp channelizer m{m_ch} x{nd}", nd, rate, eff,
                         coll, n_frames * m_ch)
        print(f"tp channelizer m{m_ch} x{nd}: {rate / 1e6:.1f} MS/s"
              f"  speedup={eff:.2f}  collectives/block: {coll_s}",
              flush=True)

        # reduce-scatter output variant: psum_scatter leaves y
        # channel-sharded and moves 1/n_dev the bytes on the wire.
        if nd > 1:
            fn_rs = mk_tp("scatter", P(None, "tp", None))
            compiled = fn_rs.lower(st_tp, xf).compile()
            coll_rs = _collective_bytes(compiled.as_text())
            out = fn_rs(st_tp, xf)
            sync(out)
            best = float("inf")
            for _ in range(3):
                t0 = time.perf_counter()
                s2 = st_tp
                for _ in range(args.iters):
                    s2, ys = fn_rs(s2, xf)
                sync(ys)
                best = min(best, time.perf_counter() - t0)
            rate_rs = n_frames * m_ch * args.iters / best
            eff_rs = rate_rs / tp_base
            coll_s = add_row(
                f"tp channelizer m{m_ch} x{nd} (reduce-scatter)", nd,
                rate_rs, eff_rs, coll_rs, n_frames * m_ch)
            print(f"tp channelizer m{m_ch} x{nd} (rs): "
                  f"{rate_rs / 1e6:.1f} MS/s  speedup={eff_rs:.2f}"
                  f"  collectives/block: {coll_s}", flush=True)

    return rows


if __name__ == "__main__":
    main()
