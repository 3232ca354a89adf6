"""Named benchmark suite mirroring the reference's embedded bench configs
(tests/embedded/src/bin/{trig,biquad,hbf}.rs).

Default config: ``--channels 512 --time 32768 --trials 3``.  Each row
reports aggregate throughput (MS/s) over a C-channel bank — the
reference measures one core at one sample per call; here C channels run
side by side, so the comparison is total samples/s per card.  Each row
is the median of ``trials`` iteration differences
(`profiling.measure_rate`, `block_until_ready`), min/max in brackets.

Rows with both a scan and a lane-bank path bench both — the kernel is
the GPU path, the scan is the semantic reference it is bit-equal to.
Needs a GPU:

    python benches/suite.py [--only <substring>]
"""

from __future__ import annotations

import argparse
import statistics
import sys
from dataclasses import dataclass, field

import numpy as np

sys.path.insert(0, ".")


@dataclass
class Row:
    name: str
    rates: list = field(default_factory=list)  # samples/s per trial

    @property
    def median(self):
        return statistics.median(self.rates)

    @property
    def lo(self):
        return min(self.rates)

    @property
    def hi(self):
        return max(self.rates)

    def line(self) -> str:
        spread = (
            (self.hi - self.lo) / self.median * 100 if self.median else 0.0
        )
        return (
            f"{self.name:36s} {self.median / 1e6:12.1f} MS/s"
            f"  [{self.lo / 1e6:.0f}, {self.hi / 1e6:.0f}]"
            f" ({spread:4.1f}% spread)"
        )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--channels", type=int, default=512)
    ap.add_argument("--time", type=int, default=32768)
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--only", type=str, default=None,
                    help="substring filter on row names")
    args = ap.parse_args(argv)

    from idsp_tpu import device

    device.enable_compile_cache()
    info = device.require_gpu()
    print(f"# device={info} card={device.card_line()}", flush=True)

    import jax
    import jax.numpy as jnp

    from idsp_tpu import fxp
    from idsp_tpu.design import Filter
    from idsp_tpu.filters import biquad, cic, hbf, lowpass, pll, wdf
    from idsp_tpu.ops.trig import atan2, cossin
    from idsp_tpu.profiling import measure_rate

    c, t, trials = args.channels, args.time, args.trials
    n = c * t
    rng = np.random.default_rng(0)
    rows: list[Row] = []

    def run_trials(name, fn, state, *xargs, samples=n, stateful=True):
        """Bench one row: median of ``trials`` iteration differences."""
        if args.only and args.only not in name:
            return
        try:
            fn = jax.jit(fn)
            _, diffs = measure_rate(fn, state, *xargs, trials=trials,
                                    stateful=stateful)
        except Exception as e:  # noqa: BLE001 — report and go on
            print(f"# {name} failed: {type(e).__name__}: {str(e)[:200]}")
            return
        row = Row(name, [samples / d for d in diffs if d > 0])
        if not row.rates:
            print(f"# {name}: no positive iteration difference")
            return
        rows.append(row)
        print(row.line(), flush=True)

    # ---- fixtures ----
    phases = jnp.asarray(
        rng.integers(-(2**31), 2**31, size=(t, c), dtype=np.int64).astype(
            np.int32
        )
    )
    xy = jnp.asarray(
        rng.integers(-(2**31), 2**31, size=(2, t, c), dtype=np.int64).astype(
            np.int32
        )
    )
    ba5 = biquad.from_cookbook(Filter().critical_frequency(0.1).lowpass())
    ba_q29 = jnp.asarray(biquad.quantize_ba(ba5, 29))
    xs_i = jnp.asarray(
        rng.integers(-(2**24), 2**24, size=(t, c), dtype=np.int64).astype(
            np.int32
        )
    )
    xs_f32 = jnp.asarray(rng.normal(size=(t, c)).astype(np.float32))
    xs_f64 = jnp.asarray(rng.normal(size=(t, c)))

    def scan_of(step_fn, *cfg, unroll=8):
        @jax.jit
        def run(st, xs):
            return jax.lax.scan(
                lambda s, x: step_fn(*cfg, s, x), st, xs, unroll=unroll
            )

        return run

    # ---- trig (trig.rs:28-29) ----
    run_trials("cossin slice", jax.jit(lambda p: cossin(p)), phases,
               stateful=False)
    run_trials("atan2 slice", jax.jit(lambda a: atan2(a[1], a[0])), xy,
               stateful=False)

    # ---- biquad variants (biquad.rs bench configs) ----
    run_trials("q32<29> df1 (scan)", scan_of(biquad.df1_step_q, ba_q29, 29),
               biquad.df1_init((c,), jnp.int32), xs_i)

    from idsp_tpu.filters import biquad_pallas as bp

    run_trials(
        "q32<29> df1 (lane bank)",
        lambda st, xs: bp.df1_bank_q(ba_q29, st, xs, 29),
        biquad.df1_init((c,), jnp.int32), xs_i,
    )
    run_trials(
        "q32<29> df1 (lane bank, runtime coefs)",
        lambda st, xs: bp.df1_bank_q_coef(ba_q29, st, xs, 29),
        biquad.df1_init((c,), jnp.int32), xs_i,
    )

    ba_q13_16 = jnp.asarray(biquad.quantize_ba(ba5, 13, dtype=jnp.int16))
    xs_i16 = jnp.asarray(
        rng.integers(-(2**14), 2**14, size=(t, c), dtype=np.int64).astype(
            np.int16
        )
    )
    run_trials(
        "q16<13> df1 (scan)",
        scan_of(
            lambda ba, f, s, x: biquad.df1_step_q(ba, f, s, x,
                                                  dtype=jnp.int16),
            ba_q13_16, 13,
        ),
        biquad.df1_init((c,), jnp.int16), xs_i16,
    )
    run_trials(
        "q16<13> df1 (lane bank)",
        lambda st, xs: bp.df1_bank_q16(ba_q13_16, st, xs, 13),
        biquad.df1_init((c,), jnp.int16), xs_i16,
    )

    ba_q61 = jnp.asarray(biquad.quantize_ba(ba5, 61, dtype=jnp.int64))
    xs_i64 = jnp.asarray(
        rng.integers(-(2**55), 2**55, size=(t, c), dtype=np.int64)
    )
    run_trials("q64<61> df1 (scan, emulated i128)",
               scan_of(biquad.df1_step_q64, ba_q61, 61),
               biquad.df1_init((c,), jnp.int64), xs_i64)
    run_trials(
        "q64<61> df1 (lane bank)",
        lambda st, xs: bp.df1_bank_q64(ba_q61, st, xs, 61),
        biquad.df1_init((c,), jnp.int64), xs_i64,
    )

    run_trials("q32 wide (scan)", scan_of(biquad.df1_wide_step, ba_q29, 29),
               biquad.df1_wide_init((c,)), xs_i)
    run_trials("q32 dither (scan)",
               scan_of(biquad.df1_dither_step, ba_q29, 29),
               biquad.df1_dither_init((c,)), xs_i)

    u, lo, hi = 0, -(2**30), 2**30

    @jax.jit
    def run_clamp(st, xs):
        return jax.lax.scan(
            lambda s, x: biquad.clamp_step(
                biquad.df1_step_q(ba_q29, 29, s, x),
                jnp.int32(u), jnp.int32(lo), jnp.int32(hi),
            ),
            st, xs, unroll=8,
        )

    run_trials("q32 clamp (scan)", run_clamp,
               biquad.df1_init((c,), jnp.int32), xs_i)

    run_trials(
        "q32 clamp (lane bank)",
        lambda st, xs: bp.df1_clamp_bank_q(
            ba_q29, st, xs, 29, u=u, lo=lo, hi=hi
        ),
        biquad.df1_init((c,), jnp.int32), xs_i,
    )
    run_trials(
        "q32 wide (lane bank)",
        lambda st, xs: bp.df1_wide_bank(ba_q29, st, xs, 29),
        biquad.df1_wide_init((c,)), xs_i,
    )
    run_trials(
        "q32 dither (lane bank)",
        lambda st, xs: bp.df1_dither_bank(ba_q29, st, xs, 29),
        biquad.df1_dither_init((c,)), xs_i,
    )
    run_trials(
        "q32 clamp+wide (lane bank)",
        lambda st, xs: bp.df1_wide_bank(
            ba_q29, st, xs, 29, clamp=(u, lo, hi)
        ),
        biquad.df1_wide_init((c,)), xs_i,
    )
    run_trials(
        "q32 clamp+dither (lane bank)",
        lambda st, xs: bp.df1_dither_bank(
            ba_q29, st, xs, 29, clamp=(u, lo, hi)
        ),
        biquad.df1_dither_init((c,)), xs_i,
    )

    # ---- float biquads ----
    ba_f32 = jnp.asarray(ba5.astype(np.float32))
    run_trials("f32 df1 (scan)", scan_of(biquad.df1_step, ba_f32),
               biquad.df1_init((c,), jnp.float32), xs_f32)
    run_trials("f32 df2t (scan)", scan_of(biquad.df2t_step, ba_f32),
               biquad.df2t_init((c,), jnp.float32), xs_f32)
    run_trials(
        "f32 df1 (lane bank)",
        lambda st, xs: bp.df1_bank_f32(
            np.asarray(ba5, np.float32), st, xs
        ),
        biquad.df1_init((c,), jnp.float32), xs_f32,
    )
    run_trials(
        "f32 df1 (assoc block)",
        jax.jit(lambda st, xs: biquad.df1_block_float(ba_f32, st, xs)),
        biquad.df1_init((c,), jnp.float32), xs_f32,
    )
    run_trials("f64 df1 (scan)", scan_of(biquad.df1_step, jnp.asarray(ba5)),
               biquad.df1_init((c,), jnp.float64), xs_f64)
    run_trials("f64 df2t (scan)", scan_of(biquad.df2t_step, jnp.asarray(ba5)),
               biquad.df2t_init((c,), jnp.float64), xs_f64)

    # ---- cascade4 (biquad.rs "idsp q32 Cascade4") ----
    ba_c = jnp.asarray(np.stack([biquad.quantize_ba(ba5, 29)] * 4))
    run_trials(
        "q32 cascade4 (scan)",
        scan_of(biquad.cascade_step_q, ba_c, 29, unroll=4),
        biquad.cascade_init(4, (c,), jnp.int32), xs_i,
    )

    def run_sos(states, xs):
        return bp.sos_bank_q(
            np.stack([biquad.quantize_ba(ba5, 29)] * 4), states, xs, 29,
        )

    run_trials(
        "q32 cascade4 (lane bank)", run_sos,
        [biquad.df1_init((c,), jnp.int32) for _ in range(4)], xs_i,
    )

    # ---- lowpass (biquad.rs lowpass1/lowpass2) ----
    k1 = jnp.asarray(lowpass.gains1(0.01))
    run_trials("lowpass1", jax.jit(lambda st, xs: lowpass.block(k1, st, xs)),
               lowpass.init(1, (c,)), xs_i)
    k2 = jnp.asarray(lowpass.gains2(0.01))
    run_trials("lowpass2", jax.jit(lambda st, xs: lowpass.block(k2, st, xs)),
               lowpass.init(2, (c,)), xs_i)
    from idsp_tpu.filters.lowpass_pallas import lowpass_bank

    run_trials(
        "lowpass1 (lane bank)",
        lambda st, xs: lowpass_bank(
            lowpass.gains1(0.01), st, xs
        ),
        lowpass.init(1, (c,)), xs_i,
    )
    run_trials(
        "lowpass2 (lane bank)",
        lambda st, xs: lowpass_bank(
            lowpass.gains2(0.01), st, xs
        ),
        lowpass.init(2, (c,)), xs_i,
    )

    # ---- WDF complementary allpass 7 (biquad.rs wdf-ca-7) ----
    tp = wdf.nibbles(0xAD, 2)
    b0 = [
        (tp, jnp.asarray(wdf.quantize(tp, [-0.9, 0.9]))),
        (tp, jnp.asarray(wdf.quantize(tp, [-0.6, 0.7]))),
    ]
    b1 = [
        (tp, jnp.asarray(wdf.quantize(tp, [-0.7, 0.6]))),
        (wdf.nibbles(0xA, 1),
         jnp.asarray(wdf.quantize(wdf.nibbles(0xA, 1), [0.8]))),
    ]
    wdf_states = (
        [wdf.init(2, (c,)), wdf.init(2, (c,))],
        [wdf.init(2, (c,)), wdf.init(1, (c,))],
    )
    run_trials("wdf-ca-7 (scan)",
               jax.jit(lambda sts, xs: wdf.pair_block(b0, b1, sts, xs)),
               wdf_states, xs_i)
    from idsp_tpu.filters.wdf_pallas import wdf_pair_bank

    run_trials(
        "wdf-ca-7 (lane bank)",
        lambda sts, xs: wdf_pair_bank(b0, b1, sts, xs),
        wdf_states, xs_i,
    )

    # ---- WDF complementary allpass 19th order (biquad.rs:143-173,
    # Gazsi 1985 Example 5; baseline 83 cyc/smp M7) ----
    g19_0 = [
        (wdf.nibbles(0x1, 1), [0.0]),
        (wdf.nibbles(0x1C, 2), [-0.226119, 0.0]),
        (wdf.nibbles(0x1D, 2), [-0.602422, 0.0]),
        (wdf.nibbles(0x1D, 2), [-0.83932, 0.0]),
        (wdf.nibbles(0x1D, 2), [-0.950847, 0.0]),
    ]
    g19_1 = [
        (wdf.nibbles(0x1C, 2), [-0.063978, 0.0]),
        (wdf.nibbles(0x1C, 2), [-0.423068, 0.0]),
        (wdf.nibbles(0x1D, 2), [-0.741327, 0.0]),
        (wdf.nibbles(0x1D, 2), [-0.905567, 0.0]),
        (wdf.nibbles(0x1D, 2), [-0.984721, 0.0]),
    ]
    b0_19 = [(tp_, jnp.asarray(wdf.quantize(tp_, gg))) for tp_, gg in g19_0]
    b1_19 = [(tp_, jnp.asarray(wdf.quantize(tp_, gg))) for tp_, gg in g19_1]
    wdf19_states = (
        [wdf.init(len(tp_), (c,)) for tp_, _ in g19_0],
        [wdf.init(len(tp_), (c,)) for tp_, _ in g19_1],
    )
    run_trials("wdf-ca-19 (scan)",
               jax.jit(lambda sts, xs: wdf.pair_block(b0_19, b1_19, sts, xs)),
               wdf19_states, xs_i)
    run_trials(
        "wdf-ca-19 (lane bank)",
        lambda sts, xs: wdf_pair_bank(b0_19, b1_19, sts, xs),
        wdf19_states, xs_i,
    )

    # ---- PLL bank ----
    pba = jnp.asarray(pll.coefficients_from_bandwidth(1e-2, 4.0))
    run_trials("pll bank (scan)",
               jax.jit(lambda st, xs: pll.block(pba, st, xs)),
               pll.init((c,)), phases)
    from idsp_tpu.filters.pll_pallas import pll_bank

    run_trials(
        "pll bank (lane bank)",
        lambda st, xs: pll_bank(pba, st, xs),
        pll.init((c,)), phases,
    )

    # ---- SVF / normal-form / RPLL banks ----
    from idsp_tpu.filters import normal, rpll, svf

    svf_f, svf_qi = svf.coefficients(0.01, 0.7)
    run_trials(
        "svf bank (scan)",
        jax.jit(lambda st, xs: svf.block(svf_f, svf_qi, st, xs)),
        svf.init((c,), jnp.float32), xs_f32,
    )
    nb, npole = normal.from_cookbook(
        Filter().critical_frequency(0.06).lowpass()
    )
    nb_q = np.asarray(fxp.from_float(jnp.asarray(nb), 29))
    np_q = np.asarray(fxp.from_float(jnp.asarray(npole), 29))
    run_trials(
        "normal form q32 (scan)",
        scan_of(
            lambda b, p, s, x: normal.step_q(b, p, 29, s, x),
            jnp.asarray(nb_q), jnp.asarray(np_q),
        ),
        normal.init((c,), jnp.int32), xs_i,
    )
    rcfg = rpll.RpllConfig(dt2=8, shift_frequency=12, shift_phase=11)
    r_valids = jnp.asarray(
        rng.integers(0, 64, size=(t, c), dtype=np.int64) == 0
    )
    run_trials(
        "rpll bank (scan)",
        jax.jit(lambda st, xs, v: rpll.block(rcfg, st, xs, v)),
        rpll.init((c,)), phases, r_valids,
    )
    from idsp_tpu.filters.normal_pallas import normal_bank_q
    from idsp_tpu.filters.rpll_pallas import rpll_bank
    from idsp_tpu.filters.svf_pallas import svf_bank

    run_trials(
        "svf bank (lane bank)",
        lambda st, xs: svf_bank(svf_f, svf_qi, st, xs),
        svf.init((c,), jnp.float32), xs_f32,
    )
    run_trials(
        "normal form q32 (lane bank)",
        lambda st, xs: normal_bank_q(
            nb_q, np_q, st, xs, 29
        ),
        normal.init((c,), jnp.int32), xs_i,
    )
    run_trials(
        "rpll bank (lane bank)",
        lambda st, xs, v: rpll_bank(rcfg, st, xs, v),
        rpll.init((c,)), phases, r_valids,
    )

    # ---- FIR / HBF (hbf.rs:29-54) ----
    del phases, xy, xs_f64  # free ~320 MB of early fixtures

    x_hbf = jnp.asarray(rng.normal(size=(c, t)).astype(np.float32))
    taps8 = jnp.asarray(
        np.array([0.01, -0.05, 0.12, 0.44], np.float32)
    )  # 8-tap even-symmetric (fir es-8 analog, biquad.rs bench)
    run_trials(
        "fir es-8 (block conv)",
        jax.jit(
            lambda st, x: hbf.fir_block(taps8, st, x, odd=False, sym=True)
        ),
        hbf.fir_init(4, False, (c,)), x_hbf,
    )
    # single-stage decimators (hbf.rs:636-655 Skylake rows): the 3-mul
    # (11-tap) last stage and the 23-mul (91-tap) first stage
    x_hbf_t = jnp.asarray(rng.normal(size=(t, c)).astype(np.float32))
    run_trials(
        "hbf dec 3-mul single stage (t-major)",
        jax.jit(lambda st, x: hbf.hbf_dec_block(
            hbf.HBF_TAPS[4], st, x, axis=0
        )),
        hbf.hbf_dec_init(len(hbf.HBF_TAPS[4]), (c,), axis=0), x_hbf_t,
    )
    run_trials(
        "hbf dec 23-mul single stage (t-major)",
        jax.jit(lambda st, x: hbf.hbf_dec_block(
            hbf.HBF_TAPS[0], st, x, axis=0
        )),
        hbf.hbf_dec_init(len(hbf.HBF_TAPS[0]), (c,), axis=0), x_hbf_t,
    )
    run_trials("hbf dec8 cascade",
               jax.jit(lambda st, x: hbf.hbf_dec_cascade(st, x)),
               hbf.hbf_dec_cascade_init(3, (c,)), x_hbf)
    run_trials("hbf dec8 cascade (t-major)",
               jax.jit(lambda st, x: hbf.hbf_dec_cascade(st, x, axis=0)),
               hbf.hbf_dec_cascade_init(3, (c,), axis=0), x_hbf.T)
    x_hbf_lo = jnp.asarray(rng.normal(size=(c, t // 8)).astype(np.float32))
    run_trials("hbf int8 cascade",
               jax.jit(lambda st, x: hbf.hbf_int_cascade(st, x)),
               hbf.hbf_int_cascade_init(3, (c,)), x_hbf_lo)

    # ---- FM discriminator receiver bank (BASELINE config #1) ----
    from idsp_tpu.pipelines import fm_disc

    ph_fm = jnp.asarray(
        rng.integers(-(2**31), 2**31, size=(t, c), dtype=np.int64).astype(
            np.int32
        )
    )
    re_fm, im_fm = cossin(ph_fm)
    ba_fm = jnp.asarray(fm_disc.deemphasis_coefficients(0.02))

    def run_fm(st, re, im):
        st2, y = fm_disc.fm_receiver(st, re, im, jnp.int32(12345), ba_fm)
        return st2, y

    run_trials("fm receiver bank", jax.jit(run_fm),
               fm_disc.init_state((c,)), re_fm, im_fm)

    # ---- rate-conversion round trip (BASELINE config #4) ----
    from idsp_tpu.pipelines import rate_conversion

    del ph_fm, re_fm, im_fm  # free 192 MB of fm fixtures (HBM headroom)

    run_trials(
        "rate conv 16x dec+int round trip",
        jax.jit(lambda st, x: rate_conversion.round_trip(st, x)),
        rate_conversion.init(4, (c,)), x_hbf,
    )
    run_trials(
        "rate conv 16x round trip (lane bank)",
        lambda st, x: rate_conversion.round_trip_t(
            st, x, use_kernel=True
        ),
        rate_conversion.init_t(4, (c,)), x_hbf.T,
    )
    run_trials(
        "rate conv 16x round trip (mxu)",
        lambda st, x: rate_conversion.round_trip_t(
            st, x, use_kernel="mxu"
        ),
        rate_conversion.init_t(4, (c,)), x_hbf.T,
    )

    # ---- CIC (cic.rs:400-422) ----
    x_cic = jnp.asarray(
        rng.integers(-(2**16), 2**16, size=(c, t), dtype=np.int64).astype(
            np.int32
        )
    )
    run_trials("cic dec N=3 R=16",
               jax.jit(lambda st, x: cic.decimate_block(st, x, 15)),
               cic.init(3, 1, (c,)), x_cic)
    x_cic_lo = jnp.asarray(
        rng.integers(-(2**10), 2**10, size=(c, t // 16),
                     dtype=np.int64).astype(np.int32)
    )
    run_trials("cic int N=3 R=16",
               jax.jit(lambda st, x: cic.interpolate_block(st, x, 15)),
               cic.init(3, 1, (c,)), x_cic_lo)

    # modular recomposition (Integrator^N -> Downsample -> Comb^N),
    # bit-equal to the monolithic path (cic.rs:305-387; the reference
    # benches the monolithic/modular/chunked triple at cic.rs:413-421 —
    # the monolithic path here IS the blocked/chunked formulation)
    from idsp_tpu import process

    def run_cic_mod_dec(st, x):
        ints, combs = st
        cur = x
        new_ints, new_combs = [], []
        for s in ints:
            s2, cur = process.integrator_block(s, cur)
            new_ints.append(s2)
        cur = process.downsample(cur, 16, 0)
        for s in combs:
            s2, cur = process.comb_block(s, cur)
            new_combs.append(s2)
        return (new_ints, new_combs), cur

    run_trials(
        "cic dec modular N=3 R=16", jax.jit(run_cic_mod_dec),
        ([process.integrator_init((c,)) for _ in range(3)],
         [process.delay_init(1, (c,), jnp.int32) for _ in range(3)]),
        x_cic,
    )

    def run_cic_mod_int(st, x):
        combs, ints = st
        cur = x
        new_combs, new_ints = [], []
        for s in combs:
            s2, cur = process.comb_block(s, cur)
            new_combs.append(s2)
        cur = process.hold(cur, 16)
        for s in ints:
            s2, cur = process.integrator_block(s, cur)
            new_ints.append(s2)
        return (new_combs, new_ints), cur

    run_trials(
        "cic int modular N=3 R=16", jax.jit(run_cic_mod_int),
        ([process.delay_init(1, (c,), jnp.int32) for _ in range(3)],
         [process.integrator_init((c,)) for _ in range(3)]),
        x_cic_lo,
    )

    # ---- ddc_lockin bank (BASELINE config #2: f32 quadrature mix +
    # shared-coefficient I/Q lowpass, ddc_lockin.rs:27-42) ----
    lo_fs = np.linspace(0.05, 0.45, c)
    ph_t = (
        np.arange(t, dtype=np.float64)[:, None] * (2 * np.pi * lo_fs[None])
    ) % (2 * np.pi)
    lo_cos = jnp.asarray(np.cos(ph_t).astype(np.float32))
    lo_sin = jnp.asarray(np.sin(ph_t).astype(np.float32))
    ba_ddcl = jnp.asarray(
        biquad.from_cookbook(
            Filter().critical_frequency(0.002).lowpass()
        ).astype(np.float32)
    )
    x_one = xs_f32[:, :1]

    def run_ddcl(st, lc, ls):
        iq = jnp.concatenate([x_one * lc, -(x_one * ls)], axis=1)
        return biquad.df1_block_float(ba_ddcl, st, iq)

    run_trials("ddc lockin bank (f32 assoc)", jax.jit(run_ddcl),
               biquad.df1_init((2 * c,), jnp.float32), lo_cos, lo_sin)

    # ---- polyphase channelizer M=1024 (reference example #3 scaled to
    # the BASELINE wideband config; DFT as a real block matmul) ----
    from idsp_tpu.pipelines import channelizer as chz

    m_ch = 1024
    n_fr = max(32, t // m_ch)
    x_fr = jnp.asarray(
        rng.normal(size=(n_fr, m_ch, 2)).astype(np.float32)
    )
    run_trials(
        "channelizer m=1024 (matmul dft)",
        jax.jit(lambda st, x: chz.channelize(st, x, m=m_ch, taps=8)),
        chz.init(m_ch, 8), x_fr, samples=n_fr * m_ch,
    )
    run_trials(
        "channelizer m=1024 (fft)",
        jax.jit(
            lambda st, x: chz.channelize(st, x, m=m_ch, taps=8, dft="fft")
        ),
        chz.init(m_ch, 8), x_fr, samples=n_fr * m_ch,
    )
    # plane-layout path (no trailing size-2 axis), at least 1024 frames
    # per dispatch so the dispatch overhead is not what is measured
    n_pl = max(1024, t // m_ch)
    zr_pl = jnp.asarray(rng.normal(size=(n_pl, m_ch)).astype(np.float32))
    zi_pl = jnp.asarray(rng.normal(size=(n_pl, m_ch)).astype(np.float32))

    def _chz_planes(st, zr, zi, **kw):
        return chz.channelize_planes(st, zr, zi, m=m_ch, taps=8, **kw)

    run_trials(
        "channelizer m=1024 (planes, matmul)",
        jax.jit(_chz_planes), chz.init_planes(m_ch, 8), zr_pl, zi_pl,
        samples=n_pl * m_ch,
    )
    run_trials(
        "channelizer m=1024 (planes, bf16)",
        jax.jit(lambda st, a, b: _chz_planes(
            st, a, b, twiddle_dtype=jnp.bfloat16)),
        chz.init_planes(m_ch, 8), zr_pl, zi_pl,
        samples=n_pl * m_ch,
    )
    run_trials(
        "channelizer m=1024 (planes, fft)",
        jax.jit(lambda st, a, b: _chz_planes(st, a, b, dft="fft")),
        chz.init_planes(m_ch, 8), zr_pl, zi_pl,
        samples=n_pl * m_ch,
    )

    del zr_pl, zi_pl, x_fr  # free channelizer fixtures

    # ---- 1024-channel DDC bank with per-channel PLL (BASELINE #5) ----
    from idsp_tpu.pipelines import ddc_bank

    cb = 1024
    x_bank = jnp.asarray(
        rng.integers(-(2**27), 2**27, size=(t,), dtype=np.int64).astype(
            np.int32
        )
    )
    steps_bank = jnp.asarray(
        rng.integers(1 << 24, 1 << 30, size=(cb,), dtype=np.int64).astype(
            np.int32
        )
    )
    lp2_gains = tuple(int(v) for v in lowpass.gains2(0.004))
    pll_ba_t = tuple(
        int(v) for v in pll.coefficients_from_bandwidth(2e-2, 4.0)
    )
    ba_bank = tuple(
        int(v)
        for v in biquad.quantize_ba(
            biquad.from_cookbook(
                Filter().critical_frequency(0.004).lowpass()
            ),
            29,
        )
    )
    run_trials(
        "ddc bank 1024ch (lowpass2+pll)",
        lambda s, x, stp: ddc_bank.ddc_bank_block(
            s, x, stp, lp2_gains, pll_ba_t, decimate=16
        ),
        ddc_bank.init(cb), x_bank, steps_bank, samples=cb * t,
    )
    run_trials(
        "ddc bank 1024ch (biquad+pll)",
        lambda s, x, stp: ddc_bank.ddc_bank_block_biquad(
            s, x, stp, ba_bank, pll_ba_t, decimate=16
        ),
        ddc_bank.init_biquad(cb), x_bank, steps_bank, samples=cb * t,
    )
    run_trials(
        "ddc bank 1024ch (biquad+pll, fastlo)",
        lambda s, x, stp: ddc_bank.ddc_bank_block_biquad(
            s, x, stp, ba_bank, pll_ba_t, decimate=16, lo_mode="fast"
        ),
        ddc_bank.init_biquad(cb), x_bank, steps_bank, samples=cb * t,
    )

    print(f"# channels={c} block={t} trials={trials}")
    for r in rows:
        print(r.line())
    return rows


if __name__ == "__main__":
    main()
