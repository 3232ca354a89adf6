"""Smoke test of the main paths on the GPU, each against its reference.

Runs, at real widths and for a few blocks with the state carried:

1. the headline DDC chain (`pipelines.ddc_chain`, c=512 and c=1024,
   t=32768): the lane-bank DF1 bit-equal to `biquad.df1_process_q`, the
   chain bit-equal to the same composition on the scan DF1, and the
   fast-LO chain holding the coherent-tone SNR gate of the exact-LO one;
2. the BASELINE #5 DDC bank (c=1024, t=16384, decimation 16, exact and
   fast LO, biquad and Lowpass2 variants) bit-equal to the scan
   composition;
3. the FM receiver bank (c=1024, t=32768) bit-equal to the scan;
4. the 16x rate-conversion round trip (t=32768, c=512) under its
   passband-tone and stopband gates;
5. the M=1024 channelizer against a float64 numpy reference;
6. every lane-bank kernel at 2048 lanes against its scan step.

Prints the card's name and power limit, the device, each headline
step's memory analysis, one line per check, each phase's wall time and
backend compiles, the compile-cache hits, and as its last line ``{"ok": true, "device": {...}}``.  Exits non-zero
if any check fails, and before any result when JAX finds no GPU.

``--four`` runs instead, on a 4-device mesh, the channel-sharded chain
and DDC bank, the time-sharded half-band decimator and float DF1, and
the integer carry relay, each against its one-device result.

Run: python chip_smoke.py [--four]
"""

from __future__ import annotations

import argparse
import functools
import json
import sys
import time

import numpy as np


def _check(results, name, ok, detail=""):
    results.append((name, bool(ok)))
    print(f"{'PASS' if ok else 'FAIL'} {name} {detail}".rstrip(), flush=True)


def _equal(a, b) -> bool:
    import jax

    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    return len(la) == len(lb) and all(
        x.shape == y.shape and x.dtype == y.dtype
        and bool(np.array_equal(np.asarray(x), np.asarray(y)))
        for x, y in zip(la, lb)
    )


def _i32(rng, shape, lim=2**27):
    import jax.numpy as jnp

    return jnp.asarray(
        rng.integers(-lim, lim, size=shape, dtype=np.int64).astype(np.int32)
    )


def _memory(fn, *args) -> str:
    import jax

    mem = jax.jit(fn).lower(*args).compile().memory_analysis()
    if mem is None:
        return "memory analysis unavailable"
    return (f"args {mem.argument_size_in_bytes} B, out "
            f"{mem.output_size_in_bytes} B, temp {mem.temp_size_in_bytes} B")


# --- 1. headline chain -------------------------------------------------------


def _tone_snr_db(zi, zq, off_step: int) -> float:
    """SNR of the coherent baseband tone of the chain SNR fixture
    (tests/test_chain_snr.py): carrier bins vs everything else."""
    z = np.asarray(zi, np.float64) + 1j * np.asarray(zq, np.float64)
    z = z[1024:1024 + 2048]
    n = len(z)
    spec = np.abs(np.fft.fft(z)) ** 2
    peak = int(np.argmax(spec))
    expect = int(round(off_step * 8 / 2**32 * n)) % n
    if min(abs(peak - expect), n - abs(peak - expect)) > 2:
        return float("-inf")
    p_sig = spec[max(peak - 1, 0):peak + 2].sum()
    return float(10 * np.log10(p_sig / (spec.sum() - p_sig)))


def phase_headline(results, c=512, t=32768, blocks=2, interpret=False,
                   memory=True, t_snr=32768):
    import jax
    import jax.numpy as jnp

    from idsp_tpu.filters import biquad
    from idsp_tpu.filters.biquad_pallas import df1_bank_q
    from idsp_tpu.ops import accu
    from idsp_tpu.ops.trig import cossin
    from idsp_tpu.pipelines import ddc_chain

    rng = np.random.default_rng(c)
    ba = ddc_chain.lowpass_coefficients()
    steps = _i32(rng, (c,), 2**30)
    x = _i32(rng, (t,))
    st = ddc_chain.init(c)
    if memory:
        print(f"# memory c={c} chain: "
              + _memory(functools.partial(ddc_chain.block, ba_q=ba),
                        st, x, steps), flush=True)

    # the DF1 alone, on the mixed lanes of a live block
    miq = jax.jit(ddc_chain.mix, static_argnums=3)(
        x, st.nco_phase, steps, "fast")
    bq0 = biquad.Df1State(x=_i32(rng, (2 * c, 2)), y=_i32(rng, (2 * c, 2)))
    got = df1_bank_q(ba, bq0, miq, 29, interpret=interpret)
    want = jax.jit(biquad.df1_process_q, static_argnums=1)(
        jnp.asarray(ba, jnp.int32), 29, bq0, miq)
    _check(results, f"headline df1 c={c} t={t}", _equal(got, want))

    ok = True
    s_k = s_r = st
    for _ in range(blocks):
        x = _i32(rng, (t,))
        s_k, y_k = ddc_chain.block(s_k, x, steps, ba)
        s_r, y_r = ddc_chain.block_reference(s_r, x, steps, ba)
        ok &= _equal(y_k, y_r)
    ok &= _equal(s_k, s_r)
    _check(results, f"headline chain c={c} t={t} x{blocks} blocks", ok)

    # SNR gate: a coherent tone through the fast-LO and exact-LO chains
    f0 = np.int32(0x4000_0000)
    off = np.int32(3 << 18)

    @jax.jit
    def tone(step):
        re_in, _ = cossin(accu.ramp(jnp.int32(123), step, t_snr))
        return ((re_in.astype(jnp.int64) * (1 << 27)) >> 31).astype(jnp.int32)

    x_snr = tone(jnp.int32(f0 + off))
    snr = {}
    for lo in ("exact", "fast"):
        _, (zi, zq) = ddc_chain.block(
            ddc_chain.init(c), x_snr, jnp.asarray(np.full((c,), f0)), ba,
            lo_mode=lo,
        )
        snr[lo] = _tone_snr_db(np.asarray(zi)[:, c - 1],
                               np.asarray(zq)[:, c - 1], int(off))
    _check(results, f"headline fast-LO SNR c={c}",
           snr["fast"] > 80.0 and snr["fast"] >= snr["exact"] - 1.0,
           f"(fast {snr['fast']:.1f} dB, exact {snr['exact']:.1f} dB,"
           " gate > 80 dB)")


# --- 2. DDC bank -------------------------------------------------------------


def phase_ddc_bank(results, c=1024, t=16384, d=16, blocks=2):
    import jax.numpy as jnp

    from idsp_tpu.design import Filter
    from idsp_tpu.filters import biquad, lowpass, pll
    from idsp_tpu.pipelines import ddc_bank

    rng = np.random.default_rng(5)
    steps = _i32(rng, (c,), 2**30)
    pll_ba = tuple(int(v) for v in pll.coefficients_from_bandwidth(2e-2))
    ba_q = tuple(int(v) for v in biquad.quantize_ba(
        biquad.from_cookbook(Filter().critical_frequency(0.004).lowpass()),
        29))
    gains = tuple(int(v) for v in lowpass.gains2(0.004))
    xs = [_i32(rng, (t,)) for _ in range(blocks)]
    cases = (
        ("biquad", ddc_bank.ddc_bank_block_biquad,
         ddc_bank.ddc_bank_block_biquad_reference, ddc_bank.init_biquad,
         ba_q),
        ("lowpass2", ddc_bank.ddc_bank_block,
         ddc_bank.ddc_bank_block_reference, ddc_bank.init, gains),
    )
    for lo in ("exact", "fast"):
        for name, fn, ref, init, coefs in cases:
            s_k = s_r = init(c)
            ok = True
            for x in xs:
                s_k, y_k = fn(s_k, x, jnp.asarray(steps), coefs, pll_ba,
                              decimate=d, lo_mode=lo)
                s_r, y_r = ref(s_r, x, jnp.asarray(steps), coefs, pll_ba,
                               decimate=d, lo_mode=lo)
                ok &= _equal(y_k, y_r)
            ok &= _equal(s_k, s_r)
            _check(results, f"ddc bank {name} {lo} LO c={c} t={t} d={d}", ok)


# --- 3. FM receiver ----------------------------------------------------------


def phase_fm(results, c=1024, t=32768, blocks=2):
    import jax
    import jax.numpy as jnp

    from idsp_tpu.ops.trig import cossin
    from idsp_tpu.pipelines import fm_disc

    rng = np.random.default_rng(3)
    ba = jnp.asarray(fm_disc.deemphasis_coefficients(0.02))
    carrier = jnp.int32(0x1934_1234)

    @jax.jit
    def signal(step, noise):
        ph = jnp.cumsum(jnp.broadcast_to(step, noise.shape).astype(jnp.int64)
                        + noise, axis=0).astype(jnp.int32)
        return cossin(ph)

    s_k = s_r = fm_disc.init_state((c,))
    ok = True
    for _ in range(blocks):
        re, im = signal(_i32(rng, (c,), 2**28), _i32(rng, (t, c), 2**22))
        s_k, y_k = fm_disc.fm_receiver(s_k, re, im, carrier, ba)
        s_r, y_r = fm_disc.fm_receiver_reference(s_r, re, im, carrier, ba)
        ok &= _equal(y_k, y_r)
    ok &= _equal(s_k, s_r)
    _check(results, f"fm receiver c={c} t={t}", ok)


# --- 4. rate conversion ------------------------------------------------------


def phase_rate(results, c=512, t=32768, depth=4):
    import jax
    import jax.numpy as jnp

    from idsp_tpu.pipelines import rate_conversion

    # half the channels carry a passband tone, half a stopband tone
    f_pass = 0.4 / (1 << depth) * 0.5
    f_stop = 0.35
    i = np.arange(t)[:, None]
    f = np.where(np.arange(c) < c // 2, f_pass, f_stop)[None]
    x = jnp.asarray(np.cos(2 * np.pi * f * i).astype(np.float32))
    _, y = jax.jit(rate_conversion.round_trip_t)(
        rate_conversion.init_t(depth, (c,)), x)
    y = np.asarray(y, np.float64)[4096:]
    x = np.asarray(x, np.float64)[4096:]
    p_ratio = (y[:, : c // 2] ** 2).mean(0) / (x[:, : c // 2] ** 2).mean(0)
    p_stop = (y[:, c // 2:] ** 2).mean(0)
    _check(results, f"rate conversion 16x round trip c={c} t={t}",
           np.abs(p_ratio - 1).max() < 1e-3
           and p_stop.max() < 0.5 * 10 ** (-98 / 10),
           f"(passband power error {np.abs(p_ratio - 1).max():.2e} < 1e-3,"
           f" stopband {10 * np.log10(p_stop.max() + 1e-300):.1f} dB"
           " < -101 dB)")


# --- 5. channelizer ----------------------------------------------------------


def phase_channelizer(results, m=1024, n=1024, taps=8):
    import jax
    import jax.numpy as jnp

    from idsp_tpu.pipelines import channelizer

    rng = np.random.default_rng(9)
    zr = rng.normal(size=(n, m)).astype(np.float32)
    zi = rng.normal(size=(n, m)).astype(np.float32)
    run = jax.jit(functools.partial(channelizer.channelize_planes, m=m,
                                    taps=taps))
    _, yr, yi = run(channelizer.init_planes(m, taps), jnp.asarray(zr),
                    jnp.asarray(zi))
    # float64 reference: the same polyphase FIR, then numpy's FFT
    h = channelizer.prototype(m, taps).astype(np.float64).reshape(taps, m)
    ext = np.concatenate([np.zeros((taps - 1, m)), zr + 1j * zi.astype(
        np.float64)])
    acc = sum(h[k] * ext[taps - 1 - k:taps - 1 - k + n] for k in range(taps))
    ref = np.fft.fft(acc, axis=-1)
    err = max(np.abs(np.asarray(yr, np.float64) - ref.real).max(),
              np.abs(np.asarray(yi, np.float64) - ref.imag).max())
    scale = np.abs(ref).max()
    # f32 DFT matmul at Precision.HIGHEST (no TF32): a K=2m f32 dot
    # product errs by ~sqrt(K) ulps; 1e-4 of the output scale leaves
    # room for that and would catch TF32 (10-bit mantissa, ~1e-3).
    _check(results, f"channelizer m={m} n={n}", err <= 1e-4 * scale,
           f"(max error {err / scale:.2e} of scale, gate 1e-4,"
           " f32 matmul at Precision.HIGHEST)")


# --- 6. every lane-bank kernel -----------------------------------------------


def kernel_cases(lanes: int, t: int, interpret: bool):
    """(name, kernel(), reference(), float ulp budget or None)."""
    import jax
    import jax.numpy as jnp

    from idsp_tpu.design import Filter
    from idsp_tpu.filters import (
        biquad, biquad_pallas as bp, lowpass, lowpass_pallas, normal,
        normal_pallas, pll, pll_pallas, rpll, rpll_pallas, svf, svf_pallas,
        wdf, wdf_pallas,
    )
    from idsp_tpu import fxp

    rng = np.random.default_rng(11)
    ba5 = biquad.from_cookbook(Filter().critical_frequency(0.05).lowpass())
    ba = biquad.quantize_ba(ba5, 29)
    baj = jnp.asarray(ba)
    xs = _i32(rng, (t, lanes))
    st = biquad.Df1State(x=_i32(rng, (lanes, 2)), y=_i32(rng, (lanes, 2)))
    clamp = (7, -(2**28), 2**28)
    u, lo, hi = (jnp.int32(v) for v in clamp)
    kw = dict(interpret=interpret)
    scan = jax.lax.scan

    def q(fc):
        return biquad.quantize_ba(
            biquad.from_cookbook(Filter().critical_frequency(fc).lowpass()),
            29)

    per_ch = jnp.asarray(np.stack(
        [q(fc) for fc in np.linspace(0.02, 0.3, lanes)], axis=1))  # (5, c)
    wide = biquad.Df1WideState(x=st.x, y=jnp.asarray(
        rng.integers(-(2**60), 2**60, (lanes, 2), dtype=np.int64)))
    dith = biquad.Df1DitherState(xy=st, e=jnp.asarray(
        rng.integers(0, 2**32, (lanes,), dtype=np.uint64).astype(np.uint32)))
    sos = np.stack([q(0.05), q(0.1), q(0.2)])
    xs16 = jnp.asarray(rng.integers(-(2**14), 2**14, (t, lanes))
                       .astype(np.int16))
    ba16 = biquad.quantize_ba(ba5, 13, dtype=jnp.int16)
    ba64 = biquad.quantize_ba(ba5, 61, dtype=jnp.int64)
    xs64 = jnp.asarray(rng.integers(-(2**55), 2**55, (t, lanes)))
    xsf = jnp.asarray(rng.normal(size=(t, lanes)).astype(np.float32))
    f32 = biquad.df1_init((lanes,), jnp.float32)
    pba = pll.coefficients_from_bandwidth(1e-2)
    ph = _i32(rng, (t, lanes), 2**31)
    nb, npole = normal.from_cookbook(
        Filter().critical_frequency(0.06).lowpass())
    nbq = np.asarray(fxp.from_float(nb, 29))
    npq = np.asarray(fxp.from_float(npole, 29))
    sf, sq = svf.coefficients(0.01, 0.7)
    rcfg = rpll.RpllConfig(dt2=8, shift_frequency=12, shift_phase=11)
    valid = jnp.asarray(rng.integers(0, 64, (t, lanes)) == 0)
    tp = wdf.nibbles(0xAD, 2)
    b0 = [(tp, wdf.quantize(tp, [-0.9, 0.9])),
          (tp, wdf.quantize(tp, [-0.6, 0.7]))]
    b1 = [(tp, wdf.quantize(tp, [-0.7, 0.6]))]
    wst = ([wdf.init(2, (lanes,)), wdf.init(2, (lanes,))],
           [wdf.init(2, (lanes,))])

    def sos_ref():
        y, out = xs, []
        for row in sos:
            s, y = biquad.df1_process_q(jnp.asarray(row), 29,
                                        biquad.df1_init((lanes,), jnp.int32), y)
            out.append(s)
        return out, y

    def dec16(r):
        s, y = r
        return s, y[::16]

    return [
        ("df1_bank_q", lambda: bp.df1_bank_q(ba, st, xs, 29, **kw),
         lambda: biquad.df1_process_q(baj, 29, st, xs), None),
        ("df1_bank_q f32 out",
         lambda: bp.df1_bank_q(ba, st, xs, 29, out_dtype=jnp.float32, **kw),
         lambda: jax.tree.map(
             lambda a: a.astype(jnp.float32) if a.ndim == 2 and a.shape[0] == t
             else a, biquad.df1_process_q(baj, 29, st, xs)), None),
        ("df1_bank_q_dec d=16",
         lambda: bp.df1_bank_q_dec(ba, st, xs, 29, d=16, **kw),
         lambda: dec16(biquad.df1_process_q(baj, 29, st, xs)), None),
        ("sos_bank_q 3 stages",
         lambda: bp.sos_bank_q(
             sos, [biquad.df1_init((lanes,), jnp.int32)] * 3, xs, 29, **kw),
         sos_ref, None),
        ("df1_clamp_bank_q",
         lambda: bp.df1_clamp_bank_q(ba, st, xs, 29, u=clamp[0], lo=clamp[1],
                                     hi=clamp[2], **kw),
         lambda: scan(lambda s, x: biquad.clamp_step(
             biquad.df1_step_q(baj, 29, s, x), u, lo, hi), st, xs), None),
        ("df1_wide_bank", lambda: bp.df1_wide_bank(ba, wide, xs, 29, **kw),
         lambda: scan(lambda s, x: biquad.df1_wide_step(baj, 29, s, x),
                      wide, xs), None),
        ("df1_wide_bank clamp",
         lambda: bp.df1_wide_bank(ba, wide, xs, 29, clamp=clamp, **kw),
         lambda: scan(lambda s, x: biquad.df1_wide_clamp_step(
             baj, 29, s, x, u, lo, hi), wide, xs), None),
        ("df1_dither_bank", lambda: bp.df1_dither_bank(ba, dith, xs, 29, **kw),
         lambda: scan(lambda s, x: biquad.df1_dither_step(baj, 29, s, x),
                      dith, xs), None),
        ("df1_dither_bank clamp",
         lambda: bp.df1_dither_bank(ba, dith, xs, 29, clamp=clamp, **kw),
         lambda: scan(lambda s, x: biquad.df1_dither_clamp_step(
             baj, 29, s, x, u, lo, hi), dith, xs), None),
        ("df1_bank_q_coef per-channel",
         lambda: bp.df1_bank_q_coef(per_ch, st, xs, 29, **kw),
         lambda: biquad.df1_process_q(per_ch.T, 29, st, xs), None),
        ("df1_clamp_bank_q_coef",
         lambda: bp.df1_clamp_bank_q_coef(per_ch, st, xs, 29, u=clamp[0],
                                          lo=clamp[1], hi=clamp[2], **kw),
         lambda: scan(lambda s, x: biquad.clamp_step(
             biquad.df1_step_q(per_ch.T, 29, s, x), u, lo, hi), st, xs),
         None),
        ("df1_wide_bank_coef",
         lambda: bp.df1_wide_bank_coef(per_ch, wide, xs, 29, **kw),
         lambda: scan(lambda s, x: biquad.df1_wide_step(per_ch.T, 29, s, x),
                      wide, xs), None),
        ("df1_dither_bank_coef",
         lambda: bp.df1_dither_bank_coef(per_ch, dith, xs, 29, **kw),
         lambda: scan(lambda s, x: biquad.df1_dither_step(
             per_ch.T, 29, s, x), dith, xs), None),
        ("df1_bank_q16",
         lambda: bp.df1_bank_q16(ba16, biquad.df1_init((lanes,), jnp.int16),
                                 xs16, 13, **kw),
         lambda: scan(lambda s, x: biquad.df1_step_q(
             jnp.asarray(ba16), 13, s, x, dtype=jnp.int16),
             biquad.df1_init((lanes,), jnp.int16), xs16), None),
        ("df1_bank_q64",
         lambda: bp.df1_bank_q64(ba64, biquad.df1_init((lanes,), jnp.int64),
                                 xs64, 61, **kw),
         lambda: biquad.df1_process_q64(
             jnp.asarray(ba64), 61, biquad.df1_init((lanes,), jnp.int64),
             xs64), None),
        ("df1_bank_f32",
         lambda: bp.df1_bank_f32(ba5.astype(np.float32), f32, xsf, **kw),
         lambda: biquad.df1_process(jnp.asarray(ba5, jnp.float32), f32, xsf),
         64),
        ("pll_bank", lambda: pll_pallas.pll_bank(pba, pll.init((lanes,)), ph,
                                                 **kw),
         lambda: pll.block(jnp.asarray(pba), pll.init((lanes,)), ph), None),
        ("lowpass_bank N=1",
         lambda: lowpass_pallas.lowpass_bank(
             lowpass.gains1(0.01), lowpass.init(1, (lanes,)), xs, **kw),
         lambda: lowpass.block(jnp.asarray(lowpass.gains1(0.01)),
                               lowpass.init(1, (lanes,)), xs), None),
        ("lowpass_bank N=2 dec=16",
         lambda: lowpass_pallas.lowpass_bank(
             lowpass.gains2(0.01), lowpass.init(2, (lanes,)), xs, dec=16,
             **kw),
         lambda: dec16(lowpass.block(jnp.asarray(lowpass.gains2(0.01)),
                                     lowpass.init(2, (lanes,)), xs)), None),
        ("normal_bank_q",
         lambda: normal_pallas.normal_bank_q(nbq, npq, st, xs, 29, **kw),
         lambda: scan(lambda s, x: normal.step_q(
             jnp.asarray(nbq), jnp.asarray(npq), 29, s, x), st, xs), None),
        ("normal_bank_f32",
         lambda: normal_pallas.normal_bank_f32(nb, npole, f32, xsf, **kw),
         lambda: normal.block(jnp.asarray(nb, jnp.float32),
                              jnp.asarray(npole, jnp.float32), f32, xsf), 64),
        ("svf_bank",
         lambda: svf_pallas.svf_bank(sf, sq, svf.init((lanes,)), xsf, **kw),
         lambda: (lambda r: (r[0], r[1].lp))(
             svf.block(sf, sq, svf.init((lanes,)), xsf)), 64),
        ("rpll_bank",
         lambda: rpll_pallas.rpll_bank(rcfg, rpll.init((lanes,)), ph, valid,
                                       **kw),
         lambda: rpll.block(rcfg, rpll.init((lanes,)), ph, valid), None),
        ("wdf_pair_bank",
         lambda: wdf_pallas.wdf_pair_bank(b0, b1, wst, xs, **kw),
         lambda: wdf.pair_block(
             [(tp_, jnp.asarray(a)) for tp_, a in b0],
             [(tp_, jnp.asarray(a)) for tp_, a in b1], wst, xs), None),
    ]


def _close(got, want, ulps) -> bool:
    import jax

    ok = True
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        scale = max(np.abs(b).max(), 1e-30)
        ok &= a.shape == b.shape and np.abs(a - b).max() <= (
            ulps * np.finfo(np.float32).eps * scale)
    return ok


def phase_kernels(results, lanes=2048, t=1008, interpret=False):
    # t = 31.5 loop chunks of 32 steps: the loop and its tail both run
    for name, kern, ref, ulps in kernel_cases(lanes, t, interpret):
        got, want = kern(), ref()
        if ulps is None:
            _check(results, f"kernel {name} lanes={lanes} t={t}",
                   _equal(got, want))
        else:
            # float steps: the GPU compiler may contract a*b + c into one
            # FMA, which rounds once instead of twice; the difference
            # feeds back through the filter.  Budget: `ulps` f32 ulps of
            # the output scale.
            _check(results, f"kernel {name} lanes={lanes} t={t}",
                   _close(got, want, ulps), f"(within {ulps} ulps of scale)")


# --- four cards --------------------------------------------------------------


def phase_four(results, n_dev=4, c_per=512, t=32768, t_bank=16384,
               t_sp=4096, width=256):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from idsp_tpu.design import Filter
    from idsp_tpu.filters import biquad, hbf, pll
    from idsp_tpu.parallel import make_mesh, sharded_df1_float
    from idsp_tpu.parallel.stream import sharded_df1_q_relay, sharded_hbf_dec
    from idsp_tpu.pipelines import ddc_bank, ddc_chain

    rng = np.random.default_rng(4)
    mesh = make_mesh({"dp": n_dev})
    c = c_per * n_dev
    ba = ddc_chain.lowpass_coefficients()
    steps = _i32(rng, (c,), 2**30)

    # channel-sharded headline chain vs the one-device chain
    run = ddc_chain.channel_sharded(mesh, "dp", ba_q=ba)
    s_sh, s_one, ok = ddc_chain.init(c), ddc_chain.init(c), True
    for _ in range(2):
        x = _i32(rng, (t,))
        s_sh, y_sh = run(s_sh, x, steps)
        s_one, y_one = ddc_chain.block(s_one, x, steps, ba)
        ok &= _equal(y_sh, y_one)
    _check(results, f"4-card channel-sharded chain c={c} t={t}", ok)

    # channel-sharded DDC bank (biquad + PLL)
    tb, d = t_bank, 16
    pll_ba = tuple(int(v) for v in pll.coefficients_from_bandwidth(2e-2))
    lanes = biquad.Df1State(x=P("dp"), y=P("dp"))
    specs = ddc_bank.DdcBankBiquadState(
        nco_phase=P("dp"), bq=lanes,
        pll=jax.tree.map(lambda _: P("dp"), pll.init((1,))),
    )
    bank = jax.jit(jax.shard_map(
        functools.partial(ddc_bank.ddc_bank_block_biquad, ba_q=ba,
                          pll_ba=pll_ba, decimate=d),
        mesh=mesh, in_specs=(specs, P(), P("dp")),
        out_specs=(specs, (P(None, "dp"), P(None, "dp"), P("dp"))),
    ))
    s_sh, s_one, ok = ddc_bank.init_biquad(c), ddc_bank.init_biquad(c), True
    for _ in range(2):
        x = _i32(rng, (tb,))
        s_sh, y_sh = bank(s_sh, x, steps)
        s_one, y_one = ddc_bank.ddc_bank_block_biquad(
            s_one, x, steps, ba, pll_ba, decimate=d)
        ok &= _equal(y_sh, y_one)
    _check(results, f"4-card channel-sharded DDC bank c={c} t={tb}", ok)

    # time-sharded half-band decimator (ppermute halos)
    taps = hbf.HBF_TAPS[2]
    xh = jnp.asarray(
        rng.normal(size=(width, n_dev * 2 * t_sp)).astype(np.float32))
    st_h = hbf.hbf_dec_init(len(taps), (width,))
    sp = jax.jit(jax.shard_map(
        lambda s, x: sharded_hbf_dec(taps, s, x, "dp"), mesh=mesh,
        in_specs=(P(), P(None, "dp")), out_specs=(P(), P(None, "dp")),
    ))
    _, y_sp = sp(st_h, xh)
    _, y_ref = hbf.hbf_dec_block(taps, st_h, xh)
    err = float(jnp.abs(y_sp - y_ref).max())
    # same windows and add order; the two graphs may contract
    # multiply-adds into FMAs differently (~1 ulp of the sample scale)
    _check(results, "4-card time-sharded hbf dec", err <= 1e-5,
           f"(max error {err:.2e}, gate 1e-5)")

    # time-sharded float DF1 (affine carry) and the integer relay
    ba5 = biquad.from_cookbook(Filter().critical_frequency(0.05).lowpass())
    xf = jnp.asarray(rng.normal(size=(n_dev * t_sp, width)))
    stf = biquad.df1_init((width,), jnp.float64)
    fl = jax.jit(jax.shard_map(
        lambda s, x: sharded_df1_float(jnp.asarray(ba5), s, x, "dp"),
        mesh=mesh, in_specs=(P(), P("dp")), out_specs=(P(), P("dp")),
    ))
    _, yf = fl(stf, xf)
    _, yf_ref = biquad.df1_process(jnp.asarray(ba5), stf, xf)
    err = float(jnp.abs(yf - yf_ref).max())
    # f64 affine composition reassociates the recurrence: 1e-9 absolute
    _check(results, "4-card time-sharded float df1", err <= 1e-9,
           f"(max error {err:.2e}, gate 1e-9)")

    baq = jnp.asarray(biquad.quantize_ba(ba5, 29))
    xq = _i32(rng, (n_dev * t_sp, width))
    stq = biquad.df1_init((width,), jnp.int32)
    relay = jax.jit(jax.shard_map(
        lambda s, x: sharded_df1_q_relay(baq, s, x, 29, "dp"),
        mesh=mesh, in_specs=(P(), P("dp")), out_specs=(P(), P("dp")),
    ))
    s_q, y_q = relay(stq, xq)
    s_qr, y_qr = biquad.df1_process_q(baq, 29, stq, xq)
    _check(results, "4-card integer relay df1",
           _equal(y_q, y_qr) and _equal(s_q, s_qr))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run the 4-card sharded paths instead")
    args = ap.parse_args(argv)

    from idsp_tpu import device

    cache_dir = device.enable_compile_cache()
    counter = device.CacheCounter()
    info = device.require_gpu()
    print(device.card_line(), flush=True)
    print(f"# device: {info['kind']} x{info['count']} ({info['platform']})",
          flush=True)
    print(f"# compile cache: {cache_dir}", flush=True)

    t0 = time.perf_counter()
    results = []

    def phase(name, fn, **kw):
        t, n, s = time.perf_counter(), counter.compiles, counter.compile_s
        fn(results, **kw)
        print(f"# phase {name}: {time.perf_counter() - t:.1f} s, "
              f"{counter.compiles - n} backend compiles "
              f"{counter.compile_s - s:.1f} s", flush=True)

    if args.four:
        if info["count"] < 4:
            raise SystemExit(f"--four needs 4 devices, have {info['count']}")
        phase("four", phase_four)
    else:
        for c in (512, 1024):
            phase(f"headline c={c}", phase_headline, c=c)
        phase("ddc bank", phase_ddc_bank)
        phase("fm", phase_fm)
        phase("rate", phase_rate)
        phase("channelizer", phase_channelizer)
        phase("kernels", phase_kernels)
    ok = bool(results) and all(r for _, r in results)
    print(f"# {sum(r for _, r in results)}/{len(results)} checks passed in "
          f"{time.perf_counter() - t0:.1f} s; compile cache hits "
          f"{counter.hits}, misses {counter.misses}", flush=True)
    if not ok:
        return 1
    info = device.describe()
    print(json.dumps({"ok": True, "device": {
        "platform": info["platform"], "kind": info["kind"],
        "count": 4 if args.four else info["count"],
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
