"""Rate-conversion cascade (BASELINE #4) and DDC bank (BASELINE #5)."""

import numpy as np
import jax.numpy as jnp

from idsp_tpu.filters import cic, hbf, lowpass, pll
from idsp_tpu.ops import sweptsine
from idsp_tpu.pipelines import ddc_bank, rate_conversion


def test_rate_conversion_round_trip_tone():
    # A passband tone survives dec16 -> int16 at unity gain.
    depth = 4
    n = 1 << 14
    f = 0.4 / (1 << depth) * 0.5  # well inside the decimated passband
    i = np.arange(n)
    x = jnp.asarray(np.cos(2 * np.pi * f * i).astype(np.float32))
    st = rate_conversion.init(depth)
    st, y = rate_conversion.round_trip(st, x)
    y = np.asarray(y, np.float64)
    x = np.asarray(x, np.float64)
    # compare steady-state amplitude via power (delay-insensitive)
    p_in = (x[4096:] ** 2).mean()
    p_out = (y[4096:] ** 2).mean()
    assert abs(p_out / p_in - 1.0) < 1e-3


def test_rate_conversion_stopband_kill():
    # Content above the decimated Nyquist is annihilated (>= 98 dB).
    depth = 2
    n = 1 << 13
    f = 0.35  # far above 0.5/4
    i = np.arange(n)
    x = jnp.asarray(np.cos(2 * np.pi * f * i).astype(np.float32))
    st = rate_conversion.init(depth)
    st, y = rate_conversion.round_trip(st, x)
    p_out = (np.asarray(y, np.float64)[2048:] ** 2).mean()
    assert p_out < 0.5 * 10 ** (-98 / 10)


def test_cic_hbf_composite_decimator():
    # CIC by 5 then HBF by 4: total 20x; DC passes with known gain.
    cic_rate = 4
    depth = 2
    n = 20 * 64
    x = jnp.full((n,), 1000, jnp.int32)
    cs = cic.init(3, 1)
    hs = hbf.hbf_dec_cascade_init(depth)
    (cs, hs), y = rate_conversion.cic_hbf_decimate(cs, hs, x, cic_rate, depth)
    # CIC gain (M(rate+1))^N times the HBF decimators' DC gain of 2 per
    # stage (hbf.rs:547-556: ones -> 2.0).
    g = cic.gain(cic_rate, 3, 1) * (1 << depth)
    y = np.asarray(y, np.float64)
    assert abs(y[-1] / (1000 * g) - 1.0) < 1e-3


def test_ddc_bank_acquires_offsets():
    # 16-channel bank on a frequency grid: each channel's PLL acquires
    # its own carrier offset despite the 15 other tones in the band.
    c = 16
    rng = np.random.default_rng(0)
    grid = 1 << 26  # 1/64 of the band between channels
    steps = ((np.arange(c) + 8) * grid).astype(np.int64).astype(np.int32)
    offsets = rng.integers(-(1 << 16), 1 << 16, size=c, dtype=np.int64).astype(
        np.int32
    )
    n = 1 << 15
    decim = 16
    x = ddc_bank.make_tone_bank(steps, n, amplitude=1 << 26, offsets=offsets)

    st = ddc_bank.init(c)
    lp_gains = tuple(int(v) for v in lowpass.gains2(0.001))
    pll_ba = tuple(int(v) for v in pll.coefficients_from_bandwidth(2e-2, 4.0))
    st, (yi, yq, yp, freq) = ddc_bank.ddc_bank_block(
        st, x, jnp.asarray(steps), lp_gains, pll_ba, decimate=decim
    )
    freq = np.asarray(freq).astype(np.int64)
    # The PLL output frequency compensates the residual offset at the
    # decimated rate: offset * decimate (mod 2^32), negated.
    want = -(offsets.astype(np.int64) * decim)
    err = (freq - want + 2**31) % 2**32 - 2**31
    # all channels lock; neighbor leakage rattles the loop slightly
    assert np.median(np.abs(err)) < 1 << 16, err
    assert np.abs(err).max() < (1 << 31) * 1e-4, err


def test_sweptsine_measures_lowpass_response():
    # Swept-sine + inverse filter recovers a filter's transfer function:
    # validate against freqz (the BASELINE #5 validation methodology).
    from idsp_tpu.design import Filter, freqz_ba5
    from idsp_tpu.filters import biquad

    sw = sweptsine.Sweep.fit(0.45, 300.0, 5.0)
    n = int(sw.delay(300.0)) + 1
    re, im = sweptsine.accu_osc(sw, n)
    x = np.asarray(re, np.float64) / 2**31

    ba = biquad.from_cookbook(Filter().critical_frequency(0.05).lowpass())
    st = biquad.df1_init((), jnp.float64)
    _, y = biquad.df1_process(jnp.asarray(ba), st, jnp.asarray(x))
    y = np.asarray(y)

    nfft = 1 << int(np.ceil(np.log2(n))) + 1
    yf = np.fft.rfft(y, nfft)
    f = np.arange(len(yf)) / nfft
    inv_re, inv_im = sw.inverse_filter(jnp.asarray(f[1:], jnp.float32))
    h = yf[1:] * (np.asarray(inv_re) + 1j * np.asarray(inv_im))

    want = freqz_ba5(ba, f[1:])
    band = (f[1:] > 0.01) & (f[1:] < 0.3)
    err_db = 20 * np.log10(
        np.abs(h[band]) / np.maximum(np.abs(want[band]), 1e-12)
    )
    # magnitude response recovered within 1 dB across the band
    assert np.median(np.abs(err_db)) < 1.0, np.median(np.abs(err_db))


def test_sweptsine_end_to_end_ddc_channel_response():
    # BASELINE #5 acceptance methodology end to end: a swept sine is
    # upconverted onto one channel's carrier, pushed through the FULL
    # DDC bank (NCO mix -> Lowpass2 -> PLL), and the channel transfer
    # function recovered by swept-sine deconvolution must match an
    # independent impulse-response measurement of the same channel
    # filter (reference workflow: src/sweptsine.rs:83-101).
    c, k0 = 4, 1
    grid = 1 << 28  # carrier spacing 1/16 fs >> sweep stop + corner
    steps = ((np.arange(c) + 2) * grid).astype(np.int64).astype(np.int32)
    f0 = 0.01
    lp_gains = tuple(int(v) for v in lowpass.gains2(f0))
    pll_ba = tuple(int(v) for v in pll.coefficients_from_bandwidth(2e-2, 4.0))

    sw = sweptsine.Sweep.fit(0.04, 100.0, 2.0)
    n = int(sw.delay(100.0)) + 1
    n -= n % 16
    amp = 1 << 27

    # stimulus: baseband sweep phase + carrier ramp, by phase additivity
    phase_bb = (np.cumsum(np.asarray(sw.frequencies(n))) >> 32).astype(
        np.int64
    )
    carrier = (int(steps[k0]) * np.arange(n, dtype=np.int64)) & 0xFFFFFFFF
    total = ((phase_bb + carrier + 2**31) % 2**32 - 2**31).astype(np.int32)
    from idsp_tpu.ops.trig import cossin

    re, _ = cossin(jnp.asarray(total))
    re = np.asarray(re)
    x = jnp.asarray(((re.astype(np.int64) * amp) >> 31).astype(np.int32))

    st = ddc_bank.init(c)
    st, (yi, yq, _, _) = ddc_bank.ddc_bank_block(
        st, x, jnp.asarray(steps), lp_gains, pll_ba, decimate=1
    )
    z = np.asarray(yi, np.float64)[:, k0] + 1j * np.asarray(yq, np.float64)[
        :, k0
    ]

    # deconvolve: FFT * inverse filter at positive frequencies
    nfft = 1 << (int(np.ceil(np.log2(n))) + 1)
    zf = np.fft.fft(np.concatenate([z, np.zeros(nfft - n)]))
    f = np.arange(1, nfft // 2) / nfft
    inv_re, inv_im = sw.inverse_filter(jnp.asarray(f, jnp.float32))
    h_meas = zf[1 : nfft // 2] * (
        np.asarray(inv_re) + 1j * np.asarray(inv_im)
    )

    # independent reference: impulse response of the bare Lowpass2
    imp = np.zeros(n, np.int32)
    imp[0] = amp
    _, h_t = lowpass.block(
        jnp.asarray(np.asarray(lp_gains, np.int64).astype(np.int32)),
        lowpass.init(2, ()),
        jnp.asarray(imp),
    )
    h_ref = np.fft.rfft(
        np.concatenate([np.asarray(h_t, np.float64), np.zeros(nfft - n)])
    )[1 : nfft // 2]

    band = (f > 0.004) & (f < 0.03)
    ref_bin = int(np.argmin(np.abs(f - 0.005)))
    meas_db = 20 * np.log10(
        np.abs(h_meas[band]) / np.abs(h_meas[ref_bin])
    )
    want_db = 20 * np.log10(np.abs(h_ref[band]) / np.abs(h_ref[ref_bin]))
    err = np.abs(meas_db - want_db)
    assert np.median(err) < 1.0, np.median(err)
    # rolloff visible: response at 0.03 is well below the passband
    assert want_db[-1] < -12.0 and abs(meas_db[-1] - want_db[-1]) < 3.0

    # channel isolation: the far channel (2 grid steps away) sees only
    # stopband energy
    z_far = np.asarray(yi, np.float64)[:, 3] + 1j * np.asarray(
        yq, np.float64
    )[:, 3]
    assert (np.abs(z_far) ** 2).mean() < 0.02 * (np.abs(z) ** 2).mean()


def test_ddc_bank_fast_lo_acquires_offsets():
    # lo_mode="fast" (coarse/fine factored LO, ops/fastlo.py): the PLL
    # bank locks to the same offsets within the same gates — the bank-
    # level matched-SNR check for the fast path.
    c = 16
    rng = np.random.default_rng(1)
    grid = 1 << 26
    steps = ((np.arange(c) + 8) * grid).astype(np.int64).astype(np.int32)
    offsets = rng.integers(-(1 << 16), 1 << 16, size=c,
                           dtype=np.int64).astype(np.int32)
    n = 1 << 15
    decim = 16
    x = ddc_bank.make_tone_bank(steps, n, amplitude=1 << 26,
                                offsets=offsets)

    st = ddc_bank.init(c)
    lp_gains = tuple(int(v) for v in lowpass.gains2(0.001))
    pll_ba = tuple(int(v) for v in pll.coefficients_from_bandwidth(2e-2, 4.0))
    st, (yi, yq, yp, freq) = ddc_bank.ddc_bank_block(
        st, x, jnp.asarray(steps), lp_gains, pll_ba, decimate=decim,
        lo_mode="fast",
    )
    freq = np.asarray(freq).astype(np.int64)
    want = -(offsets.astype(np.int64) * decim)
    err = (freq - want + 2**31) % 2**32 - 2**31
    assert np.median(np.abs(err)) < 1 << 16, err
    assert np.abs(err).max() < (1 << 31) * 1e-4, err


def test_ddc_bank_biquad_fast_fused_tracks_exact():
    # The biquad bank with the fast LO (lo_mode="fast") must drive
    # the PLL bank to the SAME operating point as the exact-LO path:
    # per-channel recovered frequencies agree to LSB-scale (the fast
    # mix differs by ~8-LSB f32 rounding).  Absolute lock quality is
    # the exact path's property (test_ddc_bank_acquires_offsets); here
    # we gate tracking equivalence plus a loose absolute bound.
    c = 128
    rng = np.random.default_rng(2)
    grid = 1 << 26
    # 16 real tones on the grid; the other 112 DDC channels tune to
    # empty spectrum.
    tone_steps = ((np.arange(16) + 8) * grid).astype(np.int64).astype(
        np.int32
    )
    offsets16 = rng.integers(-(1 << 16), 1 << 16, size=16,
                             dtype=np.int64).astype(np.int32)
    steps = np.zeros(c, np.int32)
    steps[:16] = tone_steps
    steps[16:] = (
        ((np.arange(112) + 40) * grid) & 0xFFFFFFFF
    ).astype(np.int64).astype(np.int32)
    n = 1 << 15
    decim = 16
    x = ddc_bank.make_tone_bank(tone_steps, n, amplitude=1 << 26,
                                offsets=offsets16)
    from idsp_tpu.design import Filter
    from idsp_tpu.filters import biquad

    ba_q = tuple(
        int(v)
        for v in biquad.quantize_ba(
            biquad.from_cookbook(
                Filter().critical_frequency(0.001).lowpass()
            ),
            29,
        )
    )
    pll_ba = tuple(
        int(v) for v in pll.coefficients_from_bandwidth(2e-2, 4.0)
    )

    freqs = {}
    for mode in ("exact", "fast"):
        st = ddc_bank.init_biquad(c)
        st, out = ddc_bank.ddc_bank_block_biquad(
            st, x, jnp.asarray(steps), ba_q, pll_ba, decimate=decim,
            lo_mode=mode,
        )
        freqs[mode] = np.asarray(out[-1]).astype(np.int64)[:16]

    want = -(offsets16.astype(np.int64) * decim)
    err = (freqs["fast"] - want + 2**31) % 2**32 - 2**31
    assert np.median(np.abs(err)) < 1 << 18, err  # loose absolute lock
    d = (freqs["fast"] - freqs["exact"] + 2**31) % 2**32 - 2**31
    assert np.median(np.abs(d)) < 1 << 12, d  # tracks the exact path


def test_ddc_bank_fast_lo_non_pow2_block():
    # t=192 is a legal block (multiple of decimate) but not of 128; the
    # fast-LO fine-table length must divide t (review regression).
    c = 16
    steps = ((np.arange(c) + 8) * (1 << 26)).astype(np.int64).astype(
        np.int32
    )
    x = ddc_bank.make_tone_bank(steps, 192, amplitude=1 << 26)
    st = ddc_bank.init(c)
    lp_gains = tuple(int(v) for v in lowpass.gains2(0.001))
    pll_ba = tuple(int(v) for v in pll.coefficients_from_bandwidth(2e-2, 4.0))
    st, out = ddc_bank.ddc_bank_block(
        st, x, jnp.asarray(steps), lp_gains, pll_ba, decimate=16,
        lo_mode="fast",
    )
    assert out[0].shape == (12, c)
