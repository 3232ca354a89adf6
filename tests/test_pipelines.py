"""Example-level acceptance tests (the reference CI's `--examples` run).

Thresholds come straight from the reference examples:
fm_disc.rs:151-157, ddc_lockin.rs:104-110,
polyphase_channelizer.rs:166-178.
"""

import numpy as np

from idsp_tpu.pipelines import channelizer, ddc_lockin, fm_disc


def test_fm_disc_tracks_known_modulation():
    r = fm_disc.run_fm_disc()
    assert r["corr"] > 0.999
    assert 0.95 < r["gain"] < 1.05
    assert r["rms"] < 5e-4


def test_ddc_recovers_dc_iq():
    r = ddc_lockin.run_ddc()
    assert abs(r["mean"][0] - r["expected"][0]) < 3e-3
    assert abs(r["mean"][1] - r["expected"][1]) < 3e-3
    assert r["rms"] < 6e-3


def test_channelizer_routes_center_tones():
    for freq, want in [(0.0, 0), (0.25, 1), (0.5, 2), (0.75, 3)]:
        p = channelizer.channel_powers(freq)
        assert int(np.argmax(p)) == want, (freq, p)
        others = np.delete(p, want)
        assert p[want] > 10.0 * others.max(), (freq, p)


def test_channelizer_wideband_64():
    # Scaled-up bank (towards the BASELINE #5 1024-channel config):
    # tones at channel centers land in their channel.
    m = 64
    for ch in (0, 7, 31, 63):
        p = channelizer.channel_powers(ch / m, m=m, taps=8, n=m * 512)
        assert int(np.argmax(p)) == ch
        others = np.delete(p, ch)
        assert p[ch] > 10.0 * others.max()


def test_channelizer_wideband_1024():
    # The BASELINE #5 headline channel count: a tone at a channel
    # center lands in its channel with overwhelming isolation.
    m = 1024
    p = channelizer.channel_powers(100 / m, m=m, taps=8, n=m * 160)
    assert int(np.argmax(p)) == 100
    others = np.delete(p, 100)
    assert p[100] > 1e4 * others.max()


def test_channelizer_fft_matches_matmul():
    # fft DFT option == matmul DFT up to f32 summation order; the
    # channel-isolation acceptance gate holds on both.
    from idsp_tpu.pipelines import channelizer as chz

    m, taps, n = 64, 8, 512
    x = chz.frames_from_stream(chz.tone(5.0 / m, n * m), m)
    st = chz.init(m, taps)
    _, y_mm = chz.channelize(st, x, m=m, taps=taps)
    _, y_ff = chz.channelize(st, x, m=m, taps=taps, dft="fft")
    a = np.asarray(y_mm, np.float64)
    b = np.asarray(y_ff, np.float64)
    scale = np.abs(a).max()
    assert np.abs(a - b).max() < 1e-5 * scale
    # isolation gate on the fft path (>= 10x, the reference threshold)
    p = (b[128:] ** 2).sum(axis=-1).mean(axis=0)
    k = int(np.argmax(p))
    assert k == 5
    others = np.delete(p, k)
    assert p[k] >= 10.0 * others.max()


def test_channelize_planes_matches_frames():
    # plane layout (m contiguous) == trailing-(m,2) layout
    # bit-for-bit: same FIR order, same einsum contractions.
    import jax.numpy as jnp

    m, taps, n = 64, 8, 32
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.normal(size=(n, m, 2)).astype(np.float32))
    st = channelizer.init(m, taps)
    st2, y = channelizer.channelize(st, x, m=m, taps=taps)

    pst = channelizer.init_planes(m, taps)
    pst2, yr, yi = channelizer.channelize_planes(
        pst, x[..., 0], x[..., 1], m=m, taps=taps
    )
    np.testing.assert_array_equal(np.asarray(yr), np.asarray(y[..., 0]))
    np.testing.assert_array_equal(np.asarray(yi), np.asarray(y[..., 1]))
    np.testing.assert_array_equal(
        np.asarray(pst2.hist_r), np.asarray(st2.hist[..., 0])
    )


def test_channelize_planes_streaming_and_bf16_gate():
    # streamed planes path: two chained blocks == one-shot; bf16
    # twiddles still pass the reference's >=10x bin-power gate
    # (polyphase_channelizer.rs:166-178).
    import jax.numpy as jnp

    m, taps, nfr = 64, 8, 256
    ch = 11
    x = channelizer.tone(ch / m, m * nfr)
    zr, zi = channelizer.planes_from_stream(x[..., 0], x[..., 1], m)

    pst = channelizer.init_planes(m, taps)
    _, yr1, yi1 = channelizer.channelize_planes(
        pst, zr[: nfr // 2], zi[: nfr // 2], m=m, taps=taps
    )
    pst_b = channelizer.init_planes(m, taps)
    pst_b, ya_r, ya_i = channelizer.channelize_planes(
        pst_b, zr[: nfr // 4], zi[: nfr // 4], m=m, taps=taps
    )
    _, yb_r, yb_i = channelizer.channelize_planes(
        pst_b, zr[nfr // 4: nfr // 2], zi[nfr // 4: nfr // 2],
        m=m, taps=taps,
    )
    np.testing.assert_array_equal(
        np.asarray(jnp.concatenate([ya_r, yb_r], axis=0)),
        np.asarray(yr1),
    )
    np.testing.assert_array_equal(
        np.asarray(jnp.concatenate([ya_i, yb_i], axis=0)),
        np.asarray(yi1),
    )

    _, yr, yi = channelizer.channelize_planes(
        channelizer.init_planes(m, taps), zr, zi, m=m, taps=taps,
        twiddle_dtype=jnp.bfloat16,
    )
    p = (np.asarray(yr, np.float64) ** 2
         + np.asarray(yi, np.float64) ** 2)[32:].mean(axis=0)
    assert int(np.argmax(p)) == ch
    others = np.delete(p, ch)
    assert p[ch] > 10.0 * others.max()
