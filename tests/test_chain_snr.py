"""End-to-end DDC chain signal quality.

The north star requires throughput *at matched SNR*: every integer
stage is bit-exact vs the golden model, and this test closes the loop
end-to-end — a clean carrier through mix -> Q32 biquad -> HBF dec8
recovers a baseband tone whose SNR clears the fixed-point noise floor
expectations (DDS SNR > 106 dB, biquad truncation floor).
"""

import numpy as np
import jax.numpy as jnp

from idsp_tpu import fxp
from idsp_tpu.design import Filter
from idsp_tpu.filters import biquad, hbf
from idsp_tpu.ops import accu
from idsp_tpu.ops.trig import cossin


def test_ddc_chain_snr():
    t = 1 << 15
    # input carrier: NCO at f0 + small offset; DDC LO at f0.
    # f0 = fs/4 puts the 2*f0 mixing image at Nyquist where the HBF
    # stopband annihilates it; the offset is chosen so the baseband
    # tone lands exactly on an FFT bin of the analysis slice (coherent
    # sampling, no window leakage).
    f0_step = np.int32(0x4000_0000)
    off_step = np.int32(3 << 18)  # -> bin 3 of a 2048-sample slice
    phases_in = accu.ramp(jnp.int32(123), f0_step + off_step, t)
    re_in, _ = cossin(phases_in)
    x = ((re_in.astype(jnp.int64) * (1 << 27)) >> 31).astype(jnp.int32)

    # DDC: conjugate mix at f0
    lo_phase = accu.ramp(jnp.int32(0), f0_step, t)
    lo_re, lo_im = cossin(lo_phase)
    mi = fxp.q_apply(lo_re, x, 32)
    mq = fxp.q_apply(-lo_im, x, 32)

    ba_q = jnp.asarray(
        biquad.quantize_ba(
            biquad.from_cookbook(Filter().critical_frequency(0.02).lowpass()),
            29,
        )
    )
    sti = biquad.df1_init((), jnp.int32)
    stq = biquad.df1_init((), jnp.int32)
    _, yi = biquad.df1_process_q(ba_q, 29, sti, mi)
    _, yq = biquad.df1_process_q(ba_q, 29, stq, mq)

    di = hbf.hbf_dec_cascade(hbf.hbf_dec_cascade_init(3), yi.astype(jnp.float32))[1]
    dq = hbf.hbf_dec_cascade(hbf.hbf_dec_cascade_init(3), yq.astype(jnp.float32))[1]

    z = (np.asarray(di, np.float64) + 1j * np.asarray(dq, np.float64))
    z = z[1024 : 1024 + 2048]
    n = len(z)
    spec = np.abs(np.fft.fft(z)) ** 2  # coherent: rectangular window
    peak = int(np.argmax(spec))
    # expected baseband bin: offset * 8 (decimation) scaled to the fft
    # the real input's positive-frequency component survives the
    # conjugate mix at +offset
    f_bb = (int(off_step) * 8) / 2**32
    expect_bin = int(round(f_bb * n)) % n
    assert min(abs(peak - expect_bin), n - abs(peak - expect_bin)) <= 2, (
        peak,
        expect_bin,
    )
    # SNR: carrier power (peak +- 2 bins for the window) vs everything else
    sig = slice(max(peak - 1, 0), peak + 2)
    p_sig = spec[sig].sum()
    p_noise = spec.sum() - p_sig
    snr_db = 10 * np.log10(p_sig / p_noise)
    assert snr_db > 80.0, snr_db


def test_fastlo_fused_chain_snr():
    """The fast-LO headline chain (`pipelines.ddc_chain`, lo_mode="fast")
    recovers the same coherent baseband tone at >= the exact chain's
    SNR gate — the chain-level counterpart of the LO-level gates in
    tests/test_fastlo.py (matched-SNR fast-path convention)."""
    from idsp_tpu.pipelines import ddc_chain

    t = 1 << 15
    c = 4
    f0_step = np.int32(0x4000_0000)
    off_step = np.int32(3 << 18)
    phases_in = accu.ramp(jnp.int32(123), f0_step + off_step, t)
    re_in, _ = cossin(phases_in)
    x = ((re_in.astype(jnp.int64) * (1 << 27)) >> 31).astype(jnp.int32)
    steps = jnp.full((c,), f0_step, jnp.int32)
    _, (zi, zq) = ddc_chain.block(
        ddc_chain.init(c), x, steps, ddc_chain.lowpass_coefficients(),
        lo_mode="fast",
    )
    z = (np.asarray(zi[:, 0], np.float64)
         + 1j * np.asarray(zq[:, 0], np.float64))
    z = z[1024:1024 + 2048]
    n = len(z)
    spec = np.abs(np.fft.fft(z)) ** 2
    peak = int(np.argmax(spec))
    f_bb = (int(off_step) * 8) / 2**32
    expect_bin = int(round(f_bb * n)) % n
    assert min(abs(peak - expect_bin), n - abs(peak - expect_bin)) <= 2, (
        peak, expect_bin,
    )
    sig = slice(max(peak - 1, 0), peak + 2)
    p_sig = spec[sig].sum()
    p_noise = spec.sum() - p_sig
    snr_db = 10 * np.log10(p_sig / p_noise)
    assert snr_db > 80.0, snr_db
