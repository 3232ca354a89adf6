"""Cross-implementation equivalence: JAX kernels vs the C golden model.

The reference proves its modular CIC equals the monolithic one
bit-for-bit (cic.rs:305-387); here an independent scalar C
implementation must agree bit-for-bit with the vectorized JAX kernels
over random and adversarial inputs.
"""

import numpy as np
import jax.numpy as jnp

from idsp_tpu import golden
from idsp_tpu.design import Filter
from idsp_tpu.filters import biquad
from idsp_tpu.ops import trig


def _rand_i32(rng, n):
    return rng.integers(-(2**31), 2**31, size=n, dtype=np.int64).astype(np.int32)


def test_cossin_bitexact_vs_golden():
    rng = np.random.default_rng(0)
    p = np.concatenate(
        [
            _rand_i32(rng, 4096),
            np.array(
                [0, 1, -1, 2**31 - 1, -(2**31), 1 << 29, -(1 << 29), 1 << 30],
                np.int64,
            ).astype(np.int32),
        ]
    )
    cj, sj = trig.cossin(jnp.asarray(p))
    cg, sg = golden.cossin(p)
    np.testing.assert_array_equal(np.asarray(cj), cg)
    np.testing.assert_array_equal(np.asarray(sj), sg)


def test_atan2_bitexact_vs_golden():
    rng = np.random.default_rng(1)
    y = _rand_i32(rng, 4096)
    x = _rand_i32(rng, 4096)
    extremes = np.array(
        [0, 1, -1, 2**31 - 1, -(2**31)], np.int64
    ).astype(np.int32)
    y = np.concatenate([y, np.repeat(extremes, 5)])
    x = np.concatenate([x, np.tile(extremes, 5)])
    rj = trig.atan2(jnp.asarray(y), jnp.asarray(x))
    rg = golden.atan2(y, x)
    np.testing.assert_array_equal(np.asarray(rj), rg)


def test_biquad_df1_q_bitexact_vs_golden():
    rng = np.random.default_rng(2)
    ba = biquad.quantize_ba(
        biquad.from_cookbook(Filter().critical_frequency(0.07).lowpass()), 29
    )
    x = _rand_i32(rng, 2048) >> 4
    st_j = biquad.df1_init((), jnp.int32)
    _, yj = biquad.df1_process_q(jnp.asarray(ba), 29, st_j, jnp.asarray(x))
    _, yg = golden.biquad_df1_q(ba, 29, np.zeros(4, np.int32), x)
    np.testing.assert_array_equal(np.asarray(yj), yg)


def test_biquad_wide_and_dither_bitexact_vs_golden():
    import jax

    rng = np.random.default_rng(3)
    ba = biquad.quantize_ba(
        biquad.from_cookbook(Filter().critical_frequency(0.03).lowpass()), 30
    )
    x = _rand_i32(rng, 1024) >> 3

    stw = biquad.df1_wide_init(())
    _, yj = jax.lax.scan(
        lambda s, v: biquad.df1_wide_step(jnp.asarray(ba), 30, s, v),
        stw,
        jnp.asarray(x),
    )
    _, _, yg = golden.biquad_df1_wide(
        ba, 30, np.zeros(2, np.int32), np.zeros(2, np.int64), x
    )
    np.testing.assert_array_equal(np.asarray(yj), yg)

    std = biquad.df1_dither_init(())
    _, yj = jax.lax.scan(
        lambda s, v: biquad.df1_dither_step(jnp.asarray(ba), 30, s, v),
        std,
        jnp.asarray(x),
    )
    _, _, yg = golden.biquad_df1_dither(ba, 30, np.zeros(4, np.int32), 0, x)
    np.testing.assert_array_equal(np.asarray(yj), yg)


def test_pallas_interpret_vs_golden():
    from idsp_tpu.filters.biquad_pallas import df1_bank_q

    rng = np.random.default_rng(4)
    ba = biquad.quantize_ba(
        biquad.from_cookbook(Filter().critical_frequency(0.1).highpass()), 29
    )
    c, t = 128, 256
    x = _rand_i32(rng, (t, c))
    st = biquad.df1_init((c,), jnp.int32)
    _, y_pl = df1_bank_q(
        jnp.asarray(ba), st, jnp.asarray(x), 29, interpret=True
    )
    # golden model channel by channel (first 8 channels for speed)
    for ch in range(8):
        _, yg = golden.biquad_df1_q(ba, 29, np.zeros(4, np.int32), x[:, ch])
        np.testing.assert_array_equal(np.asarray(y_pl[:, ch]), yg)


def test_biquad_fuzz_many_coefficient_sets():
    # 20 random Q29/Q30 coefficient sets x full-range random inputs,
    # every output bit-compared against the C golden model.
    rng = np.random.default_rng(123)
    for trial in range(20):
        f = int(rng.integers(27, 31))
        ba = rng.integers(-(2**31), 2**31, size=5, dtype=np.int64).astype(
            np.int32
        )
        x = _rand_i32(rng, 256)
        st_j = biquad.df1_init((), jnp.int32)
        _, yj = biquad.df1_process_q(jnp.asarray(ba), f, st_j, jnp.asarray(x))
        _, yg = golden.biquad_df1_q(ba, f, np.zeros(4, np.int32), x)
        np.testing.assert_array_equal(np.asarray(yj), yg, err_msg=f"trial {trial}")


def test_qmul_fuzz_full_range():
    rng = np.random.default_rng(321)
    from idsp_tpu import fxp

    a = _rand_i32(rng, 4096)
    b = _rand_i32(rng, 4096)
    for f in (1, 15, 29, 31):
        got = np.asarray(fxp.q_mul(jnp.asarray(a), jnp.asarray(b), f))
        want = golden.q_mul(a, b, f)
        np.testing.assert_array_equal(got, want)


def test_biquad_clamp_bitexact_vs_golden():
    import jax

    rng = np.random.default_rng(6)
    ba = biquad.quantize_ba(
        biquad.from_cookbook(Filter().critical_frequency(0.05).lowpass()), 29
    )
    x = _rand_i32(rng, 1024)
    u, lo, hi = 4321, -(2**27), 2**27
    st = biquad.df1_init((), jnp.int32)
    _, yj = jax.lax.scan(
        lambda s, v: biquad.clamp_step(
            biquad.df1_step_q(jnp.asarray(ba), 29, s, v),
            jnp.int32(u), jnp.int32(lo), jnp.int32(hi),
        ),
        st, jnp.asarray(x),
    )
    _, yg = golden.biquad_df1_clamp(ba, 29, u, lo, hi, np.zeros(4, np.int32), x)
    np.testing.assert_array_equal(np.asarray(yj), yg)


def test_biquad_q16_bitexact_vs_golden():
    """Q16<13> storage path (tests/embedded/README.md:62) — i16 arrays
    with i32 accumulation via fxp._INT_INFO."""
    import jax

    rng = np.random.default_rng(7)
    ba = biquad.quantize_ba(
        biquad.from_cookbook(Filter().critical_frequency(0.1).lowpass()),
        13, dtype=jnp.int16,
    )
    x = rng.integers(-(2**15), 2**15, size=1024, dtype=np.int64).astype(
        np.int16
    )
    st = biquad.df1_init((), jnp.int16)
    _, yj = jax.lax.scan(
        lambda s, v: biquad.df1_step_q(
            jnp.asarray(ba), 13, s, v, dtype=jnp.int16
        ),
        st, jnp.asarray(x),
    )
    _, yg = golden.biquad_df1_q16(ba, 13, np.zeros(4, np.int16), x)
    np.testing.assert_array_equal(np.asarray(yj), yg)


def test_biquad_q64_bitexact_vs_golden():
    """Q64<61> storage path (tests/embedded/README.md:63) — i64 arrays
    with emulated 128-bit accumulation."""
    rng = np.random.default_rng(8)
    ba = biquad.quantize_ba(
        biquad.from_cookbook(Filter().critical_frequency(0.02).lowpass()),
        61, dtype=jnp.int64,
    )
    x = rng.integers(-(2**62), 2**62, size=512, dtype=np.int64)
    st = biquad.df1_init((), jnp.int64)
    _, yj = biquad.df1_process_q64(jnp.asarray(ba), 61, st, jnp.asarray(x))
    _, yg = golden.biquad_df1_q64(ba, 61, np.zeros(4, np.int64), x)
    np.testing.assert_array_equal(np.asarray(yj), yg)

    # random full-range coefficients too (wrap behavior)
    for trial in range(5):
        ba_r = rng.integers(-(2**63), 2**63, size=5, dtype=np.int64)
        f = int(rng.integers(40, 63))
        x_r = rng.integers(-(2**63), 2**63, size=128, dtype=np.int64)
        _, yj = biquad.df1_process_q64(
            jnp.asarray(ba_r), f, st, jnp.asarray(x_r)
        )
        _, yg = golden.biquad_df1_q64(ba_r, f, np.zeros(4, np.int64), x_r)
        np.testing.assert_array_equal(np.asarray(yj), yg, err_msg=f"t{trial}")


def test_pll_bitexact_vs_golden():
    from idsp_tpu.filters import pll

    rng = np.random.default_rng(9)
    pba = pll.coefficients_from_bandwidth(1e-2, 4.0)
    x = _rand_i32(rng, 2048)
    st = pll.init(())
    _, yj = pll.block(jnp.asarray(pba), st, jnp.asarray(x))
    _, _, yg = golden.pll(
        pba, np.zeros(5, np.int32), np.zeros(2, np.int64), x
    )
    np.testing.assert_array_equal(np.asarray(yj), yg)


def test_normal_q_bitexact_vs_golden():
    import jax

    from idsp_tpu import fxp
    from idsp_tpu.filters import normal

    rng = np.random.default_rng(15)
    b, p = normal.from_cookbook(Filter().critical_frequency(0.06).lowpass())
    f = 29
    b_q = np.asarray(fxp.from_float(jnp.asarray(b), f)).astype(np.int32)
    p_q = np.asarray(fxp.from_float(jnp.asarray(p), f)).astype(np.int32)
    x = rng.integers(-(2**27), 2**27, size=2048, dtype=np.int64).astype(
        np.int32
    )
    st = normal.init((), jnp.int32)
    _, yj = jax.lax.scan(
        lambda s, v: normal.step_q(
            jnp.asarray(b_q), jnp.asarray(p_q), f, s, v
        ),
        st, jnp.asarray(x),
    )
    _, yg = golden.normal_q(b_q, p_q, f, np.zeros(4, np.int32), x)
    np.testing.assert_array_equal(np.asarray(yj), yg)

    # full-range coefficient/input fuzz (wrap behavior)
    for trial in range(5):
        b_r = rng.integers(-(2**31), 2**31, size=3, dtype=np.int64).astype(
            np.int32
        )
        p_r = rng.integers(
            -(2**31) + 1, 2**31, size=2, dtype=np.int64
        ).astype(np.int32)  # p_im != i32::MIN (no negation)
        f_r = int(rng.integers(1, 31))
        x_r = _rand_i32(rng, 256)
        _, yj = jax.lax.scan(
            lambda s, v: normal.step_q(
                jnp.asarray(b_r), jnp.asarray(p_r), f_r, s, v
            ),
            st, jnp.asarray(x_r),
        )
        _, yg = golden.normal_q(b_r, p_r, f_r, np.zeros(4, np.int32), x_r)
        np.testing.assert_array_equal(np.asarray(yj), yg, err_msg=f"t{trial}")


def test_rpll_bitexact_vs_golden():
    from idsp_tpu.filters import rpll

    rng = np.random.default_rng(16)
    cfg = rpll.RpllConfig(dt2=8, shift_frequency=12, shift_phase=11)
    n = 2048
    x = _rand_i32(rng, n)
    valid = rng.integers(0, 8, size=n) == 0
    st = rpll.init(())
    _, (yj, fj) = rpll.block(cfg, st, jnp.asarray(x), jnp.asarray(valid))
    _, yg, fg = golden.rpll(
        cfg.dt2, cfg.shift_frequency, cfg.shift_phase,
        np.zeros(4, np.int32), x, valid,
    )
    np.testing.assert_array_equal(np.asarray(yj), yg)
    np.testing.assert_array_equal(np.asarray(fj), fg)
