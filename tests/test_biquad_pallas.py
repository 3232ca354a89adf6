"""Lane-bank kernels (interpret mode): bit-exactness vs the scan reference."""

import numpy as np
import jax
import jax.numpy as jnp

from idsp_tpu.design import Filter
from idsp_tpu.filters import biquad
from idsp_tpu.filters.biquad_pallas import df1_bank_q


def test_pallas_df1_bank_bitexact():
    c, t = 128, 512
    rng = np.random.default_rng(0)
    ba_q = jnp.asarray(
        biquad.quantize_ba(
            biquad.from_cookbook(Filter().critical_frequency(0.1).lowpass()), 29
        )
    )
    xs = jnp.asarray(
        rng.integers(-(2**31), 2**31, size=(t, c), dtype=np.int64).astype(np.int32)
    )
    st = biquad.Df1State(
        x=jnp.asarray(
            rng.integers(-(2**31), 2**31, size=(c, 2), dtype=np.int64).astype(
                np.int32
            )
        ),
        y=jnp.asarray(
            rng.integers(-(2**31), 2**31, size=(c, 2), dtype=np.int64).astype(
                np.int32
            )
        ),
    )

    st_ref, ys_ref = biquad.df1_process_q(ba_q, 29, st, xs)
    st_pl, ys_pl = df1_bank_q(
        ba_q, st, xs, 29, interpret=True
    )

    np.testing.assert_array_equal(np.asarray(ys_pl), np.asarray(ys_ref))
    np.testing.assert_array_equal(np.asarray(st_pl.x), np.asarray(st_ref.x))
    np.testing.assert_array_equal(np.asarray(st_pl.y), np.asarray(st_ref.y))


def test_pallas_df1_bank_gain_extremes():
    # saturated coefficients and extreme inputs still match bit-for-bit
    c, t = 128, 256
    ba_q = jnp.asarray(
        np.array(
            [2**31 - 1, -(2**31), 0x1234_5678, -0x0765_4321, 1], np.int64
        ).astype(np.int32)
    )
    xs = jnp.asarray(
        np.tile(
            np.array(
                [2**31 - 1, -(2**31), 0, 1, -1, 0x7FFF, -0x8000], np.int64
            ).astype(np.int32),
            (t // 7 + 1,),
        )[: t, None].repeat(c, axis=1)
    )
    st = biquad.df1_init((c,), jnp.int32)
    _, ys_ref = biquad.df1_process_q(ba_q, 30, st, xs)
    _, ys_pl = df1_bank_q(ba_q, st, xs, 30, interpret=True)
    np.testing.assert_array_equal(np.asarray(ys_pl), np.asarray(ys_ref))


def test_pallas_sos_cascade_bitexact():
    from idsp_tpu.filters.biquad_pallas import sos_bank_q

    c, t = 128, 256
    rng = np.random.default_rng(7)
    bas = np.stack(
        [
            biquad.quantize_ba(
                biquad.from_cookbook(Filter().critical_frequency(fc).lowpass()),
                29,
            )
            for fc in (0.05, 0.1, 0.15)
        ]
    )
    xs = jnp.asarray(
        rng.integers(-(2**24), 2**24, size=(t, c), dtype=np.int64).astype(np.int32)
    )
    states = [biquad.df1_init((c,), jnp.int32) for _ in range(3)]
    sts_pl, ys_pl = sos_bank_q(bas, states, xs, 29, interpret=True)

    # stage-major reference
    y = xs
    refs = []
    for i in range(3):
        st = biquad.df1_init((c,), jnp.int32)
        st, y = biquad.df1_process_q(jnp.asarray(bas[i]), 29, st, y)
        refs.append(st)
    np.testing.assert_array_equal(np.asarray(ys_pl), np.asarray(y))
    for a, b in zip(sts_pl, refs):
        np.testing.assert_array_equal(np.asarray(a.x), np.asarray(b.x))
        np.testing.assert_array_equal(np.asarray(a.y), np.asarray(b.y))


def test_pallas_f32_bank_matches_scan():
    from idsp_tpu.filters.biquad_pallas import df1_bank_f32

    c, t = 128, 256
    rng = np.random.default_rng(5)
    ba = biquad.from_cookbook(
        Filter().critical_frequency(0.07).lowpass()
    ).astype(np.float32)
    xs = jnp.asarray(rng.normal(size=(t, c)).astype(np.float32))
    st = biquad.df1_init((c,), jnp.float32)
    st_ref, ys_ref = biquad.df1_process(jnp.asarray(ba), st, xs)
    st_pl, ys_pl = df1_bank_f32(ba, st, xs, interpret=True)
    np.testing.assert_array_equal(np.asarray(ys_pl), np.asarray(ys_ref))
    np.testing.assert_array_equal(np.asarray(st_pl.y), np.asarray(st_ref.y))


def _rand_i32(rng, shape, lim=2**31):
    return jnp.asarray(
        rng.integers(-lim, lim, size=shape, dtype=np.int64).astype(np.int32)
    )


def _ba_q(fc=0.1, f=29):
    return jnp.asarray(
        biquad.quantize_ba(
            biquad.from_cookbook(Filter().critical_frequency(fc).lowpass()), f
        )
    )


def test_pallas_clamp_bank_bitexact():
    from idsp_tpu.filters.biquad_pallas import df1_clamp_bank_q

    c, t = 128, 512
    rng = np.random.default_rng(11)
    ba_q = _ba_q()
    xs = _rand_i32(rng, (t, c))
    st = biquad.Df1State(x=_rand_i32(rng, (c, 2)), y=_rand_i32(rng, (c, 2)))
    u, lo, hi = 12345, -(2**28), 2**28

    def step(s, x):
        return biquad.clamp_step(
            biquad.df1_step_q(ba_q, 29, s, x),
            jnp.int32(u), jnp.int32(lo), jnp.int32(hi),
        )

    st_ref, ys_ref = jax.lax.scan(step, st, xs)
    st_pl, ys_pl = df1_clamp_bank_q(
        ba_q, st, xs, 29, u=u, lo=lo, hi=hi, interpret=True
    )
    np.testing.assert_array_equal(np.asarray(ys_pl), np.asarray(ys_ref))
    np.testing.assert_array_equal(np.asarray(st_pl.x), np.asarray(st_ref.x))
    np.testing.assert_array_equal(np.asarray(st_pl.y), np.asarray(st_ref.y))


def test_pallas_wide_bank_bitexact():
    from idsp_tpu.filters.biquad_pallas import df1_wide_bank

    c, t = 128, 512
    rng = np.random.default_rng(12)
    ba_q = _ba_q()
    xs = _rand_i32(rng, (t, c))
    st = biquad.Df1WideState(
        x=_rand_i32(rng, (c, 2)),
        y=jnp.asarray(
            rng.integers(-(2**62), 2**62, size=(c, 2), dtype=np.int64)
        ),
    )
    st_ref, ys_ref = jax.lax.scan(
        lambda s, x: biquad.df1_wide_step(ba_q, 29, s, x), st, xs
    )
    st_pl, ys_pl = df1_wide_bank(
        ba_q, st, xs, 29, interpret=True
    )
    np.testing.assert_array_equal(np.asarray(ys_pl), np.asarray(ys_ref))
    np.testing.assert_array_equal(np.asarray(st_pl.x), np.asarray(st_ref.x))
    np.testing.assert_array_equal(np.asarray(st_pl.y), np.asarray(st_ref.y))


def test_pallas_wide_clamp_bank_bitexact():
    from idsp_tpu.filters.biquad_pallas import df1_wide_bank

    c, t = 128, 256
    rng = np.random.default_rng(13)
    ba_q = _ba_q()
    xs = _rand_i32(rng, (t, c))
    st = biquad.df1_wide_init((c,))
    u, lo, hi = -777, -(2**27), 2**27
    st_ref, ys_ref = jax.lax.scan(
        lambda s, x: biquad.df1_wide_clamp_step(
            ba_q, 29, s, x, jnp.int32(u), jnp.int32(lo), jnp.int32(hi)
        ),
        st, xs,
    )
    st_pl, ys_pl = df1_wide_bank(
        ba_q, st, xs, 29, clamp=(u, lo, hi), interpret=True
    )
    np.testing.assert_array_equal(np.asarray(ys_pl), np.asarray(ys_ref))
    np.testing.assert_array_equal(np.asarray(st_pl.y), np.asarray(st_ref.y))


def test_pallas_dither_bank_bitexact():
    from idsp_tpu.filters.biquad_pallas import df1_dither_bank

    c, t = 128, 512
    rng = np.random.default_rng(14)
    ba_q = _ba_q()
    xs = _rand_i32(rng, (t, c))
    st = biquad.Df1DitherState(
        xy=biquad.Df1State(
            x=_rand_i32(rng, (c, 2)), y=_rand_i32(rng, (c, 2))
        ),
        e=jnp.asarray(
            rng.integers(0, 2**32, size=(c,), dtype=np.uint64).astype(
                np.uint32
            )
        ),
    )
    st_ref, ys_ref = jax.lax.scan(
        lambda s, x: biquad.df1_dither_step(ba_q, 29, s, x), st, xs
    )
    st_pl, ys_pl = df1_dither_bank(
        ba_q, st, xs, 29, interpret=True
    )
    np.testing.assert_array_equal(np.asarray(ys_pl), np.asarray(ys_ref))
    np.testing.assert_array_equal(
        np.asarray(st_pl.xy.y), np.asarray(st_ref.xy.y)
    )
    np.testing.assert_array_equal(np.asarray(st_pl.e), np.asarray(st_ref.e))


def test_pallas_dither_clamp_bank_bitexact():
    from idsp_tpu.filters.biquad_pallas import df1_dither_bank

    c, t = 128, 256
    rng = np.random.default_rng(15)
    ba_q = _ba_q()
    xs = _rand_i32(rng, (t, c))
    st = biquad.df1_dither_init((c,))
    u, lo, hi = 99, -(2**26), 2**26
    st_ref, ys_ref = jax.lax.scan(
        lambda s, x: biquad.df1_dither_clamp_step(
            ba_q, 29, s, x, jnp.int32(u), jnp.int32(lo), jnp.int32(hi)
        ),
        st, xs,
    )
    st_pl, ys_pl = df1_dither_bank(
        ba_q, st, xs, 29, clamp=(u, lo, hi), interpret=True
    )
    np.testing.assert_array_equal(np.asarray(ys_pl), np.asarray(ys_ref))
    np.testing.assert_array_equal(np.asarray(st_pl.e), np.asarray(st_ref.e))


def test_pallas_coef_bank_bitexact_and_per_channel():
    from idsp_tpu.filters.biquad_pallas import df1_bank_q_coef

    c, t = 128, 256
    rng = np.random.default_rng(16)
    ba_q = _ba_q()
    xs = _rand_i32(rng, (t, c))
    st = biquad.Df1State(x=_rand_i32(rng, (c, 2)), y=_rand_i32(rng, (c, 2)))

    # shared coefficients: must match the static-coefficient kernel
    st_ref, ys_ref = biquad.df1_process_q(ba_q, 29, st, xs)
    st_pl, ys_pl = df1_bank_q_coef(
        ba_q, st, xs, 29, interpret=True
    )
    np.testing.assert_array_equal(np.asarray(ys_pl), np.asarray(ys_ref))
    np.testing.assert_array_equal(np.asarray(st_pl.y), np.asarray(st_ref.y))

    # per-channel coefficients (beyond the reference): match a vmapped scan
    ba_pc = jnp.stack(
        [
            jnp.asarray(
                biquad.quantize_ba(
                    biquad.from_cookbook(
                        Filter().critical_frequency(fc).lowpass()
                    ),
                    29,
                )
            )
            for fc in np.linspace(0.02, 0.3, c)
        ],
        axis=1,
    )  # (5, c)
    st_ref2, ys_ref2 = biquad.df1_process_q(
        jnp.moveaxis(ba_pc, 0, -1), 29, st, xs
    )
    st_pl2, ys_pl2 = df1_bank_q_coef(
        ba_pc, st, xs, 29, interpret=True
    )
    np.testing.assert_array_equal(np.asarray(ys_pl2), np.asarray(ys_ref2))
    np.testing.assert_array_equal(np.asarray(st_pl2.y), np.asarray(st_ref2.y))


def test_pallas_coef_bank_retune_no_recompile():
    """Swapping coefficients between blocks must not retrace/recompile
    (the DF1 atomic-swap property, biquad.rs:34-36) and the state must
    carry continuously across the swap."""
    from idsp_tpu.filters import biquad_pallas as bp

    c, t = 128, 128
    rng = np.random.default_rng(17)
    xs1 = _rand_i32(rng, (t, c))
    xs2 = _rand_i32(rng, (t, c))
    ba_a = _ba_q(0.05)
    ba_b = _ba_q(0.2)
    st = biquad.df1_init((c,), jnp.int32)

    n0 = bp._coef_bank._cache_size()
    st1, _ = bp.df1_bank_q_coef(ba_a, st, xs1, 29, interpret=True)
    n1 = bp._coef_bank._cache_size()
    st2, ys2 = bp.df1_bank_q_coef(ba_b, st1, xs2, 29, interpret=True)
    n2 = bp._coef_bank._cache_size()
    assert n1 == n0 + 1 and n2 == n1, "coefficient swap recompiled"

    # continuity: same as scanning with ba_a then ba_b
    st1_ref, _ = biquad.df1_process_q(ba_a, 29, st, xs1)
    _, ys2_ref = biquad.df1_process_q(ba_b, 29, st1_ref, xs2)
    np.testing.assert_array_equal(np.asarray(ys2), np.asarray(ys2_ref))


def test_pallas_pll_bank_bitexact():
    from idsp_tpu.filters import pll
    from idsp_tpu.filters.pll_pallas import pll_bank

    c, t = 128, 512
    rng = np.random.default_rng(18)
    pba = jnp.asarray(pll.coefficients_from_bandwidth(1e-2, 4.0))
    xs = _rand_i32(rng, (t, c))
    st = pll.init((c,))

    st_ref, ys_ref = pll.block(pba, st, xs)
    st_pl, ys_pl = pll_bank(pba, st, xs, interpret=True)
    np.testing.assert_array_equal(np.asarray(ys_pl), np.asarray(ys_ref))
    for a, b in zip(jax.tree.leaves(st_pl), jax.tree.leaves(st_ref)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_pallas_pll_bank_converges_from_nonzero_state():
    """Chained blocks through the kernel track a frequency ramp exactly
    like the scan (state handoff across pallas_call boundaries)."""
    from idsp_tpu.filters import pll
    from idsp_tpu.filters.pll_pallas import pll_bank

    c, t = 128, 256
    pba = jnp.asarray(pll.coefficients_from_bandwidth(5e-2, 4.0))
    step = np.int64(0x8765437) .astype(np.int32)
    phases = (
        (np.arange(1, 2 * t + 1, dtype=np.int64) * step) & 0xFFFFFFFF
    ).astype(np.int64)
    phases = np.where(phases >= 2**31, phases - 2**32, phases).astype(
        np.int32
    )
    xs = jnp.asarray(np.tile(phases[:, None], (1, c)))

    st_ref, st_pl = pll.init((c,)), pll.init((c,))
    st_ref, ys_ref = pll.block(pba, st_ref, xs[:t])
    st_ref, ys_ref2 = pll.block(pba, st_ref, xs[t:])
    st_pl, ys_pl = pll_bank(pba, st_pl, xs[:t], interpret=True)
    st_pl, ys_pl2 = pll_bank(pba, st_pl, xs[t:], interpret=True)
    np.testing.assert_array_equal(np.asarray(ys_pl2), np.asarray(ys_ref2))
    np.testing.assert_array_equal(np.asarray(st_pl.f), np.asarray(st_ref.f))


def test_pallas_wdf_bank_bitexact():
    from idsp_tpu.filters import wdf
    from idsp_tpu.filters.wdf_pallas import wdf_bank

    c, t = 128, 256
    rng = np.random.default_rng(6)
    tpas = wdf.nibbles(0xAD, 2)
    a = wdf.quantize(tpas, [-0.9, 0.9])
    xs = jnp.asarray(
        rng.integers(-(2**24), 2**24, size=(t, c), dtype=np.int64).astype(np.int32)
    )
    st = wdf.init(2, (c,))

    # reference scan (channels on trailing axes)
    st_ref, ys_ref = wdf.block(tpas, jnp.asarray(a), st, xs)
    st_pl, ys_pl = wdf_bank(tpas, a, st, xs, interpret=True)
    np.testing.assert_array_equal(np.asarray(ys_pl), np.asarray(ys_ref))
    np.testing.assert_array_equal(np.asarray(st_pl.z), np.asarray(st_ref.z))


def test_pallas_wdf_pair_bank_bitexact():
    from idsp_tpu.filters import wdf
    from idsp_tpu.filters.wdf_pallas import wdf_pair_bank

    c, t = 128, 256
    rng = np.random.default_rng(19)
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
    xs = _rand_i32(rng, (t, c), lim=2**24)
    sts = (
        [wdf.init(2, (c,)), wdf.init(2, (c,))],
        [wdf.init(2, (c,)), wdf.init(1, (c,))],
    )
    sts_ref, (lo_ref, hi_ref) = wdf.pair_block(b0, b1, sts, xs)
    sts_pl, (lo_pl, hi_pl) = wdf_pair_bank(
        b0, b1, sts, xs, interpret=True
    )
    np.testing.assert_array_equal(np.asarray(lo_pl), np.asarray(lo_ref))
    np.testing.assert_array_equal(np.asarray(hi_pl), np.asarray(hi_ref))
    for br_pl, br_ref in zip(sts_pl, sts_ref):
        for a, b in zip(br_pl, br_ref):
            np.testing.assert_array_equal(np.asarray(a.z), np.asarray(b.z))


def test_pallas_lowpass_bank_bitexact():
    from idsp_tpu.filters import lowpass
    from idsp_tpu.filters.lowpass_pallas import lowpass_bank

    c, t = 128, 512
    rng = np.random.default_rng(20)
    xs = _rand_i32(rng, (t, c), lim=2**24)
    for n, k in ((1, lowpass.gains1(0.01)), (2, lowpass.gains2(0.01))):
        st = lowpass.LowpassState(
            p=jnp.asarray(
                rng.integers(-(2**40), 2**40, size=(c, n), dtype=np.int64)
            )
        )
        st_ref, ys_ref = lowpass.block(jnp.asarray(k), st, xs)
        st_pl, ys_pl = lowpass_bank(k, st, xs, interpret=True)
        np.testing.assert_array_equal(np.asarray(ys_pl), np.asarray(ys_ref))
        np.testing.assert_array_equal(np.asarray(st_pl.p), np.asarray(st_ref.p))


def test_pallas_lowpass_bank_saturating_input():
    """Extreme inputs exercise the saturating subtract path."""
    from idsp_tpu.filters import lowpass
    from idsp_tpu.filters.lowpass_pallas import lowpass_bank

    c, t = 128, 128
    k = lowpass.gains2(0.2)
    col = np.tile(
        np.array([2**31 - 1, -(2**31), 2**31 - 1, 0], np.int64).astype(
            np.int32
        ),
        t // 4,
    )
    xs = jnp.asarray(np.broadcast_to(col[:, None], (t, c)).copy())
    st = lowpass.LowpassState(
        p=jnp.asarray(
            np.full((c, 2), -(2**55), np.int64)
        )
    )
    st_ref, ys_ref = lowpass.block(jnp.asarray(k), st, xs)
    st_pl, ys_pl = lowpass_bank(k, st, xs, interpret=True)
    np.testing.assert_array_equal(np.asarray(ys_pl), np.asarray(ys_ref))
    np.testing.assert_array_equal(np.asarray(st_pl.p), np.asarray(st_ref.p))


def _ba_pc(c, f=29, lo_fc=0.02, hi_fc=0.3):
    return jnp.stack(
        [
            jnp.asarray(
                biquad.quantize_ba(
                    biquad.from_cookbook(
                        Filter().critical_frequency(fc).lowpass()
                    ),
                    f,
                )
            )
            for fc in np.linspace(lo_fc, hi_fc, c)
        ],
        axis=1,
    )  # (5, c)


def test_pallas_clamp_coef_bank_bitexact():
    from idsp_tpu.filters.biquad_pallas import (
        df1_clamp_bank_q,
        df1_clamp_bank_q_coef,
    )

    c, t = 128, 256
    rng = np.random.default_rng(21)
    ba_q = _ba_q()
    xs = _rand_i32(rng, (t, c))
    st = biquad.Df1State(x=_rand_i32(rng, (c, 2)), y=_rand_i32(rng, (c, 2)))
    u, lo, hi = 321, -(2**28), 2**28

    st_ref, ys_ref = df1_clamp_bank_q(
        ba_q, st, xs, 29, u=u, lo=lo, hi=hi, interpret=True
    )
    st_pl, ys_pl = df1_clamp_bank_q_coef(
        ba_q, st, xs, 29, u=u, lo=lo, hi=hi, interpret=True
    )
    np.testing.assert_array_equal(np.asarray(ys_pl), np.asarray(ys_ref))
    np.testing.assert_array_equal(np.asarray(st_pl.y), np.asarray(st_ref.y))

    # per-channel coefficients vs the scan
    ba_pc = _ba_pc(c)

    def step(s, x):
        return biquad.clamp_step(
            biquad.df1_step_q(jnp.moveaxis(ba_pc, 0, -1), 29, s, x),
            jnp.int32(u), jnp.int32(lo), jnp.int32(hi),
        )

    st_ref2, ys_ref2 = jax.lax.scan(step, st, xs)
    st_pl2, ys_pl2 = df1_clamp_bank_q_coef(
        ba_pc, st, xs, 29, u=u, lo=lo, hi=hi, interpret=True
    )
    np.testing.assert_array_equal(np.asarray(ys_pl2), np.asarray(ys_ref2))
    np.testing.assert_array_equal(np.asarray(st_pl2.y), np.asarray(st_ref2.y))


def test_pallas_wide_coef_bank_bitexact():
    from idsp_tpu.filters.biquad_pallas import (
        df1_wide_bank,
        df1_wide_bank_coef,
    )

    c, t = 128, 256
    rng = np.random.default_rng(22)
    ba_q = _ba_q()
    xs = _rand_i32(rng, (t, c))
    st = biquad.Df1WideState(
        x=_rand_i32(rng, (c, 2)),
        y=jnp.asarray(
            rng.integers(-(2**62), 2**62, size=(c, 2), dtype=np.int64)
        ),
    )
    st_ref, ys_ref = df1_wide_bank(
        ba_q, st, xs, 29, interpret=True
    )
    st_pl, ys_pl = df1_wide_bank_coef(
        ba_q, st, xs, 29, interpret=True
    )
    np.testing.assert_array_equal(np.asarray(ys_pl), np.asarray(ys_ref))
    np.testing.assert_array_equal(np.asarray(st_pl.y), np.asarray(st_ref.y))

    # per-channel + clamp vs the scan
    ba_pc = _ba_pc(c)
    u, lo, hi = -5, -(2**27), 2**27
    st2 = biquad.df1_wide_init((c,))
    st_ref2, ys_ref2 = jax.lax.scan(
        lambda s, x: biquad.df1_wide_clamp_step(
            jnp.moveaxis(ba_pc, 0, -1), 29, s, x,
            jnp.int32(u), jnp.int32(lo), jnp.int32(hi),
        ),
        st2, xs,
    )
    st_pl2, ys_pl2 = df1_wide_bank_coef(
        ba_pc, st2, xs, 29, clamp=(u, lo, hi), interpret=True,
    )
    np.testing.assert_array_equal(np.asarray(ys_pl2), np.asarray(ys_ref2))
    np.testing.assert_array_equal(np.asarray(st_pl2.y), np.asarray(st_ref2.y))


def test_pallas_dither_coef_bank_bitexact():
    from idsp_tpu.filters.biquad_pallas import (
        df1_dither_bank,
        df1_dither_bank_coef,
    )

    c, t = 128, 256
    rng = np.random.default_rng(23)
    ba_q = _ba_q()
    xs = _rand_i32(rng, (t, c))
    st = biquad.Df1DitherState(
        xy=biquad.Df1State(
            x=_rand_i32(rng, (c, 2)), y=_rand_i32(rng, (c, 2))
        ),
        e=jnp.asarray(
            rng.integers(0, 2**32, size=(c,), dtype=np.uint64).astype(
                np.uint32
            )
        ),
    )
    st_ref, ys_ref = df1_dither_bank(
        ba_q, st, xs, 29, interpret=True
    )
    st_pl, ys_pl = df1_dither_bank_coef(
        ba_q, st, xs, 29, interpret=True
    )
    np.testing.assert_array_equal(np.asarray(ys_pl), np.asarray(ys_ref))
    np.testing.assert_array_equal(np.asarray(st_pl.e), np.asarray(st_ref.e))

    # per-channel coefficients vs the scan
    ba_pc = _ba_pc(c)
    st_ref2, ys_ref2 = jax.lax.scan(
        lambda s, x: biquad.df1_dither_step(
            jnp.moveaxis(ba_pc, 0, -1), 29, s, x
        ),
        st, xs,
    )
    st_pl2, ys_pl2 = df1_dither_bank_coef(
        ba_pc, st, xs, 29, interpret=True
    )
    np.testing.assert_array_equal(np.asarray(ys_pl2), np.asarray(ys_ref2))
    np.testing.assert_array_equal(
        np.asarray(st_pl2.xy.y), np.asarray(st_ref2.xy.y)
    )
    np.testing.assert_array_equal(np.asarray(st_pl2.e), np.asarray(st_ref2.e))


def test_pallas_q64_bank_bitexact():
    # Q64<61> bank kernel (emulated 128-bit limb MAC) == df1_process_q64
    # scanned, bit-for-bit, across streamed blocks with carried state.
    from idsp_tpu.filters.biquad_pallas import df1_bank_q64

    c2, t = 128, 192
    rng = np.random.default_rng(61)
    ba5 = np.asarray(
        biquad.from_cookbook(
            __import__("idsp_tpu.design", fromlist=["Filter"])
            .Filter().critical_frequency(0.05).lowpass()
        )
    )
    ba_q61 = jnp.asarray(biquad.quantize_ba(ba5, 61, dtype=jnp.int64))

    st_ref = biquad.df1_init((c2,), jnp.int64)
    st_pl = biquad.df1_init((c2,), jnp.int64)
    for _ in range(3):
        xs = jnp.asarray(
            rng.integers(-(2**55), 2**55, size=(t, c2), dtype=np.int64)
        )
        st_ref, ys_ref = biquad.df1_process_q64(ba_q61, 61, st_ref, xs)
        st_pl, ys = df1_bank_q64(ba_q61, st_pl, xs, 61, interpret=True)
        np.testing.assert_array_equal(np.asarray(ys), np.asarray(ys_ref))
        np.testing.assert_array_equal(np.asarray(st_pl.x),
                                      np.asarray(st_ref.x))
        np.testing.assert_array_equal(np.asarray(st_pl.y),
                                      np.asarray(st_ref.y))


def test_pallas_q16_bank_bitexact():
    # Q16<13> bank kernel (native i32 accumulator) == the i16 scan,
    # bit-for-bit, with wrap-heavy random i16 state/input.
    from idsp_tpu.filters.biquad_pallas import df1_bank_q16

    c2, t = 128, 256
    rng = np.random.default_rng(16)
    ba5 = np.asarray(
        biquad.from_cookbook(Filter().critical_frequency(0.05).lowpass())
    )
    ba16 = jnp.asarray(biquad.quantize_ba(ba5, 13, dtype=jnp.int16))

    def r16(shape):
        return jnp.asarray(
            rng.integers(-(2**15), 2**15, size=shape,
                         dtype=np.int64).astype(np.int16)
        )

    st_ref = biquad.Df1State(x=r16((c2, 2)), y=r16((c2, 2)))
    st_pl = st_ref
    for _ in range(3):
        xs = r16((t, c2))
        st_ref, ys_ref = jax.lax.scan(
            lambda s, x: biquad.df1_step_q(ba16, 13, s, x,
                                           dtype=jnp.int16),
            st_ref, xs,
        )
        st_pl, ys = df1_bank_q16(ba16, st_pl, xs, 13, interpret=True)
        np.testing.assert_array_equal(np.asarray(ys), np.asarray(ys_ref))
        np.testing.assert_array_equal(np.asarray(st_pl.x),
                                      np.asarray(st_ref.x))
        np.testing.assert_array_equal(np.asarray(st_pl.y),
                                      np.asarray(st_ref.y))


def test_pallas_df1_bank_dec_bitexact():
    # keep-1-in-d kernel epilogue == full-rate kernel + [::d]; state
    # carries the full-rate recurrence exactly.
    from idsp_tpu.filters.biquad_pallas import df1_bank_q, df1_bank_q_dec

    c, t, d = 128, 512, 16
    rng = np.random.default_rng(40)
    ba_q = _ba_q(0.02)
    st_a = biquad.df1_init((c,), jnp.int32)
    st_b = biquad.df1_init((c,), jnp.int32)
    for _ in range(2):
        xs = jnp.asarray(
            rng.integers(-(2**27), 2**27, size=(t, c),
                         dtype=np.int64).astype(np.int32)
        )
        st_a, ys = df1_bank_q(ba_q, st_a, xs, 29, interpret=True)
        st_b, yd = df1_bank_q_dec(ba_q, st_b, xs, 29, d=d,
                                  interpret=True)
        np.testing.assert_array_equal(
            np.asarray(ys)[::d], np.asarray(yd)
        )
        np.testing.assert_array_equal(np.asarray(st_a.y),
                                      np.asarray(st_b.y))
        np.testing.assert_array_equal(np.asarray(st_a.x),
                                      np.asarray(st_b.x))


def test_pallas_lowpass_bank_dec_bitexact():
    # lowpass bank dec epilogue == full-rate bank + [::dec]
    from idsp_tpu.filters import lowpass
    from idsp_tpu.filters.lowpass_pallas import lowpass_bank

    c, t, d = 128, 512, 16
    rng = np.random.default_rng(41)
    k2 = lowpass.gains2(0.01)
    st_a = lowpass.init(2, (c,))
    st_b = lowpass.init(2, (c,))
    for _ in range(2):
        xs = jnp.asarray(
            rng.integers(-(2**27), 2**27, size=(t, c),
                         dtype=np.int64).astype(np.int32)
        )
        st_a, ys = lowpass_bank(k2, st_a, xs, interpret=True)
        st_b, yd = lowpass_bank(k2, st_b, xs, dec=d,
                                interpret=True)
        np.testing.assert_array_equal(np.asarray(ys)[::d], np.asarray(yd))
        np.testing.assert_array_equal(np.asarray(st_a.p),
                                      np.asarray(st_b.p))


def test_pallas_df1_bank_dec_non_pow2():
    # dec=12 has no power-of-two chunk multiple; the chunk picker must
    # enumerate lcm multiples instead of halving (review regression).
    from idsp_tpu.filters.biquad_pallas import df1_bank_q, df1_bank_q_dec

    c, t, d = 128, 96 * 4, 12
    rng = np.random.default_rng(43)
    ba_q = _ba_q(0.05)
    xs = jnp.asarray(
        rng.integers(-(2**27), 2**27, size=(t, c),
                     dtype=np.int64).astype(np.int32)
    )
    st_a = biquad.df1_init((c,), jnp.int32)
    st_b = biquad.df1_init((c,), jnp.int32)
    st_a, ys = df1_bank_q(ba_q, st_a, xs, 29, interpret=True)
    st_b, yd = df1_bank_q_dec(ba_q, st_b, xs, 29, d=d, interpret=True)
    np.testing.assert_array_equal(np.asarray(ys)[::d], np.asarray(yd))
    np.testing.assert_array_equal(np.asarray(st_a.y), np.asarray(st_b.y))


