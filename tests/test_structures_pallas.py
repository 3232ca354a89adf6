"""Lane-bank kernels for the alternative structures (SVF, normal
form, RPLL): bit-exactness vs the lax.scan references, interpret mode.

Same equivalence-test pattern as test_biquad_pallas.py (the reference's
modular-vs-monolithic discipline, cic.rs:305-387).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from idsp_tpu.design import Filter
from idsp_tpu.filters import normal, rpll, svf
from idsp_tpu.filters.normal_pallas import normal_bank_f32, normal_bank_q
from idsp_tpu.filters.rpll_pallas import rpll_bank
from idsp_tpu.filters.svf_pallas import svf_bank
from idsp_tpu import fxp


@pytest.mark.parametrize("output", ["lp", "hp", "bp", "br"])
def test_svf_bank_matches_scan(output):
    c, t = 128, 256
    rng = np.random.default_rng(11)
    f, qi = svf.coefficients(0.04, 1.3)
    xs = jnp.asarray(rng.normal(size=(t, c)).astype(np.float32))
    st = svf.init((c,), jnp.float32)
    st_ref, outs = svf.block(
        jnp.float32(f), jnp.float32(qi), st, xs, unroll=1
    )
    ys_ref = {
        "lp": outs.lp, "hp": outs.hp, "bp": outs.bp,
        "br": outs.hp + outs.lp,
    }[output]
    st_pl, ys_pl = svf_bank(
        f, qi, st, xs, output=output, interpret=True
    )
    np.testing.assert_array_equal(np.asarray(ys_pl), np.asarray(ys_ref))
    for a, b in zip(st_pl, st_ref):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_normal_bank_q_matches_scan():
    c, t = 128, 256
    rng = np.random.default_rng(12)
    b, p = normal.from_cookbook(Filter().critical_frequency(0.06).lowpass())
    f = 29
    b_q = np.asarray(fxp.from_float(jnp.asarray(b), f))
    p_q = np.asarray(fxp.from_float(jnp.asarray(p), f))
    xs = jnp.asarray(
        rng.integers(-(2**27), 2**27, size=(t, c), dtype=np.int64).astype(
            np.int32
        )
    )
    st = normal.init((c,), jnp.int32)

    def step(s, x):
        return normal.step_q(
            jnp.asarray(b_q), jnp.asarray(p_q), f, s, x
        )

    import jax

    st_ref, ys_ref = jax.lax.scan(step, st, xs)
    st_pl, ys_pl = normal_bank_q(
        b_q, p_q, st, xs, f, interpret=True
    )
    np.testing.assert_array_equal(np.asarray(ys_pl), np.asarray(ys_ref))
    np.testing.assert_array_equal(np.asarray(st_pl.x), np.asarray(st_ref.x))
    np.testing.assert_array_equal(np.asarray(st_pl.y), np.asarray(st_ref.y))


def test_normal_bank_f32_matches_scan():
    c, t = 128, 256
    rng = np.random.default_rng(13)
    b, p = normal.from_cookbook(Filter().critical_frequency(0.06).lowpass())
    b = b.astype(np.float32)
    p = p.astype(np.float32)
    xs = jnp.asarray(rng.normal(size=(t, c)).astype(np.float32))
    st = normal.init((c,), jnp.float32)
    st_ref, ys_ref = normal.block(
        jnp.asarray(b), jnp.asarray(p), st, xs, unroll=1
    )
    st_pl, ys_pl = normal_bank_f32(
        b, p, st, xs, interpret=True
    )
    np.testing.assert_array_equal(np.asarray(ys_pl), np.asarray(ys_ref))
    np.testing.assert_array_equal(np.asarray(st_pl.y), np.asarray(st_ref.y))


def test_rpll_bank_matches_scan():
    # 4 distinct operating points tiled over the lanes (the kernel is
    # config-shared but the timestamp streams differ per channel).
    c, t = 128, 256
    cfg = rpll.RpllConfig(dt2=8, shift_frequency=12, shift_phase=11)
    rng = np.random.default_rng(14)
    xs = np.zeros((t, c), np.int32)
    valids = np.zeros((t, c), bool)
    for k, period in enumerate((333, 217, 1024, 89)):
        tt = 0
        nxt = np.int32(100 + 7 * k)
        for i in range(t):
            if np.int32(tt - nxt) >= 0:
                xs[i, k::4] = nxt
                valids[i, k::4] = True
                nxt = np.int32(nxt + period + rng.integers(-3, 4))
            tt = np.int32(tt + (1 << cfg.dt2))
    xs_j = jnp.asarray(xs)
    v_j = jnp.asarray(valids)
    st = rpll.init((c,))
    st_ref, (y_ref, f_ref) = rpll.block(cfg, st, xs_j, v_j)
    st_pl, (y_pl, f_pl) = rpll_bank(
        cfg, st, xs_j, v_j, interpret=True
    )
    np.testing.assert_array_equal(np.asarray(y_pl), np.asarray(y_ref))
    np.testing.assert_array_equal(np.asarray(f_pl), np.asarray(f_ref))
    np.testing.assert_array_equal(np.asarray(st_pl.x), np.asarray(st_ref.x))
    np.testing.assert_array_equal(
        np.asarray(st_pl.ff), np.asarray(st_ref.ff)
    )
    np.testing.assert_array_equal(np.asarray(st_pl.f), np.asarray(st_ref.f))
    np.testing.assert_array_equal(np.asarray(st_pl.y), np.asarray(st_ref.y))
