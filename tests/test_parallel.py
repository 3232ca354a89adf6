"""Distributed-vs-single-device equivalence (SURVEY.md §4.10).

The reference's cross-implementation equivalence pattern (cic.rs:305-387)
applied across the mesh: the same bits/values must come out of the
1-device and N-device shardings.
"""

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from jax import shard_map

from idsp_tpu.filters import biquad
from idsp_tpu.parallel import make_mesh, sharded_df1_float
from idsp_tpu.parallel.stream import halo_exchange_prev, time_sharded_prev


def test_halo_exchange_prev():
    mesh = make_mesh({"sp": 4})
    x = jnp.arange(32, dtype=jnp.int32).reshape(32)  # 8 per device

    def f(x):
        return halo_exchange_prev(x, "sp", 2, fill=-1)

    out = jax.jit(
        shard_map(f, mesh=mesh, in_specs=P("sp"), out_specs=P("sp"))
    )(x)
    out = np.asarray(out).reshape(4, 2)
    np.testing.assert_array_equal(out[0], [-1, -1])
    np.testing.assert_array_equal(out[1], [6, 7])
    np.testing.assert_array_equal(out[2], [14, 15])
    np.testing.assert_array_equal(out[3], [22, 23])


def test_time_sharded_prev():
    mesh = make_mesh({"sp": 4})
    x = jnp.arange(16, dtype=jnp.int32)

    def f(x):
        prev, valid = time_sharded_prev(
            x, "sp", jnp.int32(-7), jnp.asarray(False)
        )
        return prev, valid

    prev, valid = jax.jit(
        shard_map(f, mesh=mesh, in_specs=P("sp"), out_specs=(P("sp"), P("sp")))
    )(x)
    prev = np.asarray(prev)
    valid = np.asarray(valid)
    want_prev = np.concatenate([[-7], np.arange(15)])
    np.testing.assert_array_equal(prev, want_prev)
    assert not valid[0] and valid[1:].all()


def test_sharded_df1_matches_sequential():
    mesh = make_mesh({"sp": 8})
    rng = np.random.default_rng(11)
    from idsp_tpu.design import Filter

    ba = jnp.asarray(
        biquad.from_cookbook(Filter().critical_frequency(0.05).lowpass())
    )
    n, c = 256, 3
    xs = jnp.asarray(rng.normal(size=(n, c)))
    st = biquad.Df1State(
        x=jnp.asarray(rng.normal(size=(c, 2))),
        y=jnp.asarray(rng.normal(size=(c, 2))),
    )

    # sequential reference
    st_ref, ys_ref = biquad.df1_process(ba, st, xs)

    def f(xs):
        return sharded_df1_float(ba, st, xs, "sp")

    st_sh, ys_sh = jax.jit(
        shard_map(
            f,
            mesh=mesh,
            in_specs=P("sp"),
            out_specs=(P(), P("sp")),
        )
    )(xs)

    np.testing.assert_allclose(
        np.asarray(ys_sh), np.asarray(ys_ref), rtol=1e-9, atol=1e-9
    )
    np.testing.assert_allclose(
        np.asarray(st_sh.y), np.asarray(st_ref.y), rtol=1e-9, atol=1e-9
    )
    np.testing.assert_array_equal(np.asarray(st_sh.x), np.asarray(st_ref.x))


def test_channel_sharded_fm_bank():
    """A bank of FM channels sharded over the mesh gives the same bits
    as unsharded execution."""
    from jax.sharding import NamedSharding

    from idsp_tpu.pipelines import fm_disc

    mesh = make_mesh({"dp": 8})
    c, n = 16, 128
    rng = np.random.default_rng(5)
    phases = rng.integers(-(2**31), 2**31, size=(n, c), dtype=np.int64).astype(
        np.int32
    )
    from idsp_tpu.ops.trig import cossin

    re, im = cossin(jnp.asarray(phases))
    ba_q = jnp.asarray(fm_disc.deemphasis_coefficients(0.02))
    st = fm_disc.init_state((c,))

    _, y_ref = fm_disc.fm_receiver(st, re, im, jnp.int32(1000), ba_q)

    sh = NamedSharding(mesh, P(None, "dp"))
    re_s = jax.device_put(re, sh)
    im_s = jax.device_put(im, sh)
    _, y_sh = fm_disc.fm_receiver(st, re_s, im_s, jnp.int32(1000), ba_q)
    np.testing.assert_array_equal(np.asarray(y_ref), np.asarray(y_sh))


def test_sharded_hbf_dec_matches_block():
    """Time-sharded HBF decimator (overlap-save halos) == sequential
    hbf_dec_block (up to FMA contraction), including the carried state
    across two chained sharded blocks."""
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P
    from idsp_tpu.filters import hbf
    from idsp_tpu.parallel import make_mesh
    from idsp_tpu.parallel.stream import sharded_hbf_dec

    mesh = make_mesh({"sp": 8})
    taps = hbf.HBF_TAPS[2]
    m = len(taps)
    c, t = 3, 8 * 64
    rng = np.random.default_rng(3)
    x1 = jnp.asarray(rng.normal(size=(c, t)).astype(np.float32))
    x2 = jnp.asarray(rng.normal(size=(c, t)).astype(np.float32))

    st = hbf.hbf_dec_init(m, (c,))

    def sharded(st, x):
        return sharded_hbf_dec(taps, st, x, "sp")

    f = jax.jit(
        shard_map(
            sharded, mesh=mesh,
            in_specs=(P(), P(None, "sp")),
            out_specs=(P(), P(None, "sp")),
        )
    )
    st_sh, y1_sh = f(st, x1)
    st_sh, y2_sh = f(st_sh, x2)

    st_ref, y1 = hbf.hbf_dec_block(taps, st, x1)
    st_ref, y2 = hbf.hbf_dec_block(taps, st_ref, x2)
    np.testing.assert_allclose(np.asarray(y1_sh), np.asarray(y1), atol=2e-6)
    np.testing.assert_allclose(np.asarray(y2_sh), np.asarray(y2), atol=2e-6)
    np.testing.assert_array_equal(np.asarray(st_sh.odd), np.asarray(st_ref.odd))


def test_channelizer_tensor_parallel():
    """TP channelizer (DFT contraction sharded + psum) matches the
    replicated channelizer across two chained blocks."""
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P
    from idsp_tpu.pipelines import channelizer
    from idsp_tpu.parallel import make_mesh

    n_dev, m, taps, n = 8, 16, 8, 32
    mesh = make_mesh({"tp": n_dev})
    rng = np.random.default_rng(5)
    x1 = jnp.asarray(rng.normal(size=(n, m, 2)).astype(np.float32))
    x2 = jnp.asarray(rng.normal(size=(n, m, 2)).astype(np.float32))

    st_ref = channelizer.init(m, taps)
    st_ref, y1 = channelizer.channelize(st_ref, x1, m=m, taps=taps)
    st_ref, y2 = channelizer.channelize(st_ref, x2, m=m, taps=taps)

    f = jax.jit(
        shard_map(
            lambda st, x: channelizer.channelize_tp(
                st, x, "tp", m=m, taps=taps
            ),
            mesh=mesh,
            in_specs=(P(None, "tp", None), P(None, "tp", None)),
            out_specs=(P(None, "tp", None), P()),
        )
    )
    st_tp = channelizer.init(m, taps)
    st_tp, y1_tp = f(st_tp, x1)
    st_tp, y2_tp = f(st_tp, x2)
    np.testing.assert_allclose(
        np.asarray(y1_tp), np.asarray(y1), rtol=0, atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(y2_tp), np.asarray(y2), rtol=0, atol=1e-5
    )


def test_distributed_helpers_single_process():
    # Single-process: initialize_from_env stays inert (returns False,
    # touches nothing), global_mesh == make_mesh over all devices, and
    # process_info reports the 1-process topology.
    from idsp_tpu.parallel import distributed

    env_keys = (
        "JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS",
        "JAX_NUM_PROCESSES", "NUM_PROCESSES",
        "JAX_PROCESS_ID", "PROCESS_ID",
    )
    import os

    saved = {k: os.environ.pop(k) for k in env_keys if k in os.environ}
    try:
        assert distributed.initialize_from_env() is False
    finally:
        os.environ.update(saved)

    n = len(jax.devices())
    mesh = distributed.global_mesh({"dp": n})
    assert mesh.shape["dp"] == n

    info = distributed.process_info()
    assert info["process_count"] == 1
    assert info["global_devices"] == n


def test_channel_sharded_fused_cascade_bitexact():
    # The headline chain (mix + DF1 + 3-stage HBF cascade) under channel
    # (dp) sharding: per-channel math is independent, so the sharded
    # result must be BIT-identical to the unsharded run across blocks —
    # including the f32 FIR outputs (same per-channel op order).
    from idsp_tpu.pipelines import ddc_chain

    n_dev = len(jax.devices())
    mesh = make_mesh({"dp": n_dev})
    c, t = 4 * n_dev, 256
    rng = np.random.default_rng(44)
    ba = ddc_chain.lowpass_coefficients()
    steps = jnp.asarray(
        rng.integers(1 << 24, 1 << 30, size=(c,), dtype=np.int64)
        .astype(np.int32)
    )
    run = ddc_chain.channel_sharded(mesh, "dp", ba_q=ba)
    st_ref = st_sh = ddc_chain.init(c)
    for _ in range(2):
        x = jnp.asarray(
            rng.integers(-(2**27), 2**27, size=(t,), dtype=np.int64)
            .astype(np.int32)
        )
        st_ref, y_ref = ddc_chain.block(st_ref, x, steps, ba_q=ba)
        st_sh, y_sh = run(st_sh, x, steps)
        for a, b in zip(y_sh, y_ref):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
