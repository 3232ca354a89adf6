"""The sequential lane-bank harness (interpret mode), the dispatch module
that picks it, and the device helpers of the measurement scripts."""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from idsp_tpu import device, dispatch
from idsp_tpu.filters import biquad, lowpass, pll
from idsp_tpu.filters import seq_bank as sb
from idsp_tpu.pipelines import ddc_chain

BA = np.asarray(ddc_chain.lowpass_coefficients(0.1), np.int32)
STEP = functools.partial(biquad.df1_step_q, BA, 29)


def _rand(rng, shape, lim=2**27):
    return jnp.asarray(
        rng.integers(-lim, lim, size=shape, dtype=np.int64).astype(np.int32)
    )


def _ref(step, carry, xs, dec=1, out_dtype=None):
    return dispatch.scan(step, carry, xs, dec=dec, out_dtype=out_dtype)


def _assert_tree_equal(a, b):
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.shape == y.shape and x.dtype == y.dtype
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("dec", [1, 16])
@pytest.mark.parametrize("c", [1, 3, 127, 130])
def test_harness_odd_widths_carry_across_blocks(c, dec):
    rng = np.random.default_rng(c * 100 + dec)
    st_k = st_r = biquad.Df1State(x=_rand(rng, (c, 2)), y=_rand(rng, (c, 2)))
    for _ in range(2):
        xs = _rand(rng, (80, c))
        st_k, y_k = sb.seq_bank(STEP, st_k, xs, dec=dec, interpret=True)
        st_r, y_r = _ref(STEP, st_r, xs, dec=dec)
        _assert_tree_equal((st_k, y_k), (st_r, y_r))
    assert y_k.shape == (80 // dec, c)


@pytest.mark.parametrize("chunk,dec", [(16, 1), (48, 16), (32, 16), (7, 1)])
def test_harness_chunked_loop(chunk, dec):
    # the GPU loop shape: `chunk` steps per iteration with the next
    # chunk's rows prefetched, and a tail (80 % chunk rows) after it
    rng = np.random.default_rng(chunk)
    c = 5
    st = biquad.Df1State(x=_rand(rng, (c, 2)), y=_rand(rng, (c, 2)))
    xs = _rand(rng, (80, c))
    leaves, treedef = jax.tree.flatten(st)
    st_k, y_k = sb._seq_bank(STEP, treedef, tuple(leaves), xs, dec=dec,
                             out_dtype=None, interpret=True, chunk=chunk)
    _assert_tree_equal((st_k, y_k), _ref(STEP, st, xs, dec=dec))


def test_harness_multi_axis_lanes():
    rng = np.random.default_rng(1)
    k = lowpass.gains2(0.02)
    step = functools.partial(lowpass.step, k)
    st = lowpass.LowpassState(p=jnp.asarray(
        rng.integers(-(2**40), 2**40, size=(3, 5, 2), dtype=np.int64)))
    xs = _rand(rng, (24, 3, 5))
    _assert_tree_equal(sb.seq_bank(step, st, xs, dec=4, interpret=True),
                       _ref(step, st, xs, dec=4))


def test_harness_bool_leaf_and_tuple_outputs():
    def step(carry, x):
        acc, seen = carry
        seen = seen | (x < 0)
        acc = jnp.where(seen, acc + x, acc - x)
        return (acc, seen), (acc, seen.astype(jnp.int32))

    rng = np.random.default_rng(2)
    carry = (jnp.zeros((7,), jnp.int32), jnp.zeros((7,), bool))
    xs = _rand(rng, (32, 7), 100)
    _assert_tree_equal(sb.seq_bank(step, carry, xs, interpret=True),
                       _ref(step, carry, xs))


def test_harness_out_dtype_cast():
    rng = np.random.default_rng(3)
    st = biquad.df1_init((9,), jnp.int32)
    xs = _rand(rng, (40, 9))
    got = sb.seq_bank(STEP, st, xs, out_dtype=jnp.float32, interpret=True)
    _assert_tree_equal(got, _ref(STEP, st, xs, out_dtype=jnp.float32))
    assert got[1].dtype == jnp.float32


def test_harness_runtime_coefficients_ride_in_carry():
    rng = np.random.default_rng(4)
    c = 6
    ba = jnp.asarray(np.stack([ddc_chain.lowpass_coefficients(fc)
                               for fc in np.linspace(0.02, 0.3, c)]),
                     jnp.int32)  # (c, 5)

    def step(carry, x):
        b, s = carry
        s, y = biquad.df1_step_q(b, 29, s, x)
        return (b, s), y

    carry = (ba, biquad.df1_init((c,), jnp.int32))
    xs = _rand(rng, (32, c))
    _assert_tree_equal(sb.seq_bank(step, carry, xs, interpret=True),
                       _ref(step, carry, xs))


def test_harness_rejects_non_elementwise_step():
    def step(s, x):
        return s, jnp.sum(s) + x  # a reduction over the per-lane axis

    with pytest.raises(NotImplementedError, match="reduce_sum"):
        sb.seq_bank(step, jnp.zeros((4, 3), jnp.int32),
                    jnp.zeros((8, 4), jnp.int32), interpret=True)


def test_harness_rejects_carry_change():
    def step(s, x):
        return s.astype(jnp.int64), x

    with pytest.raises(TypeError, match="structure"):
        sb.seq_bank(step, jnp.zeros((4,), jnp.int32),
                    jnp.zeros((8, 4), jnp.int32), interpret=True)


def _pallas_eqn(jaxpr):
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "pallas_call":
            return eqn
        inner = eqn.params.get("jaxpr")
        if inner is not None:
            found = _pallas_eqn(getattr(inner, "jaxpr", inner))
            if found is not None:
                return found
    return None


@pytest.mark.parametrize(
    "lanes,blocks",
    [(1, 1), (32, 1), (33, 2), (130, 5), (2048, 64), (8449, 265)],
)
def test_lane_blocks_one_warp_each(lanes, blocks):
    # traced for the GPU (no interpret mode): one 32-lane, one-warp
    # block per grid step, the last block masked
    st = biquad.df1_init((lanes,), jnp.int32)
    xs = jnp.zeros((64, lanes), jnp.int32)
    eqn = _pallas_eqn(jax.make_jaxpr(
        lambda s, x: sb.seq_bank(STEP, s, x))(st, xs).jaxpr)
    assert eqn.params["backend"] == "triton"
    assert eqn.params["grid_mapping"].grid == (blocks,)
    params = eqn.params["compiler_params"]["triton"]
    assert (params.num_warps, params.num_stages) == (1, 1)


@pytest.mark.parametrize("dec", [1, 3, 16, 20])
def test_chunk_steps(dec):
    chunk = sb.chunk_steps(dec)
    assert chunk % dec == 0 and 32 <= chunk < 32 + dec


def test_dispatch_picks_scan_off_gpu():
    assert jax.default_backend() == "cpu"
    assert not dispatch.lane_kernels()


@pytest.mark.parametrize("out_dtype", [None, jnp.float32])
@pytest.mark.parametrize("dec", [1, 4])
def test_lane_scan_is_scan_on_cpu(dec, out_dtype):
    rng = np.random.default_rng(dec)
    st = biquad.df1_init((5,), jnp.int32)
    xs = _rand(rng, (32, 5))
    st_s, ys = jax.lax.scan(STEP, st, xs)
    ys = ys[::dec] if out_dtype is None else ys[::dec].astype(out_dtype)
    _assert_tree_equal(dispatch.lane_scan(STEP, st, xs, dec=dec,
                                          out_dtype=out_dtype), (st_s, ys))


def _pipeline_cases():
    from idsp_tpu import compat
    from idsp_tpu.ops.trig import cossin
    from idsp_tpu.pipelines import ddc_bank, fm_disc

    rng = np.random.default_rng(7)
    c, t = 3, 64
    x = _rand(rng, (t,))
    steps = _rand(rng, (c,), 2**30)
    pll_ba = tuple(int(v) for v in pll.coefficients_from_bandwidth(2e-2))
    gains = tuple(int(v) for v in lowpass.gains2(0.01))
    ba = ddc_chain.lowpass_coefficients()
    re, im = cossin(_rand(rng, (t, c), 2**31))
    sos_rows = np.array([[0.1, 0.2, 0.1, 1.0, -0.5, 0.1],
                         [0.3, 0.0, -0.3, 1.0, -0.2, 0.05]])
    clamp_rows = np.concatenate(
        [sos_rows, [[0, -1e8, 1e8], [5, -1e7, 1e7]]], axis=1)
    xy = _rand(rng, (t, c))
    fm_ba = jnp.asarray(fm_disc.deemphasis_coefficients(0.02))
    return {
        "ddc_bank_lowpass_exact": lambda: ddc_bank.ddc_bank_block(
            ddc_bank.init(c), x, steps, gains, pll_ba, lo_mode="exact"),
        "ddc_bank_lowpass_fast": lambda: ddc_bank.ddc_bank_block(
            ddc_bank.init(c), x, steps, gains, pll_ba, lo_mode="fast"),
        "ddc_bank_biquad_exact": lambda: ddc_bank.ddc_bank_block_biquad(
            ddc_bank.init_biquad(c), x, steps, ba, pll_ba, lo_mode="exact"),
        "ddc_bank_biquad_fast": lambda: ddc_bank.ddc_bank_block_biquad(
            ddc_bank.init_biquad(c), x, steps, ba, pll_ba, lo_mode="fast"),
        "fm_receiver": lambda: fm_disc.fm_receiver(
            fm_disc.init_state((c,)), re, im, jnp.int32(12345), fm_ba),
        "compat_sos": lambda: compat.sos(sos_rows, xy),
        "compat_sos_clamp_wide": lambda: compat.sos_clamp_wide(
            clamp_rows, xy),
        "ddc_chain": lambda: ddc_chain.block(ddc_chain.init(c), x, steps, ba),
    }


@pytest.mark.parametrize("name", sorted(_pipeline_cases()))
def test_pipelines_route_through_the_kernel(name, monkeypatch):
    """With the GPU route forced on (kernel in interpret mode), every
    pipeline gives exactly what its scan path gives."""
    case = _pipeline_cases()[name]
    jax.clear_caches()
    want = case()
    calls = []
    orig = sb.seq_bank

    def kernel(*a, **kw):
        calls.append(1)
        return orig(*a, **{**kw, "interpret": True})

    monkeypatch.setattr(dispatch, "lane_kernels", lambda: True)
    monkeypatch.setattr(sb, "seq_bank", kernel)
    jax.clear_caches()
    got = case()
    jax.clear_caches()
    assert calls, "the kernel route was not taken"
    _assert_tree_equal(got, want)


def test_compile_cache_dir_from_env(monkeypatch):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/some/cache")
    updates = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: updates.append(a))
    assert device.compile_cache_dir() == "/some/cache"
    assert device.enable_compile_cache() == "/some/cache"
    assert updates == []  # JAX reads the variable itself


def test_compile_cache_dir_default(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    updates = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: updates.append(a))
    path = device.enable_compile_cache()
    assert path == os.path.join(str(device.REPO_ROOT), ".jax_cache")
    assert os.path.isfile(os.path.join(device.REPO_ROOT, "idsp_tpu",
                                       "device.py"))
    assert updates == [("jax_compilation_cache_dir", path)]


def test_require_gpu_refuses_cpu():
    assert device.describe()["platform"] == "cpu"
    with pytest.raises(SystemExit, match="no GPU"):
        device.require_gpu()


def test_cache_counter_counts_events():
    counter = device.CacheCounter()
    jax.monitoring.record_event("/jax/compilation_cache/cache_hits")
    jax.monitoring.record_event("/jax/compilation_cache/cache_misses")
    jax.monitoring.record_event("/jax/compilation_cache/cache_misses")
    assert (counter.hits, counter.misses) == (1, 2)
    jax.jit(lambda v: v * 3 + 1)(jnp.arange(5))  # a new program
    assert counter.compiles >= 1 and counter.compile_s > 0


@pytest.mark.gpu
def test_compiled_kernel_matches_scan(gpu_device):
    rng = np.random.default_rng(9)
    st = biquad.Df1State(x=_rand(rng, (2048, 2)), y=_rand(rng, (2048, 2)))
    xs = _rand(rng, (4096, 2048))
    for dec in (1, 16):
        _assert_tree_equal(sb.seq_bank(STEP, st, xs, dec=dec),
                           _ref(STEP, st, xs, dec=dec))
