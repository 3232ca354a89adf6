"""Test configuration: run on a virtual 8-device CPU mesh.

Multi-device sharding paths are validated on a CPU mesh
(xla_force_host_platform_device_count).  Tests that need the card carry
the `gpu` marker and take the `gpu_device` fixture, which skips them
here; `chip_smoke.py` and `bench.py` run the GPU paths on the card.
"""

import os

# Must be set before jax initializes its backends.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_enable_x64", True)


@pytest.fixture
def gpu_device():
    """The first GPU; skips the test where there is none (decided here,
    at run time, never while the module is imported)."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (JAX runs on {dev.platform})")
    return dev


# --- quick/full test lanes ----------------------------------------------------
# The measured long tail (pytest --durations, 2026-08-19: the suite is
# ~11 min wall on the 8-device CPU mesh).  Tests listed here get the
# `slow` marker at collection; `make test` runs `-m "not slow"` (~3-4
# min), `make ci` / `make test-full` run everything.  Names are
# `module::test` with parametrize suffixes stripped.
_SLOW_TESTS = {
    "test_hbf.py::test_hbf_time_major_matches_time_last",
    "test_hbf.py::test_streaming_equals_one_shot",
    "test_hbf.py::test_dec_response_length",
    "test_hbf.py::test_int_impulse_and_spectrum",
    "test_hbf.py::test_channels_batch",
    "test_hbf.py::test_taps_98_spectrum",
    "test_biquad_pallas.py::test_pallas_q64_bank_bitexact",
    "test_biquad_pallas.py::test_pallas_sos_cascade_bitexact",
    "test_fuzz.py::test_cossin_matches_golden",
    "test_fuzz.py::test_atan2_matches_golden",
    "test_fuzz.py::test_q_mul_i64_matches_bigint",
    "test_fuzz.py::test_df1_q_matches_golden",
    "test_chain_snr.py::test_ddc_chain_snr",
    "test_examples.py::test_example_passes",
    "test_stream.py::test_stage_scan_and_block_agree",
    "test_golden.py::test_biquad_fuzz_many_coefficient_sets",
    "test_golden.py::test_biquad_q64_bitexact_vs_golden",
    "test_rate_ddc_bank.py::test_rate_conversion_stopband_kill",
    "test_rate_ddc_bank.py::test_ddc_bank_fast_lo_non_pow2_block",
    "test_rate_ddc_bank.py::test_ddc_bank_biquad_fast_fused_tracks_exact",
    "test_rate_ddc_bank.py::test_sweptsine_end_to_end_ddc_channel_response",
    "test_trig.py::test_shapes_preserved",
    "test_parallel.py::test_channel_sharded_fused_cascade_bitexact",
    "test_parallel.py::test_channel_sharded_fm_bank",
    "test_loops.py::test_cic_time_major_axis_bitexact",
    "test_loops.py::test_rpll_noisy_scenario",
    "test_ops.py::test_triangular_range_and_mean",
    "test_fastlo.py::test_fastlo_mix_closer_to_ideal_than_exact",
    "test_biquad.py::test_df1_block_float_matches_scan",
    "test_masked.py::test_hold_streaming_equals_one_shot",
    "test_masked.py::test_downsample_interpolate_framing",
    "test_rate_ddc_bank.py::test_rate_conversion_round_trip_tone",
    "test_rate_ddc_bank.py::test_cic_hbf_composite_decimator",
    "test_chain_snr.py::test_fastlo_fused_chain_snr",
    "test_pipeline_parallel.py::test_pipelined_sos_sharded_deep_pipe_one_block_per_device",
    "test_rate_ddc_bank.py::test_ddc_bank_acquires_offsets",
}


def pytest_collection_modifyitems(config, items):
    for item in items:
        key = f"{item.path.name}::{item.name.split('[')[0]}"
        if key in _SLOW_TESTS:
            item.add_marker(pytest.mark.slow)
