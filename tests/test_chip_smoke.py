"""chip_smoke.py and bench.py: their phases at tiny sizes on the CPU
(lane-bank kernels in interpret mode), and their refusal to measure
anything without a GPU."""

import runpy
import sys

import jax
import pytest

import chip_smoke


def _all_pass(results):
    assert results and all(ok for _, ok in results), results


def test_phase_headline_tiny():
    results = []
    chip_smoke.phase_headline(results, c=2, t=1024, blocks=2,
                              interpret=True, memory=True)
    _all_pass(results)


def test_phase_ddc_bank_tiny():
    results = []
    chip_smoke.phase_ddc_bank(results, c=8, t=256, d=16)
    _all_pass(results)
    assert len(results) == 4  # {biquad, lowpass2} x {exact, fast} LO


def test_phase_fm_tiny():
    results = []
    chip_smoke.phase_fm(results, c=8, t=256)
    _all_pass(results)


def test_phase_rate_tiny():
    results = []
    chip_smoke.phase_rate(results, c=4, t=16384)
    _all_pass(results)


def test_phase_channelizer_tiny():
    results = []
    chip_smoke.phase_channelizer(results, m=64, n=64)
    _all_pass(results)


@pytest.mark.parametrize(
    "index", range(len(chip_smoke.kernel_cases(4, 16, True)))
)
def test_kernel_case_tiny(index):
    name, kern, ref, ulps = chip_smoke.kernel_cases(5, 48, True)[index]
    got, want = kern(), ref()
    if ulps is None:
        assert chip_smoke._equal(got, want), name
    else:
        assert chip_smoke._close(got, want, ulps), name


def test_phase_four_on_virtual_devices():
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 (virtual) devices")
    results = []
    chip_smoke.phase_four(results, c_per=2, t=256, t_bank=256, t_sp=64,
                          width=4)
    _all_pass(results)


@pytest.mark.parametrize("argv", [[], ["--four"]])
def test_chip_smoke_refuses_cpu(argv, capsys):
    with pytest.raises(SystemExit) as e:
        chip_smoke.main(argv)
    assert e.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


def test_bench_refuses_cpu(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["bench.py"])
    with pytest.raises(SystemExit) as e:
        runpy.run_path("bench.py", run_name="__main__")
    assert e.value.code not in (0, None)
    assert "metric" not in capsys.readouterr().out
