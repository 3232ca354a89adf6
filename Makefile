# CI entry points, mirroring the reference's .github/workflows/ci.yml
# (style -> lint, compile+test matrix -> test/dryrun, examples ->
# pipelines tests, bench build -> bench-smoke).

PY ?= python

.PHONY: ci lint test test-full test-gpu golden dryrun bench-smoke

ci: lint test-full dryrun bench-smoke

lint:
	$(PY) -m compileall -q idsp_tpu benches scripts tests bench.py chip_smoke.py __graft_entry__.py
	$(PY) scripts/lint.py

# quick lane: skips the `slow`-marked long tail (see tests/conftest.py)
test:
	JAX_PLATFORMS=cpu $(PY) -m pytest tests/ -q -m "not slow"

test-full:
	JAX_PLATFORMS=cpu $(PY) -m pytest tests/ -q

# on the card: the compiled-kernel tests, then the end-to-end smoke
test-gpu:
	JAX_PLATFORMS=cuda $(PY) -m pytest tests/ -q -m gpu
	$(PY) chip_smoke.py

golden:
	rm -f native/libgolden.so
	$(PY) -m pytest tests/test_golden.py -q

dryrun:
	JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 $(PY) __graft_entry__.py

# rehearsal of the scaling harness on virtual CPU devices (CPU times)
bench-smoke:
	JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=2 $(PY) benches/scaling.py --devices 1,2 --channels-per-device 16 --time 256 --iters 1
