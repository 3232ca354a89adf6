"""Profiling and throughput measurement.

Replaces the reference's DWT-cycle embedded harness
(tests/embedded/src/lib.rs:17-42) with wall-clock samples/s counters
around work that ends in `jax.block_until_ready` (JAX returns before
the device finishes), and `jax.profiler` trace capture.
"""

from __future__ import annotations

import contextlib
import statistics
import time
from dataclasses import dataclass

import jax


@dataclass(frozen=True)
class BenchResult:
    """Throughput of one benchmark config."""

    name: str
    samples: int
    seconds: float

    @property
    def samples_per_s(self) -> float:
        return self.samples / self.seconds

    @property
    def ns_per_sample(self) -> float:
        return self.seconds / self.samples * 1e9

    def row(self) -> str:
        return (
            f"{self.name:36s} {self.samples_per_s / 1e6:12.1f} MS/s"
            f" {self.ns_per_sample:10.3f} ns/sample"
        )


def bench(name: str, fn, *args, samples: int, iters: int = 5, warmup: int = 1):
    """Time ``fn(*args)`` (compiled path): warm up, then run ``iters``
    back-to-back and block once.  ``samples`` is per-call item count."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    dt = max(time.perf_counter() - t0, 1e-9)
    return BenchResult(name=name, samples=samples * iters, seconds=dt)


def bench_stateful(name: str, fn, state, *args, samples: int, iters: int = 5):
    """Like `bench` but threads a state carry so iterations chain (no
    artificial parallelism between timing iterations)."""
    jax.block_until_ready(fn(state, *args))
    t0 = time.perf_counter()
    st = state
    for _ in range(iters):
        res = fn(st, *args)
        st = res[0]
    jax.block_until_ready(res)
    dt = max(time.perf_counter() - t0, 1e-9)
    return BenchResult(name=name, samples=samples * iters, seconds=dt)


def measure_rate(step, state, *args, iters=None,
                 trials: int = 6, stateful: bool = True):
    """Seconds per dispatch: the MEDIAN of iteration differences.

    Times ``k1`` and ``k2`` chained dispatches (state threaded so the
    device cannot overlap iterations) and forms
    ``(t(k2) - t(k1)) / (k2 - k1)`` per trial, so the fixed cost of the
    final `block_until_ready` cancels.  The default ``iters=None``
    scales the gap to about 100 ms of estimated device time.

    ``step(state, *args)`` must return the new state first (or the
    value itself when ``stateful=False``).  Returns
    ``(seconds_per_dispatch, diffs)`` with every per-trial difference
    for spread reporting; seconds_per_dispatch is their median.
    Non-positive differences are kept (censoring them would bias the
    median upward); raises only if the median itself is non-positive.
    """
    if iters is not None:
        k1, k2 = iters
        if k1 < 1:
            raise ValueError(f"need k1 >= 1 dispatch in the short leg, got {iters}")
        if k2 <= k1:
            raise ValueError(f"iters gap must be positive, got {iters}")
    jax.block_until_ready(step(state, *args))

    def timed(k):
        t0 = time.perf_counter()
        st = state
        for _ in range(k):
            res = step(st, *args)
            if stateful:
                st = res[0]
        jax.block_until_ready(res)
        return time.perf_counter() - t0

    if iters is None:
        est = max((timed(12) - timed(2)) / 10.0, 1e-6)
        k1 = 10
        k2 = k1 + min(max(40, int(0.1 / est) + 1), 2000)
    diffs = []
    for _ in range(trials):
        d1 = timed(k1)
        d2 = timed(k2)
        diffs.append((d2 - d1) / (k2 - k1))
    med = statistics.median(diffs)
    if med <= 0:
        raise RuntimeError(
            "non-positive median iteration difference (timing noise"
            f" exceeds the signal — raise the gap; k1={k1} k2={k2})"
        )
    return med, diffs


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a jax.profiler trace around a block."""
    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()
