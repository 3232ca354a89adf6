"""Host streaming runtime: native ring buffer + overlapped block executor.

The reference crate is the DSP core of streaming instruments
(README.md:12): samples arrive from an acquisition DMA in fixed blocks
and every filter carries its state across block boundaries
(src/hbf.rs:93-101, dsp-process/src/process.rs:69-92).  This module is
the framework's host-side equivalent of that acquisition runtime:

* `RingBuffer` — a native single-producer/single-consumer lock-free
  byte ring (native/stream_rt.c, C11 atomics).  ctypes calls release
  the GIL, so a Python producer thread and the consumer overlap for
  real; the producer slot is equally callable from a C acquisition
  driver.
* `StreamExecutor` — pops fixed-size blocks, feeds them through any
  jitted ``block_fn(state, xs) -> (state, ys)`` (every filter in this
  package has that signature), carries the state pytree across blocks,
  and keeps a bounded number of dispatches in flight so host ingest,
  host->device transfer, and device compute overlap (JAX dispatch is
  asynchronous).

Block-boundary semantics are exactly the package-wide carried-state
contract, so a streamed run is bit-identical to a one-shot run over the
concatenated input — equivalence-tested in tests/test_runtime.py.
"""

from __future__ import annotations

import ctypes
import threading
from collections import deque
from functools import lru_cache

import jax
import numpy as np


@lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from ._native import load_native

    lib = load_native(
        "stream_rt.c", "libstreamrt.so",
        ("-O2", "-shared", "-fPIC"), ("-lpthread",),
    )
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.rb_create.argtypes = [ctypes.c_uint64]
    lib.rb_create.restype = ctypes.c_void_p
    lib.rb_destroy.argtypes = [ctypes.c_void_p]
    lib.rb_capacity.argtypes = [ctypes.c_void_p]
    lib.rb_capacity.restype = ctypes.c_uint64
    lib.rb_readable.argtypes = [ctypes.c_void_p]
    lib.rb_readable.restype = ctypes.c_uint64
    lib.rb_writable.argtypes = [ctypes.c_void_p]
    lib.rb_writable.restype = ctypes.c_uint64
    lib.rb_close.argtypes = [ctypes.c_void_p]
    lib.rb_closed.argtypes = [ctypes.c_void_p]
    lib.rb_closed.restype = ctypes.c_int
    lib.rb_write.argtypes = [ctypes.c_void_p, u8p, ctypes.c_uint64]
    lib.rb_write.restype = ctypes.c_uint64
    lib.rb_read.argtypes = [ctypes.c_void_p, u8p, ctypes.c_uint64]
    lib.rb_read.restype = ctypes.c_uint64
    lib.rb_write_all.argtypes = [
        ctypes.c_void_p, u8p, ctypes.c_uint64, ctypes.c_int64,
    ]
    lib.rb_write_all.restype = ctypes.c_int
    lib.rb_read_all.argtypes = [
        ctypes.c_void_p, u8p, ctypes.c_uint64, ctypes.c_int64,
    ]
    lib.rb_read_all.restype = ctypes.c_int
    return lib


def _u8ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _fence(tree):
    """Block until the computation feeding ``tree`` has finished."""
    jax.block_until_ready(tree)


class RingBuffer:
    """SPSC byte ring over the native library; numpy in/out.

    Writes and reads are all-or-nothing (never partial), so
    fixed-size frame boundaries survive wrap-around.
    """

    def __init__(self, capacity_bytes: int):
        self._lib = _lib()
        self._rb = self._lib.rb_create(int(capacity_bytes))
        if not self._rb:
            raise MemoryError("rb_create failed")

    @property
    def capacity(self) -> int:
        return int(self._lib.rb_capacity(self._rb))

    @property
    def readable(self) -> int:
        return int(self._lib.rb_readable(self._rb))

    @property
    def writable(self) -> int:
        return int(self._lib.rb_writable(self._rb))

    def close(self):
        """Producer-side EOF: readers drain what remains, then stop."""
        self._lib.rb_close(self._rb)

    @property
    def closed(self) -> bool:
        return bool(self._lib.rb_closed(self._rb))

    def try_write(self, arr: np.ndarray) -> bool:
        arr = np.ascontiguousarray(arr)
        if arr.nbytes == 0:
            return True  # nothing to transfer is success, not failure
        return bool(self._lib.rb_write(self._rb, _u8ptr(arr), arr.nbytes))

    def write(self, arr: np.ndarray, timeout: float | None = None) -> bool:
        """Blocking write of the whole array (GIL released in C)."""
        arr = np.ascontiguousarray(arr)
        if arr.nbytes == 0:
            return True
        to = -1 if timeout is None else int(timeout * 1e6)
        return bool(
            self._lib.rb_write_all(self._rb, _u8ptr(arr), arr.nbytes, to)
        )

    def read(self, n_items: int, dtype, timeout: float | None = None):
        """Blocking read of exactly n_items of dtype; None on EOF/timeout."""
        out = np.empty(n_items, dtype=dtype)
        if out.nbytes == 0:
            return out
        to = -1 if timeout is None else int(timeout * 1e6)
        ok = self._lib.rb_read_all(self._rb, _u8ptr(out), out.nbytes, to)
        return out if ok else None

    def __del__(self):
        rb = getattr(self, "_rb", None)
        if rb:
            self._lib.rb_destroy(rb)
            self._rb = None


class StreamExecutor:
    """Pump ring-buffer blocks through a jitted stage, carrying state.

    Args:
      block_fn: jitted ``(state, xs) -> (state, ys)`` (the package-wide
        stage signature; ys may be any pytree).
      state: initial state pytree.
      block_shape: shape of one input block (e.g. ``(t, c)``).
      dtype: input sample dtype.
      ring_blocks: ring capacity in blocks.
      max_inflight: dispatched-but-unsynced block budget — bounds device
        queue depth and host output memory while keeping transfer and
        compute overlapped.
      timeout: max seconds to wait for a block before treating the
        stream as stalled (raises TimeoutError); EOF (producer closed
        and drained) ends the run cleanly.
      checkpoint_path / checkpoint_every: periodically persist the
        carried state pytree with `idsp_tpu.checkpoint.save` (every N
        blocks and at EOF).  Resume by restoring the state and skipping
        the already-consumed samples upstream — block-boundary carries
        are exactly the checkpoint payload (SURVEY.md §5).
    """

    def __init__(self, block_fn, state, block_shape, dtype=np.int32, *,
                 ring_blocks: int = 8, max_inflight: int = 2,
                 timeout: float = 30.0, checkpoint_path: str | None = None,
                 checkpoint_every: int = 64):
        self.block_fn = block_fn
        self.state = state
        self.block_shape = tuple(block_shape)
        self.dtype = np.dtype(dtype)
        self.timeout = float(timeout)
        self.max_inflight = int(max_inflight)
        self.blocks_processed = 0
        self.checkpoint_path = checkpoint_path
        self.checkpoint_every = int(checkpoint_every)
        n_items = int(np.prod(self.block_shape))
        self.ring = RingBuffer(ring_blocks * n_items * self.dtype.itemsize)
        self._n_items = n_items

    def _checkpoint(self):
        if self.checkpoint_path is None:
            return
        from . import checkpoint

        _fence(self.state)
        checkpoint.save(self.checkpoint_path, self.state)

    def _drain_oldest(self, pending: deque, out_ring):
        """Sync the oldest in-flight output; forward it downstream."""
        y = pending.popleft()
        _fence(y)
        if out_ring is not None:
            for leaf in jax.tree_util.tree_leaves(y):
                if not out_ring.write(np.asarray(leaf),
                                      timeout=self.timeout):
                    raise TimeoutError("output ring stalled (consumer?)")

    def run(self, n_blocks: int | None = None, collect: bool = True,
            out_ring: RingBuffer | None = None):
        """Consume up to n_blocks (or until EOF), return (state, ys).

        ``ys`` is the list of per-block outputs when ``collect``, else
        None (monitor use: keep only the carried state).  With
        ``out_ring``, each synced block's output leaves are written to
        that ring in pytree order (duplex streaming: a downstream
        consumer thread drains results while upstream blocks compute);
        the ring is closed when the run ends.
        """
        outputs: list = []
        pending: deque = deque()
        k = 0
        while n_blocks is None or k < n_blocks:
            buf = self.ring.read(self._n_items, self.dtype,
                                 timeout=self.timeout)
            if buf is None:
                if self.ring.closed:
                    # EOF — but a partial tail block would be silent
                    # data loss for an acquisition stream: refuse.
                    left = self.ring.readable
                    if left:
                        raise ValueError(
                            f"stream ended with a partial block: {left}"
                            " bytes remain in the ring (pad the final"
                            " block upstream or size the stream to the"
                            " block length)"
                        )
                    break
                raise TimeoutError(
                    f"no block after {self.timeout}s (ring stalled)"
                )
            x = buf.reshape(self.block_shape)
            self.state, y = self.block_fn(self.state, x)
            self.blocks_processed += 1
            k += 1
            if collect:
                outputs.append(y)
            pending.append(y)
            # bound in-flight dispatches: sync the oldest once the
            # window is full (dispatch stays async inside the window)
            while len(pending) > self.max_inflight:
                self._drain_oldest(pending, out_ring)
            if (self.checkpoint_path is not None
                    and self.blocks_processed % self.checkpoint_every == 0):
                self._checkpoint()
        while pending:
            self._drain_oldest(pending, out_ring)
        if out_ring is not None:
            out_ring.close()
        _fence(self.state)
        self._checkpoint()
        return self.state, (outputs if collect else None)


def producer_thread(ring: RingBuffer, samples: np.ndarray, *,
                    chunk_items: int = 1000, close: bool = True,
                    timeout: float = 30.0) -> threading.Thread:
    """Feed a sample array into the ring from a daemon thread in
    irregular chunks (exercises wrap-around; stands in for an
    acquisition driver).  Returns the started thread."""
    samples = np.ascontiguousarray(samples)
    flat = samples.reshape(-1)

    def work():
        i = 0
        n = flat.size
        step = max(1, int(chunk_items))
        while i < n:
            j = min(n, i + step)
            if not ring.write(flat[i:j], timeout=timeout):
                return
            i = j
        if close:
            ring.close()

    th = threading.Thread(target=work, daemon=True)
    th.start()
    return th
