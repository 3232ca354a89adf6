"""Where each operation runs: the one place that looks at the platform.

Per-lane recurrences run in the sequential lane-bank kernel
(`filters.seq_bank`) on the GPU, and as `lax.scan` everywhere else.
Both give the same result (bit-exact on integer paths), so the choice
is about speed only and is made here, at trace time, from the backend.
"""

from __future__ import annotations

import jax


def lane_kernels() -> bool:
    """True where the lane-bank kernel runs (the GPU)."""
    return jax.default_backend() == "gpu"


def lane_scan(step, carry, xs, *, dec: int = 1, out_dtype=None):
    """``lax.scan(step, carry, xs)`` with the outputs kept 1 in ``dec``
    and cast to ``out_dtype`` — in the lane-bank kernel on the GPU.

    ``step`` must be elementwise over the lane axes ``xs.shape[1:]``
    (see `filters.seq_bank.seq_bank`).
    """
    if lane_kernels():
        from .filters.seq_bank import seq_bank

        return seq_bank(step, carry, xs, dec=dec, out_dtype=out_dtype)
    return scan(step, carry, xs, dec=dec, out_dtype=out_dtype)


def scan(step, carry, xs, *, dec: int = 1, out_dtype=None):
    """`lane_scan` as plain `lax.scan` on every platform: the reference
    the lane-bank kernel is checked against."""
    carry, ys = jax.lax.scan(step, carry, xs, unroll=8)
    t = xs.shape[0]

    def keep(y):
        if dec > 1:
            # reshape + unit slice: no strided gather
            y = y.reshape((t // dec, dec) + y.shape[1:])[:, 0]
        return y if out_dtype is None else y.astype(out_dtype)

    return carry, jax.tree.map(keep, ys)


__all__ = ["lane_kernels", "lane_scan", "scan"]
