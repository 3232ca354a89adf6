"""idsp_tpu — a software-radio / embedded-DSP framework (JAX/XLA/Pallas).

A from-scratch framework with the capabilities of the `idsp`
reference crate (quartiq/idsp): tuned fixed-point and float DSP blocks —
NCO/DDS (`cossin`), `atan2`, CORDIC, biquad IIR in several state
architectures, half-band FIR cascades, CIC, lock-in, PLL/RPLL — plus the
coefficient-design toolbox and a streaming/block processing model.

Design (not a port):

* Per-sample recurrences of the reference become `lax.scan` steps with
  explicit (config, state) pytrees; config is shared across vmapped lanes
  (the reference's `SplitProcess` config/state split, dsp-process/src/
  process.rs:69-92, maps to pytree-of-arrays + scan carry).
* Block/batch paths are vectorized jnp ops (closed-form phase ramps,
  polyphase convs, associative scans for linear recurrences), with one
  GPU kernel (`filters.seq_bank`) for the per-lane integer recurrences.
* Scale-out (absent in the single-core reference) is mesh sharding over
  channels and time blocks with XLA collectives; see `idsp_tpu.parallel`.

Integer semantics: the reference is fixed-point (i32 storage, i64
accumulators, truncating arithmetic shifts).  We enable x64 so i64
intermediates are available; hot integer kernels keep values in i32 where
the reference does.
"""

import jax

# Fixed-point paths need i64 accumulators (the reference's `Q<i32, i64, F>`
# wide multiplies, dsp-fixedpoint/src/lib.rs:302-327).
jax.config.update("jax_enable_x64", True)

from . import fxp, luts, masked, testing  # noqa: E402
from .ops import (  # noqa: E402
    accu,
    complex as complex_ops,
    cordic,
    dither,
    dsm,
    fastlo,
    sweptsine,
    trig,
    unwrap,
)
from .ops.trig import atan2, cossin  # noqa: E402

__all__ = [
    "accu",
    "atan2",
    "complex_ops",
    "cordic",
    "cossin",
    "dither",
    "dsm",
    "fastlo",
    "fxp",
    "luts",
    "masked",
    "sweptsine",
    "testing",
    "trig",
    "unwrap",
]

__version__ = "0.1.0"
