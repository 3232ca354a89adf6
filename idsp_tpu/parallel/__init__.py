"""Scale-out: mesh sharding over channels and time blocks.

The reference is single-core (SURVEY.md §5: no NCCL/MPI analog); this
package is the new, first-class scale-out dimension:

* **Channel parallelism** (`Lanes` analog): shard independent DSP
  channels over a mesh axis — pure data parallelism, no communication.
* **Time/sequence parallelism**: shard long sample streams over a mesh
  axis; per-sample recurrences are recast per stage:
  - FIR/discriminator history  -> neighbor halo exchange (`ppermute`)
  - linear IIR (biquad, CIC)   -> block-local scan + cross-device
    affine-prefix fixup (exact for floats up to reassociation)
  - nonlinear (clamp, dither)  -> carry ring-pipelined across devices
* **Pipeline parallelism**: cascade stages placed on successive devices
  (HBF cascades).

All collectives are XLA (`ppermute`, `psum`, `all_gather`), which
the GPU backend hands to NCCL.
"""

from . import distributed
from .mesh import make_mesh, local_mesh
from .stream import (
    halo_exchange_prev,
    sharded_df1_float,
    time_sharded_prev,
)

__all__ = [
    "halo_exchange_prev",
    "local_mesh",
    "make_mesh",
    "sharded_df1_float",
    "time_sharded_prev",
]
