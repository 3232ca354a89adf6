"""Device-mesh construction helpers."""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh


def make_mesh(axis_sizes: dict[str, int], *, devices=None) -> Mesh:
    """Build a Mesh with named axes from a {name: size} mapping.

    Sizes must multiply to the device count used; the first that many
    devices are laid out in the dict's axis order.  Every card of a host
    reaches every other at the same rate, so the shape follows the
    algorithm alone.
    """
    if devices is None:
        devices = jax.devices()
    names = tuple(axis_sizes)
    shape = tuple(axis_sizes[n] for n in names)
    n = int(np.prod(shape))
    if n > len(devices):
        raise ValueError(
            f"mesh {axis_sizes} needs {n} devices, have {len(devices)}"
        )
    dev = np.asarray(devices[:n]).reshape(shape)
    return Mesh(dev, names)


def local_mesh(*names_and_sizes: tuple[str, int]) -> Mesh:
    """Convenience: `local_mesh(("sp", 4), ("dp", 2))`."""
    return make_mesh(dict(names_and_sizes))
