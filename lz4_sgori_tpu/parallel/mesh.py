"""Device mesh construction for block-data-parallel codec runs."""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh

BLOCK_AXIS = "blocks"


def make_mesh(n_devices: int | None = None, axis: str = BLOCK_AXIS) -> Mesh:
    """1-D mesh over the first `n_devices` devices.

    The codec has a single parallelism axis — independent blocks — so the
    mesh is one-dimensional. The GPUs of a host reach each other all to all
    over NVLink at one rate, so the mesh needs no other shape; XLA hands
    its collectives to NCCL (SURVEY.md §5 distributed-communication
    backend).
    """
    devs = jax.devices()
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(
                f"requested {n_devices} devices, have {len(devs)}")
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))
