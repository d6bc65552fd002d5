"""Device-mesh construction helpers."""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh


def mesh_shape_for(n_devices: int, model_parallel: int | None = None):
    """Pick a (data, model) split for ``n_devices``.

    The model axis shards the scene-primitive axis of the intersection
    test; it only pays off when primitives >> devices, so default small:
    2 when the device count is even and > 2, else 1.
    """
    if model_parallel is None:
        model_parallel = 2 if (n_devices > 2 and n_devices % 2 == 0) else 1
    if n_devices % model_parallel:
        raise ValueError(f"{n_devices=} not divisible by {model_parallel=}")
    return n_devices // model_parallel, model_parallel


def make_mesh(
    n_devices: int | None = None,
    *,
    model_parallel: int | None = None,
    devices=None,
    axis_names=("data", "model"),
) -> Mesh:
    """Create a 2D ('data', 'model') mesh over the available devices: a
    plain reshape of ``jax.devices()`` (NVLink joins every card of a host
    to every other at the same rate, so no device order is better).
    """
    if devices is None:
        devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    devices = devices[:n_devices]
    dp, mp = mesh_shape_for(n_devices, model_parallel)
    arr = np.asarray(devices).reshape(dp, mp)
    return Mesh(arr, axis_names)
