"""Host-0 image assembly (VERDICT r3 ask 4; SURVEY §5 distributed row:
"all_gather of rendered tiles to host 0 for image assembly").

A sharded render returns per-ray colors distributed over the mesh; the
final PPM is a HOST artifact.  :func:`gather_colors` brings the full
color array to every participating process (one all-gather over
ICI/DCN; a no-op fetch in single-process runs), and
:func:`assemble_ppm_host0` decodes + writes the PPM on process 0 only —
the reference's WriteFile role (data_utils.h:101-122) at pod scale.
"""

from __future__ import annotations

import numpy as np


def gather_colors(colors) -> np.ndarray:
    """Sharded per-ray colors [N, 3] (or [3, N]) -> full ndarray on this
    host.

    Multi-process with a GLOBAL sharded array: reshard to a replicated
    layout (one all_gather over the mesh — the rendered-tile gather) and
    read the now-fully-addressable copy.  Multi-process with plain
    host-local data: ``process_allgather``.  Single-process: a plain
    device fetch."""
    import jax

    if jax.process_count() > 1:
        sh = getattr(colors, "sharding", None)
        if isinstance(sh, jax.sharding.NamedSharding):
            rep = jax.device_put(
                colors,
                jax.sharding.NamedSharding(
                    sh.mesh, jax.sharding.PartitionSpec()
                ),
            )
            return np.asarray(rep.addressable_data(0))
        from jax.experimental import multihost_utils

        return np.asarray(
            multihost_utils.process_allgather(colors, tiled=True)
        )
    return np.asarray(colors)


def assemble_ppm_host0(colors, width, height, samples, path):
    """Gather a sharded render and write the PPM on process 0.

    Returns the path on process 0, None on other processes (which still
    participate in the gather — it is a collective).  Byte-identical to
    the single-device pipeline: the same decode_color + encode_ppm path
    runs on the gathered array (tests/test_assembly.py gates this).
    """
    import jax

    from ascendpathtracing.utils import io

    full = gather_colors(colors)
    if jax.process_index() != 0:
        return None
    img = io.decode_color(full, width, height, samples)
    io.write_ppm(img, path)
    return path
