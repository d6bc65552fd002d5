"""Acceleration structures: triangle meshes and BVH.

New capability over the reference (which intersects 8 spheres brute-force,
rt_helper.h:453-502); mandated by the BASELINE north star: "a BVH built on
host, flattened into HBM-resident arrays, and traversed in a stackless
kernel".

- ``tri``     — Moller-Trumbore triangle intersection (SoA, vectorized).
- ``bvh``     — host-side builder (binned SAH; NumPy reference and C++
  native implementations) producing a flattened DFS-ordered node array
  with miss-links ("skip links") for stackless traversal, plus the
  jnp ``lax.while_loop`` traversal.
- ``meshes``  — procedural test meshes (cube, icosphere, quad).
"""

from ascendpathtracing.accel.tri import intersect_triangles_brute
from ascendpathtracing.accel.bvh import (
    FlatBVH,
    build_bvh,
    intersect_bvh,
)

__all__ = [
    "FlatBVH",
    "build_bvh",
    "intersect_bvh",
    "intersect_triangles_brute",
]
