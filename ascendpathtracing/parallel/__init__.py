"""Parallelism: device meshes, sharded rendering, multi-host utilities.

The reference's only parallelism is 8 share-nothing in-chip cores claiming
disjoint ray slices by ``GetBlockIdx()`` (render.cpp:9,24) — zero
inter-core communication.  Here parallelism is first-class (SURVEY §2.5):

- **DP over rays** ("data" mesh axis): each chip renders a contiguous ray
  shard — the multi-chip generalization of the reference's core blocking.
- **TP over spheres/primitives** ("model" mesh axis): the intersection
  test is sharded over scene primitives; per-shard nearest hits are
  combined with an ``all_gather`` over ICI and a lexicographic
  (t, global index) reduction that preserves the reference's
  lowest-index tie-break.
- **Gradient psum** over the whole mesh for the differentiable pass
  (compiler-inserted; see benchmarks/artifacts/overlap_r3.json for the
  HLO evidence and benchmarks/overlap_evidence.py for the async-
  collective flags that let XLA's latency-hiding scheduler overlap it
  with the backward on real slices).
- **Multi-host**: ``jax.distributed.initialize`` + per-host data feeding
  (``distributed.py``).
"""

from ascendpathtracing.parallel.assembly import (
    assemble_ppm_host0,
    gather_colors,
)
from ascendpathtracing.parallel.mesh import make_mesh, mesh_shape_for
from ascendpathtracing.parallel.sharded import (
    make_train_step,
    render_pt_mesh_sharded,
    render_reference_sharded,
    shard_rays,
    split_scene_params,
)

__all__ = [
    "assemble_ppm_host0",
    "gather_colors",
    "make_mesh",
    "mesh_shape_for",
    "make_train_step",
    "render_pt_mesh_sharded",
    "render_reference_sharded",
    "shard_rays",
    "split_scene_params",
]
