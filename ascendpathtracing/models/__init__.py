"""Renderers — the framework's "model zoo".

- ``megakernel``        — single fused jit render step (the re-design of
  the reference's one fused Ascend C kernel, src/render.cpp:104-207): the
  whole bounce loop is one XLA program.  Its reference-mode loop also
  exists as a hand-fused Pallas kernel (ops/pallas_kernels.py): a block
  of rays stays in registers across all bounces, device-memory traffic is
  the rays in and the colors out.
- ``mesh``              — spheres + a triangle mesh behind a BVH.
- ``wavefront``         — per-bounce passes with ray compaction (the
  north-star upgrade over the reference's carry-dead-rays masking,
  rt_helper.h:787-810).
"""

from ascendpathtracing.models.megakernel import (
    render_reference,
    render_pt,
    scene_to_device,
)

__all__ = ["render_reference", "render_pt", "scene_to_device"]
