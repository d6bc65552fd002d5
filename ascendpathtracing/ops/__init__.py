"""Device ops: the replacement of the reference's rt_helper.h.

The reference implements every op as hand-vectorized Ascend C over 64-ray
tiles, with ``Fake*`` workarounds for broken vendor intrinsics
(rt_helper.h:150-246).  Here these are ordinary ``jax.numpy`` expressions
(XLA fuses them) plus two Pallas kernels on the Triton route for the hot
paths (ops/pallas_kernels.py, ops/pallas_bvh.py):

- FakeGather / FakeGatherMask  -> jnp indexing / jnp.take_along_axis
- FakeCompare* / FakeSelect*   -> jnp.where
- BlockReduceMin + Brcb        -> jnp.min / jnp.argmin over the sphere axis
- Transpose 8x64 -> 64x8       -> an axis order choice, not an op
"""

from ascendpathtracing.ops.intersect import (
    intersect_spheres,
    intersect_spheres_soa,
    reduce_hit,
    reduce_hit_soa,
)
from ascendpathtracing.ops.shade import reflect, specular_bounce

__all__ = [
    "intersect_spheres",
    "intersect_spheres_soa",
    "reduce_hit",
    "reduce_hit_soa",
    "reflect",
    "specular_bounce",
]
