"""Ray reordering for traversal coherence.

A block of lanes walking a BVH runs until its slowest lane is done, and
divergent lanes of one warp serialize.  Sorting rays by a
direction-octant + quantized-origin Morton key groups rays that traverse
similar subtrees into the same blocks — the standard
coherence-extraction trick from wavefront GPU tracers (the wavefront
renderers use it at every compaction).

Pure jnp (argsort); callers scatter results back with the returned
permutation.
"""

from __future__ import annotations

import jax.numpy as jnp


def _part1by2(x):
    """Spread 10 bits to every 3rd bit (Morton interleave helper)."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x30000FF
    x = (x | (x << 8)) & 0x300F00F
    x = (x | (x << 4)) & 0x30C30C3
    x = (x | (x << 2)) & 0x9249249
    return x


def morton3(ix, iy, iz):
    """Interleave three 10-bit ints into a 30-bit Morton code."""
    return (_part1by2(iz) << 2) | (_part1by2(iy) << 1) | _part1by2(ix)


def ray_sort_keys(o3, d3, bounds_min, bounds_max, bits=7):
    """Coherence key per ray: 3-bit direction octant (major) + Morton code
    of the quantized origin (minor). bounds_*: scene bbox (3,) floats."""
    ox, oy, oz = o3
    dx, dy, dz = d3
    octant = (
        (dx >= 0).astype(jnp.int32)
        | ((dy >= 0).astype(jnp.int32) << 1)
        | ((dz >= 0).astype(jnp.int32) << 2)
    )
    scale = (1 << bits) - 1

    def q(p, lo, hi):
        t = (p - lo) / jnp.maximum(hi - lo, 1e-20)
        return jnp.clip((t * scale), 0, scale).astype(jnp.int32)

    ix = q(ox, bounds_min[0], bounds_max[0])
    iy = q(oy, bounds_min[1], bounds_max[1])
    iz = q(oz, bounds_min[2], bounds_max[2])
    return (octant << (3 * bits)) | morton3(ix, iy, iz)


def ray_sort_keys_6d(o3, d3, bounds_min, bounds_max, obits=5, dbits=5):
    """6-D Morton key interleaving quantized DIRECTION and origin bits.

    The octant+origin key above groups rays whose *origins* are close but
    only 8-way by direction; rays that share a block walk similar paths
    only if their directions agree too, so direction resolution matters
    as much as origin.  Interleaving (dx dy dz ox oy oz) bits MSB-first
    puts direction bits ahead of origin bits at each level.
    """
    ox, oy, oz = o3
    dx, dy, dz = d3

    def q(p, lo, hi, bits):
        s = (1 << bits) - 1
        t = (p - lo) / jnp.maximum(hi - lo, 1e-20)
        return jnp.clip(t * s, 0, s).astype(jnp.int32)

    ix = q(ox, bounds_min[0], bounds_max[0], obits)
    iy = q(oy, bounds_min[1], bounds_max[1], obits)
    iz = q(oz, bounds_min[2], bounds_max[2], obits)
    jx = q(dx, -1.0, 1.0, dbits)
    jy = q(dy, -1.0, 1.0, dbits)
    jz = q(dz, -1.0, 1.0, dbits)
    key = jnp.zeros_like(ix)
    for b in range(max(obits, dbits) - 1, -1, -1):
        for comp, bits in ((jx, dbits), (jy, dbits), (jz, dbits),
                           (ix, obits), (iy, obits), (iz, obits)):
            if b < bits:
                key = (key << 1) | ((comp >> b) & 1)
    return key


def sort_rays_for_traversal(o3, d3, bounds_min, bounds_max, bits=7):
    """Return (o3s, d3s, perm): rays permuted into coherence order.
    Invert with ``result_unsorted = result[inv]`` where
    ``inv = jnp.argsort(perm)`` (or scatter by perm)."""
    keys = ray_sort_keys(o3, d3, bounds_min, bounds_max, bits)
    perm = jnp.argsort(keys)
    take = lambda t: tuple(c[perm] for c in t)  # noqa: E731
    return take(o3), take(d3), perm
