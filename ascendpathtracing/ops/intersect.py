"""Ray-sphere intersection ops (jax.numpy; fused by XLA).

The re-design of the reference's intersection stack
(rt_helper.h:255-502): one batched expression replaces the per-sphere
``SphereHitInfo`` loop (rt_helper.h:457-474), the scalar-gather
``Transpose`` (rt_helper.h:372-395) and the ``ReduceMinInfo``
BlockReduceMin/Brcb/bitmask dance (rt_helper.h:397-451).

Layout: **SoA planes, rays on the minor axis** — the same choice the
reference makes with its 6/10-plane SoA tensors (rt_helper.h:65-104): ray
state lives in 1-D [N] component arrays, so consecutive rays are
contiguous (coalesced loads on the GPU), and the per-sphere hit matrix is
[S, N].

Miss semantics (load-bearing, SURVEY §7 hard-part 2): the reference takes
sqrt of a negative discriminant, yielding NaN, and both NaN and t <= eps
collapse to the 1e20 sentinel via NaN-compare-is-false
(rt_helper.h:324-364).  We compute identical *values* branch-free with a
validity mask instead of manufacturing NaNs, which keeps reverse-mode
gradients finite.
"""

from __future__ import annotations

import jax.numpy as jnp

MISS_T = 1e20


def intersect_spheres_soa(ox, oy, oz, dx, dy, dz, cx, cy, cz, r2, eps):
    """Intersect N rays (six 1-D [N] component planes) against S spheres
    (four [S] planes: center xyz + squared radius).

    Returns t: [S, N] hit distances; 1e20 where missed.  Op order matches
    oracle.intersect_all_numpy elementwise for bitwise comparability.
    """
    ocx = cx[:, None] - ox[None, :]
    ocy = cy[:, None] - oy[None, :]
    ocz = cz[:, None] - oz[None, :]
    b = ocx * dx[None, :] + ocy * dy[None, :] + ocz * dz[None, :]
    c = ocx * ocx + ocy * ocy + ocz * ocz - r2[:, None]
    det = b * b - c
    valid = det >= 0
    sq = jnp.sqrt(jnp.where(valid, det, 0.0))
    t0 = b - sq
    t1 = b + sq
    miss = jnp.asarray(MISS_T, t0.dtype)
    return jnp.where(valid & (t0 > eps), t0, jnp.where(valid & (t1 > eps), t1, miss))


def reduce_hit_soa(t):
    """Per-ray nearest hit: t [S, N] -> (tmin [N], hit [N] int32, miss [N]).

    ``jnp.argmin`` over the sphere axis returns the first
    minimal index, matching the reference's lowest-index tie-break
    (rt_helper.h:183-193 ConvertBitToValue; gen_data.py:313-321).
    """
    hit = jnp.argmin(t, axis=0).astype(jnp.int32)
    tmin = jnp.min(t, axis=0)
    miss = tmin >= jnp.asarray(MISS_T, t.dtype)
    return tmin, hit, miss


# -------------------------------------------------------- AoS wrappers ----
def intersect_spheres(o, d, centers, r2, eps):
    """AoS-boundary wrapper: o, d [N, 3]; centers [S, 3] -> t [N, S].

    Prefer the SoA form in hot paths; this exists for small-N callers and
    API compatibility.
    """
    t = intersect_spheres_soa(
        o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2],
        centers[:, 0], centers[:, 1], centers[:, 2], r2, eps,
    )
    return t.T


def reduce_hit(t):
    """AoS-boundary wrapper: t [N, S] -> (tmin, hit, miss)."""
    return reduce_hit_soa(t.T)
