"""BVH: host-side binned-SAH builder + flattened stackless traversal.

Builder output is the "flattened into HBM-resident arrays" form of the
BASELINE north star: nodes in DFS (pre)order, each carrying a **miss
link** (the node to visit when its bbox is missed, or after a leaf is
processed).  Traversal is therefore stackless: a single node pointer per
ray, advanced either to ``ptr+1`` (hit an inner node: descend into the
left child, which is next in DFS order) or to ``miss[ptr]``.

Two builders with identical output contracts:
- :func:`build_bvh_numpy` — reference implementation (binned SAH with
  median-split fallback).
- the C++ native builder (accel/native.py) — same algorithm, ~50x faster
  for large meshes; cross-checked against the NumPy builder in tests.

Traversal is a vectorized ``lax.while_loop``: every ray carries its own
pointer, lanes that finish idle until the tile converges (the SIMT
masking strategy the reference uses for dead rays, rt_helper.h:787-810,
applied to traversal).
"""

from __future__ import annotations

import dataclasses

import numpy as np

MISS_T = 1e20


@dataclasses.dataclass
class FlatBVH:
    """Flattened DFS-ordered BVH over triangles."""

    bmin: np.ndarray  # [M, 3] float32
    bmax: np.ndarray  # [M, 3] float32
    first: np.ndarray  # [M] int32: leaf -> start into tri_order; inner -> -1
    count: np.ndarray  # [M] int32: leaf -> #tris; inner -> 0
    miss: np.ndarray  # [M] int32: skip link; == M means done
    tri_order: np.ndarray  # [F] int32 permutation of triangle ids
    max_leaf: int

    @property
    def n_nodes(self) -> int:
        return int(self.bmin.shape[0])

    @property
    def n_tris(self) -> int:
        return int(self.tri_order.shape[0])


def build_bvh_numpy(
    vertices: np.ndarray,
    faces: np.ndarray,
    *,
    max_leaf: int = 4,
    n_bins: int = 16,
) -> FlatBVH:
    """Binned-SAH BVH (NumPy reference builder)."""
    vertices = np.asarray(vertices, np.float64)
    faces = np.asarray(faces, np.int64)
    f = faces.shape[0]
    tri = vertices[faces]  # [F, 3, 3]
    tbmin = tri.min(axis=1)
    tbmax = tri.max(axis=1)
    cent = (tbmin + tbmax) * 0.5

    bmin_l, bmax_l, first_l, count_l, miss_l = [], [], [], [], []
    order: list[int] = []

    def emit(bmin, bmax, first, count):
        bmin_l.append(bmin)
        bmax_l.append(bmax)
        first_l.append(first)
        count_l.append(count)
        miss_l.append(-1)
        return len(bmin_l) - 1

    def rec(idxs: np.ndarray, miss_link: int) -> int:
        node_bmin = tbmin[idxs].min(axis=0)
        node_bmax = tbmax[idxs].max(axis=0)
        if idxs.size <= max_leaf:
            nid = emit(node_bmin, node_bmax, len(order), idxs.size)
            order.extend(int(i) for i in idxs)
            miss_l[nid] = miss_link
            return nid

        # --- binned SAH over all 3 axes -------------------------------
        best = None  # (cost, axis, bin_split)
        c = cent[idxs]
        cmin = c.min(axis=0)
        cmax = c.max(axis=0)
        ext = cmax - cmin
        for axis in range(3):
            if ext[axis] <= 1e-12:
                continue
            rel = (c[:, axis] - cmin[axis]) / ext[axis]
            bins = np.minimum((rel * n_bins).astype(np.int64), n_bins - 1)
            # per-bin bounds + counts
            counts = np.bincount(bins, minlength=n_bins)
            if (counts > 0).sum() < 2:
                continue
            bb_min = np.full((n_bins, 3), np.inf)
            bb_max = np.full((n_bins, 3), -np.inf)
            for b in range(n_bins):
                m = bins == b
                if m.any():
                    bb_min[b] = tbmin[idxs[m]].min(axis=0)
                    bb_max[b] = tbmax[idxs[m]].max(axis=0)
            # prefix/suffix areas
            def area(mn, mx):
                d = np.maximum(mx - mn, 0)
                return 2 * (d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] + d[..., 0] * d[..., 2])

            lmin = np.minimum.accumulate(bb_min, axis=0)
            lmax = np.maximum.accumulate(bb_max, axis=0)
            rmin = np.minimum.accumulate(bb_min[::-1], axis=0)[::-1]
            rmax = np.maximum.accumulate(bb_max[::-1], axis=0)[::-1]
            lcnt = np.cumsum(counts)
            rcnt = np.cumsum(counts[::-1])[::-1]
            for split in range(1, n_bins):
                nl, nr = lcnt[split - 1], rcnt[split]
                if nl == 0 or nr == 0:
                    continue
                cost = nl * area(lmin[split - 1], lmax[split - 1]) + nr * area(
                    rmin[split], rmax[split]
                )
                if best is None or cost < best[0]:
                    best = (cost, axis, split, bins)

        if best is None:
            # Degenerate (all centroids coincide): arbitrary median split.
            half = idxs.size // 2
            left_idx, right_idx = idxs[:half], idxs[half:]
        else:
            _, axis, split, bins = best
            m = bins < split
            left_idx, right_idx = idxs[m], idxs[~m]

        nid = emit(node_bmin, node_bmax, -1, 0)
        miss_l[nid] = miss_link
        right_placeholder = [None]

        left_id = rec(left_idx, miss_link=-2)  # patched below
        right_id = rec(right_idx, miss_link=miss_link)
        # left subtree's miss links that pointed "past the subtree" must
        # land on the right child: we passed -2 as a sentinel; patch all.
        for i in range(left_id, right_id):
            if miss_l[i] == -2:
                miss_l[i] = right_id
        del right_placeholder
        return nid

    n_total = f
    root_idxs = np.arange(n_total)
    rec(root_idxs, miss_link=-3)  # -3 = done sentinel, patched to M below
    m = len(bmin_l)
    miss = np.asarray(miss_l, np.int64)
    miss[miss == -3] = m
    # any unpatched -2 at the top level means "done" as well
    miss[miss == -2] = m
    return FlatBVH(
        bmin=np.asarray(bmin_l, np.float32),
        bmax=np.asarray(bmax_l, np.float32),
        first=np.asarray(first_l, np.int32),
        count=np.asarray(count_l, np.int32),
        miss=miss.astype(np.int32),
        tri_order=np.asarray(order, np.int32),
        max_leaf=max_leaf,
    )


def build_bvh(vertices, faces, *, max_leaf: int = 4, backend: str = "auto") -> FlatBVH:
    """Build a BVH with the native C++ builder when available, else NumPy."""
    if backend in ("auto", "native"):
        try:
            from ascendpathtracing.accel import native

            return native.build_bvh_native(vertices, faces, max_leaf=max_leaf)
        except Exception:
            if backend == "native":
                raise
    return build_bvh_numpy(vertices, faces, max_leaf=max_leaf)


# ---------------------------------------------------------------- traversal ----
def intersect_bvh(o3, d3, bvh_arrays, tri_planes_ordered, eps, max_leaf):
    """Stackless BVH traversal, vectorized over N rays (jnp).

    Args:
      o3, d3: (x, y, z) tuples of [N] planes.
      bvh_arrays: dict of device arrays {bmin [M,3], bmax [M,3], first,
        count, miss [M]} (from :func:`bvh_to_device`).
      tri_planes_ordered: (v0, e1, e2) tuples of [F] planes, already
        permuted by tri_order so leaves are contiguous.
      max_leaf: static leaf size bound (unrolled).

    Returns (tmin [N], tri_id [N] int32 — id into the ORDERED triangle
    arrays, miss [N] bool).
    """
    import jax
    import jax.numpy as jnp

    ox, oy, oz = o3
    dx, dy, dz = d3
    n = ox.shape[0]
    m = bvh_arrays["miss"].shape[0]
    f_dtype = ox.dtype

    inv_dx = 1.0 / jnp.where(dx == 0, 1e-30, dx)
    inv_dy = 1.0 / jnp.where(dy == 0, 1e-30, dy)
    inv_dz = 1.0 / jnp.where(dz == 0, 1e-30, dz)

    v0, e1, e2 = tri_planes_ordered
    bminx, bminy, bminz = (bvh_arrays["bmin"][:, i] for i in range(3))
    bmaxx, bmaxy, bmaxz = (bvh_arrays["bmax"][:, i] for i in range(3))
    nfirst = bvh_arrays["first"]
    ncount = bvh_arrays["count"]
    nmiss = bvh_arrays["miss"]
    f_total = v0[0].shape[0]

    def tri_one(tidx, valid):
        """Per-ray single-triangle Moller-Trumbore with gathered tri data."""
        ax, ay, az = v0[0][tidx], v0[1][tidx], v0[2][tidx]
        e1x, e1y, e1z = e1[0][tidx], e1[1][tidx], e1[2][tidx]
        e2x, e2y, e2z = e2[0][tidx], e2[1][tidx], e2[2][tidx]
        px = dy * e2z - dz * e2y
        py = dz * e2x - dx * e2z
        pz = dx * e2y - dy * e2x
        det = e1x * px + e1y * py + e1z * pz
        parallel = jnp.abs(det) < 1e-12
        invd = jnp.where(parallel, 0.0, 1.0 / jnp.where(parallel, 1.0, det))
        tx, ty, tz = ox - ax, oy - ay, oz - az
        u = (tx * px + ty * py + tz * pz) * invd
        qx = ty * e1z - tz * e1y
        qy = tz * e1x - tx * e1z
        qz = tx * e1y - ty * e1x
        v = (dx * qx + dy * qy + dz * qz) * invd
        t = (e2x * qx + e2y * qy + e2z * qz) * invd
        ok = (
            valid
            & ~parallel
            & (u >= 0.0)
            & (v >= 0.0)
            & (u + v <= 1.0)
            & (t > eps)
        )
        return jnp.where(ok, t, jnp.asarray(MISS_T, f_dtype))

    def cond(state):
        ptr, _, _ = state
        return jnp.any(ptr < m)

    def body(state):
        ptr, tmin, hitid = state
        p = jnp.minimum(ptr, m - 1)
        active = ptr < m

        # slab test against current tmin
        t1x = (bminx[p] - ox) * inv_dx
        t2x = (bmaxx[p] - ox) * inv_dx
        t1y = (bminy[p] - oy) * inv_dy
        t2y = (bmaxy[p] - oy) * inv_dy
        t1z = (bminz[p] - oz) * inv_dz
        t2z = (bmaxz[p] - oz) * inv_dz
        tnear = jnp.maximum(
            jnp.maximum(jnp.minimum(t1x, t2x), jnp.minimum(t1y, t2y)),
            jnp.minimum(t1z, t2z),
        )
        tfar = jnp.minimum(
            jnp.minimum(jnp.maximum(t1x, t2x), jnp.maximum(t1y, t2y)),
            jnp.maximum(t1z, t2z),
        )
        box_hit = active & (tfar >= jnp.maximum(tnear, 0.0)) & (tnear < tmin)

        count = ncount[p]
        first = nfirst[p]
        is_leaf = count > 0
        do_leaf = box_hit & is_leaf

        # unrolled leaf triangles (max_leaf is small and static)
        for k in range(max_leaf):
            valid = do_leaf & (k < count)
            tidx = jnp.clip(first + k, 0, f_total - 1)
            t = tri_one(tidx, valid)
            better = t < tmin
            tmin = jnp.where(better, t, tmin)
            hitid = jnp.where(better, tidx, hitid)

        descend = box_hit & ~is_leaf
        nxt = jnp.where(descend, p + 1, nmiss[p])
        ptr = jnp.where(active, nxt, ptr)
        return ptr, tmin, hitid

    ptr0 = jnp.zeros((n,), jnp.int32)
    tmin0 = jnp.full((n,), MISS_T, f_dtype)
    hit0 = jnp.zeros((n,), jnp.int32)
    ptr, tmin, hitid = jax.lax.while_loop(cond, body, (ptr0, tmin0, hit0))
    miss = tmin >= jnp.asarray(MISS_T, f_dtype)
    return tmin, hitid, miss


def bvh_to_device(bvh: FlatBVH, dtype=None):
    """FlatBVH -> dict of device arrays for :func:`intersect_bvh`."""
    import jax.numpy as jnp

    fdt = dtype or jnp.float32
    return {
        "bmin": jnp.asarray(bvh.bmin, fdt),
        "bmax": jnp.asarray(bvh.bmax, fdt),
        "first": jnp.asarray(bvh.first, jnp.int32),
        "count": jnp.asarray(bvh.count, jnp.int32),
        "miss": jnp.asarray(bvh.miss, jnp.int32),
    }
