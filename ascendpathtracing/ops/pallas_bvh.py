"""Per-lane stackless BVH traversal: a Pallas kernel on the Triton route.

The BVH is the miss-link tree of accel/bvh.py (nodes in DFS order; a
miss link says where to go when a box is missed or a leaf is done).  Each
lane chases its own node pointer with gathered loads, the way a GPU walks
a tree: the node and triangle tables stay in L2 (an 81,920-triangle mesh
is about 8 MB), the ray state stays in registers, and a program loops
until every lane of its block is done.  ``accel/bvh.intersect_bvh`` is the
semantic spec and the reference: the same node order, slab test,
Moller-Trumbore and tie-break, so hit ids agree exactly and t to
rounding.  The XLA ``while_loop`` version touches every ray's state on
each iteration and runs until the slowest ray in the whole batch is done.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ascendpathtracing import backend

MISS_T = 1e20
_CANDIDATES = ((64, 2), (128, 4), (256, 4), (256, 8))
INTERPRET_BLOCK = 1024


def pack_bvh(bvh, tri_planes_ordered):
    """Host-side tables for the kernel.

    Returns (nodes_f [M, 8] f32: bmin xyz, 0, bmax xyz, 0;
             nodes_i [M, 4] i32: first, count, miss, 0;
             tris [F, 16] f32: v0 xyz, e1 xyz, e2 xyz, 0...) — one node or
    triangle per row, so a lane's reads of one record share a cache line.
    ``tri_planes_ordered``: (v0, e1, e2) plane tuples already in the
    BVH's leaf order."""
    m = bvh.n_nodes
    nodes_f = np.zeros((m, 8), np.float32)
    nodes_f[:, 0:3] = bvh.bmin
    nodes_f[:, 4:7] = bvh.bmax
    nodes_i = np.zeros((m, 4), np.int32)
    nodes_i[:, 0] = bvh.first
    nodes_i[:, 1] = bvh.count
    nodes_i[:, 2] = bvh.miss
    f = np.asarray(tri_planes_ordered[0][0]).shape[0]
    tris = np.zeros((f, 16), np.float32)
    for j, vec in enumerate(tri_planes_ordered):
        for c in range(3):
            tris[:, 3 * j + c] = np.asarray(vec[c], np.float32)
    return jnp.asarray(nodes_f), jnp.asarray(nodes_i), jnp.asarray(tris)


def _traverse_kernel(rays_ref, nodes_f_ref, nodes_i_ref, tris_ref, t_ref,
                     hit_ref, *, n, max_leaf, eps, block):
    start = pl.program_id(0) * block
    rows = pl.ds(start, block)
    mask = start + jnp.arange(block, dtype=jnp.int32) < n
    ox, oy, oz, dx, dy, dz = (
        plgpu.load(rays_ref.at[jnp.int32(c), rows], mask=mask, other=1.0)
        for c in range(6)
    )
    f_dtype = ox.dtype
    m = nodes_i_ref.shape[0]
    f_total = tris_ref.shape[0]
    inv_dx = 1.0 / jnp.where(dx == 0, 1e-30, dx)
    inv_dy = 1.0 / jnp.where(dy == 0, 1e-30, dy)
    inv_dz = 1.0 / jnp.where(dz == 0, 1e-30, dz)

    def col(ref, row, c, active, other):
        return plgpu.load(ref.at[row, jnp.int32(c)], mask=active, other=other)

    def cond(state):
        ptr, _, _ = state
        return jnp.max(jnp.where(ptr < m, 1, 0)) > 0

    def body(state):
        ptr, tmin, hitid = state
        active = ptr < m
        p = jnp.minimum(ptr, m - 1)
        b = [col(nodes_f_ref, p, c, active, 0.0) for c in (0, 1, 2, 4, 5, 6)]
        t1x = (b[0] - ox) * inv_dx
        t2x = (b[3] - ox) * inv_dx
        t1y = (b[1] - oy) * inv_dy
        t2y = (b[4] - oy) * inv_dy
        t1z = (b[2] - oz) * inv_dz
        t2z = (b[5] - oz) * inv_dz
        tnear = jnp.maximum(
            jnp.maximum(jnp.minimum(t1x, t2x), jnp.minimum(t1y, t2y)),
            jnp.minimum(t1z, t2z),
        )
        tfar = jnp.minimum(
            jnp.minimum(jnp.maximum(t1x, t2x), jnp.maximum(t1y, t2y)),
            jnp.maximum(t1z, t2z),
        )
        box_hit = active & (tfar >= jnp.maximum(tnear, 0.0)) & (tnear < tmin)
        first = col(nodes_i_ref, p, 0, active, 0)
        count = col(nodes_i_ref, p, 1, active, 0)
        miss_link = col(nodes_i_ref, p, 2, active, m)
        is_leaf = count > 0
        do_leaf = box_hit & is_leaf

        for k in range(max_leaf):
            valid = do_leaf & (k < count)
            tidx = jnp.clip(first + k, 0, f_total - 1)
            ax, ay, az, e1x, e1y, e1z, e2x, e2y, e2z = (
                col(tris_ref, tidx, c, valid, 0.0) for c in range(9)
            )
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
            ok = (valid & ~parallel & (u >= 0.0) & (v >= 0.0)
                  & (u + v <= 1.0) & (t > eps))
            t = jnp.where(ok, t, MISS_T)
            better = t < tmin
            tmin = jnp.where(better, t, tmin)
            hitid = jnp.where(better, tidx, hitid)

        nxt = jnp.where(box_hit & ~is_leaf, p + 1, miss_link)
        return jnp.where(active, nxt, ptr), tmin, hitid

    ptr0 = jnp.where(mask, 0, m).astype(jnp.int32)
    tmin0 = jnp.full((block,), MISS_T, f_dtype)
    hit0 = jnp.zeros((block,), jnp.int32)
    _, tmin, hitid = jax.lax.while_loop(cond, body, (ptr0, tmin0, hit0))
    plgpu.store(t_ref.at[rows], tmin, mask=mask)
    plgpu.store(hit_ref.at[rows], hitid, mask=mask)


def _call(rays_planes, nodes_f, nodes_i, tris, *, max_leaf, eps, block,
          num_warps, interpret):
    n = rays_planes.shape[1]
    kernel = functools.partial(
        _traverse_kernel, n=n, max_leaf=max_leaf, eps=eps, block=block
    )
    return pl.pallas_call(
        kernel,
        grid=(pl.cdiv(n, block),),
        out_shape=(
            jax.ShapeDtypeStruct((n,), rays_planes.dtype),
            jax.ShapeDtypeStruct((n,), jnp.int32),
        ),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps, num_stages=1),
        interpret=interpret,
        name="bvh_traverse",
    )(rays_planes, nodes_f, nodes_i, tris)


# rays per timing probe: enough blocks to fill the card several times
_PROBE_RAYS = 1 << 20


def launch_config(tables, *, max_leaf, eps=1e-4, interpret=False):
    """(block, num_warps) for these tables: fixed in the interpreter; on
    the GPU the fastest candidate, timed once per process on incoherent
    probe rays (origins inside the root box, uniform directions — the
    distribution of bounced rays).  ``tables`` must be concrete (they are
    built on the host)."""
    if interpret:
        return INTERPRET_BLOCK, 4
    backend.check_kernel_target(interpret)
    nodes_f, nodes_i, tris = (np.asarray(t) for t in tables)
    rng = np.random.RandomState(0)
    lo, hi = nodes_f[0, 0:3], nodes_f[0, 4:7]
    o = lo + (hi - lo) * rng.rand(_PROBE_RAYS, 3)
    d = rng.randn(_PROBE_RAYS, 3)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = np.concatenate([o, d], 1).T.astype(np.float32)

    args = (rays, nodes_f, nodes_i, tris)

    def compile_cfg(cfg):
        return jax.jit(functools.partial(
            _call, max_leaf=max_leaf, eps=eps, block=cfg[0],
            num_warps=cfg[1], interpret=False,
        )).lower(*args).compile()

    key = ("bvh_traverse", nodes_i.shape[0], tris.shape[0], max_leaf)
    return backend.fastest_config(key, _CANDIDATES, compile_cfg, args)


def intersect_bvh_pallas(rays_planes, nodes_f, nodes_i, tris, *, max_leaf,
                         eps=1e-4, block=INTERPRET_BLOCK, num_warps=4,
                         interpret=False):
    """Nearest triangle hit for each ray.

    rays_planes: [6, N]; tables from :func:`pack_bvh`; ``block`` and
    ``num_warps`` from :func:`launch_config`.
    Returns (tmin [N], tri_id [N] i32 into the leaf-ordered triangles)."""
    backend.check_kernel_target(interpret)
    return _call(
        rays_planes, nodes_f, nodes_i, tris, max_leaf=max_leaf, eps=eps,
        block=block, num_warps=num_warps, interpret=interpret,
    )
