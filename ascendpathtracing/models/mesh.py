"""Triangle-mesh scenes and the combined sphere+mesh path tracer
(BASELINE config 3: "Triangle-mesh scene with flattened BVH, stackless
traversal kernel").

A MeshScene is the reference's sphere world (walls/light stay the smallpt
spheres) plus a triangle mesh with per-face attributes, intersected
through the flattened BVH (accel/bvh.py) or brute force (for small F or
as the correctness oracle).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ascendpathtracing.accel import bvh as bvh_mod
from ascendpathtracing.accel import tri as tri_mod
from ascendpathtracing import backend
from ascendpathtracing.ops import pallas_bvh
from ascendpathtracing.models import megakernel
from ascendpathtracing.models.megakernel import select_by_id
from ascendpathtracing.ops import shade
from ascendpathtracing.ops.intersect import MISS_T
from ascendpathtracing.scenes import DIFF, REFR, SphereScene, get_scene


class StaticConf(NamedTuple):
    """Hashable non-traced traversal config carried in the device dict
    (stripped before jit and passed as a static argument)."""

    traversal: str  # kernel | jnp | brute
    max_leaf: int = 0
    # kernel launch shape (ops/pallas_bvh.launch_config)
    block: int = 0
    num_warps: int = 0
    # run the traversal kernel in the Pallas interpreter (CPU)
    interpret: bool = False
    # diff=True: differentiable mode — the traversal's winner index is
    # detached and the hit distance recomputed in jnp from the winner's
    # plane equation, so AD reaches vertices through t.
    diff: bool = False


@dataclasses.dataclass
class MeshScene:
    """Spheres (enclosure + light) + one triangle soup with per-face
    attributes."""

    spheres: SphereScene
    vertices: np.ndarray  # [V, 3]
    faces: np.ndarray  # [F, 3]
    face_albedo: np.ndarray  # [F, 3]
    face_emission: np.ndarray  # [F, 3]
    face_material: np.ndarray  # [F] int32

    @staticmethod
    def cornell_with_mesh(
        vertices, faces, albedo=(0.75, 0.75, 0.75), emission=(0, 0, 0),
        material=DIFF, base_scene: str = "smallpt9",
    ) -> "MeshScene":
        f = np.asarray(faces).shape[0]
        return MeshScene(
            spheres=get_scene(base_scene),
            vertices=np.asarray(vertices, np.float64),
            faces=np.asarray(faces, np.int64),
            face_albedo=np.tile(np.asarray(albedo, np.float64), (f, 1)),
            face_emission=np.tile(np.asarray(emission, np.float64), (f, 1)),
            face_material=np.full((f,), material, np.int32),
        )


def mesh_scene_to_device(
    ms: MeshScene, dtype=jnp.float32, use_bvh=True, max_leaf=4,
    kernel: bool | None = None, interpret: bool = False, diff: bool = False,
):
    """MeshScene -> device pytree + static traversal config.

    Hits come from the BVH (``use_bvh=True``) or brute force.  The BVH is
    walked by the Pallas traversal kernel (ops/pallas_bvh.py) when
    ``kernel`` is true — the default on a GPU (backend.use_kernels) — and
    by the jnp ``while_loop`` (accel/bvh.intersect_bvh) otherwise.
    ``interpret=True`` runs the kernel in the Pallas interpreter (CPU).
    Triangles and face attributes are stored in the BVH's leaf order;
    ``face_order`` maps a hit id back to the input face.  The static
    config rides in dev["static"]; wrappers strip it before jit.
    """
    np_dtype = np.float64 if dtype == jnp.float64 else np.float32
    sph = megakernel.scene_to_device(ms.spheres, dtype)
    v = np.asarray(ms.vertices, np_dtype)
    f = np.asarray(ms.faces)
    if kernel is None:
        kernel = use_bvh and backend.use_kernels()
    if kernel and not use_bvh:
        raise ValueError("the traversal kernel walks a BVH: use_bvh=True")

    if use_bvh:
        bvh = bvh_mod.build_bvh(v, f, max_leaf=max_leaf)
        order = bvh.tri_order
        bvh_dev = bvh_mod.bvh_to_device(bvh, dtype)
        lo, hi = bvh.bmin[0], bvh.bmax[0]
    else:
        order = np.arange(f.shape[0])
        bvh_dev = None
        lo, hi = v.min(axis=0), v.max(axis=0)
    planes = tri_mod.triangle_planes(v, f, dtype=np_dtype)
    v0, e1, e2 = (tuple(jnp.asarray(p[order]) for p in t) for t in planes)
    # geometric face normals (normalize(e1 x e2)), in leaf order
    e1n = np.stack([np.asarray(c) for c in e1], 1)
    e2n = np.stack([np.asarray(c) for c in e2], 1)
    fn = np.cross(e1n, e2n)
    fn /= np.maximum(np.linalg.norm(fn, axis=1, keepdims=True), 1e-30)

    tables = None
    block = warps = 0
    if kernel:
        backend.check_kernel_target(interpret)
        tables = pallas_bvh.pack_bvh(
            bvh, tuple(tuple(p[order] for p in t) for t in planes)
        )
        block, warps = pallas_bvh.launch_config(
            tables, max_leaf=max_leaf, interpret=interpret
        )
    traversal = "kernel" if kernel else ("jnp" if use_bvh else "brute")
    return {
        "spheres": sph,
        "v0": v0,
        "e1": e1,
        "e2": e2,
        "fnormal": tuple(jnp.asarray(fn[:, i], dtype) for i in range(3)),
        "f_albedo": tuple(jnp.asarray(ms.face_albedo[order][:, i], dtype) for i in range(3)),
        "f_emission": tuple(jnp.asarray(ms.face_emission[order][:, i], dtype) for i in range(3)),
        "f_material": jnp.asarray(ms.face_material[order], jnp.int32),
        "face_order": jnp.asarray(order, jnp.int32),
        "bounds": (jnp.asarray(lo, dtype), jnp.asarray(hi, dtype)),
        "bvh": bvh_dev,
        "bvh_tables": tables,
        "static": StaticConf(traversal, max_leaf if use_bvh else 0, block,
                             warps, interpret, diff),
    }


def _split_static(dev):
    return {k: v for k, v in dev.items() if k != "static"}, dev["static"]


def _mesh_hit(o3, d3, dev, eps, static: StaticConf):
    """Nearest triangle hit via the Pallas traversal kernel, the jnp
    while_loop traversal, or brute force.  Returns (tmin, hit, miss);
    hit ids index the leaf-ordered triangle planes of ``dev``."""
    if static.traversal == "brute":
        ts = tri_mod.intersect_triangles_brute(
            o3, d3, dev["v0"], dev["e1"], dev["e2"], eps
        )
        tmin = jnp.min(ts, axis=0)
        hit = jnp.argmin(ts, axis=0).astype(jnp.int32)
        return tmin, hit, tmin >= jnp.asarray(MISS_T, tmin.dtype)

    # pallas_call has no AD rule and while_loop none in reverse mode, so
    # the kernel — and the jnp walk in differentiable mode — produce
    # DETACHED decisions; the recompute below carries the tangents
    detach = static.traversal == "kernel" or static.diff
    stop = jax.lax.stop_gradient if detach else (lambda x: x)
    o3s = tuple(stop(c) for c in o3)
    d3s = tuple(stop(c) for c in d3)
    if static.traversal == "kernel":
        rp = jnp.stack([*o3s, *d3s], axis=0).astype(jnp.float32)
        tmin, hit = pallas_bvh.intersect_bvh_pallas(
            rp, *dev["bvh_tables"], max_leaf=static.max_leaf, eps=eps,
            block=static.block, num_warps=static.num_warps,
            interpret=static.interpret,
        )
        tmin = tmin.astype(o3[0].dtype)
    else:
        geom = tuple(tuple(stop(c) for c in dev[k]) for k in ("v0", "e1", "e2"))
        tmin, hit, _ = bvh_mod.intersect_bvh(
            o3s, d3s, dev["bvh"], geom, eps, static.max_leaf
        )
    miss = tmin >= jnp.asarray(MISS_T, tmin.dtype)
    if static.diff:
        # Detach-discrete, differentiate-continuous (SURVEY §7 phase 4
        # applied to meshes): the winner index is the discrete decision;
        # t is recomputed from the winner's plane equation in jnp — the
        # same value to rounding — so gradients flow to the v0/e1/e2
        # planes (and through them to traced vertices, diff/mesh.py).
        v0g = tuple(p[hit] for p in dev["v0"])
        e1g = tuple(p[hit] for p in dev["e1"])
        e2g = tuple(p[hit] for p in dev["e2"])
        nx = e1g[1] * e2g[2] - e1g[2] * e2g[1]
        ny = e1g[2] * e2g[0] - e1g[0] * e2g[2]
        nz = e1g[0] * e2g[1] - e1g[1] * e2g[0]
        d0 = nx * v0g[0] + ny * v0g[1] + nz * v0g[2]
        no = nx * o3[0] + ny * o3[1] + nz * o3[2]
        nd = nx * d3[0] + ny * d3[1] + nz * d3[2]
        # double-where: missed lanes carry garbage ids whose nd can be 0 —
        # guard the denominator so no nan reaches the grad
        nd = jnp.where(miss, jnp.ones_like(nd), nd)
        tmin = jnp.where(miss, jnp.asarray(MISS_T, tmin.dtype), (d0 - no) / nd)
    return tmin, hit, miss


def first_hit_mesh_impl(rays, dev, *, eps=1e-4, static=StaticConf("brute")):
    """Debug/oracle render: first-hit t and kind (0=miss, 1=sphere,
    2=triangle). Used to validate BVH-in-renderer against brute force."""
    o3, d3 = megakernel.rays_to_soa(rays)
    st, sh, sm = megakernel.default_hit_fn(o3, d3, dev["spheres"], eps)
    tt, th, tm = _mesh_hit(o3, d3, dev, eps, static)
    tri_closer = tt < st
    kind = jnp.where(
        tri_closer, jnp.where(tm, 0, 2), jnp.where(sm, 0, 1)
    )
    tmin = jnp.minimum(st, tt)
    return tmin, kind, jnp.where(tri_closer, th, sh)


# re-exported for callers that found it here first; the shared
# implementation lives beside the sphere estimator
indexed_uniforms = megakernel.indexed_uniforms


def render_pt_mesh_impl(
    key, rays, dev, *, bounces: int = 8, rr_depth: int = 5, eps: float = 1e-4,
    static: StaticConf = StaticConf("brute"), uniforms=None, global_idx=None,
):
    """smallpt estimator over spheres + mesh. Same structure as
    megakernel.render_pt_impl with a two-way nearest-hit combine.

    ``uniforms`` ([bounces, 3, N], optional) replaces the in-loop
    ``jax.random`` draws with a caller-supplied stream — what makes the
    DP-sharded render (parallel/sharded.py) BIT-EQUAL to this one: the
    stream is drawn once at global size and sharded with the rays, so
    shard boundaries cannot perturb the samples.

    ``global_idx`` ([N] i32, optional) switches to the INDEXED
    counter-based stream (:func:`indexed_uniforms`) — the production
    bitwise-sharding mode: no materialized stream, each shard passes its
    global ray indices."""
    o3, d3 = megakernel.rays_to_soa(rays)
    n = o3[0].shape[0]
    dtype = o3[0].dtype
    sph = dev["spheres"]

    cx = sph["center"][:, 0]
    cy = sph["center"][:, 1]
    cz = sph["center"][:, 2]
    sax, say, saz = (sph["albedo"][:, i] for i in range(3))
    sex, sey, sez = (sph["emission"][:, i] for i in range(3))
    smat = sph["material"]

    zeros = jnp.zeros((n,), dtype)
    ones = jnp.ones((n,), dtype)
    rad = (zeros, zeros, zeros)
    thru = (ones, ones, ones)
    alive = jnp.ones((n,), bool)

    def gather_f(planes, idx):
        return tuple(p[idx] for p in planes)

    def body(depth, state):
        key, o3, d3, rad, thru, alive = state
        if global_idx is not None:
            u = indexed_uniforms(key, depth, global_idx, dtype)
        elif uniforms is None:
            key, k1 = jax.random.split(key)
            u = jax.random.uniform(k1, (3, n), dtype=dtype)
        else:
            u = uniforms[depth].astype(dtype)

        st, shit, smiss = megakernel.default_hit_fn(o3, d3, sph, eps)
        tt, thit, tmiss = _mesh_hit(o3, d3, dev, eps, static)
        use_tri = tt < st
        tmin = jnp.where(use_tri, tt, st)
        miss = smiss & tmiss
        live = alive & ~miss
        shit = jnp.where(smiss, 0, shit)

        hp = (o3[0] + d3[0] * tmin, o3[1] + d3[1] * tmin, o3[2] + d3[2] * tmin)
        # sphere normal
        s_chit = (select_by_id(shit, cx), select_by_id(shit, cy), select_by_id(shit, cz))
        s_nrm = shade.v3_normalize(shade.v3_sub(hp, s_chit))
        t_nrm = gather_f(dev["fnormal"], thit)
        t_alb = gather_f(dev["f_albedo"], thit)
        t_emi = gather_f(dev["f_emission"], thit)
        t_is_diff = dev["f_material"][thit] == DIFF
        t_is_refr = dev["f_material"][thit] == REFR
        nrm = shade.v3_where(use_tri, t_nrm, s_nrm)
        dn = shade.v3_dot(d3, nrm)
        into = dn < 0
        nl = shade.v3_scale(nrm, jnp.where(into, 1.0, -1.0))

        emit_s = (select_by_id(shit, sex), select_by_id(shit, sey), select_by_id(shit, sez))
        emit = shade.v3_where(use_tri, t_emi, emit_s)
        rad = shade.v3_where(
            live,
            shade.v3_add(rad, (thru[0] * emit[0], thru[1] * emit[1], thru[2] * emit[2])),
            rad,
        )

        alb_s = (select_by_id(shit, sax), select_by_id(shit, say), select_by_id(shit, saz))
        alb = shade.v3_where(use_tri, t_alb, alb_s)
        s_mat = select_by_id(shit, smat)
        is_diff = jnp.where(use_tri, t_is_diff, s_mat == DIFF)
        is_refr = jnp.where(use_tri, t_is_refr, s_mat == REFR)

        d_diff = shade.cosine_sample_hemisphere(nl, u[0], u[1])
        d_spec = shade.reflect(d3, nrm)
        d_refr, refr_scale = shade.refract_or_reflect(d3, nrm, into, u[0])

        new_d = shade.v3_where(is_diff, d_diff, shade.v3_where(is_refr, d_refr, d_spec))
        scale = jnp.where(is_refr, refr_scale, 1.0)
        thru2 = shade.v3_where(
            live,
            (thru[0] * alb[0] * scale, thru[1] * alb[1] * scale, thru[2] * alb[2] * scale),
            thru,
        )

        thru_rr, survive = shade.russian_roulette(thru2, u[2])
        do_rr = depth >= rr_depth
        thru2 = shade.v3_where(do_rr, thru_rr, thru2)
        alive2 = live & jnp.where(do_rr, survive, True)

        # scale-aware offset for sphere winners (wall spheres: f32 hit
        # error ~r * 1e-6 — see shade.scaled_origin_offset); triangle
        # winners are scene-scale, keep the eps floor via r2 = 0
        r2w = jnp.where(use_tri, 0.0, select_by_id(shit, sph["r2"]))
        off = jnp.where(is_refr, 0.0, shade.scaled_origin_offset(r2w, eps))
        new_o = shade.v3_add(hp, shade.v3_scale(nl, off))
        o3 = shade.v3_where(live, new_o, o3)
        d3 = shade.v3_where(live, new_d, d3)
        return key, o3, d3, rad, thru2, alive2

    body_ckpt = jax.checkpoint(lambda depth, st: body(depth, st))
    state = (key, o3, d3, rad, thru, alive)
    state = jax.lax.fori_loop(0, bounces, body_ckpt, state, unroll=True)
    return jnp.stack(state[3], axis=1)


_render_pt_mesh_jit = jax.jit(
    render_pt_mesh_impl,
    static_argnames=("bounces", "rr_depth", "eps", "static"),
)
_first_hit_mesh_jit = jax.jit(
    first_hit_mesh_impl, static_argnames=("eps", "static")
)


def render_pt_mesh(key, rays, dev, **kw):
    """Jitted combined-scene path trace; strips the static traversal
    config out of the device pytree."""
    traced, static = _split_static(dev)
    return _render_pt_mesh_jit(key, rays, traced, static=static, **kw)


def first_hit_mesh(rays, dev, **kw):
    """Jitted first-hit query (see first_hit_mesh_impl)."""
    traced, static = _split_static(dev)
    return _first_hit_mesh_jit(rays, traced, static=static, **kw)
