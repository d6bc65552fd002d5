"""Wavefront path tracer with ray compaction and regeneration.

The north-star upgrade over the reference's carry-dead-rays masking
(rt_helper.h:787-810): a persistent ray pool of static size P streams the
whole sample set (BASELINE config 2: 1024x1024 x 64 spp) through
per-bounce passes; dead rays are compacted out (stable sort on the alive
mask) and their slots refilled with fresh camera samples generated
on-device from the global sample counter.

Why it exists: each pool iteration pays a fixed cost (a multi-operand
compaction sort + scatter-add + camera regen), which the megakernel
renderers avoid; but the pool streams an unbounded sample stream at a
fixed memory footprint, so it is the architecture for sample sets that
do not fit the device as one batch.  Megakernel vs wavefront on the GPU:
not measured.  Both renderers share ops/; bench.py measures all of
them.  Sample
accumulation uses one scatter-add per iteration (dying rays -> their
pixel), the only scatter in the framework.

RNG: each sample's jitter/BSDF draws derive from fold_in(key, global
sample index), so results are independent of pool size, iteration order
and compaction permutation — and identical across shardings (SURVEY §7
hard-part 6).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ascendpathtracing.camera import Camera
from ascendpathtracing.models import megakernel
from ascendpathtracing.models.megakernel import select_by_id
from ascendpathtracing.ops import shade
from ascendpathtracing.scenes import DIFF, REFR


def _sample_camera_rays(sample_idx, width, height, spp4, key, cam: Camera, dtype):
    """Camera ray for global sample indices [P] (on-device, RNG keyed by
    sample index). Layout matches camera.generate_rays_numpy: index =
    ((i*h + j)*2 + sy)*2*s + sx*s + k."""
    import numpy as np

    pos, d0, cx, cy = cam.basis(width, height)
    s = spp4 // 4
    idx = sample_idx
    sx = (idx // s) % 2
    sy = (idx // (2 * s)) % 2
    j_idx = (idx // (4 * s)) % height
    i_idx = idx // (4 * s * height)

    bits = jax.random.fold_in(key, 0)
    # per-sample independent uniforms via threefry on the index
    u = jax.vmap(lambda i: jax.random.uniform(jax.random.fold_in(bits, i), (2,),
                                              dtype=dtype))(idx)
    r1 = 2.0 * u[:, 0]
    r2 = 2.0 * u[:, 1]
    dx = jnp.where(r1 < 1, jnp.sqrt(r1) - 1, 1 - jnp.sqrt(jnp.maximum(2 - r1, 0)))
    dy = jnp.where(r2 < 1, jnp.sqrt(r2) - 1, 1 - jnp.sqrt(jnp.maximum(2 - r2, 0)))

    su = ((sx + 0.5 + dx) / 2.0 + i_idx) / width - 0.5
    sv = ((sy + 0.5 + dy) / 2.0 + j_idx) / height - 0.5
    cxj, d0j, cyj, posj = (jnp.asarray(v, dtype) for v in (cx, d0, cy, pos))
    ddx = su * cxj[0] + sv * cyj[0] + d0j[0]
    ddy = su * cxj[1] + sv * cyj[1] + d0j[1]
    ddz = su * cxj[2] + sv * cyj[2] + d0j[2]
    ox = posj[0] + ddx * cam.origin_push
    oy = posj[1] + ddy * cam.origin_push
    oz = posj[2] + ddz * cam.origin_push
    inv = jax.lax.rsqrt(ddx * ddx + ddy * ddy + ddz * ddz)
    pixel = (i_idx * height + j_idx).astype(jnp.int32)
    sample_in_pixel = (idx % (4 * s)).astype(jnp.int32)
    return (ox, oy, oz), (ddx * inv, ddy * inv, ddz * inv), pixel, sample_in_pixel


@partial(
    jax.jit,
    static_argnames=(
        "width", "height", "spp4", "pool", "bounces", "rr_depth", "eps",
        "compact",
    ),
)
def render_wavefront(
    key,
    scene: dict,
    *,
    width: int,
    height: int,
    spp4: int,  # samples per pixel (the reference counts 4*samples)
    pool: int = 1 << 18,
    bounces: int = 8,
    rr_depth: int = 5,
    eps: float = 1e-4,
    compact: bool = True,
):
    """Full-frame wavefront render.

    Returns accumulated radiance [width*height*spp4 grouped by pixel]:
    shape [W*H, 3] (per-pixel MEAN over its spp4 samples).
    """
    total = width * height * spp4
    n_pix = width * height
    dtype = jnp.float32
    cam = Camera()

    cx, cy, cz = megakernel._scene_planes(scene, "center")
    ax, ay, az = megakernel._scene_planes(scene, "albedo")
    ex, ey, ez = megakernel._scene_planes(scene, "emission")
    material = scene["material"]

    p = pool

    def fresh(idx_base, count_key):
        sidx = idx_base
        o3, d3, pixel, _ = _sample_camera_rays(
            sidx, width, height, spp4, count_key, cam, dtype
        )
        valid = sidx < total
        return o3, d3, pixel, valid

    if total > p and not compact:
        raise ValueError("compact=False requires pool >= total samples")

    key0 = key
    # initial fill
    o3, d3, pixel, valid = fresh(jnp.arange(p), key0)
    thru = tuple(jnp.ones((p,), dtype) for _ in range(3))
    rad = tuple(jnp.zeros((p,), dtype) for _ in range(3))
    depth = jnp.zeros((p,), jnp.int32)
    alive = valid
    image = jnp.zeros((n_pix, 3), dtype)
    next_sample = jnp.asarray(p, jnp.int32)

    def cond(st):
        return jnp.any(st[0])

    def body(st):
        (alive, o3, d3, pixel, thru, rad, depth, image, next_sample, key) = st
        key, k1 = jax.random.split(key)
        u = jax.random.uniform(k1, (3, p), dtype=dtype)

        tmin, hit, miss = megakernel.default_hit_fn(o3, d3, scene, eps)
        live = alive & ~miss
        hit = jnp.where(miss, 0, hit)

        hp = (o3[0] + d3[0] * tmin, o3[1] + d3[1] * tmin, o3[2] + d3[2] * tmin)
        chit = (select_by_id(hit, cx), select_by_id(hit, cy), select_by_id(hit, cz))
        nrm = shade.v3_normalize(shade.v3_sub(hp, chit))
        dn = shade.v3_dot(d3, nrm)
        into = dn < 0
        nl = shade.v3_scale(nrm, jnp.where(into, 1.0, -1.0))

        emit = (select_by_id(hit, ex), select_by_id(hit, ey), select_by_id(hit, ez))
        rad = shade.v3_where(
            live,
            shade.v3_add(rad, (thru[0] * emit[0], thru[1] * emit[1], thru[2] * emit[2])),
            rad,
        )

        alb = (select_by_id(hit, ax), select_by_id(hit, ay), select_by_id(hit, az))
        mat = select_by_id(hit, material)
        is_diff = mat == DIFF
        is_refr = mat == REFR

        d_diff = shade.cosine_sample_hemisphere(nl, u[0], u[1])
        d_spec = shade.reflect(d3, nrm)
        d_refr, refr_scale = shade.refract_or_reflect(d3, nrm, into, u[0])
        new_d = shade.v3_where(is_diff, d_diff, shade.v3_where(is_refr, d_refr, d_spec))
        scale = jnp.where(is_refr, refr_scale, 1.0)
        thru = shade.v3_where(
            live,
            (thru[0] * alb[0] * scale, thru[1] * alb[1] * scale, thru[2] * alb[2] * scale),
            thru,
        )

        depth = depth + jnp.where(live, 1, 0)
        thru_rr, survive = shade.russian_roulette(thru, u[2])
        do_rr = depth > rr_depth
        thru = shade.v3_where(do_rr, thru_rr, thru)
        continue_ray = live & (depth < bounces) & jnp.where(do_rr, survive, True)

        # scale-aware offset (shade.scaled_origin_offset rationale)
        r2w = select_by_id(hit, scene["r2"])
        off = jnp.where(is_refr, 0.0, shade.scaled_origin_offset(r2w, eps))
        new_o = shade.v3_add(hp, shade.v3_scale(nl, off))
        o3 = shade.v3_where(live, new_o, o3)
        d3 = shade.v3_where(live, new_d, d3)

        # ---- retire finished rays into the image (the one scatter) ----
        died = alive & ~continue_ray
        contrib = shade.v3_where(died, rad, (0.0 * rad[0],) * 3)
        image = image.at[pixel].add(
            jnp.stack(contrib, axis=1), mode="drop", unique_indices=False
        )
        alive = continue_ray

        # ---- compaction + regeneration -------------------------------
        # ONE fused multi-operand lax.sort on the dead flag (same idiom
        # as the mesh wavefront): alive rays pack to the front with no
        # per-array gathers (an argsort + 13 gathers form once crashed
        # a device runtime at every pool size; tests/test_gpu.py runs
        # this program on the card).
        if compact:
            skey = jnp.where(alive, jnp.int32(0), jnp.int32(1))
            (_, ox_, oy_, oz_, dx_, dy_, dz_, tr_, tg_, tb_, rr_, rg_,
             rb_, pixel, depth) = jax.lax.sort(
                (skey, *o3, *d3, *thru, *rad, pixel, depth), num_keys=1,
                is_stable=True,
            )
            o3 = (ox_, oy_, oz_)
            d3 = (dx_, dy_, dz_)
            thru = (tr_, tg_, tb_)
            rad = (rr_, rg_, rb_)
            n_alive = jnp.sum(alive.astype(jnp.int32))
            slot = jnp.arange(p)
            alive = slot < n_alive
            refill = ~alive
            sidx = next_sample + (slot - n_alive).astype(jnp.int32)
            f_o3, f_d3, f_pix, f_valid = fresh(sidx, key0)
            o3 = shade.v3_where(refill, f_o3, o3)
            d3 = shade.v3_where(refill, f_d3, d3)
            thru = shade.v3_where(refill, (jnp.ones((p,), dtype),) * 3, thru)
            rad = shade.v3_where(refill, (jnp.zeros((p,), dtype),) * 3, rad)
            pixel = jnp.where(refill, f_pix, pixel)
            depth = jnp.where(refill, 0, depth)
            alive = jnp.where(refill, f_valid, alive)
            next_sample = next_sample + jnp.sum(refill & f_valid, dtype=jnp.int32)

        return (alive, o3, d3, pixel, thru, rad, depth, image, next_sample, key)

    st = (alive, o3, d3, pixel, thru, rad, depth, image, next_sample, key)
    st = jax.lax.while_loop(cond, body, st)
    image = st[7]
    return image / spp4


@partial(
    jax.jit,
    static_argnames=(
        "width", "height", "spp4", "pool", "bounces", "rr_depth", "eps",
        "static", "coherence_sort", "sort_every",
    ),
)
def _render_wavefront_mesh_impl(
    key,
    dev: dict,
    *,
    width: int,
    height: int,
    spp4: int,
    pool: int,
    bounces: int,
    rr_depth: int,
    eps: float,
    static,
    coherence_sort: bool,
    sort_every: int,
):
    from ascendpathtracing.models import mesh as mesh_mod
    from ascendpathtracing.ops import sort as sort_mod
    from ascendpathtracing.scenes import DIFF as _DIFF, REFR as _REFR

    total = width * height * spp4
    n_pix = width * height
    dtype = jnp.float32
    cam = Camera()
    p = pool

    sph = dev["spheres"]
    cx, cy, cz = megakernel._scene_planes(sph, "center")
    sax, say, saz = megakernel._scene_planes(sph, "albedo")
    sex, sey, sez = megakernel._scene_planes(sph, "emission")
    smat = sph["material"]

    lo, hi = dev["bounds"]

    def fresh(sidx, count_key):
        o3, d3, pixel, _ = _sample_camera_rays(
            sidx, width, height, spp4, count_key, cam, dtype
        )
        return o3, d3, pixel, sidx < total

    key0 = key
    o3, d3, pixel, valid = fresh(jnp.arange(p), key0)
    thru = tuple(jnp.ones((p,), dtype) for _ in range(3))
    rad = tuple(jnp.zeros((p,), dtype) for _ in range(3))
    depth = jnp.zeros((p,), jnp.int32)
    alive = valid
    # NOTE r3: a standalone microbench showed 3 x 1-D scatter-adds 12x
    # faster than one [N, 3] scatter, but IN-GRAPH the [N, 3] form gets a
    # kCustom fused lowering that measured ~10%% faster end-to-end — keep
    # the fused form; re-check if the scatter lowering changes.
    image = jnp.zeros((n_pix, 3), dtype)
    next_sample = jnp.asarray(p, jnp.int32)

    def cond(st):
        # off-iterations (sort_every > 1) may briefly leave the pool
        # all-dead while samples remain unseeded — keep going until the
        # stream is exhausted AND the pool drains
        return jnp.any(st[0]) | (st[8] < total)

    def body(st):
        (alive, o3, d3, pixel, thru, rad, depth, image, next_sample, key,
         it) = st
        key, k1 = jax.random.split(key)
        u = jax.random.uniform(k1, (3, p), dtype=dtype)

        # dead lanes must not drag chunk unions through the traversal:
        # park them on a ray that misses every box immediately (origin
        # far outside, direction away — tfar < 0 fails every slab)
        o3m = tuple(jnp.where(alive, c, dtype(1e7)) for c in o3)
        d3m = tuple(jnp.where(alive, c, dtype(1.0)) for c in d3)
        st_, shit, smiss = megakernel.default_hit_fn(o3m, d3m, sph, eps)
        tt, thit, tmiss = mesh_mod._mesh_hit(o3m, d3m, dev, eps, static)
        use_tri = tt < st_
        tmin = jnp.where(use_tri, tt, st_)
        miss = smiss & tmiss
        live = alive & ~miss
        shit = jnp.where(smiss, 0, shit)

        hp = (o3[0] + d3[0] * tmin, o3[1] + d3[1] * tmin, o3[2] + d3[2] * tmin)
        s_chit = (select_by_id(shit, cx), select_by_id(shit, cy),
                  select_by_id(shit, cz))
        s_nrm = shade.v3_normalize(shade.v3_sub(hp, s_chit))
        t_nrm = tuple(pl_[thit] for pl_ in dev["fnormal"])
        t_alb = tuple(pl_[thit] for pl_ in dev["f_albedo"])
        t_emi = tuple(pl_[thit] for pl_ in dev["f_emission"])
        t_is_diff = dev["f_material"][thit] == _DIFF
        t_is_refr = dev["f_material"][thit] == _REFR
        nrm = shade.v3_where(use_tri, t_nrm, s_nrm)
        dn = shade.v3_dot(d3, nrm)
        into = dn < 0
        nl = shade.v3_scale(nrm, jnp.where(into, 1.0, -1.0))

        emit_s = (select_by_id(shit, sex), select_by_id(shit, sey),
                  select_by_id(shit, sez))
        emit = shade.v3_where(use_tri, t_emi, emit_s)
        rad = shade.v3_where(
            live,
            shade.v3_add(rad, (thru[0] * emit[0], thru[1] * emit[1],
                               thru[2] * emit[2])),
            rad,
        )

        alb_s = (select_by_id(shit, sax), select_by_id(shit, say),
                 select_by_id(shit, saz))
        alb = shade.v3_where(use_tri, t_alb, alb_s)
        s_mat = select_by_id(shit, smat)
        is_diff = jnp.where(use_tri, t_is_diff, s_mat == _DIFF)
        is_refr = jnp.where(use_tri, t_is_refr, s_mat == _REFR)

        d_diff = shade.cosine_sample_hemisphere(nl, u[0], u[1])
        d_spec = shade.reflect(d3, nrm)
        d_refr, refr_scale = shade.refract_or_reflect(d3, nrm, into, u[0])
        new_d = shade.v3_where(
            is_diff, d_diff, shade.v3_where(is_refr, d_refr, d_spec)
        )
        scale = jnp.where(is_refr, refr_scale, 1.0)
        thru = shade.v3_where(
            live,
            (thru[0] * alb[0] * scale, thru[1] * alb[1] * scale,
             thru[2] * alb[2] * scale),
            thru,
        )

        depth = depth + jnp.where(live, 1, 0)
        thru_rr, survive = shade.russian_roulette(thru, u[2])
        do_rr = depth > rr_depth
        thru = shade.v3_where(do_rr, thru_rr, thru)
        continue_ray = live & (depth < bounces) & jnp.where(do_rr, survive, True)

        # scale-aware offset for sphere winners; triangle winners keep
        # the eps floor via r2 = 0 (shade.scaled_origin_offset rationale)
        r2w = jnp.where(use_tri, 0.0, select_by_id(shit, sph["r2"]))
        off = jnp.where(is_refr, 0.0, shade.scaled_origin_offset(r2w, eps))
        new_o = shade.v3_add(hp, shade.v3_scale(nl, off))
        o3 = shade.v3_where(live, new_o, o3)
        d3 = shade.v3_where(live, new_d, d3)

        died = alive & ~continue_ray
        contrib = shade.v3_where(died, rad, (0.0 * rad[0],) * 3)
        image = image.at[pixel].add(
            jnp.stack(contrib, axis=1), mode="drop", unique_indices=False
        )
        alive = continue_ray

        # ---- fused compaction (+ coherence) sort + regeneration ------
        # ONE multi-operand lax.sort does compaction AND Morton
        # grouping: key = dead-flag (bit 30) | 6-D direction+origin
        # Morton code (30 bits).  Alive rays pack to the front in
        # traversal-coherent order (neighbouring lanes then walk
        # similar BVH paths).
        # With sort_every > 1 the sort/refill runs on every k-th round
        # only — dead lanes idle briefly (parked on the instant-miss ray
        # above, so they cost nothing in the traversal) and the sort +
        # camera-regen overheads amortize over k bounces.
        def compact(carry):
            alive, o3, d3, pixel, thru, rad, depth, next_sample = carry
            if coherence_sort:
                mkey = sort_mod.ray_sort_keys_6d(o3, d3, lo, hi)
            else:
                mkey = jnp.zeros((p,), jnp.int32)
            skey = jnp.where(alive, mkey, mkey | (1 << 30))
            (_, ox_, oy_, oz_, dx_, dy_, dz_, tr_, tg_, tb_, rr_, rg_,
             rb_, pixel, depth) = jax.lax.sort(
                (skey, *o3, *d3, *thru, *rad, pixel, depth), num_keys=1,
                is_stable=True,
            )
            o3 = (ox_, oy_, oz_)
            d3 = (dx_, dy_, dz_)
            thru = (tr_, tg_, tb_)
            rad = (rr_, rg_, rb_)
            n_alive = jnp.sum(alive.astype(jnp.int32))
            slot = jnp.arange(p)
            alive = slot < n_alive
            refill = ~alive
            sidx = next_sample + (slot - n_alive).astype(jnp.int32)
            f_o3, f_d3, f_pix, f_valid = fresh(sidx, key0)
            o3 = shade.v3_where(refill, f_o3, o3)
            d3 = shade.v3_where(refill, f_d3, d3)
            thru = shade.v3_where(refill, (jnp.ones((p,), dtype),) * 3, thru)
            rad = shade.v3_where(refill, (jnp.zeros((p,), dtype),) * 3, rad)
            pixel = jnp.where(refill, f_pix, pixel)
            depth = jnp.where(refill, 0, depth)
            alive = jnp.where(refill, f_valid, alive)
            next_sample = next_sample + jnp.sum(
                refill & f_valid, dtype=jnp.int32
            )
            return (alive, o3, d3, pixel, thru, rad, depth, next_sample)

        carry = (alive, o3, d3, pixel, thru, rad, depth, next_sample)
        if sort_every == 1:
            carry = compact(carry)
        else:
            carry = jax.lax.cond(
                jax.lax.rem(it, jnp.int32(sort_every)) == sort_every - 1,
                compact, lambda c: c, carry,
            )
        (alive, o3, d3, pixel, thru, rad, depth, next_sample) = carry

        return (alive, o3, d3, pixel, thru, rad, depth, image, next_sample,
                key, it + 1)

    st = (alive, o3, d3, pixel, thru, rad, depth, image, next_sample, key,
          jnp.int32(0))
    st = jax.lax.while_loop(cond, body, st)
    return st[7] / spp4


def render_wavefront_mesh(
    key,
    mdev: dict,
    *,
    width: int,
    height: int,
    spp4: int,
    pool: int = 1 << 18,
    bounces: int = 8,
    rr_depth: int = 5,
    eps: float = 1e-4,
    coherence_sort: bool = True,
    sort_every: int = 1,
):
    """Wavefront render of a sphere+MESH scene — compaction where it was
    always supposed to matter: per-bounce work is dominated by the BVH
    traversal, so (a) dead lanes would still hold their block's walk in
    a masked megakernel, and (b) the fused compaction+Morton sort hands
    the traversal coherent blocks every bounce.

    ``mdev`` comes from mesh_scene_to_device (any traversal).  Returns
    per-pixel means
    [W*H, 3].  The pool must be a multiple of the traversal tile (2048).
    """
    from ascendpathtracing.models import mesh as mesh_mod

    if pool % 2048:
        raise ValueError(f"{pool=} must be a multiple of 2048")
    traced, static = mesh_mod._split_static(mdev)
    return _render_wavefront_mesh_impl(
        key, traced, width=width, height=height, spp4=spp4, pool=pool,
        bounces=bounces, rr_depth=rr_depth, eps=eps, static=static,
        coherence_sort=coherence_sort, sort_every=sort_every,
    )
