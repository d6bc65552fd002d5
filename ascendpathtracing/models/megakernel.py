"""The jit megakernel renderer.

The re-design of the reference's fused Ascend C kernel
(src/render.cpp): the CopyIn/Compute/CopyOut tile pipeline
(render.cpp:52-59) and the manual UB allocator (src/allocator.h) disappear
— the whole render is one traced XLA program; XLA handles fusion, tiling
and memory.  The fixed ``while depth < 5`` bounce loop
(render.cpp:141-188) becomes a ``lax.fori_loop`` with static trip count.

Layout: ray state is SoA — ten 1-D [N] planes (o, d, throughput, alive) —
mirroring the reference's RaySoA/VecSoA design (rt_helper.h:65-123) and
keeping every hot array a contiguous 1-D plane (see ops/intersect.py).
The [N, 6] / [N, 3] AoS forms appear only at the API boundary.

Two render modes (config.mode):

- :func:`render_reference` — parity with the reference kernel / oracle
  semantics (specular-only, light-mask on the light sphere, throughput x
  emission finalize; see oracle.py for the contract).
- :func:`render_pt` — the full smallpt Monte-Carlo estimator (DIFF /
  SPEC / REFR materials, emission accumulated every bounce, Russian
  roulette) — the BASELINE north-star mode.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ascendpathtracing.ops.intersect import (
    intersect_spheres_soa,
    reduce_hit_soa,
)
from ascendpathtracing.ops import shade
from ascendpathtracing.scenes import DIFF, REFR, SPEC, SphereScene


def scene_to_device(scene: SphereScene, dtype=jnp.float32) -> dict:
    """SphereScene -> pytree of device arrays.

    ``r2`` (not radius) is the stored parameter, matching the on-disk /
    reference layout (gen_data.py:109).  All float leaves are
    differentiable; ``material`` and ``light_index`` ride along as
    metadata.
    """
    return {
        "r2": jnp.asarray(scene.r2, dtype),
        "center": jnp.asarray(scene.center, dtype),
        "emission": jnp.asarray(scene.emission, dtype),
        "albedo": jnp.asarray(scene.color, dtype),
        "material": jnp.asarray(scene.material, jnp.int32),
        "light_index": int(scene.light_index),
    }


def rays_to_soa(rays):
    """[N, 6] -> (o3, d3) component tuples (the boundary transpose)."""
    return (
        (rays[:, 0], rays[:, 1], rays[:, 2]),
        (rays[:, 3], rays[:, 4], rays[:, 5]),
    )


def _scene_planes(scene, key):
    arr = scene[key]
    return (arr[:, 0], arr[:, 1], arr[:, 2])


def select_by_id(gid, plane):
    """Gather ``plane[gid]`` as an unrolled select-chain over the (small,
    static) sphere axis.  Functionally identical to ``plane[gid]`` but its
    transpose is a masked SUM instead of a scatter-add, so the whole
    backward is elementwise work and reductions that XLA fuses.
    ``gid`` must be in range."""
    s = plane.shape[0]
    acc = jnp.zeros(gid.shape, plane.dtype)
    for i in range(s):
        acc = jnp.where(gid == i, plane[i], acc)
    return acc


# ------------------------------------------------------------------------
# Reference-parity mode
# ------------------------------------------------------------------------
def default_hit_fn(o3, d3, scene: dict, eps: float):
    """Single-device nearest-hit: intersect all spheres, reduce.
    Swappable so the sharded renderer can substitute a tensor-parallel
    version (parallel/sharded.py) without duplicating the bounce loop."""
    cx, cy, cz = _scene_planes(scene, "center")
    t = intersect_spheres_soa(*o3, *d3, cx, cy, cz, scene["r2"], eps)
    return reduce_hit_soa(t)


def reference_bounce_loop(
    o3, d3, scene: dict, *, bounces, eps, hit_fn=default_hit_fn, remat=True
):
    """The reference kernel's bounce loop (render.cpp:141-196) over SoA
    ray state; see oracle.py for the semantics contract.

    Args: o3, d3 = (x, y, z) tuples of [N] planes.
    ``remat=True`` checkpoints each bounce: the backward pass recomputes
    the bounce instead of storing every intermediate — the standard
    FLOPs-for-memory trade.
    Identical values either way.
    Returns colors [N, 3] (AoS at the boundary).
    """
    n = o3[0].shape[0]
    s = scene["r2"].shape[0]
    light = scene["light_index"]
    dtype = o3[0].dtype

    cx, cy, cz = _scene_planes(scene, "center")
    ax, ay, az = _scene_planes(scene, "albedo")

    tr = jnp.ones((n,), dtype)
    tg = jnp.ones((n,), dtype)
    tb = jnp.ones((n,), dtype)
    alive = jnp.ones((n,), bool)

    def body(_, state):
        o3, d3, thru, alive = state
        tmin, hit, miss = hit_fn(o3, d3, scene, eps)
        # Miss => sphere_id -1 in the oracle, which wrap-indexes to the
        # last sphere in gathers (gen_data.py:343,390). jnp gather clamps
        # instead, so make it explicit.
        gid = jnp.where(miss, s - 1, hit)
        center_hit = (
            select_by_id(gid, cx),
            select_by_id(gid, cy),
            select_by_id(gid, cz),
        )
        o3n, d3n = shade.specular_bounce(o3, d3, tmin, center_hit)
        # Mask update BEFORE throughput multiply (gen_data.py:379-390).
        hit_light = (hit == light) & ~miss
        alive2 = alive & ~hit_light
        mult = (select_by_id(gid, ax), select_by_id(gid, ay), select_by_id(gid, az))
        thru2 = shade.v3_where(
            alive2, (thru[0] * mult[0], thru[1] * mult[1], thru[2] * mult[2]), thru
        )
        return o3n, d3n, thru2, alive2

    if remat:
        _raw_body = body
        inner = jax.checkpoint(lambda st: _raw_body(0, st))
        body = lambda _, st: inner(st)  # noqa: E731
    o3, d3, thru, alive = jax.lax.fori_loop(
        0, bounces, body, (o3, d3, (tr, tg, tb), alive), unroll=True
    )
    emi = scene["emission"][light]
    return jnp.stack([thru[0] * emi[0], thru[1] * emi[1], thru[2] * emi[2]], axis=1)


def render_reference_impl(rays, scene: dict, *, bounces: int = 5, eps: float = 1e-4):
    """Render with reference-kernel semantics.

    Args:
      rays: [N, 6] (ox oy oz dx dy dz).
      scene: pytree from :func:`scene_to_device`.

    Returns colors [N, 3] = throughput * light emission
    (render.cpp:194-196).
    """
    o3, d3 = rays_to_soa(rays)
    return reference_bounce_loop(o3, d3, scene, bounces=bounces, eps=eps)


render_reference = jax.jit(render_reference_impl, static_argnames=("bounces", "eps"))


def render_reference_hits_impl(rays, scene: dict, *, bounces: int = 5, eps: float = 1e-4):
    """Per-bounce hit decisions of the reference bounce loop.

    Returns hit ids [bounces, N] i32 (-1 on miss, -2 once the ray has
    terminated on the light and later decisions no longer affect color) —
    the discrete decision trail that determines the whole render.  Two
    runs whose trails agree on a ray produce colors that differ only by
    elementwise f32 rounding (exactly equal when op order matches); a
    differing trail is a "decision flip", the precise f32 chaos envelope
    used by the golden and parity tests."""
    o3, d3 = rays_to_soa(rays)
    scene = dict(scene)
    s = scene["r2"].shape[0]
    light = scene["light_index"]
    cx, cy, cz = _scene_planes(scene, "center")
    alive = jnp.ones(o3[0].shape, bool)
    trail = []
    for _ in range(bounces):
        tmin, hit, miss = default_hit_fn(o3, d3, scene, eps)
        decision = jnp.where(miss, -1, hit).astype(jnp.int32)
        trail.append(jnp.where(alive, decision, -2))
        alive = alive & ~((hit == light) & ~miss)
        gid = jnp.where(miss, s - 1, hit)
        center_hit = (
            select_by_id(gid, cx),
            select_by_id(gid, cy),
            select_by_id(gid, cz),
        )
        o3, d3 = shade.specular_bounce(o3, d3, tmin, center_hit)
    return jnp.stack(trail, axis=0)


render_reference_hits = jax.jit(
    render_reference_hits_impl, static_argnames=("bounces", "eps")
)


def render_depth_impl(rays, scene: dict, *, eps: float = 1e-4):
    """First-hit depth AOV: t per ray (0 on miss).

    Unlike the radiance output — which is a product of discretely-gathered
    albedos, hence piecewise CONSTANT in geometry/camera parameters — the
    depth map depends continuously on them, so it is the right observable
    for geometry/camera gradient gates (and a standard AOV for users).
    """
    o3, d3 = rays_to_soa(rays)
    tmin, hit, miss = default_hit_fn(o3, d3, scene, eps)
    return jnp.where(miss, 0.0, tmin)


render_depth = jax.jit(render_depth_impl, static_argnames=("eps",))


def render_gbuffer_impl(rays, scene: dict, *, eps: float = 1e-4):
    """First-hit G-buffer: depth, shading normal, albedo, hit id.

    The geometry AOVs double as guides for the a-trous denoiser (post.py)
    and as continuous observables for geometry/camera gradients (see
    render_depth).  Returns a dict of per-ray planes: ``depth`` [N]
    (0 on miss), ``normal`` [N, 3] (oriented against the ray; 0 on miss),
    ``albedo`` [N, 3] (0 on miss), ``hit_id`` [N] i32 (-1 on miss).
    """
    o3, d3 = rays_to_soa(rays)
    cx, cy, cz = _scene_planes(scene, "center")
    ax, ay, az = _scene_planes(scene, "albedo")
    tmin, hit, miss = default_hit_fn(o3, d3, scene, eps)
    gid = jnp.where(miss, 0, hit)
    hp = (o3[0] + d3[0] * tmin, o3[1] + d3[1] * tmin, o3[2] + d3[2] * tmin)
    chit = (select_by_id(gid, cx), select_by_id(gid, cy), select_by_id(gid, cz))
    nrm = shade.v3_normalize(shade.v3_sub(hp, chit))
    # orient against the incoming ray (outward-facing for the viewer)
    flip = jnp.where(shade.v3_dot(d3, nrm) < 0, 1.0, -1.0)
    nrm = shade.v3_scale(nrm, flip)
    live = ~miss
    zero3 = (jnp.zeros_like(tmin),) * 3
    nrm = shade.v3_where(live, nrm, zero3)
    alb = shade.v3_where(
        live,
        (select_by_id(gid, ax), select_by_id(gid, ay), select_by_id(gid, az)),
        zero3,
    )
    return {
        "depth": jnp.where(miss, 0.0, tmin),
        "normal": jnp.stack(nrm, axis=1),
        "albedo": jnp.stack(alb, axis=1),
        "hit_id": jnp.where(miss, -1, hit).astype(jnp.int32),
    }


render_gbuffer = jax.jit(render_gbuffer_impl, static_argnames=("eps",))


# ------------------------------------------------------------------------
# Full physically-based mode (north star)
# ------------------------------------------------------------------------
def indexed_uniforms(key, depth, global_idx, dtype):
    """[3, n] uniforms keyed by (bounce depth, GLOBAL ray index): the
    counter-based stream that makes sharded renders BITWISE-equal to the
    single-device render at ZERO extra memory — each shard derives its
    own slice from its global indices (SURVEY §7 hard-part 6: "per-shard
    RNG keys derived from global ray index, not from host id")."""
    kd = jax.random.fold_in(key, depth)
    keys = jax.vmap(jax.random.fold_in, in_axes=(None, 0))(kd, global_idx)
    return jax.vmap(
        lambda k: jax.random.uniform(k, (3,), dtype=dtype)
    )(keys).T


def render_pt_impl(
    key,
    rays,
    scene: dict,
    *,
    bounces: int = 8,
    rr_depth: int = 5,
    eps: float = 1e-4,
    materials_static: tuple | None = None,
    global_idx=None,
):
    """Full smallpt estimator: L = sum over bounces of throughput *
    emission(hit), with cosine-weighted diffuse, mirror and dielectric
    BSDFs and Russian roulette from ``rr_depth``.

    ``key``: a PRNG key; per-bounce subkeys are folded in, and per-ray
    streams are independent via the [N]-shaped draws (sharding-stable when
    the caller derives ``key`` from global ray indices).
    ``materials_static``: optional static tuple of the scene's material
    codes; when given, BSDF branches absent from the scene are compiled
    out (e.g. no dielectric math for glass-free scenes).
    """
    o3, d3 = rays_to_soa(rays)
    n = o3[0].shape[0]
    dtype = o3[0].dtype

    cx, cy, cz = _scene_planes(scene, "center")
    ax, ay, az = _scene_planes(scene, "albedo")
    ex, ey, ez = _scene_planes(scene, "emission")
    material = scene["material"]

    zeros = jnp.zeros((n,), dtype)
    ones = jnp.ones((n,), dtype)
    rad = (zeros, zeros, zeros)
    thru = (ones, ones, ones)
    alive = jnp.ones((n,), bool)

    def body(depth, state):
        key, o3, d3, rad, thru, alive = state
        if global_idx is not None:
            # indexed counter-based stream (see indexed_uniforms): the
            # production bitwise-sharding mode
            u = indexed_uniforms(key, depth, global_idx, dtype)
        else:
            key, k1 = jax.random.split(key)
            u = jax.random.uniform(k1, (3, n), dtype=dtype)

        tmin, hit, miss = default_hit_fn(o3, d3, scene, eps)
        live = alive & ~miss
        hit = jnp.where(miss, 0, hit)  # clamp for gathers; masked by live

        hp = (o3[0] + d3[0] * tmin, o3[1] + d3[1] * tmin, o3[2] + d3[2] * tmin)
        chit = (select_by_id(hit, cx), select_by_id(hit, cy), select_by_id(hit, cz))
        nrm = shade.v3_normalize(shade.v3_sub(hp, chit))
        dn = shade.v3_dot(d3, nrm)
        into = dn < 0
        nl = shade.v3_scale(nrm, jnp.where(into, 1.0, -1.0))

        # Accumulate emission of the surface we hit.
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

        has_diff = materials_static is None or DIFF in materials_static
        has_refr = materials_static is None or REFR in materials_static

        d_spec = shade.reflect(d3, nrm)
        d_diff = (
            shade.cosine_sample_hemisphere(nl, u[0], u[1]) if has_diff else d_spec
        )
        if has_refr:
            d_refr, refr_scale = shade.refract_or_reflect(d3, nrm, into, u[0])
        else:
            d_refr, refr_scale = d_spec, 1.0

        new_d = shade.v3_where(is_diff, d_diff, shade.v3_where(is_refr, d_refr, d_spec))
        scale = jnp.where(is_refr, refr_scale, 1.0) if has_refr else 1.0
        thru2 = shade.v3_where(
            live,
            (thru[0] * alb[0] * scale, thru[1] * alb[1] * scale, thru[2] * alb[2] * scale),
            thru,
        )

        # Russian roulette after rr_depth (unbiased).
        thru_rr, survive = shade.russian_roulette(thru2, u[2])
        do_rr = depth >= rr_depth
        thru2 = shade.v3_where(do_rr, thru_rr, thru2)
        alive2 = live & jnp.where(do_rr, survive, True)

        # Next origin: offset along the oriented normal (diffuse/specular)
        # to avoid self-intersection — scale-aware, or the f32 hit error
        # on the 1e5-radius walls leaks paths through them (see
        # shade.scaled_origin_offset); refractive rays may cross the
        # surface, keep origin at the hit point.
        r2w = select_by_id(hit, scene["r2"])
        off = jnp.where(is_refr, 0.0, shade.scaled_origin_offset(r2w, eps))
        new_o = shade.v3_add(hp, shade.v3_scale(nl, off))
        o3 = shade.v3_where(live, new_o, o3)
        d3 = shade.v3_where(live, new_d, d3)
        return key, o3, d3, rad, thru2, alive2

    state = (key, o3, d3, rad, thru, alive)
    # Per-bounce remat: backward recomputes each bounce from its input
    # state instead of storing intermediates (HBM-bound otherwise).
    # depth feeds lax.cond-free math only via `depth >= rr_depth`, which
    # must stay a traced scalar, so fold it into the carried state.
    body_ckpt = jax.checkpoint(lambda depth, st: body(depth, st))
    state = jax.lax.fori_loop(0, bounces, body_ckpt, state, unroll=True)
    rad = state[3]
    return jnp.stack(rad, axis=1)


render_pt = jax.jit(
    render_pt_impl,
    static_argnames=("bounces", "rr_depth", "eps", "materials_static"),
)


def render_pt_nee_impl(
    key,
    rays,
    scene: dict,
    *,
    bounces: int = 8,
    rr_depth: int = 5,
    eps: float = 1e-4,
):
    """Path tracing with next-event estimation (explicit light sampling).

    At every diffuse hit a direction toward the light sphere is sampled
    over its subtended cone (smallpt's explicit-lighting variant) and a
    shadow ray tests visibility; BSDF-sampled continuations then skip
    light emission at the next vertex to avoid double counting.  Large
    variance reduction at equal spp, and — unlike the pure BSDF sampler —
    the radiance depends continuously on light position/size.
    """
    o3, d3 = rays_to_soa(rays)
    n = o3[0].shape[0]
    dtype = o3[0].dtype
    light = scene["light_index"]

    cx, cy, cz = _scene_planes(scene, "center")
    ax, ay, az = _scene_planes(scene, "albedo")
    ex, ey, ez = _scene_planes(scene, "emission")
    material = scene["material"]
    lcx, lcy, lcz = cx[light], cy[light], cz[light]
    ler, leg, leb = ex[light], ey[light], ez[light]
    lr2 = scene["r2"][light]

    zeros = jnp.zeros((n,), dtype)
    ones = jnp.ones((n,), dtype)
    rad = (zeros, zeros, zeros)
    thru = (ones, ones, ones)
    alive = jnp.ones((n,), bool)
    # emission gate: 1.0 on the first vertex and after specular bounces,
    # 0.0 after a diffuse vertex (its light contribution came from NEE)
    egate = jnp.ones((n,), dtype)

    def body(depth, state):
        key, o3, d3, rad, thru, alive, egate = state
        key, k1 = jax.random.split(key)
        u = jax.random.uniform(k1, (5, n), dtype=dtype)

        tmin, hit, miss = default_hit_fn(o3, d3, scene, eps)
        live = alive & ~miss
        hit = jnp.where(miss, 0, hit)

        hp = (o3[0] + d3[0] * tmin, o3[1] + d3[1] * tmin, o3[2] + d3[2] * tmin)
        chit = (select_by_id(hit, cx), select_by_id(hit, cy), select_by_id(hit, cz))
        nrm = shade.v3_normalize(shade.v3_sub(hp, chit))
        dn = shade.v3_dot(d3, nrm)
        into = dn < 0
        nl = shade.v3_scale(nrm, jnp.where(into, 1.0, -1.0))

        # gated emission accumulation
        emit = (select_by_id(hit, ex), select_by_id(hit, ey), select_by_id(hit, ez))
        g = jnp.where(live, egate, 0.0)
        rad = shade.v3_add(
            rad, (g * thru[0] * emit[0], g * thru[1] * emit[1], g * thru[2] * emit[2])
        )

        alb = (select_by_id(hit, ax), select_by_id(hit, ay), select_by_id(hit, az))
        mat = select_by_id(hit, material)
        is_diff = mat == DIFF
        is_refr = mat == REFR

        # ---- NEE: sample the light-sphere cone from the hit point ----
        swx, swy, swz = lcx - hp[0], lcy - hp[1], lcz - hp[2]
        dist2 = swx * swx + swy * swy + swz * swz
        sw = shade.v3_normalize((swx, swy, swz))
        cos_a_max = jnp.sqrt(jnp.maximum(1.0 - lr2 / jnp.maximum(dist2, 1e-12), 0.0))
        cos_a = 1.0 - u[3] + u[3] * cos_a_max
        sin_a = jnp.sqrt(jnp.maximum(1.0 - cos_a * cos_a, 0.0))
        phi = (2.0 * jnp.pi) * u[4]
        flip = jnp.abs(sw[0]) > 0.1
        aux_v = (jnp.where(flip, 0.0, 1.0), jnp.where(flip, 1.0, 0.0), zeros)
        su_ = shade.v3_normalize(shade.v3_cross(aux_v, sw))
        sv_ = shade.v3_cross(sw, su_)
        ldir = shade.v3_normalize(
            shade.v3_add(
                shade.v3_add(
                    shade.v3_scale(su_, jnp.cos(phi) * sin_a),
                    shade.v3_scale(sv_, jnp.sin(phi) * sin_a),
                ),
                shade.v3_scale(sw, cos_a),
            )
        )
        # scale-aware offset for the shadow ray too: a shadow origin
        # inside the wall it sits on self-occludes and kills the NEE term
        r2w = select_by_id(hit, scene["r2"])
        soff = shade.scaled_origin_offset(r2w, eps)
        shadow_o = shade.v3_add(hp, shade.v3_scale(nl, soff))
        st, shit2, smiss2 = default_hit_fn(shadow_o, ldir, scene, eps)
        lit = ~smiss2 & (shit2 == light)
        ldot = jnp.maximum(shade.v3_dot(ldir, nl), 0.0)
        omega_w = 2.0 * (1.0 - cos_a_max)  # * (1/pi) * pi cancels
        w = jnp.where(live & is_diff & lit, ldot * omega_w, 0.0)
        rad = shade.v3_add(
            rad,
            (
                thru[0] * alb[0] * ler * w,
                thru[1] * alb[1] * leg * w,
                thru[2] * alb[2] * leb * w,
            ),
        )

        # ---- BSDF continuation (same as render_pt_impl) --------------
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
        egate = jnp.where(
            live & is_diff, jnp.asarray(0.0, dtype), jnp.asarray(1.0, dtype)
        )

        thru_rr, survive = shade.russian_roulette(thru, u[2])
        do_rr = depth >= rr_depth
        thru = shade.v3_where(do_rr, thru_rr, thru)
        alive = live & jnp.where(do_rr, survive, True)

        off = jnp.where(is_refr, 0.0, soff)
        new_o = shade.v3_add(hp, shade.v3_scale(nl, off))
        o3 = shade.v3_where(live, new_o, o3)
        d3 = shade.v3_where(live, new_d, d3)
        return key, o3, d3, rad, thru, alive, egate

    body_ckpt = jax.checkpoint(lambda depth, st: body(depth, st))
    state = (key, o3, d3, rad, thru, alive, egate)
    state = jax.lax.fori_loop(0, bounces, body_ckpt, state, unroll=True)
    return jnp.stack(state[3], axis=1)


render_pt_nee = jax.jit(
    render_pt_nee_impl, static_argnames=("bounces", "rr_depth", "eps")
)
