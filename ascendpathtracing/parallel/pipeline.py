"""Ring parallelism over ICI — two systolic decompositions.

1. :func:`render_reference_pipelined` — pipeline over the BOUNCE
   dimension.  Rays are SHARDED across the 'stage' axis
   (``in_specs=P('stage')``) and the ray STATE rotates around the ring
   with ``lax.ppermute``: at step s every device applies its
   ``bounces/S``-bounce chunk to whichever shard currently resides.
   After S steps each shard has passed every stage exactly once and is
   home, so outputs come out sharded ``P('stage')`` with no gather and
   no pipeline bubble.  Scene tables are REPLICATED on every stage —
   this bounds the per-device RAY working set (N/S states), not the
   scene.

2. :func:`render_reference_ring_scene` — ring over the SCENE dimension
   (the giant-scene use case; the same shape as ring-attention's
   rotating KV blocks).  Each device keeps its ray shard AND holds only
   1/S of the sphere tables; per bounce, the scene CHUNKS rotate around
   the ring while per-ray (tmin, winner-id, winner-attribute) carriers
   stay home and fold in each visiting chunk with the reference's exact
   combine (lowest global index on real ties, rt_helper.h:183-193;
   miss wraps to the LAST sphere, gen_data.py:313-321 — encoded as
   highest-index tie-break at the miss sentinel).  The min-combine is
   visit-order-independent, so the result is bit-identical to the
   single-device render regardless of which chunk arrives when.  Moving
   the scene instead of the rays costs S*(10*s/S) floats per bounce of
   ICI traffic versus the rays' N/S*13 — for big scenes with modest ray
   shards this is the bandwidth-optimal direction.

Both are verified bit-for-bit in float64 by tests/test_pipeline.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from ascendpathtracing.models.megakernel import (
    default_hit_fn,
    rays_to_soa,
    select_by_id,
)
from ascendpathtracing.ops import shade


def _bounce_chunk(state, scene, n_bounces, eps):
    """Apply ``n_bounces`` reference-semantics bounces to SoA ray state
    (o3, d3, thru, alive) — same math as megakernel.reference_bounce_loop."""
    s = scene["r2"].shape[0]
    light = scene["light_index"]
    cx, cy, cz = (scene["center"][:, i] for i in range(3))
    ax, ay, az = (scene["albedo"][:, i] for i in range(3))

    def body(_, st):
        o3, d3, thru, alive = st
        tmin, hit, miss = default_hit_fn(o3, d3, scene, eps)
        gid = jnp.where(miss, s - 1, hit)
        center_hit = (select_by_id(gid, cx), select_by_id(gid, cy), select_by_id(gid, cz))
        o3n, d3n = shade.specular_bounce(o3, d3, tmin, center_hit)
        hit_light = (hit == light) & ~miss
        alive2 = alive & ~hit_light
        mult = (select_by_id(gid, ax), select_by_id(gid, ay), select_by_id(gid, az))
        thru2 = shade.v3_where(
            alive2, (thru[0] * mult[0], thru[1] * mult[1], thru[2] * mult[2]), thru
        )
        return o3n, d3n, thru2, alive2

    return lax.fori_loop(0, n_bounces, body, state, unroll=True)


def render_reference_pipelined(
    rays,
    scene: dict,
    mesh: Mesh,
    *,
    bounces: int = 8,
    eps: float = 1e-4,
    axis: str = "stage",
    microbatches: int | None = None,  # accepted for CLI/back-compat; unused
):
    """Reference-mode render ring-pipelined over a 1-D ('stage',) mesh.

    rays [N, 6]; N must divide by the stage count (the shards), bounces
    must divide by the stage count. Returns colors [N, 3], sharded
    P('stage') over the same mesh.
    """
    n = rays.shape[0]
    n_stages = mesh.shape[axis]
    if bounces % n_stages:
        raise ValueError(f"{bounces=} not divisible by {n_stages=} stages")
    if n % n_stages:
        raise ValueError(f"{n=} rays not divisible by {n_stages=} stages")
    per_stage = bounces // n_stages
    dtype = rays.dtype

    def body(rays_sh, scene):
        o3, d3 = rays_to_soa(rays_sh)
        m = o3[0].shape[0]
        ones = jnp.ones((m,), dtype)
        state = (o3, d3, (ones, ones, ones), jnp.ones((m,), bool))
        fwd = [(i, (i + 1) % n_stages) for i in range(n_stages)]

        def step(_s, st):
            st = _bounce_chunk(st, scene, per_stage, eps)
            # hand the ray state to the next stage over ICI; after
            # n_stages rotations every shard is home again
            return jax.tree.map(lambda x: lax.ppermute(x, axis, fwd), st)

        state = lax.fori_loop(0, n_stages, step, state)
        emi = scene["emission"][scene["light_index"]]
        thru = state[2]
        return jnp.stack(
            [thru[0] * emi[0], thru[1] * emi[1], thru[2] * emi[2]], axis=1
        )

    f = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(axis), P()),
        out_specs=P(axis),
        check_vma=False,
    )
    return jax.jit(f)(rays, scene)


def render_reference_ring_scene(
    rays,
    scene: dict,
    mesh: Mesh,
    *,
    bounces: int = 8,
    eps: float = 1e-4,
    axis: str = "stage",
):
    """Reference-mode render with the SCENE sharded 1/S per device and
    rotated around the ring (see module docstring, decomposition 2).

    rays [N, 6] sharded P(axis); sphere tables sharded P(axis) on the
    sphere axis.  N and the sphere count must divide by the stage count.
    Returns colors [N, 3], sharded P(axis), bit-equal to
    ``megakernel.render_reference``.
    """
    from ascendpathtracing.ops.intersect import (
        MISS_T,
        intersect_spheres_soa,
    )

    n = rays.shape[0]
    n_stages = mesh.shape[axis]
    s = scene["r2"].shape[0]
    if n % n_stages:
        raise ValueError(f"{n=} rays not divisible by {n_stages=} stages")
    if s % n_stages:
        raise ValueError(f"{s=} spheres not divisible by {n_stages=} stages")
    s_local = s // n_stages
    light = int(scene["light_index"])
    dtype = rays.dtype
    fwd = [(i, (i + 1) % n_stages) for i in range(n_stages)]

    def body(rays_sh, r2_l, center_l, albedo_l, emission_l):
        o3, d3 = rays_to_soa(rays_sh)
        m = o3[0].shape[0]
        ones = jnp.ones((m,), dtype)
        me = lax.axis_index(axis)

        # the light's emission, broadcast from whichever stage holds it
        has_light = (light >= me * s_local) & (light < (me + 1) * s_local)
        row = jnp.clip(light - me * s_local, 0, s_local - 1)
        emi = jnp.where(has_light, 1.0, 0.0) * lax.dynamic_index_in_dim(
            emission_l, row, 0, keepdims=False
        )
        emi = lax.psum(emi, axis)

        def bounce_body(_, st):
            o3, d3, thru, alive = st
            miss_t = jnp.asarray(MISS_T, dtype)
            zeros = jnp.zeros((m,), dtype)
            # rotating part: (scene chunk + its global base); resident
            # part: per-ray winner carriers (t, global id, center xyz,
            # albedo xyz)
            ring = (r2_l, center_l, albedo_l,
                    (me * s_local).astype(jnp.int32))
            carry = (jnp.full((m,), jnp.inf, dtype),
                     jnp.full((m,), -1, jnp.int32),
                     zeros, zeros, zeros, zeros, zeros, zeros)

            def ring_step(r, state):
                (r2c, cenc, albc, base), (tmin, wgid, wcx, wcy, wcz,
                                          wax, way, waz) = state
                t = intersect_spheres_soa(
                    *o3, *d3, cenc[:, 0], cenc[:, 1], cenc[:, 2], r2c, eps
                )  # [s_local, m]
                hit_l = jnp.argmin(t, axis=0).astype(jnp.int32)
                tmin_l = jnp.min(t, axis=0)
                miss_l = tmin_l >= miss_t
                # reference miss-wrap: defaulted index = the LAST sphere
                # (globally s-1) -> locally the chunk's last row, and the
                # at-miss tie-break below keeps the highest global id
                gid_attr = jnp.where(miss_l, s_local - 1, hit_l)
                gid_g = base + gid_attr
                at_miss = tmin_l >= miss_t
                better = (tmin_l < tmin) | (
                    (tmin_l == tmin)
                    & jnp.where(at_miss, gid_g > wgid, gid_g < wgid)
                )
                sel = lambda tbl: jnp.take(tbl, gid_attr, axis=0)
                cen_w = sel(cenc)
                alb_w = sel(albc)
                carry2 = (
                    jnp.where(better, tmin_l, tmin),
                    jnp.where(better, gid_g, wgid),
                    jnp.where(better, cen_w[:, 0], wcx),
                    jnp.where(better, cen_w[:, 1], wcy),
                    jnp.where(better, cen_w[:, 2], wcz),
                    jnp.where(better, alb_w[:, 0], wax),
                    jnp.where(better, alb_w[:, 1], way),
                    jnp.where(better, alb_w[:, 2], waz),
                )
                ring2 = jax.tree.map(
                    lambda x: lax.ppermute(x, axis, fwd),
                    (r2c, cenc, albc, base),
                )
                return ring2, carry2

            _, carry = lax.fori_loop(0, n_stages, ring_step, (ring, carry))
            tmin, wgid, wcx, wcy, wcz, wax, way, waz = carry
            miss = tmin >= miss_t
            # reference tmin flows through the specular bounce unclamped
            # (the miss sentinel makes the hit point astronomically far,
            # exactly like the single-device path)
            tmin_b = jnp.where(miss, miss_t, tmin)
            o3n, d3n = shade.specular_bounce(o3, d3, tmin_b, (wcx, wcy, wcz))
            hit_light = (wgid == light) & ~miss
            alive2 = alive & ~hit_light
            thru2 = shade.v3_where(
                alive2, (thru[0] * wax, thru[1] * way, thru[2] * waz), thru
            )
            return o3n, d3n, thru2, alive2

        state = (o3, d3, (ones, ones, ones), jnp.ones((m,), bool))
        state = lax.fori_loop(0, bounces, bounce_body, state, unroll=True)
        thru = state[2]
        return jnp.stack(
            [thru[0] * emi[0], thru[1] * emi[1], thru[2] * emi[2]], axis=1
        )

    f = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis, None), P(axis, None),
                  P(axis, None)),
        out_specs=P(axis),
        check_vma=False,
    )
    return jax.jit(f)(
        rays, scene["r2"], scene["center"], scene["albedo"], scene["emission"]
    )


def render_pt_ring_scene(
    key,
    rays,
    scene: dict,
    mesh: Mesh,
    *,
    bounces: int = 8,
    rr_depth: int = 5,
    eps: float = 1e-4,
    axis: str = "stage",
):
    """FULL path-tracing estimator (diffuse/mirror/glass + Russian
    roulette — megakernel.render_pt semantics) with the scene sharded
    1/S per device and rotated around the ring.

    Extends :func:`render_reference_ring_scene` to the PT shading model:
    the rotating nearest-hit carry additionally transports the winner's
    emission and material one-hots, and shading runs locally per shard.
    The per-bounce uniform stream is drawn ONCE at global size from
    ``key`` — replicating render_pt_impl's split sequence exactly — and
    sharded with the rays, so the result is BITWISE-EQUAL to the
    single-device render (tests/test_pipeline.py).  Miss-lane carrier
    values are immaterial: every consumer is ``live``-gated, exactly as
    in the single-device body.
    """
    from ascendpathtracing.ops.intersect import (
        MISS_T,
        intersect_spheres_soa,
    )
    from ascendpathtracing.scenes import DIFF, REFR

    n = rays.shape[0]
    n_stages = mesh.shape[axis]
    s = scene["r2"].shape[0]
    if n % n_stages:
        raise ValueError(f"{n=} rays not divisible by {n_stages=} stages")
    if s % n_stages:
        raise ValueError(f"{s=} spheres not divisible by {n_stages=} stages")
    s_local = s // n_stages
    dtype = rays.dtype
    fwd = [(i, (i + 1) % n_stages) for i in range(n_stages)]

    # the exact uniform sequence render_pt_impl would draw
    ks = []
    k = key
    for _ in range(bounces):
        k, k1 = jax.random.split(k)
        ks.append(k1)
    u_all = jnp.stack(
        [jax.random.uniform(k1, (3, n), dtype=dtype) for k1 in ks]
    )  # [bounces, 3, N]

    def body(rays_sh, u_sh, r2_l, center_l, albedo_l, emission_l, mat_l):
        o3, d3 = rays_to_soa(rays_sh)
        m = o3[0].shape[0]
        me = lax.axis_index(axis)
        zeros = jnp.zeros((m,), dtype)
        ones = jnp.ones((m,), dtype)
        miss_t = jnp.asarray(MISS_T, dtype)

        def bounce_body(depth, st):
            o3, d3, rad, thru, alive = st
            u = u_sh[depth]

            ring = (r2_l, center_l, albedo_l, emission_l, mat_l,
                    (me * s_local).astype(jnp.int32))
            carry = (
                jnp.full((m,), jnp.inf, dtype),         # tmin
                jnp.full((m,), -1, jnp.int32),          # wgid
                zeros, zeros, zeros,                    # center
                zeros, zeros, zeros,                    # albedo
                zeros, zeros, zeros,                    # emission
                jnp.zeros((m,), bool),                  # is_diff
                jnp.zeros((m,), bool),                  # is_refr
                zeros,                                  # winner r^2
            )

            def ring_step(r, state2):
                (r2c, cenc, albc, emic, matc, base), (
                    tmin, wgid, wcx, wcy, wcz, wax, way, waz, wex, wey,
                    wez, wdf, wrf, wr2) = state2
                t = intersect_spheres_soa(
                    *o3, *d3, cenc[:, 0], cenc[:, 1], cenc[:, 2], r2c, eps
                )
                hit_l = jnp.argmin(t, axis=0).astype(jnp.int32)
                tmin_l = jnp.min(t, axis=0)
                gid_l = base + hit_l
                # lowest global index on exact ties (matches jnp.argmin);
                # miss lanes are live-gated downstream, any winner is fine
                better = (tmin_l < tmin) | (
                    (tmin_l == tmin) & (gid_l < wgid)
                )
                sel = lambda tbl: jnp.take(tbl, hit_l, axis=0)
                cen_w = sel(cenc)
                alb_w = sel(albc)
                emi_w = sel(emic)
                mat_w = sel(matc)
                carry2 = (
                    jnp.where(better, tmin_l, tmin),
                    jnp.where(better, gid_l, wgid),
                    jnp.where(better, cen_w[:, 0], wcx),
                    jnp.where(better, cen_w[:, 1], wcy),
                    jnp.where(better, cen_w[:, 2], wcz),
                    jnp.where(better, alb_w[:, 0], wax),
                    jnp.where(better, alb_w[:, 1], way),
                    jnp.where(better, alb_w[:, 2], waz),
                    jnp.where(better, emi_w[:, 0], wex),
                    jnp.where(better, emi_w[:, 1], wey),
                    jnp.where(better, emi_w[:, 2], wez),
                    jnp.where(better, mat_w == DIFF, wdf),
                    jnp.where(better, mat_w == REFR, wrf),
                    jnp.where(better, sel(r2c), wr2),
                )
                ring2 = jax.tree.map(
                    lambda x: lax.ppermute(x, axis, fwd),
                    (r2c, cenc, albc, emic, matc, base),
                )
                return ring2, carry2

            _, carry = lax.fori_loop(0, n_stages, ring_step, (ring, carry))
            (tmin, _wgid, wcx, wcy, wcz, wax, way, waz, wex, wey, wez,
             is_diff, is_refr, wr2) = carry
            miss = tmin >= miss_t
            live = alive & ~miss

            # shading: megakernel.render_pt_impl's body, carriers instead
            # of select_by_id gathers
            hp = (o3[0] + d3[0] * tmin, o3[1] + d3[1] * tmin,
                  o3[2] + d3[2] * tmin)
            nrm = shade.v3_normalize(shade.v3_sub(hp, (wcx, wcy, wcz)))
            dn = shade.v3_dot(d3, nrm)
            into = dn < 0
            nl = shade.v3_scale(nrm, jnp.where(into, 1.0, -1.0))

            rad = shade.v3_where(
                live,
                shade.v3_add(rad, (thru[0] * wex, thru[1] * wey,
                                   thru[2] * wez)),
                rad,
            )

            d_spec = shade.reflect(d3, nrm)
            d_diff = shade.cosine_sample_hemisphere(nl, u[0], u[1])
            d_refr, refr_scale = shade.refract_or_reflect(d3, nrm, into, u[0])
            new_d = shade.v3_where(
                is_diff, d_diff, shade.v3_where(is_refr, d_refr, d_spec)
            )
            scale = jnp.where(is_refr, refr_scale, 1.0)
            thru2 = shade.v3_where(
                live,
                (thru[0] * wax * scale, thru[1] * way * scale,
                 thru[2] * waz * scale),
                thru,
            )

            thru_rr, survive = shade.russian_roulette(thru2, u[2])
            do_rr = depth >= rr_depth
            thru2 = shade.v3_where(do_rr, thru_rr, thru2)
            alive2 = live & jnp.where(do_rr, survive, True)

            # scale-aware offset — must match render_pt_impl bit-for-bit
            # (the ring is gated bit-equal against it)
            off = jnp.where(
                is_refr, 0.0, shade.scaled_origin_offset(wr2, eps)
            )
            new_o = shade.v3_add(hp, shade.v3_scale(nl, off))
            o3 = shade.v3_where(live, new_o, o3)
            d3 = shade.v3_where(live, new_d, d3)
            return o3, d3, rad, thru2, alive2

        st = (o3, d3, (zeros, zeros, zeros), (ones, ones, ones),
              jnp.ones((m,), bool))
        st = lax.fori_loop(0, bounces, bounce_body, st, unroll=True)
        return jnp.stack(st[2], axis=1)

    f = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(axis), P(None, None, axis), P(axis), P(axis, None),
                  P(axis, None), P(axis, None), P(axis)),
        out_specs=P(axis),
        check_vma=False,
    )
    return jax.jit(f)(
        rays, u_all, scene["r2"], scene["center"], scene["albedo"],
        scene["emission"], scene["material"],
    )
