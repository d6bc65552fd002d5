"""Fused reference-mode sphere renderer: a Pallas kernel on the Triton route.

The analogue of the reference's single fused Ascend C kernel
(src/render.cpp): one program takes a block of rays through the whole
bounce loop with the ray, the throughput and the running-min carriers in
registers, so device-memory traffic is one read of the six ray planes and
one write of the three colour planes.  The XLA loop
(``megakernel.reference_bounce_loop``) instead reads and writes every ray
plane at each bounce.

- The per-sphere loop is unrolled with a **running min** that carries the
  winning sphere's shading data (center, albedo, is-light) along with it:
  no [S, N] hit matrix, no argmin, no gather.  Strict ``<`` keeps the
  reference's lowest-index tie-break (rt_helper.h:183-193), and starting
  the carriers from the LAST sphere's data reproduces the oracle's
  miss => wrap-to-last-sphere semantics (gen_data.py:343,390).
- Triton wants power-of-two blocks, so the kernel reads the [6, N] ray
  planes and the [10, S] scene table through masked loads of whole rows
  and scalar loads; any N and any S (smallpt9 has 9) work unpadded.
- The differentiable forward also writes the per-bounce winner index
  (int8, S encodes a miss).  The backward (:func:`replay_scene_grads`)
  replays the albedo product chain from those indices in plain jnp,
  which XLA fuses into one reduction over rays.
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
# (block, num_warps) candidates timed on the device at first use
_CANDIDATES = ((128, 4), (256, 4), (512, 8))
# the block used in the interpreter, where launch shape is irrelevant
INTERPRET_BLOCK = 1024


def _render_ref_kernel(
    rays_ref, scene_ref, out_ref, *idx_ref, n, n_spheres, light_index,
    bounces, eps, block,
):
    """One block of rays, full reference-semantics bounce loop.

    rays_ref:  [6, N] (ox oy oz dx dy dz planes — the rays.bin layout).
    scene_ref: [10, S] (r2 x y z ex ey ez cr cg cb — the spheres.bin
               layout, gen_data.py:94).
    out_ref:   [3, N] colour planes.
    idx_ref:   optional [bounces, N] int8 winner indices (S == miss).
    """
    start = pl.program_id(0) * block
    rows = pl.ds(start, block)
    mask = start + jnp.arange(block, dtype=jnp.int32) < n
    ox, oy, oz, dx, dy, dz = (
        plgpu.load(rays_ref.at[jnp.int32(c), rows], mask=mask, other=0.0)
        for c in range(6)
    )
    f = ox.dtype
    shape = ox.shape
    sc = [[scene_ref[p, s] for s in range(n_spheres)] for p in range(10)]
    last = n_spheres - 1

    # a loop, not an unrolled Python for: the Triton compile time grows
    # with the unrolled code, and the carried state stays in registers
    def bounce(k, state):
        ox, oy, oz, dx, dy, dz, tr, tg, tb, alive = state
        # ---- intersect all spheres, running min with shading carriers ----
        tmin = jnp.full(shape, MISS_T, f)
        # miss => oracle wraps to the LAST sphere's data (gen_data.py:343).
        w_cx = jnp.full(shape, sc[1][last], f)
        w_cy = jnp.full(shape, sc[2][last], f)
        w_cz = jnp.full(shape, sc[3][last], f)
        w_ar = jnp.full(shape, sc[7][last], f)
        w_ag = jnp.full(shape, sc[8][last], f)
        w_ab = jnp.full(shape, sc[9][last], f)
        w_light = jnp.zeros(shape, jnp.bool_)
        w_idx = jnp.full(shape, last, jnp.int32)

        for s in range(n_spheres):
            cx, cy, cz = sc[1][s], sc[2][s], sc[3][s]
            ocx = cx - ox
            ocy = cy - oy
            ocz = cz - oz
            b = ocx * dx + ocy * dy + ocz * dz
            c = ocx * ocx + ocy * ocy + ocz * ocz - sc[0][s]
            det = b * b - c
            valid = det >= 0
            sq = jnp.sqrt(jnp.where(valid, det, 0.0))
            t0 = b - sq
            t1 = b + sq
            t = jnp.where(
                valid & (t0 > eps), t0, jnp.where(valid & (t1 > eps), t1, MISS_T)
            )
            better = t < tmin  # strict < == lowest-index tie-break
            tmin = jnp.where(better, t, tmin)
            w_cx = jnp.where(better, cx, w_cx)
            w_cy = jnp.where(better, cy, w_cy)
            w_cz = jnp.where(better, cz, w_cz)
            w_ar = jnp.where(better, sc[7][s], w_ar)
            w_ag = jnp.where(better, sc[8][s], w_ag)
            w_ab = jnp.where(better, sc[9][s], w_ab)
            w_idx = jnp.where(better, s, w_idx)
            if s == light_index:
                w_light = w_light | better
            else:
                w_light = w_light & jnp.logical_not(better)

        if idx_ref:
            code = jnp.where(tmin >= MISS_T, n_spheres, w_idx)
            plgpu.store(idx_ref[0].at[k, rows], code.astype(jnp.int8), mask=mask)

        # ---- specular bounce (rt_helper.h:504-709) ----
        hx = ox + dx * tmin
        hy = oy + dy * tmin
        hz = oz + dz * tmin
        nx = hx - w_cx
        ny = hy - w_cy
        nz = hz - w_cz
        n2 = nx * nx + ny * ny + nz * nz
        # 1/sqrt (not rsqrt) for value parity with the XLA loop and the
        # NumPy oracle.
        inv = jnp.where(n2 > 0, 1.0 / jnp.sqrt(n2), 0.0)
        nx, ny, nz = nx * inv, ny * inv, nz * inv
        dn = dx * nx + dy * ny + dz * nz
        td = 2.0 * dn
        dx, dy, dz = dx - td * nx, dy - td * ny, dz - td * nz

        # ---- throughput mask update (gen_data.py:379-390) ----
        alive = alive & jnp.logical_not(w_light)
        tr = jnp.where(alive, tr * w_ar, tr)
        tg = jnp.where(alive, tg * w_ag, tg)
        tb = jnp.where(alive, tb * w_ab, tb)
        return hx, hy, hz, dx, dy, dz, tr, tg, tb, alive

    one = jnp.ones(shape, f)
    state = (ox, oy, oz, dx, dy, dz, one, one, one, jnp.ones(shape, jnp.bool_))
    state = jax.lax.fori_loop(jnp.int32(0), jnp.int32(bounces), bounce, state)
    tr, tg, tb = state[6:9]

    # finalize: throughput x light emission (render.cpp:194-196)
    for c, ch in enumerate((tr, tg, tb)):
        plgpu.store(out_ref.at[jnp.int32(c), rows], ch * sc[4 + c][light_index],
                    mask=mask)


def _call(rays_planes, scene_planes, *, light_index, bounces, eps, with_idx,
          block, num_warps, interpret):
    n = rays_planes.shape[1]
    s = scene_planes.shape[1]
    if with_idx and s >= 127:
        raise ValueError(f"int8 winner indices need fewer than 127 spheres, got {s}")
    kernel = functools.partial(
        _render_ref_kernel, n=n, n_spheres=s, light_index=light_index,
        bounces=bounces, eps=eps, block=block,
    )
    out_shape = [jax.ShapeDtypeStruct((3, n), rays_planes.dtype)]
    if with_idx:
        out_shape.append(jax.ShapeDtypeStruct((bounces, n), jnp.int8))
    out = pl.pallas_call(
        kernel,
        grid=(pl.cdiv(n, block),),
        out_shape=tuple(out_shape),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps, num_stages=1),
        interpret=interpret,
        name="sphere_reference_fwd_idx" if with_idx else "sphere_reference_fwd",
    )(rays_planes, scene_planes)
    return tuple(out) if with_idx else out[0]


def _launch_config(n, s, bounces, dtype, with_idx, light_index, eps, interpret):
    """(block, num_warps): fixed in the interpreter; on the GPU the
    fastest candidate at this ray count, timed once per process."""
    if interpret:
        return INTERPRET_BLOCK, 4

    args = (np.zeros((6, n), dtype), np.zeros((10, s), dtype))

    def compile_cfg(cfg):
        return jax.jit(functools.partial(
            _call, light_index=light_index, bounces=bounces, eps=eps,
            with_idx=with_idx, block=cfg[0], num_warps=cfg[1],
            interpret=False,
        )).lower(*args).compile()

    return backend.fastest_config(
        ("sphere_reference", n, s, bounces, np.dtype(dtype).name, with_idx),
        _CANDIDATES, compile_cfg, args,
    )


def _render(rays_planes, scene_planes, *, light_index, bounces, eps,
            with_idx, interpret, block):
    backend.check_kernel_target(interpret)
    n, s = rays_planes.shape[1], scene_planes.shape[1]
    if block is None:
        block, warps = _launch_config(
            n, s, bounces, rays_planes.dtype, with_idx, light_index, eps,
            interpret,
        )
    else:
        warps = 4
    return _call(
        rays_planes, scene_planes, light_index=light_index, bounces=bounces,
        eps=eps, with_idx=with_idx, block=block, num_warps=warps,
        interpret=interpret,
    )


@functools.partial(
    jax.jit, static_argnames=("bounces", "eps", "light_index", "interpret",
                              "block"),
)
def render_reference_pallas_planes(
    rays_planes, scene_planes, *, light_index: int, bounces: int = 5,
    eps: float = 1e-4, interpret: bool = False, block: int | None = None,
):
    """Fused render over plane-layout buffers.

    Args:
      rays_planes:  [6, N] (the rays.bin layout).
      scene_planes: [10, S] (the spheres.bin layout).
      interpret: run in the Pallas interpreter (CPU); otherwise a GPU is
        required.
      block: rays per program; None picks it (and the warp count) by
        timing the candidates on the device.
    Returns colors [3, N] (the color.bin layout).
    """
    return _render(
        rays_planes, scene_planes, light_index=light_index, bounces=bounces,
        eps=eps, with_idx=False, interpret=interpret, block=block,
    )


@functools.partial(
    jax.jit, static_argnames=("bounces", "eps", "light_index", "interpret",
                              "block"),
)
def render_reference_pallas_planes_with_idx(
    rays_planes, scene_planes, *, light_index: int, bounces: int = 5,
    eps: float = 1e-4, interpret: bool = False, block: int | None = None,
):
    """Fused render that also returns the per-bounce winner indices:
    (colors [3, N], idx [bounces, N] int8, S == miss) — the replay
    residual."""
    return _render(
        rays_planes, scene_planes, light_index=light_index, bounces=bounces,
        eps=eps, with_idx=True, interpret=interpret, block=block,
    )


def render_reference_pallas(rays, scene_planes, *, light_index, bounces=5,
                            eps=1e-4, interpret=False):
    """AoS-boundary wrapper: rays [N, 6] -> colors [N, 3]."""
    colors = render_reference_pallas_planes(
        jnp.transpose(rays), scene_planes, light_index=light_index,
        bounces=bounces, eps=eps, interpret=interpret,
    )
    return jnp.transpose(colors)


# --------------------------------------------------------------------------
# Backward.  Reference-mode color_c = emission_c(light) * prod_b
# albedo_c(s_b) where the s_b are DISCRETE argmin winners, so the exact
# reverse-mode gradient is: d emission = sum_i g_i * thru_i; d albedo[s]
# by the product rule over each ray's albedo factors; d center = d r2 =
# d rays = 0 exactly (what jax AD computes through the integer paths).
# --------------------------------------------------------------------------
def replay_scene_grads(idx, scene_planes, g, *, light_index):
    """Scene-plane gradient [10, S] from the stored winner indices.

    idx: [bounces, N] winner codes (S == miss); g: [3, N] cotangent.
    A miss wraps to the LAST sphere's albedo (oracle gen_data.py:343,390)
    but is not a light hit, exactly as the forward distinguishes them."""
    s = scene_planes.shape[1]
    last = s - 1
    dtype = g.dtype
    idx = idx.astype(jnp.int32)
    shape = idx.shape[1:]
    t = [jnp.ones(shape, dtype) for _ in range(3)]
    alive = jnp.ones(shape, jnp.bool_)
    # dt[c][s] = d thru_c / d albedo[s]_c
    dt = [[jnp.zeros(shape, dtype) for _ in range(s)] for _ in range(3)]
    for k in range(idx.shape[0]):
        i = idx[k]
        eq = [i == j for j in range(last)] + [(i == last) | (i == s)]
        # a miss encodes as S, so this never fires for misses even when
        # the light is the last sphere
        alive = alive & (i != light_index)
        for c in range(3):
            alb = scene_planes[7 + c]
            w = jnp.full(shape, alb[last], dtype)
            for j in range(last):
                w = jnp.where(eq[j], alb[j], w)
            m = jnp.where(alive, w, 1.0)
            for j in range(s):
                pick = jnp.where(alive & eq[j], 1.0, 0.0).astype(dtype)
                dt[c][j] = dt[c][j] * m + pick * t[c]
            t[c] = t[c] * m
    emi = scene_planes[4:7, light_index]
    per_ray = jnp.stack(
        [g[c] * t[c] for c in range(3)]
        + [g[c] * emi[c] * dt[c][j] for c in range(3) for j in range(s)]
    )
    sums = jnp.sum(per_ray, axis=1)
    d = jnp.zeros((10, s), dtype)
    d = d.at[4:7, light_index].set(sums[:3])
    return d.at[7:10].set(sums[3:].reshape(3, s))


def make_render_reference_pallas_diff(*, light_index, bounces=5, eps=1e-4,
                                      interpret=False):
    """Differentiable fused render: fn(rays_planes [6,N], scene_planes
    [10,S]) -> colors [3,N].  The forward stores the per-bounce winner
    indices (int8, bounces bytes per ray); the backward replays the
    albedo product chain from them (:func:`replay_scene_grads`).  Rays get
    exact zeros, their true gradient (see above)."""

    @jax.custom_vjp
    def render(rays_planes, scene_planes):
        return render_reference_pallas_planes(
            rays_planes, scene_planes, light_index=light_index,
            bounces=bounces, eps=eps, interpret=interpret,
        )

    def fwd(rays_planes, scene_planes):
        out, idx = render_reference_pallas_planes_with_idx(
            rays_planes, scene_planes, light_index=light_index,
            bounces=bounces, eps=eps, interpret=interpret,
        )
        return out, (scene_planes, idx)

    def bwd(res, g):
        scene_planes, idx = res
        d_scene = replay_scene_grads(idx, scene_planes, g, light_index=light_index)
        return jnp.zeros((6, g.shape[1]), g.dtype), d_scene

    render.defvjp(fwd, bwd)
    return render
