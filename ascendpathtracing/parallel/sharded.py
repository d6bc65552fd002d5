"""Sharded rendering and the distributed training step.

Two complementary layers ("pick a mesh, annotate shardings, let XLA
insert collectives"):

1. :func:`render_reference_sharded` — **manual** ``shard_map``: rays DP
   over the 'data' axis (the multi-card generalization of the reference's
   8-core block split, render.cpp:24), spheres TP over the 'model' axis
   with an explicit ``all_gather`` + lexicographic min-combine that
   preserves the reference's lowest-sphere-index tie-break
   (rt_helper.h:183-193).
2. :func:`make_train_step` — **automatic** GSPMD: the differentiable
   render + loss is jit-compiled with sharding annotations (rays sharded
   over every device, scene parameters replicated); XLA inserts the
   gradient all-reduce, which NCCL runs over NVLink.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ascendpathtracing.models.megakernel import (
    rays_to_soa,
    reference_bounce_loop,
)
from ascendpathtracing.ops.intersect import MISS_T, intersect_spheres_soa


def shard_rays(rays, mesh: Mesh):
    """Place [N, 6] rays sharded over every mesh device (ray axis)."""
    return jax.device_put(rays, NamedSharding(mesh, P(("data", "model"), None)))


# ------------------------------------------------------------------ manual ----
def _tp_hit_fn(o3, d3, scene, eps, *, axis: str, mp: int):
    """Tensor-parallel nearest hit: each 'model'-axis device intersects its
    sphere shard, then shards combine with an all-gather.

    Tie-break correctness: global sphere index = shard * s_local + local
    index; within a shard ``argmin`` picks the lowest local index, and
    across shards ``argmin`` over the gathered axis picks the first
    (= lowest-index) shard, so the combined winner is exactly the global
    lowest-index argmin (matches rt_helper.h:183-193 / gen_data.py:313-321).
    """
    s = scene["r2"].shape[0]
    s_local = s // mp
    midx = lax.axis_index(axis)
    start = midx * s_local
    centers_l = lax.dynamic_slice_in_dim(scene["center"], start, s_local, 0)
    r2_l = lax.dynamic_slice_in_dim(scene["r2"], start, s_local, 0)

    t = intersect_spheres_soa(
        *o3, *d3, centers_l[:, 0], centers_l[:, 1], centers_l[:, 2], r2_l, eps
    )  # [s_local, n_local]
    hit_l = jnp.argmin(t, axis=0).astype(jnp.int32)
    tmin_l = jnp.min(t, axis=0)
    ghit_l = hit_l + (midx * s_local).astype(jnp.int32)

    t_all = lax.all_gather(tmin_l, axis)  # [mp, n_local]
    h_all = lax.all_gather(ghit_l, axis)  # [mp, n_local]
    best = jnp.argmin(t_all, axis=0)
    tmin = jnp.take_along_axis(t_all, best[None, :], axis=0)[0]
    hit = jnp.take_along_axis(h_all, best[None, :], axis=0)[0]
    miss = tmin >= jnp.asarray(MISS_T, tmin.dtype)
    return tmin, hit, miss


def render_reference_sharded(
    rays, scene: dict, mesh: Mesh, *, bounces: int = 5, eps: float = 1e-4
):
    """Reference-mode render, DP over rays x TP over spheres.

    Requires N % data-axis == 0 and S % model-axis == 0. Scene is
    replicated; ray shards never communicate (exactly like the
    reference's cores, SURVEY §2.5) — the only collective is the
    model-axis hit combine.
    """
    mp = mesh.shape["model"]
    if scene["r2"].shape[0] % mp:
        raise ValueError(
            f"sphere count {scene['r2'].shape[0]} not divisible by model axis {mp}"
        )

    hit_fn = partial(_tp_hit_fn, axis="model", mp=mp)

    def body(rays_shard, scene):
        o3, d3 = rays_to_soa(rays_shard)
        return reference_bounce_loop(
            o3, d3, scene, bounces=bounces, eps=eps,
            hit_fn=lambda o, d, s, e: hit_fn(o, d, s, e),
        )

    f = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P("data", None), P()),
        out_specs=P("data", None),
        check_vma=False,
    )
    return jax.jit(f)(rays, scene)


def render_pt_mesh_sharded(
    key,
    rays,
    mdev: dict,
    mesh: Mesh,
    *,
    bounces: int = 8,
    rr_depth: int = 5,
    eps: float = 1e-4,
    bit_equal: bool = True,
):
    """Mesh-scene PT render DP-sharded over rays, scene tables (sphere
    planes + slot-ordered triangle/attribute arrays) replicated — the
    reference's 8-core block split (/root/reference/src/render.cpp:24)
    generalized to the flagship scene type (VERDICT r2 item 3).

    ``bit_equal``:

    - ``"indexed"`` (the production bitwise mode): counter-based
      uniforms keyed by (bounce, GLOBAL ray index) — each shard derives
      its slice from its own indices, ZERO extra memory, and the result
      is BITWISE-EQUAL to the single-device render called with
      ``global_idx=arange(N)`` (models/mesh.indexed_uniforms; SURVEY §7
      hard-part 6's prescribed design).  Gated at any size.
    - ``True``: draws the whole per-bounce uniform stream ONCE at
      global size from ``key`` — replicating render_pt_mesh's in-loop
      ``split``/``uniform`` sequence exactly — and shards it with the
      rays; bitwise vs the DEFAULT single-device stream, but costs
      bounces*3*N floats (kept for the legacy gate).
    - ``False``: folds the shard index into the key inside each shard
      (independent per-shard streams, same estimator, no extra memory,
      statistical gates only).

    ``mdev`` may use any traversal: the jnp/brute walks and the Pallas
    kernel all lower per device inside ``shard_map``.
    """
    from ascendpathtracing.models import mesh as mesh_mod

    traced, static = mesh_mod._split_static(mdev)
    n = rays.shape[0]
    axes = ("data", "model")
    if bit_equal == "indexed":
        n_sh = mesh.shape["data"] * mesh.shape["model"]
        m = n // n_sh

        def body(rays_sh, scene):
            sh = lax.axis_index("data") * mesh.shape["model"] + (
                lax.axis_index("model")
            )
            gidx = sh * m + jnp.arange(m, dtype=jnp.int32)
            return mesh_mod.render_pt_mesh_impl(
                key, rays_sh, scene, bounces=bounces, rr_depth=rr_depth,
                eps=eps, static=static, global_idx=gidx,
            )

        f = jax.shard_map(
            body,
            mesh=mesh,
            in_specs=(P(axes, None), P()),
            out_specs=P(axes, None),
            check_vma=False,
        )
        return jax.jit(f)(rays, traced)
    if bit_equal:
        # replicate _render_pt_mesh_jit's stream: carry the key through
        # per-bounce splits, draw [3, N] at each depth
        ks = []
        k = key
        for _ in range(bounces):
            k, k1 = jax.random.split(k)
            ks.append(k1)
        u = jnp.stack(
            [jax.random.uniform(k1, (3, n), dtype=rays.dtype) for k1 in ks]
        )

        def body(rays_sh, u_sh, scene):
            return mesh_mod.render_pt_mesh_impl(
                key, rays_sh, scene, bounces=bounces, rr_depth=rr_depth,
                eps=eps, static=static, uniforms=u_sh,
            )

        f = jax.shard_map(
            body,
            mesh=mesh,
            in_specs=(P(axes, None), P(None, None, axes), P()),
            out_specs=P(axes, None),
            check_vma=False,
        )
        return jax.jit(f)(rays, u, traced)

    def body(rays_sh, scene):
        idx = lax.axis_index("data") * mesh.shape["model"] + lax.axis_index(
            "model"
        )
        k_local = jax.random.fold_in(key, idx)
        return mesh_mod.render_pt_mesh_impl(
            k_local, rays_sh, scene, bounces=bounces, rr_depth=rr_depth,
            eps=eps, static=static,
        )

    f = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(axes, None), P()),
        out_specs=P(axes, None),
        check_vma=False,
    )
    return jax.jit(f)(rays, traced)


# --------------------------------------------------------------- automatic ----
def split_scene_params(scene: dict):
    """Split the scene pytree into (differentiable params, static aux)."""
    params = {k: scene[k] for k in ("albedo", "emission", "center", "r2")}
    aux = {k: scene[k] for k in scene if k not in params}
    return params, aux


def make_train_step(
    mesh: Mesh | None,
    *,
    bounces: int = 5,
    eps: float = 1e-4,
    learning_rate: float = 1e-3,
):
    """Build a jitted SGD training step for inverse rendering: fit scene
    parameters (albedo/emission/center/r^2) so the rendered image matches
    a target (the BASELINE config-4/5 training loop).

    With a mesh, rays/targets are sharded over all devices and parameters
    are replicated; XLA's SPMD partitioner inserts the gradient
    all-reduce.
    Returns ``step(params, aux, rays, target) -> (loss, new_params)``.
    """

    def loss_fn(params, aux, rays, target):
        scene = {**params, **aux}
        o3, d3 = rays_to_soa(rays)
        colors = reference_bounce_loop(o3, d3, scene, bounces=bounces, eps=eps)
        return jnp.mean((colors - target) ** 2)

    def step(params, aux, rays, target):
        loss, grads = jax.value_and_grad(loss_fn)(params, aux, rays, target)
        new_params = jax.tree.map(lambda p, g: p - learning_rate * g, params, grads)
        return loss, new_params

    if mesh is None:
        return jax.jit(step)

    data_sh = NamedSharding(mesh, P(("data", "model"), None))
    rep = NamedSharding(mesh, P())
    return jax.jit(
        step,
        in_shardings=(rep, rep, data_sh, data_sh),
        out_shardings=(rep, rep),
        donate_argnums=(0,),
    )
