"""Benchmark harness — the headline metric.

Measures forward+backward throughput of the differentiable renderer at
8 bounces on the Cornell scene, in primary Mrays/s per card, on the GPU.
Without a GPU it exits non-zero: a CPU number is not a device metric.
Prints ONE JSON line:
    {"metric": ..., "value": N, "unit": "Mrays/s", "detail": {...}}

``detail`` names the device (platform, device_kind, device_count) and
gives the median step time, the compile+warm-up time and the device's
peak memory.

Usage: python bench.py [--rays N] [--iters K] [--bounces B]
                       [--mode pt|reference] [--renderer R] [--fwd-only]
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _parse(argv):
    p = argparse.ArgumentParser()
    # Defaults define the headline metric: fwd+bwd at 8 bounces on the
    # Cornell scene, 4M rays/step, gradients w.r.t. the scene planes.
    p.add_argument("--rays", type=int, default=1 << 22, help="primary rays per step")
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--warmup", type=int, default=2)
    p.add_argument("--bounces", type=int, default=8)
    p.add_argument("--mode", choices=["pt", "reference"], default="reference")
    p.add_argument(
        "--renderer",
        choices=["auto", "jit", "pallas", "wavefront", "xla-mesh",
                 "wavefront-mesh"],
        default="auto",
        help="pallas = the fused Pallas sphere kernel with its replay "
        "backward (reference mode); jit = the XLA bounce loop; auto = "
        "pallas where backend.py takes the kernels, jit otherwise; "
        "wavefront = compaction renderer (pt mode, full frame); xla-mesh "
        "= the XLA bounce loop over the icosphere-in-Cornell mesh scene "
        "(BVH traversal kernel on the GPU), fwd+bwd = per-face "
        "albedo/emission and vertex gradients; wavefront-mesh = pool "
        "compaction + Morton coherence sort over the same scene",
    )
    p.add_argument("--pool", type=int, default=1 << 19, help="wavefront ray pool")
    p.add_argument("--spp", type=int, default=64, help="wavefront samples/pixel")
    p.add_argument("--subdiv", type=int, default=4,
                   help="mesh renderers: icosphere subdivisions "
                   "(tris = 20*4^s: 4 -> 5120, 5 -> 20480, 6 -> 81920)")
    p.add_argument("--fwd-only", action="store_true")
    return p.parse_args(argv)


def _step_fn(args, jax, jnp, np):
    """(run(i), primary rays per step, label, extra detail)."""
    from ascendpathtracing import backend, camera, scenes
    from ascendpathtracing.models import megakernel
    from ascendpathtracing.parallel.sharded import split_scene_params

    # Square-ish image covering n rays (n = w*h*4 with samples=1).
    w = h = int(np.sqrt(args.rays / 4))
    n = w * h * 4
    tag = "fwd" if args.fwd_only else "fwd+bwd"

    if args.renderer in ("xla-mesh", "wavefront-mesh"):
        from ascendpathtracing.accel import meshes
        from ascendpathtracing.models import mesh as mesh_mod

        v, f = meshes.icosphere(
            center=(50, 40, 60), radius=14.0, subdivisions=args.subdiv
        )
        ms = mesh_mod.MeshScene.cornell_with_mesh(
            v, f, albedo=(0.85, 0.55, 0.2), base_scene="smallpt9"
        )
        mdev = mesh_mod.mesh_scene_to_device(ms)
        extra = {"tris": int(f.shape[0]), "subdiv": args.subdiv,
                 "traversal": mdev["static"].traversal}
        if args.renderer == "wavefront-mesh":
            from ascendpathtracing.models import wavefront as wf_mod

            key_w = jax.random.PRNGKey(0)

            def run(i):
                return wf_mod.render_wavefront_mesh(
                    jax.random.fold_in(key_w, i), mdev, width=w, height=h,
                    spp4=args.spp, pool=args.pool, bounces=args.bounces,
                    rr_depth=5,
                )

            extra["pool"] = args.pool
            label = (f"fwd (wavefront-mesh, {args.bounces}b RR, "
                     f"{w}x{h}x{args.spp}spp, icosphere s{args.subdiv}")
            return run, w * h * args.spp, label, extra
        # one 4-subsample frame per step: this path keeps every ray in
        # device memory (Mrays/s normalizes by samples)
        rays_m = jnp.asarray(
            camera.generate_rays_numpy(w, h, 1, seed=0).astype(np.float32)
        )
        key_m = jax.random.PRNGKey(0)
        if args.fwd_only:
            def run(i):
                return mesh_mod.render_pt_mesh(
                    jax.random.fold_in(key_m, i), rays_m, mdev,
                    bounces=args.bounces,
                )
        else:
            # the differentiable path (diff/mesh.py): gradients w.r.t.
            # vertices and per-face albedo/emission
            from ascendpathtracing.diff import mesh as dmesh

            params_m = dmesh.mesh_params(ms)
            faces_m = jnp.asarray(np.asarray(ms.faces))
            step_m = jax.jit(jax.value_and_grad(
                lambda p, k: jnp.sum(dmesh.render_pt_mesh_params(
                    k, rays_m, p, mdev, faces_m, bounces=args.bounces,
                ))
            ))

            def run(i):
                return step_m(params_m, jax.random.fold_in(key_m, i))
        label = (f"{tag} (xla-mesh, {args.bounces}b RR, {w}x{h}, "
                 f"icosphere s{args.subdiv}")
        return run, n, label, extra

    if args.renderer == "wavefront":
        from ascendpathtracing.models import wavefront

        key = jax.random.PRNGKey(0)
        sc = megakernel.scene_to_device(scenes.get_scene("cornell8"))

        def run(i):
            return wavefront.render_wavefront(
                jax.random.fold_in(key, i), sc, width=w, height=h,
                spp4=args.spp, pool=args.pool, bounces=args.bounces,
                rr_depth=5,
            )

        label = f"fwd (wavefront, {args.bounces}b RR, {w}x{h}x{args.spp}spp"
        return run, w * h * args.spp, label, {"pool": args.pool}

    rays = jnp.asarray(camera.generate_rays_numpy(w, h, 1, seed=0).astype(np.float32))
    scene_name = "cornell8" if args.mode == "reference" else "smallpt9"
    scene_obj = scenes.get_scene(scene_name)
    use_pallas = args.renderer == "pallas" or (
        args.renderer == "auto" and args.mode == "reference"
        and backend.use_kernels()
    )
    if use_pallas:
        if args.mode != "reference":
            raise ValueError("the pallas renderer renders --mode reference")
        from ascendpathtracing.ops import pallas_kernels

        planes = jnp.asarray(scene_obj.soa10())
        rays_planes = jnp.transpose(rays)
        if args.fwd_only:
            step = jax.jit(lambda p: pallas_kernels.render_reference_pallas_planes(
                rays_planes, p, light_index=scene_obj.light_index,
                bounces=args.bounces,
            ))
        else:
            render = pallas_kernels.make_render_reference_pallas_diff(
                light_index=scene_obj.light_index, bounces=args.bounces,
            )
            step = jax.jit(
                jax.value_and_grad(lambda p: jnp.sum(render(rays_planes, p)))
            )
        label = f"{tag} @ {args.bounces} bounces ({scene_name}, pallas"
        return (lambda i: step(planes)), n, label, {"renderer": "pallas"}

    scene = megakernel.scene_to_device(scene_obj)
    params, aux = split_scene_params(scene)
    key = jax.random.PRNGKey(0)
    if args.mode == "pt":
        mats_static = tuple(int(m) for m in scene_obj.material)

        def fwd(params, key):
            return megakernel.render_pt_impl(
                key, rays, {**params, **aux}, bounces=args.bounces,
                materials_static=mats_static,
            )
    else:
        def fwd(params, key):
            return megakernel.render_reference_impl(
                rays, {**params, **aux}, bounces=args.bounces
            )

    if args.fwd_only:
        step = jax.jit(lambda p, k: jnp.sum(fwd(p, k)))
    else:
        step = jax.jit(jax.value_and_grad(lambda p, k: jnp.sum(fwd(p, k))))
    label = f"{tag} @ {args.bounces} bounces ({scene_name}, jit"
    return (lambda i: step(params, jax.random.fold_in(key, i))), n, label, {
        "renderer": "jit", "mode": args.mode}


def main(argv=None) -> int:
    args = _parse(argv)

    import jax
    import jax.numpy as jnp
    import numpy as np

    from ascendpathtracing import backend
    from ascendpathtracing.utils import profiling

    try:
        backend.require_gpu("bench.py")
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    backend.enable_compile_cache()

    run, total, label, extra = _step_fn(args, jax, jnp, np)
    t0 = time.perf_counter()
    jax.block_until_ready(run(0))
    setup_s = time.perf_counter() - t0
    res = profiling.benchmark(run, iters=args.iters, warmup=args.warmup)
    dt = res["step_s"]
    out = res["out"]
    out0 = out[0] if isinstance(out, tuple) else out
    dev0 = jax.devices()[0]
    print(json.dumps({
        "metric": f"Mrays/s/card {label})",
        "value": profiling.mrays(total, dt),
        "unit": "Mrays/s",
        "detail": {
            "platform": dev0.platform,
            "device_kind": dev0.device_kind,
            "device_count": len(jax.devices()),
            "rays_per_step": total,
            "step_ms": dt * 1e3,
            "min_ms": res["min_s"] * 1e3,
            "max_ms": res["max_s"] * 1e3,
            "iters": res["iters"],
            "compile_and_first_step_s": setup_s,
            "peak_bytes_in_use": dev0.memory_stats().get("peak_bytes_in_use"),
            "out_mean": float(jnp.mean(out0)),
            "launch_configs": {str(k): v for k, v in backend.tuned_configs().items()},
            **extra,
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
