"""Command-line driver — the replacement of the reference's
``run.sh`` pipeline (run.sh:120-129: gen_data.py -> render binary ->
data_visualization.py).

Usage:
    python -m ascendpathtracing.cli render \
        --width 256 --height 256 --samples 1 --bounces 4 \
        --mode reference --backend auto --out output/

Run modes map to the reference's ``-r {cpu,sim,npu}`` (run.sh:32-60):
  --backend cpu   force JAX CPU (the tikicpulib-style host path); Pallas
                  kernels then run in the interpreter
  --backend gpu   require a GPU (exit 2 without one)
  --backend auto  use whatever JAX finds (default)

``--renderer auto`` takes the Pallas kernels on a GPU and the XLA paths
elsewhere (backend.py decides); ``pallas`` and ``jit`` pick one.

Artifacts written (reference-compatible formats, utils/io.py):
  <out>/rays.bin  <out>/spheres.bin  <out>/color.bin  <out>/color.ppm
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _parse_args(argv):
    p = argparse.ArgumentParser(prog="ascendpathtracing")
    sub = p.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("render", help="render a scene end-to-end")
    r.add_argument("--width", type=int, default=16)
    r.add_argument("--height", type=int, default=16)
    r.add_argument("--samples", type=int, default=1)
    r.add_argument("--bounces", type=int, default=5)
    r.add_argument("--mode", choices=["reference", "pt"], default="reference")
    r.add_argument(
        "--scene", default=None,
        help="default: cornell8 (reference) / smallpt9 (pt); pt mode also "
        "accepts mesh scenes: mesh-cube, mesh-icosphere[:<subdiv>], "
        "mesh-obj:<path>",
    )
    r.add_argument("--seed", type=int, default=0)
    r.add_argument("--backend", choices=["auto", "cpu", "gpu"], default="auto")
    r.add_argument("--renderer", choices=["auto", "jit", "pallas", "wavefront"],
                   default="auto",
                   help="pallas = the Pallas kernels (fused sphere forward "
                   "in reference mode, BVH traversal for mesh scenes); "
                   "jit = the XLA paths; auto = pallas on a GPU, jit "
                   "elsewhere")
    r.add_argument("--out", default="output")
    r.add_argument("--nee", action="store_true",
                   help="pt mode: next-event estimation (explicit light sampling)")
    r.add_argument("--aov", choices=["none", "depth", "normal", "albedo", "gbuffer"],
                   default="none",
                   help="also write auxiliary outputs (depth/normal/albedo"
                   ".ppm; gbuffer = all three)")
    r.add_argument("--denoise", type=int, default=0, metavar="ITERS",
                   help="a-trous wavelet denoise iterations (0 = off); "
                   "uses G-buffer guides on sphere scenes")
    r.add_argument("--tonemap", choices=["none", "reinhard", "aces"],
                   default="none", help="tone-map + gamma-encode final.ppm")
    r.add_argument("--exposure", type=float, default=1.0)
    r.add_argument("--clamp", type=float, default=0.0, metavar="L",
                   help="firefly clamp: bound per-sample luminance (0 = off)")
    r.add_argument("--check-finite", action="store_true",
                   help="fail if the render produced NaN/Inf")
    r.add_argument("--shard", type=int, default=0, metavar="N",
                   help="data-parallel the render over an N-device mesh "
                   "and assemble the image to host 0 (reference mode, "
                   "jit renderer; N must divide the ray count)")
    r.add_argument("--oracle", action="store_true", help="also run the NumPy oracle and report parity")

    t = sub.add_parser(
        "train",
        help="inverse-rendering demo: recover perturbed scene albedo from "
        "a target render (exercises the differentiable pass + checkpoint)",
    )
    t.add_argument("--width", type=int, default=32)
    t.add_argument("--height", type=int, default=32)
    t.add_argument("--bounces", type=int, default=3)
    t.add_argument("--steps", type=int, default=50)
    t.add_argument("--lr", type=float, default=0.05)
    t.add_argument("--backend", choices=["auto", "cpu", "gpu"], default="auto")
    t.add_argument("--ckpt", default="output/ckpt.npz")
    t.add_argument("--resume", action="store_true")
    t.add_argument("--ckpt-every", type=int, default=20)

    st = sub.add_parser(
        "selftest",
        help="hardware doctor: quick correctness checks of every compute "
        "path (jit/oracle, Pallas fwd, custom-VJP grads, BVH traversal) "
        "on the current backend",
    )
    st.add_argument("--backend", choices=["auto", "cpu", "gpu"], default="auto")

    o = sub.add_parser("oracle", help="run only the NumPy oracle")
    o.add_argument("--width", type=int, default=16)
    o.add_argument("--height", type=int, default=16)
    o.add_argument("--samples", type=int, default=1)
    o.add_argument("--bounces", type=int, default=5)
    o.add_argument("--seed", type=int, default=0)
    o.add_argument("--scene", default="cornell8")
    o.add_argument("--out", default="output")

    return p.parse_args(argv)


def _setup_backend(backend: str):
    import jax

    if backend == "cpu":
        jax.config.update("jax_platforms", "cpu")
    elif backend == "gpu" and jax.default_backend() != "gpu":
        print(f"ERROR: requested gpu, found {jax.default_backend()}", file=sys.stderr)
        sys.exit(2)
    return jax


def _kernel_mode(args):
    """(use the Pallas kernels, run them in the interpreter) for this
    run.  The interpreter runs only under ``--backend cpu``; a kernel
    asked for without a GPU and without it is an error."""
    from ascendpathtracing import backend

    interpret = args.backend == "cpu"
    if args.renderer == "auto":
        return backend.use_kernels(), False
    if args.renderer == "pallas":
        backend.check_kernel_target(interpret)
        return True, interpret
    return False, False


def cmd_render(args) -> int:
    from ascendpathtracing.config import RenderConfig

    try:
        RenderConfig(
            width=args.width,
            height=args.height,
            samples=args.samples,
            bounces=args.bounces,
            mode=args.mode,
        ).validate()
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    jax = _setup_backend(args.backend)
    import numpy as np

    from ascendpathtracing import camera, oracle, scenes
    from ascendpathtracing.models import megakernel
    from ascendpathtracing.utils import io

    scene_name = args.scene or ("cornell8" if args.mode == "reference" else "smallpt9")
    mesh_scene = None
    if scene_name.startswith("mesh-"):
        if args.mode != "pt":
            print("error: mesh scenes require --mode pt", file=sys.stderr)
            return 2
        from ascendpathtracing.accel import meshes as mesh_lib
        from ascendpathtracing.models import mesh as mesh_mod

        kind = scene_name[len("mesh-"):]
        if kind == "cube":
            v, f = mesh_lib.cube(center=(50, 30, 60), size=25.0)
        elif kind == "icosphere" or kind.startswith("icosphere:"):
            # mesh-icosphere:<s> — 20*4^s triangles (default s=3)
            subdiv = int(kind.partition(":")[2] or 3)
            v, f = mesh_lib.icosphere(
                center=(50, 40, 60), radius=14.0, subdivisions=subdiv
            )
        elif kind.startswith("obj:"):
            # mesh-obj:<path> — user mesh, auto-fit into the Cornell box.
            v, f = mesh_lib.load_obj(kind[len("obj:"):])
            lo, hi = v.min(axis=0), v.max(axis=0)
            scale = 28.0 / max(float((hi - lo).max()), 1e-9)
            v = mesh_lib.transform(
                v - (lo + hi) / 2.0, scale=scale, translate=(50.0, 35.0, 60.0)
            )
        else:
            print(f"error: unknown mesh scene {scene_name!r} (mesh-cube, "
                  "mesh-icosphere[:<subdiv>], mesh-obj:<path>)", file=sys.stderr)
            return 2
        mesh_scene = mesh_mod.MeshScene.cornell_with_mesh(
            v, f, albedo=(0.85, 0.55, 0.2)
        )
        scene = mesh_scene.spheres
    else:
        try:
            scene = scenes.get_scene(scene_name)
        except KeyError as e:
            print(f"error: {e.args[0]}", file=sys.stderr)
            return 2
    w, h, s = args.width, args.height, args.samples

    t0 = time.time()
    rays = camera.generate_rays_numpy(w, h, s, seed=args.seed).astype(np.float32)
    io.write_rays_bin(rays, f"{args.out}/rays.bin")
    io.write_spheres_bin(scene, f"{args.out}/spheres.bin")
    t_gen = time.time() - t0

    dev = megakernel.scene_to_device(scene)
    if args.renderer == "wavefront" and args.mode != "pt":
        print("error: --renderer wavefront is a path-tracing renderer "
              "(use --mode pt)", file=sys.stderr)
        return 2
    if args.renderer == "pallas" and args.mode == "pt" and mesh_scene is None:
        print("error: --renderer pallas renders --mode reference or mesh "
              "scenes (there is no path-tracing sphere kernel)", file=sys.stderr)
        return 2
    if args.renderer == "wavefront":
        use_kernels, interpret = False, False
    else:
        try:
            use_kernels, interpret = _kernel_mode(args)
        except RuntimeError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
    if mesh_scene is None and args.mode == "pt":
        use_kernels = False  # no path-tracing sphere kernel

    def _expand_pixel_means(img3):
        # per-pixel means -> replicated across the 4*s subsample slots so
        # color.bin keeps its layout (decode averages them back)
        return jax.numpy.repeat(
            jax.numpy.asarray(img3).reshape(w * h, 1, 3), 4 * s, axis=1
        ).reshape(w * h * 4 * s, 3)

    t0 = time.time()
    if args.renderer == "wavefront":
        # pool streaming renderer (models/wavefront.py): per-pixel means
        total_samples = w * h * 4 * s
        pool = min(1 << 18, -(-total_samples // 2048) * 2048)
        key = jax.random.PRNGKey(args.seed)
        from ascendpathtracing.models import wavefront as wf_mod

        if mesh_scene is not None:
            from ascendpathtracing.models import mesh as mesh_mod

            mdev = mesh_mod.mesh_scene_to_device(mesh_scene, kernel=False)
            img3 = wf_mod.render_wavefront_mesh(
                key, mdev, width=w, height=h, spp4=4 * s, pool=pool,
                bounces=args.bounces,
            )
        else:
            img3 = wf_mod.render_wavefront(
                key, dev, width=w, height=h, spp4=4 * s, pool=pool,
                bounces=args.bounces,
            )
        colors = _expand_pixel_means(img3)
    elif args.mode == "reference" and use_kernels:
        from ascendpathtracing.ops import pallas_kernels

        colors = pallas_kernels.render_reference_pallas(
            jax.numpy.asarray(rays),
            jax.numpy.asarray(scene.soa10()),
            light_index=scene.light_index,
            bounces=args.bounces,
            interpret=interpret,
        )
    elif args.mode == "reference":
        if args.shard:
            # DP-sharded render + host-0 assembly (SURVEY §5: all_gather
            # of rendered tiles to host 0; parallel/assembly.py)
            from ascendpathtracing import parallel as par

            mesh = par.make_mesh(args.shard)
            colors_sh = par.render_reference_sharded(
                par.shard_rays(rays, mesh), dev, mesh,
                bounces=args.bounces,
            )
            colors = par.gather_colors(colors_sh)
        else:
            colors = megakernel.render_reference(
                rays, dev, bounces=args.bounces
            )
    elif mesh_scene is not None:
        from ascendpathtracing.models import mesh as mesh_mod

        mdev = mesh_mod.mesh_scene_to_device(
            mesh_scene, kernel=use_kernels, interpret=interpret
        )
        key = jax.random.PRNGKey(args.seed)
        colors = mesh_mod.render_pt_mesh(key, rays, mdev, bounces=args.bounces)
    else:
        key = jax.random.PRNGKey(args.seed)
        fn = megakernel.render_pt_nee if args.nee else megakernel.render_pt
        colors = fn(key, rays, dev, bounces=args.bounces)
    colors = np.asarray(jax.block_until_ready(colors))
    t_render = time.time() - t0

    if args.check_finite:
        from ascendpathtracing.utils.debug import assert_finite

        assert_finite(colors, "render")

    io.write_color_bin(colors, f"{args.out}/color.bin")
    # native (C++) fused decode+encode when available, Python otherwise
    img = io.write_render_ppm(colors, w, h, s, f"{args.out}/color.ppm")

    # G-buffer (sphere scenes): AOV outputs and/or denoiser guides
    want_gbuf = (
        args.aov in ("normal", "albedo", "gbuffer") or args.denoise > 0
    ) and mesh_scene is None
    gbuf = megakernel.render_gbuffer(rays, dev) if want_gbuf else None
    if args.aov != "none":
        if args.aov in ("depth", "gbuffer"):
            depth = np.asarray(
                gbuf["depth"] if gbuf is not None
                else megakernel.render_depth(rays, dev)
            )
            dmax = max(float(depth.max()), 1e-9)
            dimg = io.decode_color(
                np.repeat((depth / dmax)[:, None], 3, axis=1), w, h, s
            )
            io.write_ppm(dimg, f"{args.out}/depth.ppm")
        if gbuf is not None and args.aov in ("normal", "gbuffer"):
            nimg = io.decode_color(
                np.asarray(gbuf["normal"]) * 0.5 + 0.5, w, h, s
            )
            io.write_ppm(nimg, f"{args.out}/normal.ppm")
        if gbuf is not None and args.aov in ("albedo", "gbuffer"):
            io.write_ppm(
                io.decode_color(np.asarray(gbuf["albedo"]), w, h, s),
                f"{args.out}/albedo.ppm",
            )

    # post pipeline: clamp -> decode HDR -> denoise -> tonemap -> final.ppm
    post_active = args.denoise > 0 or args.tonemap != "none" or args.clamp > 0
    if post_active:
        from ascendpathtracing import post

        colors_post = colors
        if args.clamp > 0:
            colors_post = np.asarray(
                post.firefly_clamp(colors, max_radiance=args.clamp)
            )
        hdr = io.decode_color_hdr(colors_post, w, h, s).astype(np.float32)
        if args.denoise > 0:
            guides = {}
            if gbuf is not None:
                nrm = io.decode_color_hdr(np.asarray(gbuf["normal"]), w, h, s)
                nrm /= np.maximum(
                    np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-9
                )
                zplanes = np.repeat(np.asarray(gbuf["depth"])[:, None], 3, axis=1)
                guides = {
                    "normal": nrm.astype(np.float32),
                    "depth": io.decode_color_hdr(zplanes, w, h, s)[..., 0]
                    .astype(np.float32),
                    "albedo": io.decode_color_hdr(
                        np.asarray(gbuf["albedo"]), w, h, s
                    ).astype(np.float32),
                }
            hdr = np.asarray(
                post.atrous_denoise(hdr, iterations=args.denoise, **guides)
            )
        if args.tonemap == "aces":
            final = post.to_u8(
                post.gamma_encode(post.tonemap_aces(hdr, args.exposure))
            )
        elif args.tonemap == "reinhard":
            final = post.to_u8(
                post.gamma_encode(post.tonemap_reinhard(hdr, args.exposure))
            )
        else:
            final = post.to_u8(np.clip(hdr, 0.0, 1.0))
        io.write_ppm(final, f"{args.out}/final.ppm")

    n_rays = rays.shape[0]
    stats = {
        "backend": jax.default_backend(),
        "scene": scene_name,
        "mode": args.mode,
        "renderer": args.renderer,
        "kernels": use_kernels,
        "interpret": interpret,
        "device_kind": jax.devices()[0].device_kind,
        "rays": n_rays,
        "bounces": args.bounces,
        "gen_s": round(t_gen, 4),
        "render_s": round(t_render, 4),
        # One definition everywhere (bench.py, BASELINE.md): Mrays/s counts
        # PRIMARY rays, not ray-bounces.  This is an END-TO-END WALL
        # number: render_s fences on np.asarray, so it includes compile
        # (first run) and the device-to-host copy.  bench.py measures the
        # steady-state step instead.
        "mrays_per_s": round(n_rays / max(t_render, 1e-9) / 1e6, 3),
        "mray_bounces_per_s": round(
            n_rays * args.bounces / max(t_render, 1e-9) / 1e6, 3
        ),
        "out": f"{args.out}/color.ppm",
    }
    if post_active:
        stats["final"] = f"{args.out}/final.ppm"
    if args.oracle and args.mode == "reference":
        exp = oracle.render_reference_numpy(rays, scene, bounces=args.bounces)
        img_o = io.decode_color(exp, w, h, s)
        stats["oracle_rays_bitexact"] = float((np.abs(exp - colors).max(1) == 0).mean())
        stats["oracle_img_equal_pix"] = float(
            (img_o == img).all(axis=-1).mean()
        )
    print(json.dumps(stats))
    return 0


def cmd_selftest(args) -> int:
    """Hardware doctor — the analogue of the reference's sim-mode
    verification sweep (run.sh:74-81 camodel + gen_data.py oracles): one
    quick correctness check per compute path, on whatever backend is
    selected.  The Pallas kernels run compiled on a GPU and in the
    interpreter under ``--backend cpu``; otherwise their checks are
    skipped.  Prints one JSON line per check; exit 0 iff all pass."""
    jax = _setup_backend(args.backend)
    import jax.numpy as jnp
    import numpy as np

    from ascendpathtracing import backend, camera, oracle, scenes
    from ascendpathtracing.models import megakernel
    from ascendpathtracing.ops import pallas_kernels as pk

    interpret = args.backend == "cpu"
    run_kernels = backend.on_gpu() or interpret
    checks = []

    def report(name, ok, **detail):
        checks.append(bool(ok))
        print(json.dumps({"check": name, "ok": bool(ok), **detail}))

    def skip(name):
        print(json.dumps({"check": name,
                          "skipped": "needs a GPU or --backend cpu"}))

    scene = scenes.cornell8()
    rays = camera.generate_rays_numpy(16, 16, 1, seed=0).astype(np.float32)
    planes = jnp.asarray(scene.soa10())
    rp = jnp.asarray(rays.T.copy())
    dev = megakernel.scene_to_device(scene)

    # 1. jit megakernel vs NumPy oracle, single bounce (f32-stable: no
    #    multi-bounce chaos at 1 bounce — tests/test_reference_parity.py).
    img = np.asarray(
        megakernel.render_reference_impl(jnp.asarray(rays), dev, bounces=1)
    )
    ora = oracle.render_reference_numpy(rays, scene, bounces=1)
    err = float(np.abs(img - ora).max())
    report("jit_vs_oracle_1bounce", err == 0.0, max_abs_err=err)

    if run_kernels:
        # 2. Pallas fused forward vs jit, 1 bounce.  Relative 1e-5: the
        #    GPU compilers may contract multiply-adds differently.
        pal = np.asarray(
            pk.render_reference_pallas_planes(
                rp, planes, light_index=scene.light_index, bounces=1,
                interpret=interpret,
            )
        ).T
        err = float(np.abs(pal - img).max() / max(np.abs(img).max(), 1e-30))
        report("pallas_fwd_vs_jit_1bounce", err <= 1e-5, max_rel_err=err,
               interpret=interpret)

        # 3. Custom-VJP gradients vs XLA AD, 1 bounce (exact at 1 bounce;
        #    at depth the f32 hit decisions are chaotic by construction).
        render = pk.make_render_reference_pallas_diff(
            light_index=scene.light_index, bounces=1, interpret=interpret,
        )
        gp = np.asarray(jax.grad(lambda p: jnp.sum(render(rp, p)))(planes))

        def loss(alb, emi):
            sc = dict(dev, albedo=alb, emission=emi)
            return jnp.sum(
                megakernel.render_reference_impl(jnp.asarray(rays), sc, bounces=1)
            )

        ga, ge = jax.grad(loss, argnums=(0, 1))(dev["albedo"], dev["emission"])
        ea = float(np.abs(gp[7:10].T - np.asarray(ga)).max())
        ee = float(np.abs(gp[4:7].T - np.asarray(ge)).max())
        eg = float(np.abs(gp[0:4]).max())
        gref = float(np.abs(np.asarray(ga)).max())
        ok = ea <= 1e-4 * max(gref, 1.0) and ee <= 1e-3 and eg == 0.0
        report("custom_vjp_grads_vs_ad_1bounce", ok, albedo_err=ea,
               emission_err=ee, geom_grads=eg, interpret=interpret)

        # 4. BVH traversal kernel vs brute force — the mesh stack's
        #    correctness gate on THIS backend.
        from ascendpathtracing.accel import bvh as bvh_mod
        from ascendpathtracing.accel import meshes as mesh_lib
        from ascendpathtracing.accel import tri as tri_mod
        from ascendpathtracing.ops import pallas_bvh

        v32, fcs = mesh_lib.icosphere(subdivisions=2)
        v32 = np.asarray(v32, np.float32)
        rng_st = np.random.RandomState(0)
        n_tr = 1024
        o_ = rng_st.randn(3, n_tr).astype(np.float32)
        o_ /= np.linalg.norm(o_, axis=0)
        o_ *= 3.0
        d_ = rng_st.randn(3, n_tr).astype(np.float32)
        d_ /= np.linalg.norm(d_, axis=0)
        rays_tr = jnp.asarray(np.concatenate([o_, d_], 0))
        tplanes = tri_mod.triangle_planes(v32, fcs, dtype=np.float32)
        ts_b = tri_mod.intersect_triangles_brute(
            tuple(rays_tr[i] for i in range(3)),
            tuple(rays_tr[i] for i in range(3, 6)),
            *(tuple(jnp.asarray(c) for c in t) for t in tplanes), 1e-4,
        )
        bt = np.asarray(jnp.min(ts_b, 0))
        bvh = bvh_mod.build_bvh(v32, fcs)
        tables = pallas_bvh.pack_bvh(
            bvh, tuple(tuple(p[bvh.tri_order] for p in t) for t in tplanes)
        )
        block, warps = pallas_bvh.launch_config(
            tables, max_leaf=bvh.max_leaf, interpret=interpret
        )
        tmin_k, _ = pallas_bvh.intersect_bvh_pallas(
            rays_tr, *tables, max_leaf=bvh.max_leaf, block=block,
            num_warps=warps, interpret=interpret,
        )
        tmin_k = np.asarray(tmin_k)
        hitm = bt < 1e19
        same_set = bool(((tmin_k >= 1e19) == ~hitm).all())
        terr = float(np.abs(tmin_k[hitm] - bt[hitm]).max()) if hitm.any() else 0.0
        report("bvh_kernel_vs_brute", same_set and terr < 1e-3,
               hit_frac=float(hitm.mean()), max_t_err=terr, interpret=interpret)
    else:
        for name in ("pallas_fwd_vs_jit_1bounce",
                     "custom_vjp_grads_vs_ad_1bounce", "bvh_kernel_vs_brute"):
            skip(name)

    # 5. checkify NaN/div guards over the jit renderer: in-graph float
    #    checks must pass on a healthy render AND catch an injected NaN
    #    (the analogue of the reference's CPU-debug allocator checks,
    #    allocator.h:261-284).
    from ascendpathtracing.utils import debug as dbg

    checked = dbg.checkify_render(
        lambda r: megakernel.render_reference_impl(r, dev, bounces=2)
    )
    try:
        out = checked(jnp.asarray(rays))
        clean_ok = bool(np.isfinite(np.asarray(out)).all())
    except Exception:
        clean_ok = False
    bad_rays = np.asarray(rays).copy()
    bad_rays[0, 3] = np.nan  # poison one direction component
    try:
        checked(jnp.asarray(bad_rays))
        caught = False
    except Exception:
        caught = True
    report("checkify_float_guards", clean_ok and caught,
           clean_pass=clean_ok, nan_caught=caught)

    n_ok = sum(checks)
    print(json.dumps({"selftest": "PASS" if n_ok == len(checks) else "FAIL",
                      "passed": n_ok, "ran": len(checks),
                      "backend": jax.default_backend()}))
    return 0 if n_ok == len(checks) else 1


def cmd_oracle(args) -> int:
    import numpy as np

    from ascendpathtracing import camera, oracle, scenes
    from ascendpathtracing.utils import io

    scene = scenes.get_scene(args.scene)
    rays = camera.generate_rays_numpy(args.width, args.height, args.samples, seed=args.seed)
    colors = oracle.render_reference_numpy(
        rays.astype(np.float32), scene, bounces=args.bounces
    )
    io.write_color_bin(colors, f"{args.out}/oracle_color.bin")
    img = io.decode_color(colors, args.width, args.height, args.samples)
    io.write_ppm(img, f"{args.out}/oracle_color.ppm")
    print(json.dumps({"rays": len(rays), "out": f"{args.out}/oracle_color.ppm"}))
    return 0


def cmd_train(args) -> int:
    jax = _setup_backend(args.backend)
    import numpy as np

    from ascendpathtracing import camera, scenes
    from ascendpathtracing.models import megakernel
    from ascendpathtracing.parallel.sharded import make_train_step, split_scene_params
    from ascendpathtracing.utils import checkpoint as ckpt

    rays = camera.generate_rays_numpy(args.width, args.height, 1, seed=0).astype(
        np.float32
    )
    scene = megakernel.scene_to_device(scenes.get_scene("cornell8"))
    target = megakernel.render_reference(rays, scene, bounces=args.bounces)
    params, aux = split_scene_params(scene)

    start_step = 0
    if args.resume and os.path.exists(args.ckpt):
        params, start_step, _ = ckpt.load_checkpoint(args.ckpt)
        params = {k: jax.numpy.asarray(v) for k, v in params.items()}
        print(f"resumed from {args.ckpt} at step {start_step}", file=sys.stderr)
    else:
        # perturb albedo; training should recover it
        params = dict(params, albedo=params["albedo"] + 0.08)

    step_fn = make_train_step(None, bounces=args.bounces, learning_rate=args.lr)
    loss = float("nan")
    for i in range(start_step, start_step + args.steps):
        loss, params = step_fn(params, aux, rays, target)
        if (i + 1) % args.ckpt_every == 0 or i + 1 == start_step + args.steps:
            ckpt.save_checkpoint(args.ckpt, jax.tree.map(lambda x: x, params), step=i + 1)
        if (i + 1) % 10 == 0:
            print(f"step {i+1} loss {float(loss):.6e}", file=sys.stderr)
    err = float(jax.numpy.abs(params["albedo"] - scene["albedo"]).max())
    print(json.dumps({
        "start_step": start_step,
        "steps": args.steps,
        "final_loss": float(loss),
        "albedo_max_err": err,
        "ckpt": args.ckpt,
    }))
    return 0


def main(argv=None) -> int:
    args = _parse_args(sys.argv[1:] if argv is None else argv)
    from ascendpathtracing import backend

    backend.enable_compile_cache()
    if args.cmd == "render":
        return cmd_render(args)
    if args.cmd == "train":
        return cmd_train(args)
    if args.cmd == "oracle":
        return cmd_oracle(args)
    if args.cmd == "selftest":
        return cmd_selftest(args)
    return 1


if __name__ == "__main__":
    sys.exit(main())
