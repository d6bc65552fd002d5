"""Smoke test of the renderer on an NVIDIA GPU, through its entry points.

One process.  It runs the GPU-marked tests (``pytest -m gpu``), then the
main path at the sizes users render, through ``bench.main`` and
``cli.main`` in-process:

1. the headline differentiable sphere step (bench.py defaults: cornell8,
   reference mode, 8 bounces, 2^22 rays, fwd+bwd);
2. a full path-traced frame: 1024x1024 at 64 spp (67M primary rays),
   smallpt9, 8 bounces with Russian roulette;
3. the icosphere (subdivision 6, 81,920 triangles) in the Cornell box at
   512x512x4 spp, 8 bounces, and per-face gradients at subdivision 4;
4. inverse rendering at 512x512, 8 bounces, 5 steps, checkpointed and
   resumed;

then compares each Pallas kernel with its plain reference at those sizes
and times it against what XLA makes of the plain version.  Every line
before the last is labelled with the card and its power limit; the last
line is ``{"ok": true, "device": {...}}``.  Any failed phase ends the run
with a non-zero exit and no such line.  Without a GPU it exits 2.

    python chip_smoke.py          # one card
    python chip_smoke.py --four   # only the paths across four cards
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import bench  # noqa: E402
from ascendpathtracing import backend, camera, cli, oracle, scenes  # noqa: E402
from ascendpathtracing.accel import bvh as bvh_mod, meshes, tri  # noqa: E402
from ascendpathtracing.models import megakernel, mesh as mesh_mod  # noqa: E402
from ascendpathtracing.ops import pallas_bvh, pallas_kernels as pk  # noqa: E402
from ascendpathtracing.utils import profiling  # noqa: E402

WORK = os.path.join(ROOT, ".chip_smoke")


class PhaseFailed(AssertionError):
    pass


def card_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


class Report:
    def __init__(self, card: str):
        self.card = card

    def line(self, **fields):
        print(json.dumps({"card": self.card, **fields}), flush=True)

    def phase(self, name, fn, rays=None):
        t0 = time.perf_counter()
        detail = fn() or {}
        wall = time.perf_counter() - t0
        stats = jax.devices()[0].memory_stats() or {}
        # rays over the phase's wall time, compiles included
        self.line(phase=name, ok=True, wall_s=wall,
                  rays_per_s_wall=(rays / wall if rays else None),
                  peak_bytes_in_use=stats.get("peak_bytes_in_use"), **detail)
        return detail


def check(cond, what, **detail):
    if not cond:
        raise PhaseFailed(f"{what}: {json.dumps(detail, default=str)}")


def run_captured(main, argv):
    """Run an entry point in-process; return (rc, its JSON lines)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    lines = [json.loads(ln) for ln in buf.getvalue().splitlines()
             if ln.startswith("{")]
    return rc, lines


def timed(fn, iters=5):
    return profiling.benchmark(lambda i: fn(), iters=iters, warmup=1)["step_s"]


# ------------------------------------------------------------ the main path --
def headline(rep):
    rc, out = run_captured(bench.main, [])
    check(rc == 0 and out, "bench.py defaults", rc=rc)
    d = out[-1]["detail"]
    check(d["renderer"] == "pallas", "headline renderer", detail=d)
    return {"metric": out[-1]["metric"], "mrays_per_s": out[-1]["value"],
            "step_ms": d["step_ms"], "rays_per_step": d["rays_per_step"],
            "launch_configs": d["launch_configs"]}


def full_pt_frame(rep, width=1024, height=1024, samples=16):
    scene = scenes.smallpt9()
    n = width * height * 4 * samples
    compiled = megakernel.render_pt.lower(
        jax.random.PRNGKey(0), jax.ShapeDtypeStruct((n, 6), jnp.float32),
        megakernel.scene_to_device(scene), bounces=8,
    ).compile()
    mem = compiled.memory_analysis()
    stats = jax.devices()[0].memory_stats()
    rep.line(phase="full_pt_memory_analysis", rays=n,
             temp_bytes=mem.temp_size_in_bytes,
             argument_bytes=mem.argument_size_in_bytes,
             output_bytes=mem.output_size_in_bytes,
             bytes_limit=stats["bytes_limit"] if stats else None)
    out_dir = os.path.join(WORK, "pt")
    rc, out = run_captured(cli.main, [
        "render", "--mode", "pt", "--width", str(width), "--height",
        str(height), "--samples", str(samples), "--bounces", "8",
        "--check-finite", "--out", out_dir,
    ])
    check(rc == 0 and out and out[-1]["rays"] == n, "cli render pt", rc=rc)
    stats = out[-1]
    img = np.asarray(_read_ppm(os.path.join(out_dir, "color.ppm")))
    check(img.shape == (height, width, 3) and img.std() > 0, "pt image",
          shape=img.shape)
    return {"rays": n, "render_s_incl_compile": stats["render_s"],
            "mrays_per_s_incl_compile": stats["mrays_per_s"],
            "image_mean": float(img.mean())}


def _read_ppm(path):
    from ascendpathtracing.utils import io as aio

    return aio.read_ppm(path)


def mesh_forward(rep, subdiv=6, width=512, height=512):
    out_dir = os.path.join(WORK, "mesh")
    rc, out = run_captured(cli.main, [
        "render", "--mode", "pt", "--scene", f"mesh-icosphere:{subdiv}",
        "--width", str(width), "--height", str(height), "--samples", "1",
        "--bounces", "8", "--check-finite", "--out", out_dir,
    ])
    check(rc == 0 and out, "cli render mesh", rc=rc)
    stats = out[-1]
    check(stats["kernels"] and not stats["interpret"], "mesh path", stats=stats)
    return {"rays": stats["rays"], "tris": 20 * 4 ** subdiv,
            "render_s_incl_compile": stats["render_s"]}


def mesh_gradients(rep):
    rc, out = run_captured(bench.main, ["--renderer", "xla-mesh", "--subdiv", "4"])
    check(rc == 0 and out, "bench xla-mesh", rc=rc)
    d = out[-1]["detail"]
    check(d["traversal"] == "kernel" and np.isfinite(d["out_mean"]),
          "mesh grads", detail=d)
    return {"metric": out[-1]["metric"], "mrays_per_s": out[-1]["value"],
            "step_ms": d["step_ms"], "tris": d["tris"]}


def inverse_rendering(rep, width=512, height=512):
    ckpt = os.path.join(WORK, "train", "ckpt.npz")
    common = ["train", "--width", str(width), "--height", str(height),
              "--bounces", "8", "--ckpt", ckpt, "--ckpt-every", "3"]
    rc1, out1 = run_captured(cli.main, common + ["--steps", "3"])
    check(rc1 == 0 and os.path.exists(ckpt), "train + checkpoint", rc=rc1)
    rc2, out2 = run_captured(cli.main, common + ["--steps", "2", "--resume"])
    check(rc2 == 0 and out2[-1]["start_step"] == 3, "resume", out=out2)
    losses = [out1[-1]["final_loss"], out2[-1]["final_loss"]]
    check(all(np.isfinite(losses)), "finite loss", losses=losses)
    return {"steps": 5, "losses": losses,
            "albedo_max_err": out2[-1]["albedo_max_err"],
            "rays_per_step": width * height * 4}


# ------------------------------------------------ kernels vs the references --
def _trail_from_idx(idx, n_spheres, light):
    code = np.where(idx == n_spheres, -1, idx.astype(np.int32))
    alive = np.ones(code.shape[1], bool)
    trail = []
    for k in range(code.shape[0]):
        trail.append(np.where(alive, code[k], -2))
        alive &= code[k] != light
    return np.stack(trail)


def sphere_kernel_parity(rep, scene_name, width=1024, height=1024):
    """Fused kernel vs the XLA loop on 4M rays.

    1 bounce: max error <= 1e-5 relative (the two GPU compilers may
    contract multiply-adds differently) and identical winners on
    >= 99.99% of rays.  8 bounces: the 1e5-radius walls make each
    self-hit decision an f32 coin flip (tests/test_reference_parity.py),
    so two f32 programs compiled apart part ways on a few percent of the
    rays.  The gates are therefore: the kernel's winner sequences agree
    with the float64 render at least as often as the XLA loop's f32
    sequences do (minus one percentage point), and the image means agree
    to 1e-3 relative."""
    scene = scenes.get_scene(scene_name)
    s, light = scene.n_spheres, scene.light_index
    rays = jnp.asarray(camera.generate_rays_numpy(width, height, 1, seed=0)
                       .astype(np.float32))
    planes = jnp.asarray(scene.soa10())
    dev = megakernel.scene_to_device(scene)
    out = {}
    for b in (1, 8):
        col, idx = pk.render_reference_pallas_planes_with_idx(
            rays.T, planes, light_index=light, bounces=b)
        ref = np.asarray(megakernel.render_reference(rays, dev, bounces=b))
        col = np.asarray(col).T
        k_trail = _trail_from_idx(np.asarray(idx), s, light)
        x_trail = np.asarray(megakernel.render_reference_hits(rays, dev, bounces=b))
        same = float((k_trail == x_trail).all(0).mean())
        rel = float(np.abs(col - ref).max() / np.abs(ref).max())
        mean_rel = float(abs(col.mean() - ref.mean()) / ref.mean())
        if b == 1:
            check(rel <= 1e-5 and same >= 0.9999, f"{scene_name} 1 bounce",
                  rel=rel, same=same)
            out["b1"] = {"max_rel_err": rel, "same_winners": same}
        else:
            with jax.enable_x64(True):
                dev64 = megakernel.scene_to_device(scene, dtype=jnp.float64)
                f_trail = np.asarray(megakernel.render_reference_hits(
                    rays.astype(jnp.float64), dev64, bounces=b))
            k64 = float((k_trail == f_trail).all(0).mean())
            x64 = float((x_trail == f_trail).all(0).mean())
            check(k64 >= x64 - 0.01 and mean_rel <= 1e-3,
                  f"{scene_name} 8 bounces", k64=k64, x64=x64,
                  mean_rel=mean_rel)
            out["b8"] = {"same_winners_vs_xla_f32": same,
                         "kernel_same_as_f64": k64, "xla_f32_same_as_f64": x64,
                         "image_mean_rel_err": mean_rel}
    return {"scene": scene_name, "rays": int(rays.shape[0]), **out}


def replay_grads_parity(rep, width=1024, height=1024):
    """Replay backward vs XLA AD at 1 bounce, to the tolerances of
    ``cli.py selftest`` check 3 (exact decisions at 1 bounce; the sums
    over 4M rays differ only in summation order)."""
    scene = scenes.cornell8()
    rays = jnp.asarray(camera.generate_rays_numpy(width, height, 1, seed=0)
                       .astype(np.float32))
    planes = jnp.asarray(scene.soa10())
    render = pk.make_render_reference_pallas_diff(light_index=7, bounces=1)
    gp = np.asarray(jax.grad(lambda p: jnp.sum(render(rays.T, p)))(planes))
    dev = megakernel.scene_to_device(scene)
    ga, ge = jax.grad(
        lambda a, e: jnp.sum(megakernel.render_reference_impl(
            rays, dict(dev, albedo=a, emission=e), bounces=1)),
        argnums=(0, 1))(dev["albedo"], dev["emission"])
    ga, ge = np.asarray(ga), np.asarray(ge)
    ea = float(np.abs(gp[7:10].T - ga).max())
    ee = float(np.abs(gp[4:7].T - ge).max())
    eg = float(np.abs(gp[0:4]).max())
    gref = float(np.abs(ga).max())
    eref = float(np.abs(ge).max())
    # selftest check 3's bounds, scaled with the gradient: they were set
    # at 256 rays, and the sums grow with the ray count
    ok = ea <= 1e-4 * max(gref, 1.0) and ee <= 1e-3 * max(eref / 256, 1.0) and eg == 0
    check(ok, "replay grads", albedo_err=ea, emission_err=ee, geom=eg)
    return {"albedo_err": ea, "albedo_grad_max": gref, "emission_err": ee,
            "emission_grad_max": eref}


def brute_nearest(o, d, v0, e1, e2, eps=1e-4, chunk=512):
    """Nearest hit by brute force over triangle chunks (lowest index wins
    ties, as in accel/tri.py)."""
    f = v0.shape[0]
    pad = -(-f // chunk) * chunk - f
    v0, e1, e2 = (jnp.pad(a, ((0, pad), (0, 0))).reshape(-1, chunk, 3)
                  for a in (v0, e1, e2))
    o3 = tuple(o[:, i] for i in range(3))
    d3 = tuple(d[:, i] for i in range(3))

    def body(carry, xs):
        tmin, hid = carry
        a, b, c, base = xs
        t = tri.intersect_triangles_brute(
            o3, d3, *(tuple(x[:, i] for i in range(3)) for x in (a, b, c)), eps)
        t = jnp.where((base + jnp.arange(chunk) < f)[:, None], t, 1e20)
        tm, am = jnp.min(t, 0), jnp.argmin(t, 0).astype(jnp.int32) + base
        better = tm < tmin
        return (jnp.where(better, tm, tmin), jnp.where(better, am, hid)), None

    n = o.shape[0]
    init = (jnp.full((n,), 1e20, o.dtype), jnp.zeros((n,), jnp.int32))
    bases = jnp.arange(v0.shape[0], dtype=jnp.int32) * chunk
    (tmin, hid), _ = jax.lax.scan(body, init, (v0, e1, e2, bases))
    return tmin, hid


def traversal_parity_and_timing(rep, subdiv, n=1 << 20):
    """Kernel vs accel/bvh.intersect_bvh (its spec) and brute force on 1M
    incoherent rays: identical hit sets and ids, t within 1e-4
    relative; and the kernel's time beside the XLA while_loop's."""
    v, f = meshes.icosphere(center=(50, 40, 60), radius=14.0, subdivisions=subdiv)
    v32 = np.asarray(v, np.float32)
    bvh = bvh_mod.build_bvh(v32, f)
    planes = tri.triangle_planes(v32, f, dtype=np.float32)
    ordered = tuple(tuple(p[bvh.tri_order] for p in t) for t in planes)
    tables = pallas_bvh.pack_bvh(bvh, ordered)
    rng = np.random.RandomState(1)
    o = (np.asarray([50, 40, 60]) + rng.uniform(-30, 30, (n, 3))).astype(np.float32)
    d = rng.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rp = jnp.asarray(np.concatenate([o, d], 1).T)
    block, warps = pallas_bvh.launch_config(tables, max_leaf=bvh.max_leaf)
    kern = jax.jit(lambda r: pallas_bvh.intersect_bvh_pallas(
        r, *tables, max_leaf=bvh.max_leaf, block=block, num_warps=warps))
    o3 = tuple(jnp.asarray(o[:, i]) for i in range(3))
    d3 = tuple(jnp.asarray(d[:, i]) for i in range(3))
    bdev = bvh_mod.bvh_to_device(bvh)
    geom = tuple(tuple(jnp.asarray(p) for p in t) for t in ordered)
    xla = jax.jit(lambda o3, d3: bvh_mod.intersect_bvh(
        o3, d3, bdev, geom, 1e-4, bvh.max_leaf)[:2])
    brute = jax.jit(brute_nearest)
    tk, hk = map(np.asarray, kern(rp))
    tj, hj = map(np.asarray, xla(o3, d3))
    tb, hb = map(np.asarray, brute(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(v32[f[:, 0]]),
        jnp.asarray(v32[f[:, 1]] - v32[f[:, 0]]),
        jnp.asarray(v32[f[:, 2]] - v32[f[:, 0]])))
    hit = tk < 1e19
    res = {
        "tris": int(f.shape[0]), "rays": n, "hit_frac": float(hit.mean()),
        "same_hits_vs_xla": bool((hit == (tj < 1e19)).all()),
        "same_ids_vs_xla": bool((hk[hit] == hj[hit]).all()),
        "t_rel_vs_xla": float((np.abs(tk[hit] - tj[hit]) / tj[hit]).max()),
        "same_hits_vs_brute": bool((hit == (tb < 1e19)).all()),
        "same_faces_vs_brute": bool((bvh.tri_order[hk[hit]] == hb[hit]).all()),
        "t_rel_vs_brute": float((np.abs(tk[hit] - tb[hit]) / tb[hit]).max()),
    }
    check(res["same_hits_vs_xla"] and res["same_ids_vs_xla"]
          and res["t_rel_vs_xla"] <= 1e-4 and res["same_hits_vs_brute"]
          and res["same_faces_vs_brute"] and res["t_rel_vs_brute"] <= 1e-4,
          f"traversal s{subdiv}", **res)
    res["kernel_ms"] = timed(lambda: kern(rp)) * 1e3
    res["xla_ms"] = timed(lambda: xla(o3, d3)) * 1e3
    res["launch"] = [block, warps]
    return res


def mesh_render_kernel_vs_xla(rep, subdiv=6, width=512, height=512):
    """End to end: the mesh path-tracing frame with the traversal kernel
    vs the same frame with the XLA while_loop traversal."""
    v, f = meshes.icosphere(center=(50, 40, 60), radius=14.0, subdivisions=subdiv)
    ms = mesh_mod.MeshScene.cornell_with_mesh(v, f, albedo=(0.85, 0.55, 0.2))
    rays = jnp.asarray(camera.generate_rays_numpy(width, height, 1, seed=0)
                       .astype(np.float32))
    key = jax.random.PRNGKey(0)
    out = {"tris": int(f.shape[0]), "rays": int(rays.shape[0])}
    means = {}
    for name, kernel in (("kernel", True), ("xla", False)):
        mdev = mesh_mod.mesh_scene_to_device(ms, kernel=kernel)
        img = mesh_mod.render_pt_mesh(key, rays, mdev, bounces=8)
        means[name] = float(jnp.mean(img))
        out[f"{name}_ms"] = timed(
            lambda: mesh_mod.render_pt_mesh(key, rays, mdev, bounces=8), 3) * 1e3
    # same estimator, same random stream, same hits up to f32 rounding
    rel = abs(means["kernel"] - means["xla"]) / means["xla"]
    check(rel <= 1e-3, "mesh frame kernel vs xla", means=means)
    return {**out, "image_mean_rel_diff": rel}


def sphere_kernel_vs_xla(rep):
    """Sphere fwd and fwd+bwd step: the fused kernel vs the XLA loop,
    through bench.py."""
    res = {}
    for tag, extra in (("fwd", ["--fwd-only"]), ("fwd+bwd", [])):
        for r in ("pallas", "jit"):
            rc, out = run_captured(bench.main, ["--renderer", r, *extra])
            check(rc == 0, f"bench {r} {tag}", rc=rc)
            res[f"{tag}_{r}_ms"] = out[-1]["detail"]["step_ms"]
            res[f"{tag}_{r}_mrays_per_s"] = out[-1]["value"]
    return res


def oracle_f64(rep):
    """The XLA path in float64 on the card vs the NumPy oracle at
    64x64x5 bounces: identical winners, max error <= 1e-12 (float64 noise
    ~1e-11 of the wall cancellation is far below eps, so no decision
    flips)."""
    scene = scenes.cornell8()
    rays = camera.generate_rays_numpy(64, 64, 1, seed=0)
    with jax.enable_x64(True):
        dev = megakernel.scene_to_device(scene, dtype=jnp.float64)
        got = np.asarray(megakernel.render_reference(jnp.asarray(rays), dev, bounces=5))
        trail = np.asarray(megakernel.render_reference_hits(
            jnp.asarray(rays), dev, bounces=5))
    exp = oracle.render_reference_numpy(rays, scene, bounces=5, dtype=np.float64)
    exp_trail = oracle.render_reference_hits_numpy(rays, scene, bounces=5,
                                                   dtype=np.float64)
    err = float(np.abs(got - exp).max())
    same = bool((trail == exp_trail).all())
    check(got.dtype == np.float64 and same and err <= 1e-12, "f64 oracle",
          err=err, same=same)
    return {"max_abs_err": err, "same_winners": same}


def run_one_card(rep):
    rc = __import__("pytest").main(
        ["-q", "-m", "gpu", "-p", "no:cacheprovider", os.path.join(ROOT, "tests")])
    check(rc == 0, "pytest -m gpu", rc=int(rc))
    rep.line(phase="pytest -m gpu", ok=True)

    rep.phase("headline_sphere_fwd_bwd", lambda: headline(rep))
    rep.phase("full_pt_1024x1024x64spp", lambda: full_pt_frame(rep),
              rays=1024 * 1024 * 64)
    rep.phase("mesh_forward_s6_512x512x4", lambda: mesh_forward(rep),
              rays=512 * 512 * 4)
    rep.phase("mesh_gradients_s4", lambda: mesh_gradients(rep))
    rep.phase("inverse_rendering_512_5steps", lambda: inverse_rendering(rep))
    for name in ("cornell8", "smallpt9"):
        rep.phase(f"sphere_kernel_parity_{name}",
                  lambda name=name: sphere_kernel_parity(rep, name))
    rep.phase("replay_grads_parity", lambda: replay_grads_parity(rep))
    for subdiv in (4, 6):
        rep.phase(f"traversal_s{subdiv}_1M",
                  lambda subdiv=subdiv: traversal_parity_and_timing(rep, subdiv))
    rep.phase("kernel_vs_xla_sphere", lambda: sphere_kernel_vs_xla(rep))
    rep.phase("kernel_vs_xla_mesh_frame_s6", lambda: mesh_render_kernel_vs_xla(rep))
    rep.phase("xla_f64_vs_oracle", lambda: oracle_f64(rep))


# ------------------------------------------------------------ four cards ----
def run_four_cards(rep, *, width=1024, height=1024, train_wh=512,
                   mesh_wh=512, subdiv=4):
    """The paths that exist only across cards, each against its one-card
    result in float64 (allclose <= 1e-9, the tolerance of
    __graft_entry__.py: XLA may fuse the sharded and the one-card
    programs differently, ~1e-14; a decision flip would be O(1))."""
    from ascendpathtracing.parallel import (
        make_mesh, make_train_step, render_pt_mesh_sharded,
        render_reference_sharded, shard_rays, split_scene_params,
    )

    check(len(jax.devices()) >= 4, "four devices", found=len(jax.devices()))
    mesh = make_mesh(4, devices=jax.devices()[:4])

    def close(a, b, what):
        err = float(np.abs(np.asarray(a) - np.asarray(b)).max())
        check(np.isfinite(err) and err <= 1e-9, what, err=err)
        return err

    with jax.enable_x64(True):
        scene = megakernel.scene_to_device(scenes.cornell8(), dtype=jnp.float64)
        rays = jnp.asarray(camera.generate_rays_numpy(width, height, 1, seed=0))

        def sharded_render():
            got = render_reference_sharded(shard_rays(rays, mesh), scene, mesh,
                                           bounces=8)
            ref = megakernel.render_reference(rays, scene, bounces=8)
            return {"rays": int(rays.shape[0]), "mesh": dict(mesh.shape),
                    "max_abs_err": close(got, ref, "sharded render")}

        rep.phase("four_render_reference_sharded", sharded_render)

        def train_step():
            r = jnp.asarray(camera.generate_rays_numpy(train_wh, train_wh, 1, seed=0))
            target = megakernel.render_reference(r, scene, bounces=8)
            params, aux = split_scene_params(scene)
            params = dict(params, albedo=params["albedo"] + 0.03)
            l1, p1 = make_train_step(None, bounces=8, learning_rate=1.0)(
                jax.tree.map(jnp.array, params), aux, r, target)
            ln, pn = make_train_step(mesh, bounces=8, learning_rate=1.0)(
                jax.tree.map(jnp.array, params), aux, shard_rays(r, mesh),
                shard_rays(target, mesh))
            errs = {k: close(p1[k], pn[k], f"train param {k}") for k in p1}
            rel = abs(float(l1) - float(ln)) / abs(float(l1))
            check(rel <= 1e-9, "train loss", rel=rel)
            return {"rays": int(r.shape[0]), "loss": float(l1),
                    "loss_rel_err": rel, "param_errs": errs}

        rep.phase("four_gspmd_train_step", train_step)

        def sharded_mesh():
            v, f = meshes.icosphere(center=(50, 40, 60), radius=14.0,
                                    subdivisions=subdiv)
            ms = mesh_mod.MeshScene.cornell_with_mesh(v, f, albedo=(0.8, 0.5, 0.2))
            mdev = mesh_mod.mesh_scene_to_device(ms, dtype=jnp.float64)
            r = jnp.asarray(camera.generate_rays_numpy(mesh_wh, mesh_wh, 1, seed=0))
            key = jax.random.PRNGKey(3)
            n = r.shape[0]
            got = render_pt_mesh_sharded(key, r, mdev, mesh, bounces=8,
                                         bit_equal="indexed")
            ref = mesh_mod.render_pt_mesh(
                key, r, mdev, bounces=8, global_idx=jnp.arange(n, dtype=jnp.int32))
            return {"rays": int(n), "tris": int(f.shape[0]),
                    "traversal": mdev["static"].traversal,
                    "max_abs_err": close(got, ref, "sharded mesh render")}

        rep.phase("four_render_pt_mesh_sharded", sharded_mesh)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--four", action="store_true",
                   help="run only the paths across four cards")
    args = p.parse_args(argv)
    if jax.default_backend() != "gpu":
        print(f"error: no GPU (JAX found {jax.default_backend()})", file=sys.stderr)
        return 2
    backend.enable_compile_cache()
    card = card_name_and_power()
    print(card, flush=True)
    rep = Report(card)
    shutil.rmtree(WORK, ignore_errors=True)
    try:
        if args.four:
            run_four_cards(rep)
        else:
            run_one_card(rep)
    except PhaseFailed as e:
        print(f"FAILED {e}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": 4 if args.four else len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
