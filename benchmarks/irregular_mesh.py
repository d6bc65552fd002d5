"""Irregular-mesh traversal: the BVH traversal kernel off the icosphere.

A uniform icosphere has constant triangle density, the best case for a
BVH.  This harness times the traversal on a NON-uniform scene at EQUAL
triangle count (81,920 tris, the s6 row): two large smooth spheres plus a
tight cluster of eight small dense ones — triangle edge lengths spanning
~20x — beside the uniform icosphere, for the Pallas kernel
(ops/pallas_bvh.py) and the XLA while_loop walk (accel/bvh.py), on the
same incoherent rays.  Hit ids of the two must agree.

Usage: python benchmarks/irregular_mesh.py [--rays 1048576] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def clustered_specs():
    """81,920 triangles: 2 x subdiv-5 large + 8 x subdiv-4 small spheres
    (20480*2 + 5120*8), radii spanning 16 -> 0.9, the small ones packed
    into a ~10-unit cluster near the front-left floor."""
    import numpy as np

    specs = [
        ((30.0, 22.0, 55.0), 16.0, 5),
        ((72.0, 14.0, 90.0), 12.0, 5),
    ]
    rng = np.random.RandomState(7)
    base = np.array([22.0, 5.0, 115.0])
    for i in range(8):
        off = rng.rand(3) * np.array([10.0, 6.0, 10.0])
        r = 0.9 + 0.35 * i
        specs.append((tuple(base + off), float(r), 4))
    return specs


def main(argv=None) -> int:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    p = argparse.ArgumentParser()
    p.add_argument("--rays", type=int, default=1 << 20)
    p.add_argument("--iters", type=int, default=6)
    p.add_argument("--out", default=None, help="also write the JSON here")
    args = p.parse_args(argv)

    import jax
    import jax.numpy as jnp
    import numpy as np

    from ascendpathtracing import backend
    from ascendpathtracing.accel import bvh as bvh_mod, meshes, tri
    from ascendpathtracing.ops import pallas_bvh
    from ascendpathtracing.utils import profiling

    backend.require_gpu("benchmarks/irregular_mesh.py")
    scenes = {
        "uniform-icosphere-s6": meshes.icosphere(
            center=(50, 40, 60), radius=14.0, subdivisions=6),
        "clustered-2big-8small": meshes.clustered_icospheres(clustered_specs()),
    }
    dev0 = jax.devices()[0]
    art = {"platform": dev0.platform, "device_kind": dev0.device_kind,
           "rays": args.rays, "scenes": {}}
    for name, (v, f) in scenes.items():
        v32 = np.asarray(v, np.float32)
        bvh = bvh_mod.build_bvh(v32, f)
        planes = tri.triangle_planes(v32, f, dtype=np.float32)
        ordered = tuple(tuple(q[bvh.tri_order] for q in t) for t in planes)
        tables = pallas_bvh.pack_bvh(bvh, ordered)
        # incoherent rays: origins in the mesh's (padded) box, uniform dirs
        rng = np.random.RandomState(0)
        lo, hi = v32.min(0), v32.max(0)
        ext = hi - lo
        o = (lo - 0.1 * ext + rng.rand(args.rays, 3) * 1.2 * ext).astype(np.float32)
        d = rng.randn(args.rays, 3).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        rp = jnp.asarray(np.concatenate([o, d], 1).T)
        block, warps = pallas_bvh.launch_config(tables, max_leaf=bvh.max_leaf)
        kern = jax.jit(lambda r: pallas_bvh.intersect_bvh_pallas(
            r, *tables, max_leaf=bvh.max_leaf, block=block, num_warps=warps))
        o3 = tuple(jnp.asarray(o[:, i]) for i in range(3))
        d3 = tuple(jnp.asarray(d[:, i]) for i in range(3))
        bdev = bvh_mod.bvh_to_device(bvh)
        geom = tuple(tuple(jnp.asarray(q) for q in t) for t in ordered)
        xla = jax.jit(lambda o3, d3: bvh_mod.intersect_bvh(
            o3, d3, bdev, geom, 1e-4, bvh.max_leaf)[:2])
        tk, hk = map(np.asarray, kern(rp))
        tj, hj = map(np.asarray, xla(o3, d3))
        hit = tk < 1e19
        k_res = profiling.benchmark(lambda i: kern(rp), iters=args.iters)
        x_res = profiling.benchmark(lambda i: xla(o3, d3), iters=args.iters)
        entry = {
            "tris": int(np.asarray(f).shape[0]), "nodes": bvh.n_nodes,
            "hit_frac": float(hit.mean()),
            "same_ids": bool((hit == (tj < 1e19)).all()
                             and (hk[hit] == hj[hit]).all()),
            "kernel_ms": k_res["step_s"] * 1e3, "xla_ms": x_res["step_s"] * 1e3,
            "launch": [block, warps],
        }
        art["scenes"][name] = entry
        print(json.dumps({"scene": name, **entry}), flush=True)
    print(json.dumps(art))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(art, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
