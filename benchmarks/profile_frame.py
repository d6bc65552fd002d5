"""Where-did-the-cycles-go: capture a device trace of ONE render step
and print the per-op duration table.

The reference's analogue is the camodel simulator run (`run.sh -r sim`,
waveforms under CAMODEL_LOG_PATH); here `jax.profiler` wraps one fenced
step and the trace.json.gz is summed by op name.  Works on the GPU and
(less usefully) on CPU.

Usage:
  python benchmarks/profile_frame.py --renderer jit [--top 25]
  python benchmarks/profile_frame.py --renderer wavefront-mesh --subdiv 4
  python benchmarks/profile_frame.py --renderer xla-mesh --keep-trace DIR

Prints one JSON line per op (sorted by total duration), then a summary
line.  HLO op names map back to source via the `metadata.op_name` /
`source_file` fields inside the trace — open it in xprof/TensorBoard
(`--keep-trace`) for the full timeline.
"""

from __future__ import annotations

import argparse
import collections
import glob
import gzip
import json
import os
import shutil
import sys
import tempfile


def main(argv=None) -> int:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    p = argparse.ArgumentParser()
    p.add_argument("--renderer",
                   choices=["wavefront", "wavefront-mesh", "xla-mesh", "jit"],
                   default="jit")
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--spp", type=int, default=16)
    p.add_argument("--bounces", type=int, default=8)
    p.add_argument("--subdiv", type=int, default=4)
    p.add_argument("--pool", type=int, default=1 << 19)
    p.add_argument("--top", type=int, default=20)
    p.add_argument("--keep-trace", default=None,
                   help="keep the raw trace directory at this path")
    args = p.parse_args(argv)

    import jax
    import jax.numpy as jnp
    import numpy as np

    from ascendpathtracing import camera, scenes
    from ascendpathtracing.utils import profiling

    w, h, spp4 = args.width, args.height, args.spp
    key = jax.random.PRNGKey(0)

    if args.renderer in ("wavefront-mesh", "xla-mesh"):
        from ascendpathtracing.accel import meshes
        from ascendpathtracing.models import mesh as mesh_mod

        v, f = meshes.icosphere(
            center=(50, 40, 60), radius=14.0, subdivisions=args.subdiv
        )
        ms = mesh_mod.MeshScene.cornell_with_mesh(
            v, f, albedo=(0.85, 0.55, 0.2), base_scene="smallpt9"
        )
        mdev = mesh_mod.mesh_scene_to_device(ms)
        if args.renderer == "wavefront-mesh":
            from ascendpathtracing.models import wavefront as wf

            def run(i):
                return wf.render_wavefront_mesh(
                    jax.random.fold_in(key, i), mdev, width=w, height=h,
                    spp4=spp4, pool=args.pool, bounces=args.bounces,
                )
        else:
            rays = jnp.asarray(
                camera.generate_rays_numpy(w, h, 1, seed=0).astype(np.float32)
            )

            def run(i):
                return mesh_mod.render_pt_mesh(
                    jax.random.fold_in(key, i), rays, mdev,
                    bounces=args.bounces,
                )
    elif args.renderer == "wavefront":
        from ascendpathtracing.models import megakernel, wavefront as wf

        scene = megakernel.scene_to_device(scenes.cornell8())

        def run(i):
            return wf.render_wavefront(
                jax.random.fold_in(key, i), scene, width=w, height=h,
                spp4=spp4, pool=args.pool, bounces=args.bounces,
            )
    else:  # jit
        from ascendpathtracing.models import megakernel

        scene = megakernel.scene_to_device(scenes.cornell8())
        rays = jnp.asarray(
            camera.generate_rays_numpy(w, h, 1, seed=0).astype(np.float32)
        )

        def run(i):
            return megakernel.render_pt(
                jax.random.fold_in(key, i), rays, scene, bounces=args.bounces
            )

    jax.block_until_ready(run(0))  # compile + per-process warmup

    trace_dir = args.keep_trace or tempfile.mkdtemp(prefix="apt_trace_")
    with profiling.trace(trace_dir):
        jax.block_until_ready(run(1))

    files = glob.glob(os.path.join(trace_dir, "**/*.trace.json.gz"),
                      recursive=True)
    if not files:
        print(json.dumps({"error": f"no trace written under {trace_dir}"}))
        return 1
    events = json.loads(gzip.open(files[0]).read())["traceEvents"]
    dur = collections.Counter()
    for e in events:
        if e.get("ph") == "X" and "dur" in e:
            name = e.get("name", "?")
            # skip host-side python frames; keep device ops
            if name.startswith("$"):
                continue
            dur[name] += e["dur"]
    total = sum(dur.values())
    for name, d in dur.most_common(args.top):
        print(json.dumps({
            "op": name[:100],
            "ms": round(d / 1e3, 2),
            "pct": round(100.0 * d / max(total, 1), 1),
        }), flush=True)
    print(json.dumps({
        "renderer": args.renderer,
        "platform": jax.devices()[0].platform,
        "device_kind": jax.devices()[0].device_kind,
        "total_traced_ms": round(total / 1e3, 1),
        "trace": trace_dir if args.keep_trace else "(deleted)",
    }))
    if not args.keep_trace:
        shutil.rmtree(trace_dir, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
