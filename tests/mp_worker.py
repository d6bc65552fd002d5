"""Worker for tests/test_multiprocess.py: one jax.distributed CPU
process of an N-process job (the closest reachable analogue of one pod
HOST — SURVEY §4(d): the 2-host gate).

Runs initialize -> make_global_mesh -> host_local_rays -> the full GSPMD
train step (forward + backward + XLA-inserted grad all-reduce + SGD) and
a sharded reference render assembled to process 0, then writes a JSON
result file for the test to compare across processes and against the
single-process run.

argv: process_id num_processes coordinator_port local_devices out_dir
"""

import json
import os
import sys


def main() -> int:
    pid, nproc, port, local, out_dir = (
        int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], int(sys.argv[4]),
        sys.argv[5],
    )
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={local}"
    )

    import jax

    jax.config.update("jax_platforms", "cpu")

    from ascendpathtracing.parallel import distributed as dist

    if nproc > 1:
        jax.distributed.initialize(
            coordinator_address=f"127.0.0.1:{port}",
            num_processes=nproc,
            process_id=pid,
        )
    assert jax.process_count() == nproc, (jax.process_count(), nproc)
    assert len(jax.devices()) == nproc * local

    import jax.numpy as jnp
    import numpy as np

    from ascendpathtracing import camera, parallel, scenes
    from ascendpathtracing.models import megakernel

    mesh = dist.make_global_mesh()
    w = h = 8
    rays_np = camera.generate_rays_numpy(w, h, 1, seed=0).astype(np.float32)
    rays_sh = dist.host_local_rays(rays_np, mesh)
    scene = megakernel.scene_to_device(scenes.cornell8())

    # full GSPMD train step: loss + params after one SGD update
    params, aux = parallel.split_scene_params(scene)
    params = jax.tree.map(jnp.array, params)
    target = dist.host_local_rays(
        np.zeros((rays_np.shape[0], 3), np.float32), mesh
    )
    step = parallel.make_train_step(mesh, bounces=3, learning_rate=1e-3)
    loss, new_params = step(params, aux, rays_sh, target)
    loss = float(loss)

    # sharded render -> host-0 assembly (collective: all processes join)
    colors_sh = parallel.render_reference_sharded(
        rays_sh, scene, mesh, bounces=3
    )
    ppm = parallel.assemble_ppm_host0(
        colors_sh, w, h, 1, os.path.join(out_dir, "assembled.ppm")
    )

    albedo_sum = float(jnp.sum(new_params["albedo"]))
    with open(os.path.join(out_dir, f"result_{pid}.json"), "w") as fh:
        json.dump({
            "process_index": jax.process_index(),
            "process_count": jax.process_count(),
            "global_devices": len(jax.devices()),
            "loss": loss,
            "albedo_sum": albedo_sum,
            "wrote_ppm": ppm is not None,
        }, fh)
    return 0


if __name__ == "__main__":
    sys.exit(main())
