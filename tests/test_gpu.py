"""Tests that need the card.  On the GPU run them with

    python -m pytest tests/ -m gpu

(chip_smoke.py runs them in-process first).  Elsewhere they skip from
the ``gpu_device`` fixture.  They cover what the CPU suite cannot: the
Triton kernels compiled for the card, and the wavefront renderers'
fused-sort compaction executed on the device (an earlier argsort+gather
form crashed a device runtime while passing every CPU test).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ascendpathtracing import camera, scenes
from ascendpathtracing.models import megakernel

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("scene_name", ["cornell8", "smallpt9"])
def test_sphere_kernel_matches_xla_one_bounce(gpu_device, scene_name):
    from ascendpathtracing.ops import pallas_kernels as pk

    scene = scenes.get_scene(scene_name)
    rays = jnp.asarray(camera.generate_rays_numpy(64, 48, 1, seed=0).astype(np.float32))
    got = np.asarray(pk.render_reference_pallas(
        rays, jnp.asarray(scene.soa10()), light_index=scene.light_index,
        bounces=1,
    ))
    ref = np.asarray(megakernel.render_reference(
        rays, megakernel.scene_to_device(scene), bounces=1
    ))
    # relative 1e-5: the GPU compilers may contract multiply-adds
    # differently from each other
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


def test_sphere_kernel_grads_match_xla_ad(gpu_device):
    from ascendpathtracing.ops import pallas_kernels as pk

    scene = scenes.cornell8()
    rays = camera.generate_rays_numpy(32, 32, 1, seed=0).astype(np.float32)
    planes = jnp.asarray(scene.soa10())
    render = pk.make_render_reference_pallas_diff(light_index=7, bounces=1)
    gp = np.asarray(jax.grad(lambda p: jnp.sum(render(jnp.asarray(rays.T), p)))(planes))
    dev = megakernel.scene_to_device(scene)
    ga, ge = jax.grad(
        lambda a, e: jnp.sum(megakernel.render_reference_impl(
            jnp.asarray(rays), dict(dev, albedo=a, emission=e), bounces=1)),
        argnums=(0, 1),
    )(dev["albedo"], dev["emission"])
    np.testing.assert_allclose(gp[7:10].T, ga, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(gp[4:7].T, ge, rtol=1e-4, atol=1e-3)
    assert np.abs(gp[0:4]).max() == 0.0


def test_bvh_kernel_matches_xla_traversal(gpu_device):
    from ascendpathtracing.accel import bvh as bvh_mod, meshes, tri
    from ascendpathtracing.ops import pallas_bvh

    v, f = meshes.icosphere(center=(50, 40, 60), radius=14.0, subdivisions=3)
    v32 = np.asarray(v, np.float32)
    bvh = bvh_mod.build_bvh(v32, f)
    planes = tri.triangle_planes(v32, f, dtype=np.float32)
    ordered = tuple(tuple(p[bvh.tri_order] for p in t) for t in planes)
    tables = pallas_bvh.pack_bvh(bvh, ordered)
    rng = np.random.RandomState(0)
    n = 1 << 16
    o = (np.asarray([50, 40, 60]) + rng.uniform(-30, 30, (n, 3))).astype(np.float32)
    d = rng.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    block, warps = pallas_bvh.launch_config(tables, max_leaf=bvh.max_leaf)
    tk, hk = pallas_bvh.intersect_bvh_pallas(
        jnp.asarray(np.concatenate([o, d], 1).T), *tables,
        max_leaf=bvh.max_leaf, block=block, num_warps=warps,
    )
    tj, hj, _ = bvh_mod.intersect_bvh(
        tuple(jnp.asarray(o[:, i]) for i in range(3)),
        tuple(jnp.asarray(d[:, i]) for i in range(3)),
        bvh_mod.bvh_to_device(bvh),
        tuple(tuple(jnp.asarray(p) for p in t) for t in ordered), 1e-4,
        bvh.max_leaf,
    )
    tk, hk, tj, hj = map(np.asarray, (tk, hk, tj, hj))
    hit = tj < 1e19
    assert hit.any()
    np.testing.assert_array_equal(tk < 1e19, hit)
    np.testing.assert_array_equal(hk[hit], hj[hit])
    np.testing.assert_allclose(tk[hit], tj[hit], rtol=1e-4)


def test_wavefront_sphere_runs_on_card(gpu_device):
    from ascendpathtracing.models import wavefront as wf

    scene = megakernel.scene_to_device(scenes.cornell8())
    out = np.asarray(
        wf.render_wavefront(
            jax.random.PRNGKey(0), scene, width=32, height=32, spp4=32,
            pool=1 << 12, bounces=8, rr_depth=5,
        )
    )
    assert np.isfinite(out).all() and out.std() > 0
    # energy parity vs the jit megakernel estimator
    rays = camera.generate_rays_numpy(32, 32, 8, seed=0).astype(np.float32)
    ref = np.asarray(
        megakernel.render_pt(
            jax.random.PRNGKey(1), jnp.asarray(rays), scene, bounces=8
        )
    ).reshape(32 * 32, 32, 3).mean(1)
    ratio = out.mean() / max(ref.mean(), 1e-9)
    assert 0.9 < ratio < 1.1, ratio


def test_wavefront_mesh_runs_on_card(gpu_device):
    from ascendpathtracing.accel import meshes as mesh_lib
    from ascendpathtracing.models import mesh as mesh_mod, wavefront as wf

    v, f = mesh_lib.icosphere(center=(50, 40, 60), radius=14.0, subdivisions=3)
    ms = mesh_mod.MeshScene.cornell_with_mesh(v, f, albedo=(0.85, 0.55, 0.2))
    mdev = mesh_mod.mesh_scene_to_device(ms)
    assert mdev["static"].traversal == "kernel"
    out = np.asarray(
        wf.render_wavefront_mesh(
            jax.random.PRNGKey(0), mdev, width=32, height=32, spp4=16,
            pool=2048, bounces=6, rr_depth=4,
        )
    )
    assert np.isfinite(out).all() and out.std() > 0
