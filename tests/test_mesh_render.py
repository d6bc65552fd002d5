"""Mesh-scene rendering (BASELINE config 3 gates): BVH-backed renders must
match brute-force renders, and the combined scene must render sensibly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ascendpathtracing import camera
from ascendpathtracing.accel import meshes
from ascendpathtracing.models import mesh as mesh_mod


def _scene(subdiv=1):
    v, f = meshes.icosphere(center=(50, 40, 60), radius=12.0, subdivisions=subdiv)
    return mesh_mod.MeshScene.cornell_with_mesh(v, f, albedo=(0.9, 0.6, 0.2))


def test_first_hit_bvh_matches_brute_float64():
    """The in-renderer hit combine with BVH == brute force, exactly
    (float64)."""
    ms = _scene(subdiv=2)
    rays = camera.generate_rays_numpy(32, 32, 1, seed=0)
    dev_b = mesh_mod.mesh_scene_to_device(ms, dtype=jnp.float64, use_bvh=True)
    dev_n = mesh_mod.mesh_scene_to_device(ms, dtype=jnp.float64, use_bvh=False)
    t_b, k_b, _ = mesh_mod.first_hit_mesh(jnp.asarray(rays), dev_b)
    t_n, k_n, _ = mesh_mod.first_hit_mesh(jnp.asarray(rays), dev_n)
    np.testing.assert_array_equal(np.asarray(k_b), np.asarray(k_n))
    np.testing.assert_allclose(np.asarray(t_b), np.asarray(t_n), rtol=1e-12)
    # the mesh is actually visible
    assert (np.asarray(k_b) == 2).sum() > 50


def test_render_pt_mesh_smoke_and_determinism():
    ms = _scene(subdiv=1)
    rays = camera.generate_rays_numpy(24, 24, 1, seed=0).astype(np.float32)
    dev = mesh_mod.mesh_scene_to_device(ms, use_bvh=True)
    key = jax.random.PRNGKey(0)
    a = np.asarray(mesh_mod.render_pt_mesh(key, rays, dev, bounces=4))
    b = np.asarray(mesh_mod.render_pt_mesh(key, rays, dev, bounces=4))
    np.testing.assert_array_equal(a, b)
    assert np.isfinite(a).all() and a.min() >= 0 and a.max() > 0.1


def test_render_pt_mesh_bvh_equals_brute_same_key():
    """With identical RNG keys and float64 math, the BVH-backed render and
    the brute-force render are the same estimator — images must agree."""
    ms = _scene(subdiv=1)
    rays = camera.generate_rays_numpy(16, 16, 1, seed=0)
    key = jax.random.PRNGKey(3)
    dev_b = mesh_mod.mesh_scene_to_device(ms, dtype=jnp.float64, use_bvh=True)
    dev_n = mesh_mod.mesh_scene_to_device(ms, dtype=jnp.float64, use_bvh=False)
    a = np.asarray(mesh_mod.render_pt_mesh(key, jnp.asarray(rays), dev_b, bounces=4))
    b = np.asarray(mesh_mod.render_pt_mesh(key, jnp.asarray(rays), dev_n, bounces=4))
    np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-9)


def test_mesh_emissive_lights_work():
    """An emissive mesh must illuminate the scene even with the sphere
    light removed (replaced by a dark sphere)."""
    v, f = meshes.cube(center=(50, 75, 80), size=25.0)
    ms = mesh_mod.MeshScene.cornell_with_mesh(
        v, f, albedo=(0, 0, 0), emission=(15, 15, 15), base_scene="cornell8"
    )
    # dim the sphere light to zero emission
    ms.spheres.emission[:] = 0
    rays = camera.generate_rays_numpy(16, 16, 1, seed=0).astype(np.float32)
    dev = mesh_mod.mesh_scene_to_device(ms)
    img = np.asarray(
        mesh_mod.render_pt_mesh(jax.random.PRNGKey(0), rays, dev, bounces=4)
    )
    assert img.max() > 0.5, "emissive mesh should light the box"


@pytest.mark.parametrize("subdiv", [1, 2])
def test_first_hit_traversal_kernel_matches_brute(subdiv):
    """The Pallas traversal kernel (interpret mode) inside the renderer
    agrees with brute force: same kind, same winning face, t to f32
    rounding."""
    ms = _scene(subdiv=subdiv)
    rays = camera.generate_rays_numpy(24, 24, 1, seed=0).astype(np.float32)
    dev_k = mesh_mod.mesh_scene_to_device(ms, kernel=True, interpret=True)
    assert dev_k["static"].traversal == "kernel"
    dev_n = mesh_mod.mesh_scene_to_device(ms, dtype=jnp.float32, use_bvh=False)
    t_k, k_k, h_k = mesh_mod.first_hit_mesh(jnp.asarray(rays), dev_k)
    t_n, k_n, h_n = mesh_mod.first_hit_mesh(jnp.asarray(rays), dev_n)
    np.testing.assert_array_equal(np.asarray(k_k), np.asarray(k_n))
    tri_hit = np.asarray(k_n) == 2
    assert tri_hit.sum() > 50
    order = np.asarray(dev_k["face_order"])
    np.testing.assert_array_equal(
        order[np.asarray(h_k)[tri_hit]], np.asarray(h_n)[tri_hit]
    )
    np.testing.assert_allclose(
        np.asarray(t_k)[tri_hit], np.asarray(t_n)[tri_hit], rtol=1e-4
    )


def test_render_pt_mesh_kernel_smoke_and_determinism():
    ms = _scene(subdiv=1)
    rays = camera.generate_rays_numpy(16, 16, 1, seed=0).astype(np.float32)
    dev = mesh_mod.mesh_scene_to_device(ms, kernel=True, interpret=True)
    key = jax.random.PRNGKey(0)
    a = np.asarray(mesh_mod.render_pt_mesh(key, rays, dev, bounces=4))
    b = np.asarray(mesh_mod.render_pt_mesh(key, rays, dev, bounces=4))
    np.testing.assert_array_equal(a, b)
    assert np.isfinite(a).all() and a.min() >= 0 and a.max() > 0.1
    # same estimator as the jnp walk over the same BVH
    dev_j = mesh_mod.mesh_scene_to_device(ms, kernel=False)
    c = np.asarray(mesh_mod.render_pt_mesh(key, rays, dev_j, bounces=4))
    assert abs(a.mean() - c.mean()) <= 0.02 * c.mean()


def test_default_traversal_follows_the_backend():
    """backend.py decides: the kernel on a GPU, the jnp walk elsewhere;
    asking for the compiled kernel on the CPU is an error."""
    ms = _scene(subdiv=1)
    assert mesh_mod.mesh_scene_to_device(ms)["static"].traversal == "jnp"
    assert mesh_mod.mesh_scene_to_device(ms, use_bvh=False)["static"].traversal == "brute"
    with pytest.raises(RuntimeError, match="need a GPU"):
        mesh_mod.mesh_scene_to_device(ms, kernel=True)
    with pytest.raises(ValueError, match="use_bvh"):
        mesh_mod.mesh_scene_to_device(ms, kernel=True, use_bvh=False,
                                      interpret=True)
