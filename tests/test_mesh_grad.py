"""Differentiable mesh pass gates (BASELINE config 4 generalized beyond
spheres): finite differences vs AD in float64 on the brute path, and
traversal-kernel-path gradients vs the brute-path gold on the same scene.

Gradient semantics: discrete hit decisions are detached (reparameterized
per the north star); face attributes flow through the radiance estimator,
vertices flow through the first-hit depth AOV (the same depth-based gate
diff/camera.py uses for camera geometry)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ascendpathtracing import camera
from ascendpathtracing.accel import meshes
from ascendpathtracing.diff import mesh as dmesh
from ascendpathtracing.models import mesh as mesh_mod


def _setup(traversal, dtype):
    v, f = meshes.icosphere(center=(50, 40, 60), radius=12.0, subdivisions=1)
    ms = mesh_mod.MeshScene.cornell_with_mesh(v, f, albedo=(0.6, 0.5, 0.4))
    if traversal == "kernel":
        dev = mesh_mod.mesh_scene_to_device(ms, kernel=True, interpret=True)
    elif traversal == "jnp":
        dev = mesh_mod.mesh_scene_to_device(ms, dtype=dtype, kernel=False)
    else:
        dev = mesh_mod.mesh_scene_to_device(ms, dtype=dtype, use_bvh=False)
    params = dmesh.mesh_params(ms, dtype)
    faces = jnp.asarray(np.asarray(ms.faces))
    rays = jnp.asarray(
        camera.generate_rays_numpy(24, 24, 1, seed=0).astype(
            np.float64 if dtype == jnp.float64 else np.float32
        )
    )
    return ms, dev, params, faces, rays


def _radiance_loss(params, key, rays, dev, faces):
    # 4 bounces: enough for camera -> mesh -> (wall ->) light paths, so
    # mesh ALBEDO gradients are nonzero, not just emission ones
    img = dmesh.render_pt_mesh_params(key, rays, params, dev, faces, bounces=4)
    return jnp.mean(img)


def _depth_loss(params, rays, dev, faces):
    d = dmesh.depth_aov_params(rays, params, dev, faces)
    m = jax.lax.stop_gradient(d < 1e19).astype(d.dtype)
    return jnp.sum(d * m)


def test_face_attribute_grads_match_fd_float64():
    _, dev, params, faces, rays = _setup("brute", jnp.float64)
    key = jax.random.PRNGKey(7)
    loss = lambda p: _radiance_loss(p, key, rays, dev, faces)
    g = jax.grad(loss)(params)

    h = 1e-6
    for name in ("face_albedo", "face_emission"):
        arr = np.asarray(g[name])
        assert np.abs(arr).max() > 0, f"{name}: AD gradient is identically zero"
        # probe the largest-|grad| coordinates (faces actually on a
        # camera->...->light path)
        for fi in np.argsort(-np.abs(arr).ravel())[:5]:
            i, j = divmod(int(fi), 3)
            e = jnp.zeros_like(params[name]).at[i, j].set(h)
            fd = (float(loss({**params, name: params[name] + e}))
                  - float(loss({**params, name: params[name] - e}))) / (2 * h)
            np.testing.assert_allclose(arr[i, j], fd, rtol=1e-5, atol=1e-10)


def test_vertex_grads_via_depth_aov_match_fd_float64():
    _, dev, params, faces, rays = _setup("brute", jnp.float64)
    loss = lambda p: _depth_loss(p, rays, dev, faces)
    g = np.asarray(jax.grad(loss)(params)["vertices"])
    assert np.abs(g).max() > 0, "no vertex gradient at all"

    # probe the largest-gradient coordinates (surely-hit vertices)
    flat = np.argsort(-np.abs(g).ravel())[:6]
    h = 1e-6
    for fi in flat:
        i, j = divmod(int(fi), 3)
        e = jnp.zeros_like(params["vertices"]).at[i, j].set(h)
        fd = (float(loss({**params, "vertices": params["vertices"] + e}))
              - float(loss({**params, "vertices": params["vertices"] - e}))) / (2 * h)
        np.testing.assert_allclose(g[i, j], fd, rtol=1e-4, atol=1e-8)


@pytest.mark.parametrize("traversal", ["kernel", "jnp"])
def test_bvh_traversal_grads_match_brute(traversal):
    """The detached-traversal + recompute path (the Pallas kernel, and
    the jnp while_loop walk) must produce the same gradients as the
    fully-differentiable brute path (same decisions, f32 formula noise
    only)."""
    _, dev_b, params, faces, rays = _setup("brute", jnp.float32)
    _, dev_c, _, _, _ = _setup(traversal, jnp.float32)
    key = jax.random.PRNGKey(7)

    ga = jax.grad(lambda p: _radiance_loss(p, key, rays, dev_c, faces))(params)
    gb = jax.grad(lambda p: _radiance_loss(p, key, rays, dev_b, faces))(params)
    for name in ("face_albedo", "face_emission"):
        a, b = np.asarray(ga[name]), np.asarray(gb[name])
        denom = np.abs(b).max()
        assert denom > 0
        np.testing.assert_allclose(a, b, atol=5e-3 * denom, rtol=5e-2)

    da = np.asarray(jax.grad(lambda p: _depth_loss(p, rays, dev_c, faces))(params)["vertices"])
    db = np.asarray(jax.grad(lambda p: _depth_loss(p, rays, dev_b, faces))(params)["vertices"])
    np.testing.assert_allclose(da, db, atol=5e-3 * np.abs(db).max(), rtol=5e-2)


def test_vertex_optimization_loop_with_rebuild_guard():
    """The documented kernel-traversal workflow (diff/mesh.py docstring
    + VERDICT r2 item 10): optimize vertices against a depth target,
    guarding each step with assert_tables_fresh and rebuilding the
    device scene outside jit when the kernel tables go stale."""
    import dataclasses

    ms, dev, params, faces, rays = _setup("kernel", jnp.float32)
    target = dmesh.depth_aov_params(rays, params, dev, faces) * 0.98

    def loss_fn(p):
        d = dmesh.depth_aov_params(rays, p, dev, faces)
        m = jax.lax.stop_gradient((d < 1e19) & (target < 1e19)).astype(d.dtype)
        return jnp.mean(((d - target) * m) ** 2)

    grad_fn = jax.grad(loss_fn)
    l0 = float(loss_fn(params))
    rebuilds = 0
    # lr and tol sized so the guard actually trips within a few
    # iterations (measured drift ~5e-5 of the diagonal per step here)
    lr = 2e-1
    for _ in range(6):
        g = grad_fn(params)
        params = {**params,
                  "vertices": params["vertices"] - lr * g["vertices"]}
        try:
            dmesh.assert_tables_fresh(params, dev, faces, tol=1e-4)
        except dmesh.StaleKernelTablesError:
            # the documented recovery: rebuild the packed kernel tables
            # from the moved vertices, outside jit
            ms2 = dataclasses.replace(
                ms, vertices=np.asarray(params["vertices"], np.float64)
            )
            dev = mesh_mod.mesh_scene_to_device(ms2, kernel=True, interpret=True)
            rebuilds += 1
            assert dmesh.table_drift(params, dev, faces) < 1e-6
    l1 = float(loss_fn(params))
    assert np.isfinite(l1)
    assert l1 < l0, (l0, l1)
    assert rebuilds >= 1, "guard never tripped — test not exercising rebuild"


@pytest.mark.parametrize("traversal", ["brute", "jnp"])
def test_table_drift_zero_for_brute(traversal):
    """Traversals that walk the traced planes themselves have no frozen
    tables to drift from."""
    ms, dev, params, faces, rays = _setup(traversal, jnp.float64)
    moved = {**params, "vertices": params["vertices"] + 1.0}
    assert dmesh.table_drift(moved, dev, faces) == 0.0


def test_table_drift_sees_non_v0_vertices():
    """Drift concentrated in a vertex that never occupies the v0 slot of
    any face must still trip the guard (ADVICE r3 medium #2: the old
    check compared only grid.tris[:, 0:3])."""
    v = np.array(
        [[0.0, 0.0, 0.0], [30.0, 0.0, 0.0], [30.0, 30.0, 0.0],
         [0.0, 30.0, 0.0]]
    ) + np.array([35.0, 25.0, 50.0])
    f = np.array([[0, 1, 2], [0, 2, 3]])  # vertex 3 is only ever v2
    assert 3 not in f[:, 0]
    ms = mesh_mod.MeshScene.cornell_with_mesh(v, f, albedo=(0.6, 0.5, 0.4))
    dev = mesh_mod.mesh_scene_to_device(ms, kernel=True, interpret=True)
    params = dmesh.mesh_params(ms, jnp.float32)
    faces = jnp.asarray(np.asarray(ms.faces))
    assert dmesh.table_drift(params, dev, faces) < 1e-6
    moved = np.asarray(params["vertices"]).copy()
    moved[3] += 5.0  # big, unambiguous drift in a non-v0 vertex
    params2 = {**params, "vertices": jnp.asarray(moved)}
    d = dmesh.table_drift(params2, dev, faces)
    assert d > 0.01, d
