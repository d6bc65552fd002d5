"""Differentiable-pass gates (BASELINE config 4): AD gradients vs central
finite differences, in float64 (decision-stable — see
test_reference_parity.py on float32 chaos), for albedo, emission,
geometry (centers, r^2) and camera parameters."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ascendpathtracing import camera as cam_np
from ascendpathtracing import scenes
from ascendpathtracing.diff import CameraParams, camera_rays, check_grads_fd
from ascendpathtracing.models import megakernel

W = H = 12
BOUNCES = 3


@pytest.fixture(scope="module")
def setup():
    rays = jnp.asarray(cam_np.generate_rays_numpy(W, H, 1, seed=0))
    scene = megakernel.scene_to_device(scenes.cornell8(), dtype=jnp.float64)
    target = megakernel.render_reference(rays, scene, bounces=BOUNCES)
    return rays, scene, target


def _loss_fn(rays, scene, target, keys):
    def loss(p):
        sc = dict(scene, **p)
        img = megakernel.render_reference_impl(rays, sc, bounces=BOUNCES)
        return jnp.mean((img - target + 0.05) ** 2)

    return loss


def test_albedo_gradients_match_fd(setup):
    rays, scene, target = setup
    loss = _loss_fn(rays, scene, target, None)
    check_grads_fd(
        lambda p: loss(p), {"albedo": scene["albedo"]},
        eps=1e-6, coords=10, rtol=1e-5, atol=1e-9,
    )


def test_emission_gradients_match_fd(setup):
    rays, scene, target = setup
    loss = _loss_fn(rays, scene, target, None)
    check_grads_fd(
        lambda p: loss(p), {"emission": scene["emission"]},
        eps=1e-6, coords=9, rtol=1e-5, atol=1e-9,
    )


def test_radiance_is_piecewise_constant_in_geometry(setup):
    """Reference-mode radiance = product of discretely-gathered albedos,
    so its geometry gradient is exactly zero almost everywhere (silhouette
    terms are measure-zero and need edge-sampling estimators). Document
    and pin that fact."""
    rays, scene, target = setup
    loss = _loss_fn(rays, scene, target, None)
    g = jax.grad(lambda p: jnp.sum(loss(p)))({"r2": scene["r2"]})
    np.testing.assert_array_equal(np.asarray(g["r2"]), 0.0)


def test_geometry_gradients_match_fd_depth_aov(setup):
    """Geometry gates run against the depth AOV, which depends
    continuously on centers/radii (unlike the radiance, see above)."""
    rays, scene, _ = setup

    def loss(p):
        sc = dict(scene, **p)
        return jnp.mean(megakernel.render_depth_impl(rays, sc) ** 2) * 1e-4

    check_grads_fd(
        loss, {"center": scene["center"]}, eps=1e-4, coords=8, rtol=5e-4,
        atol=1e-12,
    )
    check_grads_fd(
        # r^2 spans 272 (mirror) .. 1e10 (walls): use relative FD steps.
        loss, {"r2": scene["r2"]}, eps=1e-7, rel=True, coords=[0, 4, 6, 7],
        rtol=1e-3, atol=1e-12,
    )


@pytest.mark.parametrize("samples,jittered", [(1, False), (1, True), (2, True)])
def test_camera_gradients_match_fd_depth_aov(setup, samples, jittered):
    """Camera position, direction and fov gradients through
    diff/camera.py vs central finite differences, with and without a
    fixed tent-filter jitter and with several samples per pixel."""
    _, scene, _ = setup
    n = W * H * 4 * samples
    jitter = (jnp.asarray(np.random.RandomState(samples).uniform(-0.9, 0.9, (n, 2)))
              if jittered else jnp.zeros((n, 2), jnp.float64))

    def loss(p):
        rays = camera_rays(p, W, H, samples, jitter=jitter)
        return jnp.mean(megakernel.render_depth_impl(rays, scene) ** 2) * 1e-4

    params = CameraParams(dtype=jnp.float64)
    check_grads_fd(loss, params, eps=1e-6, coords=None, rtol=1e-3, atol=1e-8)


def test_pt_mode_gradients_finite_and_fd_albedo():
    """The Monte-Carlo estimator is differentiable per-sample: with the
    RNG key held fixed the realized path is a deterministic function of
    params, so AD == FD on albedo."""
    rays = jnp.asarray(cam_np.generate_rays_numpy(8, 8, 1, seed=1))
    scene = megakernel.scene_to_device(scenes.smallpt9(), dtype=jnp.float64)
    key = jax.random.PRNGKey(2)

    def loss(p):
        sc = dict(scene, **p)
        img = megakernel.render_pt_impl(key, rays, sc, bounces=3, rr_depth=99)
        return jnp.mean(img)

    check_grads_fd(
        loss, {"albedo": scene["albedo"]}, eps=1e-6, coords=8, rtol=1e-4,
        atol=1e-9,
    )
