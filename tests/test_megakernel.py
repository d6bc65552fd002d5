"""Renderer unit tests (mode sanity, determinism, differentiability)."""

import jax
import jax.numpy as jnp
import numpy as np

from ascendpathtracing import camera, scenes
from ascendpathtracing.models import megakernel


def _rays(w=32, h=32, s=1, seed=0):
    return camera.generate_rays_numpy(w, h, s, seed=seed).astype(np.float32)


def test_reference_mode_deterministic():
    rays = _rays()
    dev = megakernel.scene_to_device(scenes.cornell8())
    a = np.asarray(megakernel.render_reference(rays, dev))
    b = np.asarray(megakernel.render_reference(rays, dev))
    np.testing.assert_array_equal(a, b)
    assert np.isfinite(a).all()
    assert a.max() > 0, "render must not be all black"


def test_reference_mode_not_all_one_color():
    rays = _rays()
    dev = megakernel.scene_to_device(scenes.cornell8())
    img = np.asarray(megakernel.render_reference(rays, dev))
    assert np.unique(img.round(3), axis=0).shape[0] > 10


def test_pt_mode_smoke():
    rays = _rays()
    dev = megakernel.scene_to_device(scenes.smallpt9())
    key = jax.random.PRNGKey(0)
    img = np.asarray(megakernel.render_pt(key, rays, dev, bounces=4, rr_depth=3))
    assert np.isfinite(img).all()
    assert img.min() >= 0
    assert img.max() > 0.5, "light emission should reach the camera"


def test_pt_mode_deterministic_given_key():
    rays = _rays(16, 16)
    dev = megakernel.scene_to_device(scenes.smallpt9())
    key = jax.random.PRNGKey(7)
    a = np.asarray(megakernel.render_pt(key, rays, dev, bounces=3))
    b = np.asarray(megakernel.render_pt(key, rays, dev, bounces=3))
    np.testing.assert_array_equal(a, b)


def test_pt_mode_monte_carlo_converges():
    """Two independent sample sets must agree within Monte-Carlo error on
    the mean image — a statistical correctness check of the estimator."""
    w = h = 16
    rays = _rays(w, h, s=8, seed=1)
    dev = megakernel.scene_to_device(scenes.smallpt9())
    a = np.asarray(megakernel.render_pt(jax.random.PRNGKey(1), rays, dev, bounces=5))
    b = np.asarray(megakernel.render_pt(jax.random.PRNGKey(2), rays, dev, bounces=5))
    # average over the 32 samples of each pixel
    am = a.reshape(w * h, 32, 3).mean(1)
    bm = b.reshape(w * h, 32, 3).mean(1)
    corr = np.corrcoef(am.reshape(-1), bm.reshape(-1))[0, 1]
    assert corr > 0.9, f"independent renders decorrelated: corr={corr:.3f}"


def test_reference_mode_is_differentiable():
    """Scene parameters must have finite, nonzero gradients (the
    differentiable-pass foundation; BASELINE config 4)."""
    rays = _rays(8, 8)
    dev = megakernel.scene_to_device(scenes.cornell8())

    def loss(albedo):
        scene = dict(dev, albedo=albedo)
        img = megakernel.render_reference(rays, scene)
        return jnp.sum(img**2)

    g = jax.grad(loss)(dev["albedo"])
    g = np.asarray(g)
    assert np.isfinite(g).all(), "NaN/inf in albedo gradient"
    assert np.abs(g).max() > 0, "zero gradient"
