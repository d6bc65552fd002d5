"""Next-event-estimation gates: unbiasedness vs the BSDF-only estimator
and variance reduction on a small-light scene."""

import jax
import jax.numpy as jnp
import numpy as np

from ascendpathtracing import camera, scenes
from ascendpathtracing.models import megakernel as mk


def _samples(scene_name, fn, key, w=12, h=12, spp4=64, bounces=5):
    sc = mk.scene_to_device(scenes.get_scene(scene_name))
    rays = jnp.asarray(
        camera.generate_rays_numpy(w, h, spp4 // 4, seed=0).astype(np.float32)
    )
    out = np.asarray(fn(key, rays, sc, bounces=bounces))
    return out.reshape(w * h, spp4, 3)


def test_nee_unbiased_vs_bsdf_sampling():
    a = _samples("cornell-smalllight", mk.render_pt_nee, jax.random.PRNGKey(0))
    b = _samples("cornell-smalllight", mk.render_pt, jax.random.PRNGKey(1))
    ratio = a.mean() / b.mean()
    assert 0.95 < ratio < 1.05, ratio
    corr = np.corrcoef(a.mean(1).reshape(-1), b.mean(1).reshape(-1))[0, 1]
    assert corr > 0.95, corr


def test_nee_reduces_variance_on_small_light():
    a = _samples("cornell-smalllight", mk.render_pt_nee, jax.random.PRNGKey(2))
    b = _samples("cornell-smalllight", mk.render_pt, jax.random.PRNGKey(3))
    reduction = b.var(1).mean() / a.var(1).mean()
    assert reduction > 1.5, reduction


def test_nee_matches_on_big_light_scene():
    """On the stock scene the light subtends ~a hemisphere; NEE reduces to
    (correct) near-parity with BSDF sampling."""
    a = _samples("cornell8", mk.render_pt_nee, jax.random.PRNGKey(4))
    b = _samples("cornell8", mk.render_pt, jax.random.PRNGKey(5))
    ratio = a.mean() / b.mean()
    assert 0.93 < ratio < 1.07, ratio


def test_nee_deterministic():
    a = _samples("cornell-smalllight", mk.render_pt_nee, jax.random.PRNGKey(6))
    b = _samples("cornell-smalllight", mk.render_pt_nee, jax.random.PRNGKey(6))
    np.testing.assert_array_equal(a, b)
