"""Custom-VJP fused renderer: the jnp replay backward
(pallas_kernels.replay_scene_grads) vs jax AD of the jit megakernel
(interpret mode; the on-card gate is in tests/test_gpu.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ascendpathtracing import camera, scenes
from ascendpathtracing.models import megakernel
from ascendpathtracing.ops import pallas_kernels as pk


def _setup(scene_name):
    scene = scenes.get_scene(scene_name)
    planes = jnp.asarray(scene.soa10())
    rays = camera.generate_rays_numpy(16, 16, 1, seed=0).astype(np.float32)
    dev = megakernel.scene_to_device(scene)
    return scene, planes, rays, dev


def _ad_grads(dev, rays, bounces, weight=None):
    def loss(alb, emi):
        sc = dict(dev, albedo=alb, emission=emi)
        out = megakernel.render_reference_impl(jnp.asarray(rays), sc, bounces=bounces)
        return jnp.sum(out if weight is None else out * weight.T)

    ga, ge = jax.grad(loss, argnums=(0, 1))(dev["albedo"], dev["emission"])
    return np.asarray(ga), np.asarray(ge)


@pytest.mark.parametrize("scene_name", ["cornell8", "smallpt9"])
@pytest.mark.parametrize("bounces", [1, 2, 3, 4, 5])
def test_custom_vjp_matches_ad(scene_name, bounces):
    scene, planes, rays, dev = _setup(scene_name)
    rp = jnp.asarray(rays.T.copy())
    render = pk.make_render_reference_pallas_diff(
        light_index=scene.light_index, bounces=bounces, interpret=True
    )
    gp = np.asarray(jax.grad(lambda p: jnp.sum(render(rp, p)))(planes))
    ga, ge = _ad_grads(dev, rays, bounces)
    np.testing.assert_allclose(gp[7:10].T, ga, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(gp[4:7].T, ge, rtol=1e-4, atol=1e-3)
    # geometry + ray grads are exactly zero (discrete-only dependence)
    assert np.abs(gp[0:4]).max() == 0.0


@pytest.mark.parametrize("bounces", [1, 3, 5])
def test_replay_matches_ad_float64_weighted_cotangent(bounces):
    """float64 (no decision chaos) with a non-trivial cotangent that
    weights each ray and channel differently: the replay is the exact
    product rule, so it agrees with AD to float64 rounding."""
    scene = scenes.cornell8()
    rays = camera.generate_rays_numpy(16, 16, 1, seed=3)
    planes = jnp.asarray(scene.soa10(dtype=np.float64))
    dev = megakernel.scene_to_device(scene, dtype=jnp.float64)
    n = rays.shape[0]
    g = jnp.asarray(np.random.RandomState(0).rand(3, n))
    _, idx = pk.render_reference_pallas_planes_with_idx(
        jnp.asarray(rays.T.copy()), planes, light_index=7, bounces=bounces,
        interpret=True,
    )
    d = np.asarray(pk.replay_scene_grads(idx, planes, g, light_index=7))
    ga, ge = _ad_grads(dev, rays, bounces, weight=g)
    np.testing.assert_allclose(d[7:10].T, ga, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(d[4:7].T, ge, rtol=1e-10, atol=1e-12)
    assert np.abs(d[0:4]).max() == 0.0


@pytest.mark.parametrize("scene_name", ["cornell8", "smallpt9"])
def test_fwd_idx_values_and_indices(scene_name):
    """colors from the idx-emitting forward == plain forward bitwise; the
    stored indices are the XLA loop's winners (S encodes a miss)."""
    scene, planes, rays, dev = _setup(scene_name)
    rp = jnp.asarray(rays.T.copy())
    s = scene.n_spheres
    colors, idx = pk.render_reference_pallas_planes_with_idx(
        rp, planes, light_index=scene.light_index, bounces=5, interpret=True
    )
    plain = pk.render_reference_pallas_planes(
        rp, planes, light_index=scene.light_index, bounces=5, interpret=True
    )
    np.testing.assert_array_equal(np.asarray(colors), np.asarray(plain))
    assert idx.shape == (5, rays.shape[0]) and idx.dtype == np.int8
    i0 = np.asarray(idx).astype(np.int32)
    assert i0.min() >= 0 and i0.max() <= s
    hits = np.asarray(megakernel.render_reference_hits(
        jnp.asarray(rays), dev, bounces=1
    ))[0]
    np.testing.assert_array_equal(np.where(i0[0] == s, -1, i0[0]), hits)


def test_custom_vjp_forward_value_unchanged():
    scene, planes, rays, dev = _setup("cornell8")
    rp = jnp.asarray(rays.T.copy())
    render = pk.make_render_reference_pallas_diff(
        light_index=7, bounces=5, interpret=True
    )
    plain = pk.render_reference_pallas_planes(
        rp, planes, light_index=7, bounces=5, interpret=True
    )
    np.testing.assert_array_equal(np.asarray(render(rp, planes)), np.asarray(plain))


def test_custom_vjp_zero_ray_grads():
    _, planes, rays, _ = _setup("cornell8")
    rp = jnp.asarray(rays.T.copy())
    render = pk.make_render_reference_pallas_diff(
        light_index=7, bounces=3, interpret=True
    )
    dr = jax.grad(lambda r: jnp.sum(render(r, planes)))(rp)
    assert dr.shape == rp.shape
    assert np.abs(np.asarray(dr)).max() == 0.0


def test_int8_indices_reject_huge_scenes():
    planes = jnp.zeros((10, 130), jnp.float32)
    with pytest.raises(ValueError, match="fewer than 127"):
        pk.render_reference_pallas_planes_with_idx(
            jnp.zeros((6, 64), jnp.float32), planes, light_index=0,
            bounces=1, interpret=True,
        )
