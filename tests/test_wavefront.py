"""Wavefront renderer gates: determinism, sample conservation, and
statistical agreement with the megakernel estimator."""

import jax
import jax.numpy as jnp
import numpy as np

from ascendpathtracing import camera, scenes
from ascendpathtracing.models import megakernel, wavefront


def _pixel_mean_megakernel(key, w, h, spp4, scene, bounces):
    s = spp4 // 4
    rays = camera.generate_rays_numpy(w, h, s, seed=0).astype(np.float32)
    img = np.asarray(
        megakernel.render_pt(key, jnp.asarray(rays), scene, bounces=bounces)
    )
    return img.reshape(w * h, spp4, 3).mean(1)


def test_wavefront_deterministic():
    scene = megakernel.scene_to_device(scenes.smallpt9())
    key = jax.random.PRNGKey(0)
    kw = dict(width=8, height=8, spp4=8, pool=256, bounces=4)
    a = np.asarray(wavefront.render_wavefront(key, scene, **kw))
    b = np.asarray(wavefront.render_wavefront(key, scene, **kw))
    np.testing.assert_array_equal(a, b)
    assert np.isfinite(a).all() and a.max() > 0.1


def test_wavefront_pool_size_consistency():
    """Different pool sizes are different schedules of the same sample
    stream; with camera jitter keyed by global sample index the images
    must agree within per-bounce-RNG Monte-Carlo noise."""
    scene = megakernel.scene_to_device(scenes.cornell8())
    key = jax.random.PRNGKey(1)
    kw = dict(width=8, height=8, spp4=32, bounces=4)
    a = np.asarray(wavefront.render_wavefront(key, scene, pool=256, **kw))
    b = np.asarray(wavefront.render_wavefront(key, scene, pool=2048, **kw))
    # same camera rays, different per-bounce draws: images correlate strongly
    corr = np.corrcoef(a.reshape(-1), b.reshape(-1))[0, 1]
    assert corr > 0.95, corr


def test_wavefront_matches_megakernel_statistically():
    """Same estimator as megakernel pt mode: pixel means must agree
    within Monte-Carlo error at moderate spp."""
    scene = megakernel.scene_to_device(scenes.cornell8())
    w = h = 8
    spp4 = 256
    a = np.asarray(
        wavefront.render_wavefront(
            jax.random.PRNGKey(2), scene, width=w, height=h, spp4=spp4,
            pool=4096, bounces=5,
        )
    )
    b = _pixel_mean_megakernel(jax.random.PRNGKey(3), w, h, spp4, scene, 5)
    corr = np.corrcoef(a.reshape(-1), b.reshape(-1))[0, 1]
    assert corr > 0.96, corr
    # overall energy within a few percent
    ratio = a.mean() / max(b.mean(), 1e-9)
    assert 0.85 < ratio < 1.15, ratio


def test_wavefront_no_compaction_path():
    scene = megakernel.scene_to_device(scenes.cornell8())
    key = jax.random.PRNGKey(4)
    a = np.asarray(
        wavefront.render_wavefront(
            key, scene, width=8, height=8, spp4=4, pool=256, bounces=3,
            compact=False,
        )
    )
    assert np.isfinite(a).all() and a.max() > 0.1


def test_wavefront_mesh_matches_pt_mesh_statistically():
    """Mesh-scene wavefront (fused compaction+Morton sort, VERDICT item
    4) must agree in distribution with the bounce-loop mesh renderer on
    the same scene (independent RNG streams -> statistical gate)."""
    from ascendpathtracing.accel import meshes as mesh_lib
    from ascendpathtracing.models import mesh as mesh_mod

    v, f = mesh_lib.cube(center=(50, 30, 60), size=30.0)
    ms = mesh_mod.MeshScene.cornell_with_mesh(v, f, albedo=(0.85, 0.55, 0.2))
    mdev = mesh_mod.mesh_scene_to_device(ms, use_bvh=False)

    w = h = 16
    spp4 = 64
    a = np.asarray(
        wavefront.render_wavefront_mesh(
            jax.random.PRNGKey(2), mdev, width=w, height=h, spp4=spp4,
            pool=4096, bounces=5,
        )
    )
    rays = camera.generate_rays_numpy(w, h, spp4 // 4, seed=0).astype(np.float32)
    b = np.asarray(
        mesh_mod.render_pt_mesh(
            jax.random.PRNGKey(3), jnp.asarray(rays), mdev, bounces=5
        )
    ).reshape(w * h, spp4, 3).mean(1)
    assert np.isfinite(a).all()
    corr = np.corrcoef(a.reshape(-1), b.reshape(-1))[0, 1]
    assert corr > 0.93, corr
    ratio = a.mean() / max(b.mean(), 1e-9)
    assert 0.85 < ratio < 1.15, ratio


def test_wavefront_mesh_pool_size_consistency():
    """Energy must be pool-size invariant (compaction/regeneration must
    not double-count or drop samples)."""
    from ascendpathtracing.accel import meshes as mesh_lib
    from ascendpathtracing.models import mesh as mesh_mod

    v, f = mesh_lib.cube(center=(50, 30, 60), size=30.0)
    ms = mesh_mod.MeshScene.cornell_with_mesh(v, f, albedo=(0.85, 0.55, 0.2))
    mdev = mesh_mod.mesh_scene_to_device(ms, use_bvh=False)
    imgs = [
        np.asarray(
            wavefront.render_wavefront_mesh(
                jax.random.PRNGKey(7), mdev, width=8, height=8, spp4=32,
                pool=pool, bounces=4,
            )
        )
        for pool in (2048, 4096)
    ]
    ratio = imgs[0].mean() / max(imgs[1].mean(), 1e-9)
    assert 0.8 < ratio < 1.25, ratio


def test_wavefront_mesh_sort_every_energy_invariant():
    """Deferring compaction (sort_every=2) must not change total energy
    beyond RNG noise — samples are neither dropped nor double-counted."""
    from ascendpathtracing.accel import meshes as mesh_lib
    from ascendpathtracing.models import mesh as mesh_mod

    v, f = mesh_lib.cube(center=(50, 30, 60), size=30.0)
    ms = mesh_mod.MeshScene.cornell_with_mesh(v, f, albedo=(0.85, 0.55, 0.2))
    mdev = mesh_mod.mesh_scene_to_device(ms, use_bvh=False)
    imgs = [
        np.asarray(
            wavefront.render_wavefront_mesh(
                jax.random.PRNGKey(7), mdev, width=8, height=8, spp4=32,
                pool=2048, bounces=4, sort_every=se,
            )
        )
        for se in (1, 2, 3)
    ]
    for img in imgs[1:]:
        ratio = imgs[0].mean() / max(img.mean(), 1e-9)
        assert 0.8 < ratio < 1.25, ratio
