"""Ring-parallelism gates: both decompositions (rays rotating over
bounce stages; scene chunks rotating over ray shards) must equal the
single-device megakernel bit for bit (float64)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from ascendpathtracing import camera, scenes
from ascendpathtracing.models import megakernel
from ascendpathtracing.parallel.pipeline import (
    render_pt_ring_scene,
    render_reference_pipelined,
    render_reference_ring_scene,
)


@pytest.fixture(scope="module")
def setup():
    rays = jnp.asarray(camera.generate_rays_numpy(16, 16, 1, seed=0))
    scene = megakernel.scene_to_device(scenes.cornell8(), dtype=jnp.float64)
    expect = np.asarray(megakernel.render_reference(rays, scene, bounces=8))
    return rays, scene, expect


@pytest.mark.parametrize("stages", [2, 4, 8])
def test_pipelined_equals_megakernel(setup, stages):
    if len(jax.devices()) < stages:
        pytest.skip("not enough devices")
    rays, scene, expect = setup
    mesh = Mesh(np.asarray(jax.devices()[:stages]), ("stage",))
    got = np.asarray(render_reference_pipelined(rays, scene, mesh, bounces=8))
    np.testing.assert_array_equal(expect, got)


def test_pipelined_output_is_stage_sharded(setup):
    """PP must BOUND memory: outputs (and ray state) stay sharded over
    the stage axis — the round-1 version replicated both."""
    rays, scene, _ = setup
    stages = min(4, len(jax.devices()))
    mesh = Mesh(np.asarray(jax.devices()[:stages]), ("stage",))
    out = render_reference_pipelined(rays, scene, mesh, bounces=8)
    assert len(out.sharding.device_set) == stages
    shard_rows = {sh.data.shape[0] for sh in out.addressable_shards}
    assert shard_rows == {rays.shape[0] // stages}


@pytest.mark.parametrize("stages", [2, 4, 8])
def test_ring_scene_sharded_equals_megakernel(setup, stages):
    """Scene tables sharded 1/S per stage and ROTATED around the ring
    (the giant-scene decomposition): winner carriers must reproduce the
    single-device render exactly, including the lowest-index tie-break
    and the miss-wraps-to-last-sphere default (8 spheres / 8 stages puts
    ONE sphere per device — the hardest carve)."""
    if len(jax.devices()) < stages:
        pytest.skip("not enough devices")
    rays, scene, expect = setup
    mesh = Mesh(np.asarray(jax.devices()[:stages]), ("stage",))
    got = np.asarray(
        render_reference_ring_scene(rays, scene, mesh, bounces=8)
    )
    np.testing.assert_array_equal(expect, got)


def test_ring_scene_holds_shards_not_replicas(setup):
    """The point of the scene ring: each device's resident scene block
    is s/S rows (the in_specs are P('stage'), not P())."""
    rays, scene, _ = setup
    stages = min(4, len(jax.devices()))
    mesh = Mesh(np.asarray(jax.devices()[:stages]), ("stage",))
    out = render_reference_ring_scene(rays, scene, mesh, bounces=4)
    assert len(out.sharding.device_set) == stages
    shard_rows = {sh.data.shape[0] for sh in out.addressable_shards}
    assert shard_rows == {rays.shape[0] // stages}


@pytest.mark.parametrize("stages", [2, 4, 8])
def test_pt_ring_scene_equals_megakernel(stages):
    """The FULL PT estimator (diffuse/mirror/glass + RR) over the scene
    ring: carriers transport emission + material one-hots, the uniform
    stream is drawn once at global size and sharded with the rays —
    bit-equal to megakernel.render_pt (8 spheres / 8 stages = one sphere
    per device)."""
    if len(jax.devices()) < stages:
        pytest.skip("not enough devices")
    rays = jnp.asarray(camera.generate_rays_numpy(16, 16, 1, seed=0))
    scene = megakernel.scene_to_device(scenes.smallpt9(), dtype=jnp.float64)
    key = jax.random.PRNGKey(11)
    expect = np.asarray(
        megakernel.render_pt(key, rays, scene, bounces=6, rr_depth=4)
    )
    # 9 smallpt spheres don't divide by the stage count — pad with
    # never-hit spheres: r2 = -1 makes the discriminant b^2 - (|oc|^2+1)
    # strictly negative for any ray (robust even to |d| != 1 rounding),
    # so pads cannot win any nearest-hit combine
    s = scene["r2"].shape[0]
    s_pad = -(-s // stages) * stages
    if s_pad != s:
        padn = s_pad - s
        scene = dict(
            scene,
            r2=jnp.concatenate(
                [scene["r2"], jnp.full((padn,), -1.0, jnp.float64)]
            ),
            center=jnp.concatenate(
                [scene["center"], jnp.zeros((padn, 3), jnp.float64)]
            ),
            albedo=jnp.concatenate(
                [scene["albedo"], jnp.zeros((padn, 3), jnp.float64)]
            ),
            emission=jnp.concatenate(
                [scene["emission"], jnp.zeros((padn, 3), jnp.float64)]
            ),
            material=jnp.concatenate(
                [scene["material"], jnp.zeros((padn,), jnp.int32)]
            ),
        )
    mesh = Mesh(np.asarray(jax.devices()[:stages]), ("stage",))
    got = np.asarray(
        render_pt_ring_scene(key, rays, scene, mesh, bounces=6, rr_depth=4)
    )
    np.testing.assert_array_equal(expect, got)


def test_ring_scene_validates_divisibility(setup):
    rays, scene, _ = setup
    mesh = Mesh(np.asarray(jax.devices()[:3]), ("stage",))
    with pytest.raises(ValueError, match="not divisible"):
        render_reference_ring_scene(rays, scene, mesh, bounces=4)


def test_pipelined_validates_divisibility(setup):
    rays, scene, _ = setup
    mesh = Mesh(np.asarray(jax.devices()[:4]), ("stage",))
    with pytest.raises(ValueError, match="not divisible"):
        render_reference_pipelined(rays, scene, mesh, bounces=6)
    with pytest.raises(ValueError, match="not divisible"):
        render_reference_pipelined(rays[:1023], scene, mesh, bounces=8)
