"""Checkpoint round-trip + training resume continuity."""

import numpy as np

from ascendpathtracing.utils import checkpoint as ckpt


def test_roundtrip_nested_pytree(tmp_path, rng):
    params = {
        "albedo": rng.rand(8, 3).astype(np.float32),
        "nested": {"a": rng.rand(4), "b": [rng.rand(2), rng.rand(3)]},
        "tup": (rng.rand(5), {"x": rng.rand(1)}),
    }
    p = str(tmp_path / "ck.npz")
    ckpt.save_checkpoint(p, params, step=17, extra={"note": "hi"})
    back, step, extra = ckpt.load_checkpoint(p)
    assert step == 17 and extra == {"note": "hi"}
    assert isinstance(back["nested"]["b"], list)
    assert isinstance(back["tup"], tuple)
    np.testing.assert_array_equal(back["albedo"], params["albedo"])
    np.testing.assert_array_equal(back["tup"][1]["x"], params["tup"][1]["x"])


def test_atomic_overwrite(tmp_path, rng):
    p = str(tmp_path / "ck.npz")
    ckpt.save_checkpoint(p, {"w": rng.rand(3)}, step=1)
    ckpt.save_checkpoint(p, {"w": rng.rand(3)}, step=2)
    _, step, _ = ckpt.load_checkpoint(p)
    assert step == 2


def test_training_resume_continues_loss_descent(tmp_path):
    """Split one 20-step run into 10 + resume(10): final params equal."""
    import jax
    import jax.numpy as jnp

    from ascendpathtracing import camera, scenes
    from ascendpathtracing.models import megakernel
    from ascendpathtracing.parallel.sharded import make_train_step, split_scene_params

    rays = jnp.asarray(camera.generate_rays_numpy(8, 8, 1, seed=0).astype(np.float32))
    scene = megakernel.scene_to_device(scenes.cornell8())
    target = megakernel.render_reference(rays, scene, bounces=2)
    params0, aux = split_scene_params(scene)
    params0 = dict(params0, albedo=params0["albedo"] + 0.05)
    step_fn = make_train_step(None, bounces=2, learning_rate=0.05)

    # straight 20 steps
    pa = {k: v.copy() for k, v in params0.items()}
    for _ in range(20):
        _, pa = step_fn(pa, aux, rays, target)

    # 10 steps -> checkpoint -> reload -> 10 steps
    pb = {k: v.copy() for k, v in params0.items()}
    for _ in range(10):
        _, pb = step_fn(pb, aux, rays, target)
    p = str(tmp_path / "ck.npz")
    ckpt.save_checkpoint(p, pb, step=10)
    pb2, step, _ = ckpt.load_checkpoint(p)
    assert step == 10
    pb2 = {k: jnp.asarray(v) for k, v in pb2.items()}
    for _ in range(10):
        _, pb2 = step_fn(pb2, aux, rays, target)

    for k in pa:
        np.testing.assert_allclose(
            np.asarray(pa[k]), np.asarray(pb2[k]), rtol=1e-6, atol=1e-7
        )
