"""Fused sphere kernel (ops/pallas_kernels.py) in the Pallas interpreter
against the plain references: the NumPy oracle and the XLA bounce loop.
The same kernel compiles for the GPU through Triton; tests/test_gpu.py
runs it there, and test_kernels_lower_for_gpu below checks here that it
lowers to Triton IR."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ascendpathtracing import camera, oracle, scenes
from ascendpathtracing.models import megakernel
from ascendpathtracing.ops import pallas_kernels


@pytest.mark.parametrize("scene_name", ["cornell8", "smallpt9"])
@pytest.mark.parametrize("wh", [(32, 32), (16, 10), (7, 5)])
def test_pallas_matches_oracle_one_bounce_bitwise(scene_name, wh):
    """Ray counts 4096, 640 and 140: the last block is ragged in the
    latter two (masked loads and stores)."""
    scene = scenes.get_scene(scene_name)
    rays = camera.generate_rays_numpy(*wh, 1, seed=0).astype(np.float32)
    expect = oracle.render_reference_numpy(rays, scene, bounces=1)
    got = np.asarray(
        pallas_kernels.render_reference_pallas(
            jnp.asarray(rays), jnp.asarray(scene.soa10()),
            light_index=scene.light_index, bounces=1, interpret=True,
        )
    )
    np.testing.assert_array_equal(expect, got)


@pytest.mark.parametrize("scene_name", ["cornell8", "smallpt9"])
def test_pallas_matches_megakernel_float64_full_depth(scene_name):
    """Stable full-logic gate: float64 interpret-mode kernel vs the jit
    megakernel must agree to float64 noise at 5 bounces."""
    scene = scenes.get_scene(scene_name)
    planes = jnp.asarray(scene.soa10(dtype=np.float64))
    rays = camera.generate_rays_numpy(32, 32, 1, seed=0)
    dev = megakernel.scene_to_device(scene, dtype=jnp.float64)
    expect = np.asarray(megakernel.render_reference(rays, dev, bounces=5))
    got = np.asarray(
        pallas_kernels.render_reference_pallas(
            jnp.asarray(rays), planes, light_index=scene.light_index,
            bounces=5, interpret=True,
        )
    )
    np.testing.assert_allclose(expect, got, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("block", [128, 256, 512])
@pytest.mark.parametrize("n", [1000, 1024, 1537])
def test_pallas_block_sizes_and_ragged_counts(block, n):
    """Every block size gives the same colors for ragged and exact ray
    counts; lanes past N are never written."""
    scene = scenes.cornell8()
    base = camera.generate_rays_numpy(24, 24, 1, seed=1).astype(np.float32)
    rays = np.concatenate([base] * (-(-n // base.shape[0])))[:n]
    rp = jnp.asarray(rays.T.copy())
    planes = jnp.asarray(scene.soa10())
    got = np.asarray(pallas_kernels.render_reference_pallas_planes(
        rp, planes, light_index=7, bounces=3, interpret=True, block=block,
    ))
    full = np.asarray(pallas_kernels.render_reference_pallas_planes(
        rp, planes, light_index=7, bounces=3, interpret=True,
    ))
    assert got.shape == (3, n) and np.isfinite(got).all()
    np.testing.assert_array_equal(got, full)


def test_pallas_statistical_vs_megakernel_f32():
    scene = scenes.cornell8()
    rays = camera.generate_rays_numpy(32, 32, 1, seed=2).astype(np.float32)
    dev = megakernel.scene_to_device(scene)
    expect = np.asarray(megakernel.render_reference(rays, dev, bounces=5))
    got = np.asarray(
        pallas_kernels.render_reference_pallas(
            jnp.asarray(rays), jnp.asarray(scene.soa10()), light_index=7,
            bounces=5, interpret=True,
        )
    )
    diff = np.abs(expect - got).max(1)
    # f32 multi-bounce chaos envelope (see test_reference_parity.py).
    assert (diff == 0).mean() >= 0.6


def test_compiled_kernel_refuses_cpu():
    """Off the GPU a compiled kernel is an error, never a silent switch
    to the interpreter."""
    scene = scenes.cornell8()
    rp = jnp.zeros((6, 256), jnp.float32)
    with pytest.raises(RuntimeError, match="need a GPU"):
        pallas_kernels.render_reference_pallas_planes(
            rp, jnp.asarray(scene.soa10()), light_index=7, bounces=1
        )


@pytest.mark.parametrize("with_idx", [False, True])
@pytest.mark.parametrize("scene_name", ["cornell8", "smallpt9"])
def test_kernels_lower_for_gpu(with_idx, scene_name):
    """The Triton lowering (Pallas -> Triton IR) runs here for the CUDA
    target: what the GPU's own compiler sees, at the headline ray count."""
    scene = scenes.get_scene(scene_name)
    f = functools.partial(
        pallas_kernels._call, light_index=scene.light_index, bounces=8,
        eps=1e-4, with_idx=with_idx, block=256, num_warps=4, interpret=False,
    )
    lowered = jax.jit(f).trace(
        jax.ShapeDtypeStruct((6, 1 << 22), jnp.float32),
        jnp.asarray(scene.soa10()),
    ).lower(lowering_platforms=("cuda",))
    assert "__gpu$xla.gpu.triton" in lowered.as_text()


def test_launch_config_is_fixed_in_the_interpreter():
    assert pallas_kernels._launch_config(
        5000, 9, 8, np.float32, True, 8, 1e-4, interpret=True
    ) == (pallas_kernels.INTERPRET_BLOCK, 4)
