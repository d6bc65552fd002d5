"""End-to-end parity gates against the UPSTREAM reference oracle.

The upstream repo's own NumPy oracle (scripts/gen_data.py test_soa — the
bit-faithful simulation of its Ascend C kernel) is executed and compared
against (a) our NumPy oracle and (b) our jit megakernel renderer.

A note on float32 chaos (why not every gate is bitwise)
-------------------------------------------------------
The Cornell walls are spheres of radius 1e5.  A ray leaving a wall
re-tests that wall next bounce; the self-hit root is t0 = b - sqrt(b^2-c)
with b ~ 1e5 and c ~ 0, so in float32 the cancellation noise in c
(|oc|^2 ~ 1e10, ulp ~ 1e3) makes t0 ~ 0 +/- 1e-2 — two orders of
magnitude ABOVE the reference's eps = 1e-4 self-hit threshold
(common.h:9).  Whether `t0 > eps` passes is therefore a per-ray,
per-bounce coin flip decided by arithmetic-order details (FMA contraction,
BLAS accumulation order in np.dot/np.linalg.norm), and flips compound
chaotically through the specular bounce loop.  The upstream kernel has the
same property vs its own Python oracle — its README's comparison is a
visual screenshot for this reason.

The gate matrix is therefore:
  1. BITWISE, always:   camera rays, scene table, bin formats.
  2. BITWISE, 1 bounce: upstream vs ours (no decision has flipped yet).
  3. BITWISE, float64:  our oracle vs our renderer at full bounce count —
     noise ~1e-11 << eps, so every t0>eps decision is stable; this proves
     the *logic* (argmin ties, masks, gathers, reflection, finalize)
     identical. Runs at the reference config AND BASELINE config-1 shape.
  4. STATISTICAL, float32 multi-bounce: divergence bounded (fraction of
     affected rays and image error must stay in the chaos-sized envelope).
"""

import numpy as np
import pytest

from ascendpathtracing import camera, oracle, scenes
from ascendpathtracing.models import megakernel
from ascendpathtracing.utils import io

from tests.reference_runner import run_reference_pipeline


@pytest.fixture(scope="module")
def reference_artifacts(reference_scripts_dir, tmp_path_factory):
    work = tmp_path_factory.mktemp("refrun")
    return run_reference_pipeline(reference_scripts_dir, str(work))


@pytest.fixture(scope="module")
def reference_artifacts_1bounce(reference_scripts_dir, tmp_path_factory):
    work = tmp_path_factory.mktemp("refrun1b")
    return run_reference_pipeline(reference_scripts_dir, str(work), bounces=1)


# ---------------------------------------------------------------- gate 1 ----
def test_camera_rays_bitwise_vs_reference(reference_artifacts):
    """Our vectorized ray gen must reproduce the reference's scalar loops
    bit for bit (same MT19937 stream, gen_data.py:21-75)."""
    ref = reference_artifacts
    ours = camera.generate_rays_numpy(
        ref["width"], ref["height"], ref["samples"], seed=0
    ).astype(np.float32)
    np.testing.assert_array_equal(ours, ref["rays"])


def test_scene_table_matches_reference(reference_artifacts):
    ref = reference_artifacts
    scene = scenes.cornell8()
    # reference gen_spheres returns [S, 10] with r^2 in column 0
    # (gen_data.py:109,132).
    ours = scene.soa10().T.astype(np.float32)
    np.testing.assert_array_equal(ours, ref["spheres"])


# ---------------------------------------------------------------- gate 2 ----
def test_single_bounce_bitwise_vs_reference(reference_artifacts_1bounce):
    """At 1 bounce no chaotic decision has flipped: upstream test_soa, our
    oracle and our jit renderer must agree bit for bit."""
    ref = reference_artifacts_1bounce
    scene = scenes.cornell8()
    mine = oracle.render_reference_numpy(ref["rays"], scene, bounces=1)
    np.testing.assert_array_equal(mine, ref["soa_colors"])
    dev = megakernel.scene_to_device(scene)
    got = np.asarray(
        megakernel.render_reference(ref["rays"].astype(np.float32), dev, bounces=1)
    )
    np.testing.assert_array_equal(got, ref["soa_colors"])


# ---------------------------------------------------------------- gate 3 ----
@pytest.mark.parametrize(
    "w,h,s,bounces",
    [
        (16, 16, 1, 5),  # the reference's shipped config (common.h:4-6)
        (256, 256, 1, 4),  # BASELINE config 1 shape
    ],
)
def test_float64_bitwise_oracle_vs_renderer(w, h, s, bounces):
    """Stable full-depth parity: in float64 the eps decisions cannot flip,
    so oracle and renderer must agree exactly — colors and decoded PPM."""
    import jax.numpy as jnp

    rays = camera.generate_rays_numpy(w, h, s, seed=0)
    scene = scenes.cornell8()
    expect = oracle.render_reference_numpy(rays, scene, bounces=bounces, dtype=np.float64)
    dev = megakernel.scene_to_device(scene, dtype=jnp.float64)
    got = np.asarray(megakernel.render_reference(rays, dev, bounces=bounces))
    assert got.dtype == np.float64
    np.testing.assert_array_equal(expect, got)
    np.testing.assert_array_equal(
        io.decode_color(expect, w, h, s), io.decode_color(got, w, h, s)
    )


def test_float32_single_bounce_bitwise_oracle_vs_renderer():
    w, h, s = 64, 64, 1
    rays = camera.generate_rays_numpy(w, h, s, seed=0).astype(np.float32)
    scene = scenes.cornell8()
    expect = oracle.render_reference_numpy(rays, scene, bounces=1)
    dev = megakernel.scene_to_device(scene)
    got = np.asarray(megakernel.render_reference(rays, dev, bounces=1))
    np.testing.assert_array_equal(expect, got)


# ---------------------------------------------------------------- gate 4 ----
def _stats(ours, ref_colors, w, h, s):
    diff = np.abs(ours - ref_colors).max(1)
    close = (diff <= 2e-5).mean()
    img_r = io.decode_color(ref_colors, w, h, s)
    img_o = io.decode_color(ours, w, h, s)
    mean_img = np.abs(img_r.astype(float) - img_o.astype(float)).mean()
    return close, mean_img


def test_float32_multibounce_statistical_vs_reference(reference_artifacts):
    """Full 5-bounce float32 vs upstream: divergence must stay inside the
    chaos envelope (measured ~10% of rays for the NumPy oracle, ~28% for
    the jit renderer whose XLA arithmetic differs more)."""
    ref = reference_artifacts
    scene = scenes.cornell8()
    w, h, s, b = ref["width"], ref["height"], ref["samples"], ref["bounces"]

    mine = oracle.render_reference_numpy(ref["rays"], scene, bounces=b)
    close, mean_img = _stats(mine, ref["soa_colors"], w, h, s)
    assert close >= 0.85, f"numpy oracle: only {close:.1%} rays match upstream"
    assert mean_img < 15.0, f"numpy oracle: image mean diff {mean_img:.1f}/255"

    dev = megakernel.scene_to_device(scene)
    got = np.asarray(
        megakernel.render_reference(ref["rays"].astype(np.float32), dev, bounces=b)
    )
    close, mean_img = _stats(got, ref["soa_colors"], w, h, s)
    assert close >= 0.60, f"jit renderer: only {close:.1%} rays match upstream"
    assert mean_img < 35.0, f"jit renderer: image mean diff {mean_img:.1f}/255"


def test_float32_multibounce_statistical_oracle_vs_renderer():
    """Our own f32 oracle vs renderer at a larger config, gated by the
    PRECISE chaos envelope: the per-bounce hit-decision trails identify
    exactly which rays flipped a discrete decision by f32 rounding;
    every flip-free ray must be BITWISE equal (color is a fixed-order
    product of albedo constants over the trail), and flips must stay a
    minority."""
    import jax.numpy as jnp

    w, h, s, bounces = 64, 64, 2, 6
    rays = camera.generate_rays_numpy(w, h, s, seed=3).astype(np.float32)
    scene = scenes.cornell8()
    expect = oracle.render_reference_numpy(rays, scene, bounces=bounces)
    dev = megakernel.scene_to_device(scene)
    got = np.asarray(megakernel.render_reference(rays, dev, bounces=bounces))

    hits_jit = np.asarray(
        megakernel.render_reference_hits(jnp.asarray(rays), dev, bounces=bounces)
    )
    hits_ora = oracle.render_reference_hits_numpy(rays, scene, bounces=bounces)
    flipped = (hits_jit != hits_ora).any(axis=0)
    # ~52% measured at 6 bounces (flips accumulate ~10%/bounce)
    assert flipped.mean() <= 0.60, f"{flipped.mean():.1%} rays flipped"
    diff = np.abs(expect - got).max(1)
    assert (diff[~flipped] == 0).all(), (
        f"{(diff[~flipped] != 0).sum()} flip-free rays not bitwise equal"
    )
