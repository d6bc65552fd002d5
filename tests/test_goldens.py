"""Golden PPM regression (the formalized version of the reference's
committed Pystd-color.ppm golden, SURVEY §4.3): the NumPy oracle render
of fixed configs must reproduce the committed images exactly.

The oracle is pure elementwise NumPy (no BLAS reductions), so its float32
output is machine-stable; the decoded uint8 PPM is the committed
artifact. Regenerate with the snippet in this file's history if the
*semantics* intentionally change."""

import os

import numpy as np
import pytest

from ascendpathtracing import camera, oracle, scenes
from ascendpathtracing.utils import io

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")


@pytest.mark.parametrize(
    "w,h,s,b,name",
    [
        (16, 16, 1, 5, "cornell8_16x16_b5"),  # the reference's shipped config
        (64, 64, 1, 5, "cornell8_64x64_b5"),  # the golden-image size (Pystd-color.ppm)
    ],
)
def test_oracle_matches_golden(w, h, s, b, name):
    scene = scenes.cornell8()
    rays = camera.generate_rays_numpy(w, h, s, seed=0).astype(np.float32)
    colors = oracle.render_reference_numpy(rays, scene, bounces=b)
    img = io.decode_color(colors, w, h, s)
    golden = io.read_ppm(os.path.join(GOLDEN_DIR, f"{name}.ppm"))
    np.testing.assert_array_equal(img, golden)


def test_renderer_close_to_golden():
    """The jit renderer vs the committed golden, gated by the PRECISE f32
    chaos envelope: the per-bounce hit-decision trail of the jit renderer
    vs the oracle (which produced the golden) marks exactly which rays
    diverged by rounding-induced decision flips; color is a fixed-order
    f32 product of albedo constants over the trail, so every pixel whose
    4 subpixel rays are flip-free must match the golden EXACTLY."""
    import jax.numpy as jnp

    from ascendpathtracing.models import megakernel

    w = h = 16
    b = 5
    scene = scenes.cornell8()
    rays = camera.generate_rays_numpy(w, h, 1, seed=0).astype(np.float32)
    dev32 = megakernel.scene_to_device(scene, dtype=jnp.float32)

    colors = np.asarray(megakernel.render_reference(rays, dev32, bounces=b))
    img = io.decode_color(colors, w, h, 1)
    golden = io.read_ppm(os.path.join(GOLDEN_DIR, "cornell8_16x16_b5.ppm"))

    hits_jit = np.asarray(
        megakernel.render_reference_hits(jnp.asarray(rays), dev32, bounces=b)
    )
    hits_ora = oracle.render_reference_hits_numpy(rays, scene, bounces=b)
    flipped_ray = (hits_jit != hits_ora).any(axis=0)  # [N]
    # Map ray flips to image pixels through decode_color itself (no
    # hand-derived index math): a pixel is clean iff the decoded mean of
    # the flip indicator is exactly 0 for its 4 subpixel rays.
    indicator = np.repeat(flipped_ray[:, None].astype(np.float32), 3, axis=1)
    clean = (io.decode_color(indicator, w, h, 1) == 0).all(axis=-1)

    # ~40% of rays flip somewhere in 5 bounces (eps=1e-4 vs 1e-2 f32
    # cancellation noise on the 1e5-radius walls — chaos by construction,
    # see tests/test_reference_parity.py:8-29); the load-bearing gate is
    # the EXACT match on the flip-free pixels below.
    flip_frac = 1.0 - clean.mean()
    assert clean.mean() >= 0.10, f"only {clean.mean():.1%} flip-free pixels"
    neq = (img != golden).any(axis=-1)
    offenders = neq & clean
    assert not offenders.any(), (
        f"{offenders.sum()} flip-free pixels differ from golden "
        f"(flip fraction {flip_frac:.1%})"
    )


def _mesh_gbuffer_image(w=32, h=32):
    """Deterministic mesh-scene golden source: first-hit kind/depth/id
    of the cube-in-Cornell scene, f64 brute force (no RNG, no BVH order
    dependence), quantized to u8 — robust to last-ulp FP drift."""
    import jax.numpy as jnp

    from ascendpathtracing.accel import meshes
    from ascendpathtracing.models import mesh as mesh_mod

    v, f = meshes.cube(center=(50, 30, 60), size=25.0)
    ms = mesh_mod.MeshScene.cornell_with_mesh(v, f, albedo=(0.8, 0.5, 0.2))
    dev = mesh_mod.mesh_scene_to_device(ms, dtype=jnp.float64, use_bvh=False)
    rays = camera.generate_rays_numpy(w, h, 1, seed=0)
    tmin, kind, hid = mesh_mod.first_hit_mesh(jnp.asarray(rays), dev)
    tmin = np.asarray(tmin)
    kind = np.asarray(kind)
    hid = np.asarray(hid)
    depth = np.where(kind == 0, 0.0, np.clip(tmin / 300.0, 0.0, 1.0))
    planes = np.stack([
        kind.astype(np.float64) * (80.0 / 255.0),
        depth,
        (hid % 251).astype(np.float64) / 255.0,
    ], axis=1)
    return io.decode_color(planes, w, h, 1)


def test_mesh_first_hit_matches_golden():
    img = _mesh_gbuffer_image()
    golden = io.read_ppm(os.path.join(GOLDEN_DIR, "mesh_cube_firsthit_32x32.ppm"))
    np.testing.assert_array_equal(img, golden)


# --------------------------------------------------------------- PT golden --
PT_GOLDEN = os.path.join(GOLDEN_DIR, "pt_smallpt9_64x64_s4_b5.npy")


def pt_golden_image(w=64, h=64, s=4, bounces=5, rr_depth=3):
    """Fixed-seed FULL-PT estimator golden source (VERDICT r3 ask 9):
    the smallpt9 scene (diffuse + mirror + glass + Russian roulette all
    on-path) rendered by the f64 XLA megakernel with PRNGKey(42), decoded
    to the per-pixel linear-radiance image.  f64 + fixed threefry bits
    make this reproducible up to FP reassociation (~1e-15); the 1e-9
    gate therefore catches any semantic drift in the estimator that the
    energy/statistical rel-gates would average away."""
    import jax
    import jax.numpy as jnp

    from ascendpathtracing.models import megakernel

    sc = scenes.smallpt9()
    dev = megakernel.scene_to_device(sc, dtype=jnp.float64)
    rays = camera.generate_rays_numpy(w, h, s, seed=0)
    cols = megakernel.render_pt(
        jax.random.PRNGKey(42), jnp.asarray(rays), dev, bounces=bounces,
        rr_depth=rr_depth, materials_static=tuple(int(m) for m in sc.material),
    )
    return io.decode_color_hdr(np.asarray(cols), w, h, s)  # [w, h, 3] f64


def test_pt_estimator_matches_golden():
    """Exact-reproduction gate for the full PT estimator on CPU: the
    committed fixed-seed radiance image must reproduce to 1e-9 (drift in
    the BSDFs, RR weights, RNG layout or decode breaks this test, not
    just an energy gate).  Regenerate (only on intentional semantic
    change) with APT_REGEN_GOLDENS=1 pytest tests/test_goldens.py -k pt."""
    img = pt_golden_image()
    if os.environ.get("APT_REGEN_GOLDENS"):
        np.save(PT_GOLDEN, img.astype(np.float64))
    golden = np.load(PT_GOLDEN)
    err = np.abs(img - golden).max()
    assert err <= 1e-9, f"PT estimator drifted from golden by {err}"


# ---------------------------------------------------------- mesh PT golden --
MESH_PT_GOLDEN = os.path.join(GOLDEN_DIR, "pt_meshcube_32x32_s4_b5.npy")


def mesh_pt_golden_image(w=32, h=32, s=4, bounces=5, rr_depth=3):
    """Fixed-seed MESH-PT estimator golden source (VERDICT r4 ask 7):
    the cube-in-Cornell combined sphere+mesh scene rendered by the f64
    jnp-BVH path (models/mesh.render_pt_mesh, the oracle-grade mesh
    estimator every Pallas mesh renderer is gated against) with
    PRNGKey(42).  Pins the two-way nearest-hit combine, the per-face
    attribute gathers, and the mesh BSDF path against drift the same way
    pt_smallpt9 pins the sphere estimator."""
    import jax
    import jax.numpy as jnp

    from ascendpathtracing.accel import meshes
    from ascendpathtracing.models import mesh as mesh_mod

    v, f = meshes.cube(center=(50, 30, 60), size=25.0)
    ms = mesh_mod.MeshScene.cornell_with_mesh(v, f, albedo=(0.8, 0.5, 0.2))
    dev = mesh_mod.mesh_scene_to_device(ms, dtype=jnp.float64, use_bvh=True)
    rays = camera.generate_rays_numpy(w, h, s, seed=0)
    cols = mesh_mod.render_pt_mesh(
        jax.random.PRNGKey(42), jnp.asarray(rays), dev, bounces=bounces,
        rr_depth=rr_depth,
    )
    return io.decode_color_hdr(np.asarray(cols), w, h, s)  # [w, h, 3] f64


def test_mesh_pt_estimator_matches_golden():
    """Exact-reproduction gate for the mesh PT estimator on CPU (1e-9 —
    the fixed threefry stream + f64 math reproduce to FP reassociation
    noise).  Regenerate only on intentional semantic change with
    APT_REGEN_GOLDENS=1 pytest tests/test_goldens.py -k mesh_pt."""
    img = mesh_pt_golden_image()
    if os.environ.get("APT_REGEN_GOLDENS"):
        np.save(MESH_PT_GOLDEN, img.astype(np.float64))
    golden = np.load(MESH_PT_GOLDEN)
    err = np.abs(img - golden).max()
    assert err <= 1e-9, f"mesh PT estimator drifted from golden by {err}"
