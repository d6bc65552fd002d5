"""Post-processing subsystem: tone mapping, firefly clamp, G-buffer AOVs,
a-trous denoiser (post.py, megakernel.render_gbuffer).

The reference has no post pipeline (decode clips to u8 directly,
data_visualization.py:54-58); these are beyond-parity components, so the
tests assert this framework's own contracts: operator ranges and
monotonicity, G-buffer geometric invariants against the scene table, and
the denoiser's variance-reduction / edge-preservation behavior.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from ascendpathtracing import camera, post, scenes
from ascendpathtracing.models import megakernel


def test_tonemap_range_and_monotonicity():
    x = jnp.asarray(np.linspace(0.0, 50.0, 512, dtype=np.float32))[:, None]
    img = jnp.repeat(x, 3, axis=1)[None]  # [1, 512, 3]
    for tm in (post.tonemap_reinhard, post.tonemap_aces):
        y = np.asarray(tm(img))
        assert y.min() >= 0.0 and y.max() <= 1.0
        assert np.all(np.diff(y[0, :, 0]) >= -1e-6), tm.__name__
    assert float(post.tonemap_aces(jnp.zeros((1, 1, 3)))[0, 0, 0]) == 0.0


def test_gamma_encode_bounds():
    img = jnp.asarray([[[0.0, 0.25, 1.0]]])
    y = np.asarray(post.gamma_encode(img))
    assert y[0, 0, 0] == 0.0 and abs(y[0, 0, 2] - 1.0) < 1e-6
    assert y[0, 0, 1] > 0.25  # gamma brightens midtones


def test_firefly_clamp_bounds_luminance_preserves_hue():
    c = jnp.asarray(
        [[0.5, 0.5, 0.5], [100.0, 50.0, 10.0]], dtype=jnp.float32
    )
    out = np.asarray(post.firefly_clamp(c, max_radiance=2.0))
    # dim sample untouched
    np.testing.assert_allclose(out[0], [0.5, 0.5, 0.5], rtol=1e-6)
    lum = 0.2126 * out[1, 0] + 0.7152 * out[1, 1] + 0.0722 * out[1, 2]
    assert lum <= 2.0 + 1e-4
    # hue (channel ratios) preserved
    np.testing.assert_allclose(out[1, 0] / out[1, 1], 2.0, rtol=1e-5)


def test_gbuffer_invariants():
    scene = scenes.get_scene("cornell8")
    dev = megakernel.scene_to_device(scene)
    rays = camera.generate_rays_numpy(16, 16, 1, seed=0).astype(np.float32)
    gb = megakernel.render_gbuffer(rays, dev)
    depth = np.asarray(gb["depth"])
    nrm = np.asarray(gb["normal"])
    alb = np.asarray(gb["albedo"])
    hid = np.asarray(gb["hit_id"])
    live = hid >= 0
    assert live.any()
    # depth positive on hits, zero on miss
    assert (depth[live] > 0).all() and (depth[~live] == 0).all()
    # unit, viewer-facing normals on hits; zero on miss
    nl = np.linalg.norm(nrm, axis=1)
    np.testing.assert_allclose(nl[live], 1.0, atol=1e-5)
    assert (nl[~live] == 0).all()
    d = rays[:, 3:6]
    assert (np.sum(d * nrm, axis=1)[live] < 1e-6).all()
    # albedo equals the scene table entry of the hit sphere
    table = np.asarray(scene.color, np.float32)
    np.testing.assert_allclose(alb[live], table[hid[live]], rtol=1e-6)


def _noisy_edge_image(rng, w=64, h=64, sigma=0.2):
    img = np.zeros((w, h, 3), np.float32)
    img[: w // 2] = 0.2
    img[w // 2:] = 0.8
    noisy = img + rng.normal(0, sigma, img.shape).astype(np.float32)
    return img, noisy


def test_atrous_reduces_noise():
    rng = np.random.RandomState(0)
    clean, noisy = _noisy_edge_image(rng)
    out = np.asarray(post.atrous_denoise(jnp.asarray(noisy), iterations=3))
    mse_in = float(np.mean((noisy - clean) ** 2))
    mse_out = float(np.mean((out - clean) ** 2))
    assert mse_out < 0.5 * mse_in, (mse_in, mse_out)


def test_atrous_guides_preserve_edge():
    """With a normal/depth edge along the color edge, the guided filter
    must keep the step sharp even when color sigma is loose."""
    rng = np.random.RandomState(1)
    clean, noisy = _noisy_edge_image(rng, sigma=0.1)
    w = clean.shape[0]
    nrm = np.zeros_like(clean)
    nrm[: w // 2, :, 0] = 1.0
    nrm[w // 2:, :, 2] = 1.0
    depth = np.full(clean.shape[:2], 0.5, np.float32)
    depth[w // 2:] = 1.0
    out = np.asarray(
        post.atrous_denoise(
            jnp.asarray(noisy), normal=jnp.asarray(nrm),
            depth=jnp.asarray(depth), iterations=3, sigma_color=1e3,
        )
    )
    # interior smoothed toward flat values...
    lo = out[: w // 2 - 4].mean(axis=(0, 1))
    hi = out[w // 2 + 4:].mean(axis=(0, 1))
    assert abs(float(lo[0]) - 0.2) < 0.05
    assert abs(float(hi[0]) - 0.8) < 0.05
    # ...and the step survives: adjacent rows across the edge stay apart
    step = float(out[w // 2 + 1].mean() - out[w // 2 - 2].mean())
    assert step > 0.45, step


def test_atrous_albedo_demodulation_roundtrip():
    """A noise-free image must pass through ~unchanged when albedo
    demodulation is on (irradiance is constant => filter is a no-op)."""
    alb = np.zeros((32, 32, 3), np.float32)
    alb[:, :16] = (0.9, 0.2, 0.2)
    alb[:, 16:] = (0.2, 0.9, 0.2)
    img = alb * 0.5  # constant irradiance
    out = np.asarray(
        post.atrous_denoise(
            jnp.asarray(img), albedo=jnp.asarray(alb), iterations=2
        )
    )
    np.testing.assert_allclose(out, img, atol=1e-4)


def test_cli_post_pipeline(tmp_path):
    from ascendpathtracing import cli

    out = tmp_path / "r"
    rc = cli.main([
        "render", "--width", "16", "--height", "16", "--backend", "cpu",
        "--mode", "pt", "--bounces", "3", "--denoise", "2", "--tonemap",
        "aces", "--clamp", "8", "--aov", "gbuffer", "--out", str(out),
    ])
    assert rc == 0
    for f in ("color.ppm", "final.ppm", "depth.ppm", "normal.ppm",
              "albedo.ppm"):
        assert (out / f).exists(), f
    from ascendpathtracing.utils.io import read_ppm

    img = read_ppm(str(out / "final.ppm"))
    assert img.shape == (16, 16, 3)
