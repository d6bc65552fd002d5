"""IO/codec tests.

Formalizes the reference's only real assertion test (``test_decode``,
data_visualization.py:61-89) plus round-trip coverage of every bin format.
"""

import numpy as np

from ascendpathtracing import scenes
from ascendpathtracing.utils import io


def test_rays_bin_roundtrip(tmp_path, rng):
    rays = rng.rand(128, 6).astype(np.float32)
    p = str(tmp_path / "rays.bin")
    io.write_rays_bin(rays, p)
    back = io.read_rays_bin(p)
    np.testing.assert_array_equal(rays, back)


def test_spheres_bin_roundtrip_and_padding(tmp_path):
    scene = scenes.cornell8()
    p = str(tmp_path / "spheres.bin")
    io.write_spheres_bin(scene, p)
    raw = np.fromfile(p, dtype=np.float32)
    # 10 planes x 8 spheres = 320B payload padded to 512B (gen_data.py:122).
    assert raw.nbytes == 512
    back = io.read_spheres_bin(p, n_spheres=8)
    np.testing.assert_allclose(back.r2, scene.r2.astype(np.float32), rtol=1e-6)
    np.testing.assert_array_equal(
        back.center, scene.center.astype(np.float32)
    )
    np.testing.assert_array_equal(back.color, scene.color.astype(np.float32))
    # Inference of sphere count from padding also works for this scene.
    back2 = io.read_spheres_bin(p)
    assert back2.n_spheres == 8


def test_color_bin_roundtrip(tmp_path, rng):
    colors = rng.rand(64, 3).astype(np.float32)
    p = str(tmp_path / "color.bin")
    io.write_color_bin(colors, p)
    np.testing.assert_array_equal(colors, io.read_color_bin(p))


def _decode_reference_scalar(planes, w, h, s):
    """Direct scalar port of data_visualization.py:20-58 for cross-checking
    the vectorized decode."""
    colors = planes.reshape(3, w, h, 4 * s).transpose(1, 2, 3, 0)
    new_colors = np.zeros((w, h, 3))
    for i in range(w):
        for j in range(h):
            sum_color = np.zeros(3)
            u = h - 1 - j
            for k in range(0, 4 * s, s):
                pixel_values = colors[i, u, k : k + s, :]
                sum_color += np.mean(pixel_values, axis=0)
            new_colors[i, j] = sum_color / 4
    return (np.clip(new_colors, 0, 1) * 255).astype(np.uint8)


def test_decode_matches_scalar_reference(rng):
    w, h, s = 8, 8, 3
    planes = rng.rand(3, w * h * 4 * s).astype(np.float32) * 1.5
    expect = _decode_reference_scalar(planes.astype(np.float64), w, h, s)
    got = io.decode_color(planes, w, h, s)
    np.testing.assert_array_equal(expect, got)


def test_ppm_roundtrip(tmp_path, rng):
    img = (rng.rand(16, 16, 3) * 255).astype(np.uint8)
    p = str(tmp_path / "img.ppm")
    io.write_ppm(img, p)
    back = io.read_ppm(p)
    np.testing.assert_array_equal(img, back)


def test_ppm_format_matches_reference_layout(tmp_path):
    """Line i of the body must hold data[j, i] for j in 0..h
    (data_visualization.py:11-17)."""
    img = np.arange(2 * 2 * 3, dtype=np.uint8).reshape(2, 2, 3)
    text = io.encode_ppm(img)
    lines = text.strip().split("\n")
    assert lines[0] == "P3"
    assert lines[1] == "2 2"
    assert lines[2] == "255"
    # i=0 line: img[0,0], img[1,0]
    assert lines[3].split() == ["0", "1", "2", "6", "7", "8"]
    # i=1 line: img[0,1], img[1,1]
    assert lines[4].split() == ["3", "4", "5", "9", "10", "11"]
