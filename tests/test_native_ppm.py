"""Native (C++) fused PPM codec vs the Python decode+encode path."""

import numpy as np
import pytest

from ascendpathtracing.accel import native
from ascendpathtracing.utils import io


needs_native = pytest.mark.skipif(
    not native.is_available(), reason="native toolchain unavailable"
)


@needs_native
@pytest.mark.parametrize("w,h,s", [(16, 16, 1), (32, 32, 2), (8, 8, 5)])
def test_native_ppm_bitwise_matches_python(w, h, s):
    rng = np.random.RandomState(0)
    # values straddling the clip boundaries and digit widths
    planes = (rng.rand(3, w * h * 4 * s).astype(np.float32) * 1.4 - 0.2)
    text_native = native.encode_ppm_native(planes, w, h, s)
    text_python = io.encode_ppm(io.decode_color(planes, w, h, s))
    assert text_native == text_python


@needs_native
def test_write_render_ppm_native_and_python_files_equal(tmp_path):
    rng = np.random.RandomState(1)
    w = h = 16
    colors = rng.rand(w * h * 4, 3).astype(np.float32)  # [N, 3] row layout
    pn = str(tmp_path / "native.ppm")
    pp = str(tmp_path / "python.ppm")
    img_n = io.write_render_ppm(colors, w, h, 1, pn, native="always")
    img_p = io.write_render_ppm(colors, w, h, 1, pp, native="never")
    assert open(pn).read() == open(pp).read()
    np.testing.assert_array_equal(img_n, img_p)
    # and the file round-trips through the reader
    np.testing.assert_array_equal(io.read_ppm(pn), img_p)
