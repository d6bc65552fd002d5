"""Host-0 image assembly (parallel/assembly.py, VERDICT r3 ask 4):
a DP-sharded render gathered and encoded must produce a PPM
byte-for-byte identical to the single-device pipeline's, on the virtual
8-device mesh.  (The 2-process gather path is exercised by
tests/test_multiprocess.py.)
"""

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ascendpathtracing import camera, parallel, scenes  # noqa: E402
from ascendpathtracing.models import megakernel  # noqa: E402
from ascendpathtracing.utils import io  # noqa: E402


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
def test_sharded_assembly_ppm_byte_identical(tmp_path):
    w = h = 16
    rays = jnp.asarray(camera.generate_rays_numpy(w, h, 1, seed=0))
    dev = megakernel.scene_to_device(scenes.cornell8(), dtype=rays.dtype)

    # single-device pipeline
    colors_1 = np.asarray(megakernel.render_reference(rays, dev, bounces=5))
    img_1 = io.decode_color(colors_1, w, h, 1)
    p1 = tmp_path / "single.ppm"
    io.write_ppm(img_1, str(p1))

    # sharded render -> host-0 assembly
    mesh = parallel.make_mesh(8)
    colors_sh = parallel.render_reference_sharded(
        parallel.shard_rays(rays, mesh), dev, mesh, bounces=5
    )
    p2 = tmp_path / "assembled.ppm"
    out = parallel.assemble_ppm_host0(colors_sh, w, h, 1, str(p2))
    assert out == str(p2)

    assert p1.read_bytes() == p2.read_bytes()


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
def test_cli_shard_flag_renders_and_assembles(tmp_path):
    """--shard N runs the DP-sharded reference render through the normal
    CLI artifact pipeline; the PPM must equal the unsharded one."""
    from ascendpathtracing import cli

    args = [
        "render", "--width", "16", "--height", "16", "--samples", "1",
        "--bounces", "4", "--mode", "reference", "--backend", "cpu",
    ]
    assert cli.main(args + ["--out", str(tmp_path / "a")]) == 0
    assert cli.main(
        args + ["--shard", "8", "--out", str(tmp_path / "b")]
    ) == 0
    a = (tmp_path / "a" / "color.ppm").read_bytes()
    b = (tmp_path / "b" / "color.ppm").read_bytes()
    assert a == b
