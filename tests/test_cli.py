"""CLI end-to-end smoke tests (subprocess, CPU backend)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, timeout=420):
    return subprocess.run(
        [sys.executable, "-m", "ascendpathtracing.cli", *args],
        cwd=REPO,
        capture_output=True,
        text=True,
        timeout=timeout,
    )


def test_render_reference_end_to_end(tmp_path):
    r = _run(
        ["render", "--width", "16", "--height", "16", "--backend", "cpu",
         "--oracle", "--out", str(tmp_path)]
    )
    assert r.returncode == 0, r.stderr[-2000:]
    stats = json.loads(r.stdout.strip().splitlines()[-1])
    assert stats["rays"] == 16 * 16 * 4
    for f in ("rays.bin", "spheres.bin", "color.bin", "color.ppm"):
        assert (tmp_path / f).exists(), f
    # reference formats are readable
    from ascendpathtracing.utils import io

    rays = io.read_rays_bin(str(tmp_path / "rays.bin"))
    assert rays.shape == (1024, 6)
    img = io.read_ppm(str(tmp_path / "color.ppm"))
    assert img.shape == (16, 16, 3)


def test_render_rejects_bad_args(tmp_path):
    assert _run(["render", "--width", "0", "--backend", "cpu"]).returncode == 2
    assert _run(["render", "--scene", "nope", "--backend", "cpu"]).returncode == 2
    r = _run(["render", "--scene", "mesh-cube", "--mode", "reference",
              "--backend", "cpu"])
    assert r.returncode == 2
    assert "mesh scenes require" in r.stderr


def test_train_and_resume(tmp_path):
    ck = str(tmp_path / "ck.npz")
    r = _run(["train", "--backend", "cpu", "--steps", "6", "--width", "8",
              "--height", "8", "--bounces", "2", "--ckpt", ck,
              "--ckpt-every", "3"])
    assert r.returncode == 0, r.stderr[-2000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert np.isfinite(out["final_loss"])
    assert os.path.exists(ck)
    r2 = _run(["train", "--backend", "cpu", "--steps", "3", "--width", "8",
               "--height", "8", "--bounces", "2", "--ckpt", ck, "--resume"])
    assert r2.returncode == 0, r2.stderr[-2000:]
    assert "resumed from" in r2.stderr


def test_cli_render_wavefront_renderer(tmp_path):
    """--renderer wavefront routes pt scenes through the pool renderer
    (sphere and mesh), and refuses reference mode."""
    from ascendpathtracing import cli

    rc = cli.main([
        "render", "--width", "8", "--height", "8", "--samples", "1",
        "--bounces", "3", "--mode", "pt", "--renderer", "wavefront",
        "--backend", "cpu", "--out", str(tmp_path),
    ])
    assert rc == 0
    assert (tmp_path / "color.ppm").read_text().startswith("P3")
    rc = cli.main([
        "render", "--width", "8", "--height", "8", "--renderer",
        "wavefront", "--backend", "cpu", "--out", str(tmp_path),
    ])
    assert rc == 2


@pytest.mark.parametrize("scene,extra", [
    ("cornell8", ["--mode", "reference"]),
    ("mesh-icosphere:1", ["--mode", "pt", "--bounces", "2"]),
])
def test_cli_pallas_renderer_runs_in_interpreter_only_when_asked(
        tmp_path, scene, extra):
    """--renderer pallas runs the kernels in the interpreter under
    --backend cpu (and says so); without a GPU and without --backend cpu
    it is an error, never a silent fallback."""
    from ascendpathtracing import cli

    args = ["render", "--width", "8", "--height", "8", "--scene", scene,
            "--renderer", "pallas", "--out", str(tmp_path), *extra]
    r = _run(args + ["--backend", "cpu"])
    assert r.returncode == 0, r.stderr[-2000:]
    stats = json.loads(r.stdout.strip().splitlines()[-1])
    assert stats["kernels"] is True and stats["interpret"] is True
    assert cli.main(args) == 2


def test_cli_requires_gpu_when_asked():
    r = _run(["render", "--width", "8", "--height", "8", "--backend", "gpu"])
    assert r.returncode == 2
    assert "requested gpu" in r.stderr


def test_cli_auto_renderer_takes_xla_on_cpu(tmp_path):
    r = _run(["render", "--width", "8", "--height", "8", "--backend", "cpu",
              "--scene", "mesh-icosphere:1", "--mode", "pt", "--bounces", "2",
              "--out", str(tmp_path)])
    assert r.returncode == 0, r.stderr[-2000:]
    stats = json.loads(r.stdout.strip().splitlines()[-1])
    assert stats["kernels"] is False and stats["interpret"] is False
