"""Wavefront OBJ loader/saver (user-mesh ingestion for the BVH pipeline).

The reference has no mesh IO at all (procedural spheres only —
/root/reference/scripts/gen_data.py:94-102); meshes + OBJ are part of the
BASELINE config-3 build-out.
"""

import numpy as np
import pytest

from ascendpathtracing.accel import meshes


def test_obj_roundtrip(tmp_path):
    v, f = meshes.icosphere(radius=1.0, subdivisions=1)
    p = tmp_path / "ico.obj"
    meshes.save_obj(p, v, f)
    v2, f2 = meshes.load_obj(p)
    np.testing.assert_allclose(v2, v, rtol=0, atol=1e-8)
    np.testing.assert_array_equal(f2, f)


def test_obj_polygons_negative_indices_and_tuples(tmp_path):
    p = tmp_path / "quad.obj"
    p.write_text(
        "# a unit quad with vt/vn tuples and a negative-index triangle\n"
        "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\n"
        "f 1/1/1 2/2/1 3/3/1 4/4/1\n"   # quad -> fan = 2 tris
        "f -4 -3 -2\n"                   # negative (relative) indices
    )
    v, f = meshes.load_obj(p)
    assert v.shape == (4, 3)
    np.testing.assert_array_equal(
        f, [[0, 1, 2], [0, 2, 3], [0, 1, 2]]
    )


def test_obj_errors(tmp_path):
    empty = tmp_path / "empty.obj"
    empty.write_text("# nothing\n")
    with pytest.raises(ValueError, match="no geometry"):
        meshes.load_obj(empty)
    bad = tmp_path / "bad.obj"
    bad.write_text("v 0 0 0\nf 1 2 3\n")
    with pytest.raises(ValueError, match="out of range"):
        meshes.load_obj(bad)


def test_transform():
    v = np.array([[1.0, 0.0, 0.0]])
    out = meshes.transform(v, scale=2.0, rotate_y=np.pi / 2, translate=(0, 5, 0))
    np.testing.assert_allclose(out, [[0.0, 5.0, -2.0]], atol=1e-12)


def test_cli_renders_obj_mesh(tmp_path):
    """mesh-obj:<path> goes through load -> auto-fit -> BVH -> render."""
    from ascendpathtracing import cli

    v, f = meshes.cube(size=2.0)
    obj = tmp_path / "cube.obj"
    meshes.save_obj(obj, v, f)
    rc = cli.main([
        "render", "--width", "16", "--height", "16", "--samples", "1",
        "--bounces", "3", "--mode", "pt", "--scene", f"mesh-obj:{obj}",
        "--backend", "cpu", "--out", str(tmp_path),
    ])
    assert rc == 0
    ppm = (tmp_path / "color.ppm").read_text().split()
    assert ppm[0] == "P3" and ppm[1] == "16" and ppm[2] == "16"


def test_native_loader_matches_python(tmp_path):
    """The C++ OBJ loader (native/obj_loader.cpp) must parse identically
    to the Python reference parser, including polygons, vt/vn tuples and
    negative indices; skips if the toolchain is unavailable."""
    from ascendpathtracing.accel import native as native_mod

    if not native_mod.is_available():
        pytest.skip("native toolchain unavailable")

    v, f = meshes.icosphere(radius=1.5, subdivisions=2)
    p1 = tmp_path / "ico.obj"
    meshes.save_obj(p1, v, f)
    p2 = tmp_path / "mixed.obj"
    p2.write_text(
        "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\n"
        "f 1/1/1 2/2/1 3/3/1 4/4/1\n"
        "f -4 -3 -2\n"
        "v 2 2 2\n"
        "f 1 2 5\n"
    )
    for p in (p1, p2):
        vn, fn = meshes.load_obj(p, native="always")
        vp, fp_ = meshes.load_obj(p, native="never")
        np.testing.assert_array_equal(vn, vp)
        np.testing.assert_array_equal(fn, fp_)


def test_native_loader_malformed_parity(tmp_path):
    """Malformed tokens must ERROR in both parsers, not silently load
    different geometry depending on which parser ran (ADVICE r3 low #2):
    Python's int()/float() raise, so the C++ loader must too."""
    from ascendpathtracing.accel import native as native_mod

    if not native_mod.is_available():
        pytest.skip("native toolchain unavailable")

    cases = [
        # trailing junk in a face index: int("2x") raises
        "v 0 0 0\nv 1 0 0\nv 1 1 0\nf 1 2x 3\n",
        # junk vertex coordinate: float("zz") raises
        "v 0 0 zz\nv 1 0 0\nv 1 1 0\nf 1 2 3\n",
        # empty index head: int("") raises
        "v 0 0 0\nv 1 0 0\nv 1 1 0\nf 1 /2 3\n",
    ]
    for i, text in enumerate(cases):
        p = tmp_path / f"bad{i}.obj"
        p.write_text(text)
        with pytest.raises(ValueError):
            meshes.load_obj(p, native="never")
        with pytest.raises(ValueError):
            meshes.load_obj(p, native="always")
    # too-few-field records are silently SKIPPED by both (len(parts)
    # guards), even with junk further down the line
    ok = tmp_path / "short.obj"
    ok.write_text("v 0 0\nv 0 0 0\nv 1 0 0\nv 1 1 0\nf 1 2\nf 1 2 3\n")
    vn, fn = meshes.load_obj(ok, native="always")
    vp, fp_ = meshes.load_obj(ok, native="never")
    np.testing.assert_array_equal(vn, vp)
    np.testing.assert_array_equal(fn, fp_)
