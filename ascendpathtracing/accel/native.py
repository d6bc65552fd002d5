"""ctypes bindings for the native (C++) host components.

The shared library is built on demand with ``make`` (g++); if the
toolchain or binary is unavailable every caller falls back to the NumPy
implementations (accel/bvh.py), so the framework never hard-requires the
native path — mirroring the reference's CPU-sim fallback philosophy
(SURVEY §4.1).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "native")
_LIB_PATH = os.path.abspath(os.path.join(_NATIVE_DIR, "libaptnative.so"))
_lock = threading.Lock()
_lib = None


class NativeUnavailable(RuntimeError):
    pass


def _stale() -> bool:
    if not os.path.exists(_LIB_PATH):
        return True
    lib_mtime = os.path.getmtime(_LIB_PATH)
    src_dir = os.path.abspath(_NATIVE_DIR)
    return any(
        f.endswith(".cpp") and os.path.getmtime(os.path.join(src_dir, f)) > lib_mtime
        for f in os.listdir(src_dir)
    )


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if _stale():
            try:
                subprocess.run(
                    ["make", "-C", os.path.abspath(_NATIVE_DIR)],
                    check=True,
                    capture_output=True,
                    timeout=120,
                )
            except Exception as e:  # noqa: BLE001
                raise NativeUnavailable(f"native build failed: {e}") from e
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError as e:
            raise NativeUnavailable(f"cannot load {_LIB_PATH}: {e}") from e
        lib.apt_build_bvh.restype = ctypes.c_int32
        lib.apt_build_bvh.argtypes = [
            ctypes.POINTER(ctypes.c_float),  # tri_verts
            ctypes.c_int32,  # n_tris
            ctypes.c_int32,  # max_leaf
            ctypes.c_int32,  # n_bins
            ctypes.POINTER(ctypes.c_float),  # bmin
            ctypes.POINTER(ctypes.c_float),  # bmax
            ctypes.POINTER(ctypes.c_int32),  # first
            ctypes.POINTER(ctypes.c_int32),  # count
            ctypes.POINTER(ctypes.c_int32),  # miss
            ctypes.POINTER(ctypes.c_int32),  # tri_order
            ctypes.c_int32,  # max_nodes
        ]
        lib.apt_encode_ppm.restype = ctypes.c_int64
        lib.apt_encode_ppm.argtypes = [
            ctypes.POINTER(ctypes.c_float),  # planes [3, w*h*4*s]
            ctypes.c_int32,  # width
            ctypes.c_int32,  # height
            ctypes.c_int32,  # samples
            ctypes.c_char_p,  # out text buffer
            ctypes.c_int64,  # max_len
        ]
        lib.apt_obj_count.restype = ctypes.c_int32
        lib.apt_obj_count.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_long),
            ctypes.POINTER(ctypes.c_long),
        ]
        lib.apt_obj_load.restype = ctypes.c_int32
        lib.apt_obj_load.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_longlong),
            ctypes.c_long,
            ctypes.c_long,
        ]
        _lib = lib
        return lib


def is_available() -> bool:
    try:
        _load()
        return True
    except NativeUnavailable:
        return False


def build_bvh_native(vertices, faces, *, max_leaf: int = 4, n_bins: int = 16):
    """C++ binned-SAH builder; same output contract as build_bvh_numpy."""
    from ascendpathtracing.accel.bvh import FlatBVH

    lib = _load()
    vertices = np.ascontiguousarray(vertices, np.float32)
    faces = np.asarray(faces, np.int64)
    f = faces.shape[0]
    tri_verts = np.ascontiguousarray(vertices[faces], np.float32)  # [F,3,3]

    max_nodes = max(2 * f, 16)
    bmin = np.empty((max_nodes, 3), np.float32)
    bmax = np.empty((max_nodes, 3), np.float32)
    first = np.empty(max_nodes, np.int32)
    count = np.empty(max_nodes, np.int32)
    miss = np.empty(max_nodes, np.int32)
    order = np.empty(max(f, 1), np.int32)

    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int32)
    m = lib.apt_build_bvh(
        tri_verts.ctypes.data_as(fp),
        f,
        max_leaf,
        n_bins,
        bmin.ctypes.data_as(fp),
        bmax.ctypes.data_as(fp),
        first.ctypes.data_as(ip),
        count.ctypes.data_as(ip),
        miss.ctypes.data_as(ip),
        order.ctypes.data_as(ip),
        max_nodes,
    )
    if m < 0:
        raise RuntimeError("apt_build_bvh: node buffer too small")
    return FlatBVH(
        bmin=bmin[:m].copy(),
        bmax=bmax[:m].copy(),
        first=first[:m].copy(),
        count=count[:m].copy(),
        miss=miss[:m].copy(),
        tri_order=order[:f].copy(),
        max_leaf=max_leaf,
    )


def encode_ppm_native(planes, width: int, height: int, samples: int) -> str:
    """Fused decode (sub-pixel averaging + flip + clip) and ASCII P3
    encode in C++ — bit-exact with utils/io.decode_color + encode_ppm.

    planes: float32 [3, width*height*4*samples] color planes.
    """
    lib = _load()
    planes = np.ascontiguousarray(planes, np.float32)
    n = width * height * 4 * samples
    if planes.shape != (3, n):
        raise ValueError(f"expected [3, {n}] planes, got {planes.shape}")
    # worst case: 4 chars/value + newline per line + header
    max_len = width * (height * 3 * 4 + 2) + 64
    buf = ctypes.create_string_buffer(max_len)
    written = lib.apt_encode_ppm(
        planes.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        width, height, samples, buf, max_len,
    )
    if written < 0:
        raise RuntimeError("apt_encode_ppm: buffer too small")
    return buf.raw[:written].decode("ascii")


def load_obj_native(path: str):
    """C++ Wavefront-OBJ loader; same (vertices [V,3] f64, faces [F,3]
    i64) contract and parse semantics as accel/meshes.load_obj (two-pass:
    count, then fill caller-allocated buffers)."""
    lib = _load()
    pathb = os.fsencode(path)
    nv = ctypes.c_long(0)
    nt = ctypes.c_long(0)
    rc = lib.apt_obj_count(pathb, ctypes.byref(nv), ctypes.byref(nt))
    if rc == 2:  # malformed token — mirror the Python parser's exception
        raise ValueError(f"malformed token in OBJ file {path!r}")
    if rc:
        raise RuntimeError(f"apt_obj_count failed for {path!r}")
    if nv.value == 0 or nt.value == 0:
        raise ValueError(f"no geometry in OBJ file {path!r}")
    verts = np.empty((nv.value, 3), np.float64)
    faces = np.empty((nt.value, 3), np.int64)
    rc = lib.apt_obj_load(
        pathb,
        verts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        faces.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
        nv.value,
        nt.value,
    )
    if rc == 2:
        raise ValueError(f"malformed token in OBJ file {path!r}")
    if rc:
        # IO error, or the file changed between the count and load passes
        raise RuntimeError(f"apt_obj_load failed for {path!r}")
    if faces.min() < 0 or faces.max() >= nv.value:
        raise ValueError(f"face index out of range in {path!r}")
    return verts, faces
