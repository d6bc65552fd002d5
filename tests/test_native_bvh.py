"""Native (C++) BVH builder: structure contract + traversal equivalence
with the NumPy builder. Skips cleanly when no C++ toolchain is present."""

import jax.numpy as jnp
import numpy as np
import pytest

from ascendpathtracing.accel import bvh as bvh_mod
from ascendpathtracing.accel import meshes, tri

native = pytest.importorskip("ascendpathtracing.accel.native")

pytestmark = pytest.mark.skipif(
    not native.is_available(), reason="native toolchain unavailable"
)


def _traverse(bvh, v32, f, o3, d3):
    dev = bvh_mod.bvh_to_device(bvh, dtype=jnp.float32)
    planes = tri.triangle_planes(v32, f, dtype=np.float32)
    ordered = tuple(tuple(jnp.asarray(p[bvh.tri_order]) for p in t) for t in planes)
    tmin, hitid, miss = bvh_mod.intersect_bvh(o3, d3, dev, ordered, 1e-5, bvh.max_leaf)
    return np.asarray(tmin), bvh.tri_order[np.asarray(hitid)], np.asarray(miss)


def test_native_structure_and_equivalence():
    rng = np.random.RandomState(0)
    v, f = meshes.icosphere(subdivisions=3)
    v32 = np.asarray(v, np.float32)

    nb = native.build_bvh_native(v32, f)
    assert sorted(nb.tri_order.tolist()) == list(range(len(f)))
    m = nb.n_nodes
    assert (nb.miss > np.arange(m)).all() and (nb.miss <= m).all()
    leaves = nb.count > 0
    assert nb.count[leaves].sum() == len(f)

    pb = bvh_mod.build_bvh_numpy(v32, f)

    n = 512
    o = (rng.randn(n, 3) * 3).astype(np.float32)
    d = rng.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o3 = tuple(jnp.asarray(o[:, i]) for i in range(3))
    d3 = tuple(jnp.asarray(d[:, i].astype(np.float32)) for i in range(3))

    t_n, h_n, m_n = _traverse(nb, v32, f, o3, d3)
    t_p, h_p, m_p = _traverse(pb, v32, f, o3, d3)
    np.testing.assert_array_equal(m_n, m_p)
    np.testing.assert_allclose(t_n, t_p, rtol=1e-6, atol=1e-6)


def test_native_speed_advantage():
    """The native builder should beat NumPy clearly on a larger mesh."""
    import time

    v, f = meshes.icosphere(subdivisions=5)  # 20480 tris
    v32 = np.asarray(v, np.float32)
    t0 = time.perf_counter()
    native.build_bvh_native(v32, f)
    t_native = time.perf_counter() - t0
    t0 = time.perf_counter()
    bvh_mod.build_bvh_numpy(v32, f)
    t_numpy = time.perf_counter() - t0
    assert t_native < t_numpy, (t_native, t_numpy)
