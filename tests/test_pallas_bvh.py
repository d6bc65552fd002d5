"""Per-lane BVH traversal kernel (ops/pallas_bvh.py) in the Pallas
interpreter against its semantic spec (accel/bvh.intersect_bvh, the jnp
while_loop walk) and brute force, over several meshes, ray counts and
block sizes.  The compiled kernel runs on the card in tests/test_gpu.py;
test_traversal_lowers_for_gpu checks here that it lowers to Triton IR."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ascendpathtracing.accel import bvh as bvh_mod, meshes, tri
from ascendpathtracing.ops import pallas_bvh


def _soup(n_tris=200, seed=0):
    """Seeded triangle soup: thin, anisotropic, mixed-scale triangles."""
    rng = np.random.RandomState(seed)
    centers = rng.uniform(-1, 1, (n_tris, 3))
    scale = 10 ** rng.uniform(-2, -0.3, (n_tris, 1, 1))
    offs = rng.randn(n_tris, 3, 3) * scale * np.asarray([1.0, 0.2, 0.05])
    v = (centers[:, None, :] + offs).reshape(-1, 3)
    return v, np.arange(3 * n_tris).reshape(n_tris, 3)


MESHES = {
    "cube": lambda: meshes.cube(center=(0, 0, 0), size=1.5),
    "ico1": lambda: meshes.icosphere(subdivisions=1),
    "ico2": lambda: meshes.icosphere(subdivisions=2),
    "ico3": lambda: meshes.icosphere(subdivisions=3),
    "soup": _soup,
}


def _tables(name):
    v, f = MESHES[name]()
    v32 = np.asarray(v, np.float32)
    bvh = bvh_mod.build_bvh_numpy(v32, f)
    planes = tri.triangle_planes(v32, f, dtype=np.float32)
    ordered = tuple(tuple(p[bvh.tri_order] for p in t) for t in planes)
    return bvh, planes, ordered, pallas_bvh.pack_bvh(bvh, ordered)


def _rays(n, seed):
    rng = np.random.RandomState(seed)
    o = (rng.randn(n, 3) * 3).astype(np.float32)
    # aim half the rays near the origin so the mesh is actually hit
    tgt = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    d = np.where(np.arange(n)[:, None] % 2 == 0, tgt - o, rng.randn(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return o, d


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_traversal_matches_jnp_spec_and_brute(mesh_name):
    bvh, planes, ordered, tables = _tables(mesh_name)
    o, d = _rays(1536, seed=1)
    t_k, h_k = pallas_bvh.intersect_bvh_pallas(
        jnp.asarray(np.concatenate([o, d], 1).T.copy()), *tables,
        max_leaf=bvh.max_leaf, eps=1e-5, interpret=True,
    )
    t_k, h_k = np.asarray(t_k), np.asarray(h_k)

    o3 = tuple(jnp.asarray(o[:, i]) for i in range(3))
    d3 = tuple(jnp.asarray(d[:, i]) for i in range(3))
    t_j, h_j, _ = bvh_mod.intersect_bvh(
        o3, d3, bvh_mod.bvh_to_device(bvh, dtype=jnp.float32),
        tuple(tuple(jnp.asarray(p) for p in t) for t in ordered), 1e-5,
        bvh.max_leaf,
    )
    t_j, h_j = np.asarray(t_j), np.asarray(h_j)
    hits = t_j < 1e19
    assert hits.sum() > 100
    # same node order, slab test and Moller-Trumbore as the spec
    np.testing.assert_array_equal(t_k, t_j)
    np.testing.assert_array_equal(h_k[hits], h_j[hits])

    ts = tri.intersect_triangles_brute(
        o3, d3, *(tuple(jnp.asarray(c) for c in t) for t in planes), 1e-5
    )
    t_b = np.asarray(jnp.min(ts, 0))
    np.testing.assert_array_equal(t_k < 1e19, t_b < 1e19)
    np.testing.assert_allclose(t_k[hits], t_b[hits], rtol=1e-6)
    # the leaf-ordered id maps back to the brute-force winner face
    # wherever that winner is unique
    h_b = np.asarray(jnp.argmin(ts, 0))
    tie = (np.sort(np.asarray(ts), 0)[1] == t_b)
    ok = hits & ~tie
    np.testing.assert_array_equal(bvh.tri_order[h_k[ok]], h_b[ok])


@pytest.mark.parametrize("block", [64, 128, 256])
@pytest.mark.parametrize("n", [300, 512, 777])
def test_traversal_block_sizes_and_ragged_counts(block, n):
    bvh, _, _, tables = _tables("ico2")
    o, d = _rays(n, seed=2)
    rp = jnp.asarray(np.concatenate([o, d], 1).T.copy())
    t_k, h_k = pallas_bvh.intersect_bvh_pallas(
        rp, *tables, max_leaf=bvh.max_leaf, interpret=True, block=block,
    )
    t_r, h_r = pallas_bvh.intersect_bvh_pallas(
        rp, *tables, max_leaf=bvh.max_leaf, interpret=True,
    )
    assert t_k.shape == (n,) and h_k.shape == (n,)
    np.testing.assert_array_equal(np.asarray(t_k), np.asarray(t_r))
    np.testing.assert_array_equal(np.asarray(h_k), np.asarray(h_r))


def test_pack_bvh_layout():
    bvh, _, ordered, (nodes_f, nodes_i, tris) = _tables("cube")
    assert nodes_f.shape == (bvh.n_nodes, 8) and nodes_i.shape == (bvh.n_nodes, 4)
    assert tris.shape == (bvh.n_tris, 16)
    np.testing.assert_array_equal(np.asarray(nodes_f)[:, 0:3], bvh.bmin)
    np.testing.assert_array_equal(np.asarray(nodes_f)[:, 4:7], bvh.bmax)
    np.testing.assert_array_equal(np.asarray(nodes_i)[:, 2], bvh.miss)
    np.testing.assert_array_equal(np.asarray(tris)[:, 3], ordered[1][0])


def test_compiled_traversal_refuses_cpu():
    bvh, _, _, tables = _tables("cube")
    with pytest.raises(RuntimeError, match="need a GPU"):
        pallas_bvh.intersect_bvh_pallas(
            jnp.zeros((6, 64), jnp.float32), *tables, max_leaf=bvh.max_leaf
        )
    with pytest.raises(RuntimeError, match="need a GPU"):
        pallas_bvh.launch_config(tables, max_leaf=bvh.max_leaf)
    assert pallas_bvh.launch_config(
        tables, max_leaf=bvh.max_leaf, interpret=True
    ) == (pallas_bvh.INTERPRET_BLOCK, 4)


@pytest.mark.parametrize("block,warps", [(64, 2), (256, 8)])
def test_traversal_lowers_for_gpu(block, warps):
    bvh, _, _, tables = _tables("ico3")
    f = functools.partial(
        pallas_bvh._call, max_leaf=bvh.max_leaf, eps=1e-4, block=block,
        num_warps=warps, interpret=False,
    )
    lowered = jax.jit(f).trace(
        jax.ShapeDtypeStruct((6, 1 << 20), jnp.float32), *tables
    ).lower(lowering_platforms=("cuda",))
    assert "__gpu$xla.gpu.triton" in lowered.as_text()
