"""Morton ray-sort correctness: permutation validity and key locality."""

import jax.numpy as jnp
import numpy as np

from ascendpathtracing.ops import sort as rs


def test_sort_is_permutation_and_groups_octants():
    rng = np.random.RandomState(0)
    n = 4096
    o = rng.rand(n, 3).astype(np.float32) * 100
    d = rng.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o3 = tuple(jnp.asarray(o[:, i]) for i in range(3))
    d3 = tuple(jnp.asarray(d[:, i]) for i in range(3))
    lo = jnp.asarray([0.0, 0.0, 0.0])
    hi = jnp.asarray([100.0, 100.0, 100.0])
    o3s, d3s, perm = rs.sort_rays_for_traversal(o3, d3, lo, hi)
    perm = np.asarray(perm)
    assert sorted(perm.tolist()) == list(range(n))
    # data is actually permuted consistently
    np.testing.assert_allclose(np.asarray(o3s[0]), o[perm, 0])
    np.testing.assert_allclose(np.asarray(d3s[2]), d[perm, 2])
    # octants are contiguous after the sort
    dxs, dys, dzs = (np.asarray(c) for c in d3s)
    octant = (dxs >= 0) + 2 * (dys >= 0) + 4 * (dzs >= 0)
    changes = (np.diff(octant) != 0).sum()
    assert changes <= 7, f"octants not grouped: {changes} transitions"


def test_morton_locality():
    """Nearby origins map to nearby codes (sanity on the bit interleave)."""
    ix = jnp.asarray([0, 1, 0, 0], jnp.int32)
    iy = jnp.asarray([0, 0, 1, 0], jnp.int32)
    iz = jnp.asarray([0, 0, 0, 1], jnp.int32)
    codes = np.asarray(rs.morton3(ix, iy, iz))
    assert codes[0] == 0 and codes[1] == 1 and codes[2] == 2 and codes[3] == 4


def test_ray_sort_keys_6d_groups_direction():
    # rays at one origin with two opposite directions must sort into two
    # contiguous groups (the octant key would too); rays with slightly
    # different directions in the same octant must still subgroup
    n = 256
    rng = np.random.RandomState(0)
    o = tuple(jnp.zeros((n,), jnp.float32) for _ in range(3))
    half = n // 2
    dx = np.where(np.arange(n) < half, 1.0, -1.0).astype(np.float32)
    dy = (rng.rand(n) * 0.1).astype(np.float32)
    d = (jnp.asarray(dx), jnp.asarray(dy), jnp.zeros((n,), jnp.float32))
    lo = jnp.asarray([-1.0, -1.0, -1.0])
    hi = jnp.asarray([1.0, 1.0, 1.0])
    keys = np.asarray(rs.ray_sort_keys_6d(o, d, lo, hi))
    assert keys[:half].max() != keys[half:].max()
    order = np.argsort(keys)
    groups = (np.arange(n)[order] < half)
    # one transition between the two direction groups
    assert np.abs(np.diff(groups.astype(int))).sum() == 1
