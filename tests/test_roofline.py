"""Tests for the mechanical op counter behind the roofline accounting.

The counter (utils/roofline.count_ops) supplies the numerators of
per-kernel roofline bounds; these tests pin its
semantics on functions with hand-checkable counts: leaf classification,
scan/pallas-grid multipliers, assigned while-loop trip counts, and
dot_general matmul flops.  (The reference has no perf accounting at all to
mirror — SURVEY §6; this is BASELINE.json north-star tooling.)
"""

import jax
import jax.numpy as jnp
import numpy as np

from ascendpathtracing.utils import roofline as rl


def test_simple_elementwise_counts():
    f = lambda x: x * 2.0 + 1.0
    c = rl.count_ops(f, jnp.ones((8, 16)))
    assert c.flops == 2 * 8 * 16
    assert c.hard == 0 and c.vops == 0
    assert not c.whiles and not c.other


def test_classes_hard_and_vops():
    def f(x):
        y = jnp.sqrt(x)              # hard (8)
        z = jnp.where(x > y, x, y)   # gt (8) + select_n (8) vops
        return z / x                 # hard (8)

    c = rl.count_ops(f, jnp.ones((8,)))
    assert c.hard == 16
    assert c.hard_by_prim == {"sqrt": 8.0, "div": 8.0}
    assert c.vops == 16


def test_scan_multiplies_by_length():
    def f(x):
        def body(carry, _):
            return carry * 1.5 + 1.0, None
        out, _ = jax.lax.scan(body, x, None, length=7)
        return out

    c = rl.count_ops(f, jnp.ones((16,)))
    assert c.flops == 7 * 2 * 16


def test_fori_concrete_bounds_is_static():
    # fori_loop with concrete bounds lowers to scan: no `whiles` entry
    def f(x):
        return jax.lax.fori_loop(0, 5, lambda i, c: c * 2.0, x)

    c = rl.count_ops(f, jnp.ones((16,)))
    assert not c.whiles
    # 5 iterations x (16 body flops + 1 loop-counter increment)
    assert c.flops == 5 * (16 + 1)


def test_while_trips_assignment():
    def f(n, x):
        return jax.lax.fori_loop(0, n, lambda i, c: c * 2.0 + 1.0, x)

    c = rl.count_ops(f, 3, jnp.ones((16,)), while_trips={0: 10.0})
    assert len(c.whiles) == 1
    assert c.whiles[0]["trips"] == 10.0
    # 2*16 body flops + 1 loop-counter increment
    assert c.whiles[0]["body_vector_ops"] == 2 * 16 + 1
    # body flops scaled by the assigned trip count
    assert c.flops >= 10 * 2 * 16


def test_dot_general_mxu_flops():
    f = lambda a, b: a @ b
    c = rl.count_ops(f, jnp.ones((8, 32)), jnp.ones((32, 16)))
    assert c.matmul_flops == 2 * 8 * 16 * 32
    assert c.flops == 0


def test_reduce_counts_input_elems():
    c = rl.count_ops(lambda x: jnp.sum(x), jnp.ones((8, 128)))
    assert c.flops == 8 * 128


def test_pallas_call_grid_multiplier():
    from jax.experimental import pallas as pl

    def k(x_ref, o_ref):
        o_ref[...] = x_ref[...] * 2.0

    def f(x):
        return pl.pallas_call(
            k, grid=(4,),
            in_specs=[pl.BlockSpec((8, 128), lambda i: (0, 0))],
            out_specs=pl.BlockSpec((8, 128), lambda i: (0, 0)),
            out_shape=jax.ShapeDtypeStruct((8, 128), jnp.float32),
            interpret=True,
        )(x)

    c = rl.count_ops(f, jnp.ones((8, 128), jnp.float32))
    # mul counted once per grid step; ref get/swap land in mem_elems
    assert c.flops == 4 * 8 * 128
    assert c.mem_elems == 2 * 4 * 8 * 128


def test_value_and_grad_counts_both_passes():
    f = lambda x: x * x
    fwd = rl.count_ops(lambda x: jnp.sum(f(x)), jnp.ones((16,)))
    both = rl.count_ops(
        jax.value_and_grad(lambda x: jnp.sum(f(x))), jnp.ones((16,)))
    assert both.flops > fwd.flops


def test_bvh_kernel_counts_and_while_structure():
    """The traversal kernel traces with zero unknown primitives and one
    data-dependent loop (the per-block walk), whose body holds the slab
    test and max_leaf triangle tests."""
    from ascendpathtracing.accel import bvh as bvh_mod, meshes, tri
    from ascendpathtracing.ops import pallas_bvh

    v, f = meshes.icosphere(subdivisions=2)
    v32 = np.asarray(v, np.float32)
    bvh = bvh_mod.build_bvh_numpy(v32, f)
    planes = tri.triangle_planes(v32, f, dtype=np.float32)
    tables = pallas_bvh.pack_bvh(
        bvh, tuple(tuple(p[bvh.tri_order] for p in t) for t in planes))

    def step(rays):
        return pallas_bvh.intersect_bvh_pallas(
            rays, *tables, max_leaf=bvh.max_leaf, block=256, interpret=True)

    c = rl.count_ops(step, jnp.ones((6, 1024), jnp.float32),
                     default_while_trips=1.0)
    assert not c.other, c.other
    assert len(c.whiles) == 1
    assert c.whiles[0]["mult"] == 4.0  # one walk per block
    assert c.flops > 0 and c.vops > 0 and c.hard > 0
