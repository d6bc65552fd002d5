"""Device-side + host-side dump helpers (utils/debug.py) — the
reference's DumpTensor/DEBUG-macro and PrintData analogues
(rt_helper.h:17-48, data_utils.h:124-195)."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ascendpathtracing.utils import debug as dbg  # noqa: E402


def test_print_data_typed_dump(capsys):
    arr = np.arange(20, dtype=np.float32).reshape(4, 5)
    arr[1, 1] = np.nan
    msg = dbg.print_data("hit_t", arr, max_items=4)
    err = capsys.readouterr().err
    assert "hit_t" in err and "float32" in err and "(4, 5)" in err
    assert "finite=19/20" in msg
    assert "0, 1, 2, 3, ..." in msg


def test_print_data_int_and_empty():
    msg = dbg.print_data("ids", np.asarray([3, 1, 2], np.int32))
    assert "int32" in msg and "min=1" in msg and "max=3" in msg
    msg2 = dbg.print_data("empty", np.zeros((0,), np.float32))
    assert "finite=0/0" in msg2


def test_kernel_dump_in_interpret_kernel(capfd):
    """kernel_dump must lower inside a Pallas kernel (interpret mode
    prints via the host) and gate on grid cell 0 by default."""
    from jax.experimental import pallas as pl

    def kernel(x_ref, o_ref):
        s = jnp.sum(x_ref[...])
        dbg.kernel_dump("tile sum", s)
        o_ref[...] = x_ref[...] * 2.0

    x = jnp.arange(4 * 128, dtype=jnp.float32).reshape(4, 128)
    out = pl.pallas_call(
        kernel,
        grid=(2,),
        in_specs=[pl.BlockSpec((2, 128), lambda b: (b, 0))],
        out_specs=pl.BlockSpec((2, 128), lambda b: (b, 0)),
        out_shape=jax.ShapeDtypeStruct((4, 128), jnp.float32),
        interpret=True,
    )(x)
    jax.block_until_ready(out)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(x) * 2.0)
    captured = capfd.readouterr()
    text = captured.out + captured.err
    # gated on cell 0: exactly one print despite a 2-cell grid
    assert text.count("tile sum") == 1, text
