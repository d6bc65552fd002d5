"""Debug guards + device/host dump helpers.

The reference's observability stack maps here as:

- device-side kernel printfs (``CPUDumpTensor``/``DEBUG`` macro gated on
  block 0, rt_helper.h:17-48; ``DumpTensor`` at render.cpp:198-201)
  -> :func:`kernel_dump`, a ``pl.debug_print`` wrapper usable inside
  Pallas kernels, gated on grid cell 0 like the reference gates on
  ``GetBlockIdx() == 0``;
- typed host-side buffer dumps (``PrintData``, data_utils.h:124-195)
  -> :func:`print_data`;
- CPU-debug allocator warnings / ASSERTs (allocator.h:261-284,
  render.cpp:68-73) -> :func:`assert_finite` + :func:`checkify_render`
  (NaN handling is load-bearing by design — the miss path is
  branch-free, see ops/intersect.py — so the guard is a cheap
  post-condition plus an optional checkify pass).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def kernel_dump(label: str, value, *, every_cell: bool = False, gate=None):
    """Device-side scalar dump from inside a Pallas kernel: the
    ``DumpTensor``/``DEBUG``-macro analogue (rt_helper.h:43-46 gates on
    core 0; this gates on grid cell 0 unless ``every_cell``).

    ``value`` must be a SCALAR (reduce vectors first).  Usage inside a kernel::

        kernel_dump("worklist k", k)          # cell 0 only
        kernel_dump("tile tmin", jnp.min(tmin), every_cell=True)

    ``gate``: an explicit traced-bool predicate replacing the default
    cell-0 gate.  REQUIRED when dumping from inside a ``fori_loop`` body
    — ``pl.program_id`` does not lower there; compute the gate at kernel
    top (e.g. ``(pl.program_id(0) == 0) & (pl.program_id(1) == 0)``) and
    close over it.

    Prints appear on the host's stderr in interpret mode, and from the
    device's printf on the GPU.
    """
    from jax.experimental import pallas as pl

    def _p():
        pl.debug_print(label + ": {}", value)

    if every_cell:
        _p()
        return
    if gate is None:
        gate = pl.program_id(0) == 0
        for d in range(1, 8):
            try:
                gate = gate & (pl.program_id(d) == 0)
            except Exception:  # noqa: BLE001 - out of grid dims
                break

    @pl.when(gate)
    def _():
        _p()


def print_data(name: str, x, *, max_items: int = 16, file=None) -> str:
    """Typed host dump of a device/host array — the ``PrintData``
    analogue (data_utils.h:124-195): dtype, shape, min/max/mean, finite
    count, and the first ``max_items`` values.  Returns the formatted
    string (and prints it to ``file``/stderr)."""
    import sys

    import numpy as np

    arr = np.asarray(x)
    flat = arr.reshape(-1)
    head = ", ".join(f"{v:.6g}" for v in flat[:max_items].astype(np.float64))
    if flat.size > max_items:
        head += ", ..."
    finite = int(np.isfinite(flat.astype(np.float64)).sum()) if flat.size else 0
    stats = ""
    if flat.size and np.issubdtype(arr.dtype, np.number):
        f64 = flat.astype(np.float64)
        stats = (f" min={np.nanmin(f64):.6g} max={np.nanmax(f64):.6g}"
                 f" mean={np.nanmean(f64):.6g}")
    msg = (f"[dump] {name}: dtype={arr.dtype} shape={arr.shape}"
           f" finite={finite}/{flat.size}{stats}\n        [{head}]")
    print(msg, file=file or sys.stderr)
    return msg


class NonFiniteRenderError(RuntimeError):
    pass


def assert_finite(x, name="output"):
    """Host-side post-condition; raises with basic stats on failure."""
    import numpy as np

    arr = np.asarray(x)
    bad = ~np.isfinite(arr)
    if bad.any():
        raise NonFiniteRenderError(
            f"{name}: {bad.sum()} non-finite of {arr.size} "
            f"(nan={np.isnan(arr).sum()}, inf={np.isinf(arr).sum()})"
        )
    return x


def checkify_render(fn):
    """Wrap a render function with jax.experimental.checkify so in-graph
    NaN/div checks surface as errors instead of silent propagation.
    Returns wrapped(fn) -> output (raises on check failure)."""
    from jax.experimental import checkify

    checked = checkify.checkify(fn, errors=checkify.float_checks)

    def run(*args, **kwargs):
        err, out = checked(*args, **kwargs)
        err.throw()
        return out

    return run
