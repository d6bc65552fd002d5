"""Mechanical op accounting from lowered jaxprs (roofline inputs).

The reference ships no performance accounting at all (SURVEY §6: no
timing code anywhere).  This module produces the *numerator* of a
roofline — element-op counts per kernel — mechanically, by walking the
jaxpr that is actually compiled (including inside ``pallas_call``
bodies), instead of trusting a hand-written flop model.  The
denominators (the device's peak rates) and the kernel times come from
chip runs.

Counting model (element ops, i.e. per-lane work):

- ``flops``      — one-slot vector arithmetic (add/mul/sub/max/min/…).
- ``hard``       — multi-cycle ops (div, sqrt, rsqrt, exp, log, sin/cos,
                   tanh…), counted apart because their cost per element
                   is several arithmetic ops.
- ``vops``       — non-arithmetic element ops: compares, selects,
                   boolean algebra, dtype converts; they take issue
                   slots like flops.
- ``matmul_flops`` — dot_general: 2·M·N·K (tensor cores, separate bound).
- ``mem_elems``  — layout/copy/gather work (broadcast, reshape, slice,
                   ref get/swap …); reported separately, excluded from
                   the arithmetic count.
- ``while_*``    — data-dependent loops cannot be counted statically;
                   each ``while`` is assigned a trip count by the caller
                   (e.g. the kernel's measured worklist length from its
                   ``with_stats`` output).  Unassigned whiles default to
                   ``default_while_trips`` and are listed in the report
                   so nothing is silently dropped.

The walker recurses through pjit / scan / while / cond / custom_vjp /
checkpoint / pallas_call.  ``scan`` multiplies by its static ``length``
(this also covers ``lax.fori_loop`` with concrete bounds, which lowers
to scan).  ``pallas_call`` multiplies by the static grid size.

Tested on known-size functions and on the traversal kernel in
tests/test_roofline.py.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import jax
from jax import core as jcore  # noqa: F401  (kept for type context)

# one-slot vector arithmetic
_FLOPS = {
    "add", "sub", "mul", "max", "min", "neg", "abs", "sign", "floor",
    "ceil", "round", "add_any", "nextafter", "copy",
}
# multi-cycle element ops (see module docstring)
_HARD = {
    "div", "sqrt", "rsqrt", "cbrt", "exp", "exp2", "expm1", "log",
    "log1p", "sin", "cos", "tan", "asin", "acos", "atan", "atan2",
    "sinh", "cosh", "tanh", "erf", "erfc", "erf_inv", "logistic", "pow",
    "rem", "igamma", "lgamma", "digamma",
}
# non-arithmetic element ops
_VOPS = {
    "lt", "le", "gt", "ge", "eq", "ne", "and", "or", "not", "xor",
    "select_n", "convert_element_type", "is_finite", "shift_left",
    "shift_right_logical", "shift_right_arithmetic", "population_count",
    "clz", "random_bits", "threefry2x32", "clamp", "integer_pow",
    "bitcast_convert_type", "real", "imag", "stop_gradient",
}
# layout / memory movement (excluded from the arithmetic count)
_MEM = {
    "broadcast_in_dim", "reshape", "transpose", "slice", "squeeze",
    "concatenate", "pad", "rev", "iota", "gather", "scatter",
    "scatter-add", "scatter_add", "dynamic_slice", "dynamic_update_slice",
    "get", "swap", "masked_load", "masked_store", "masked_swap",
    "broadcast_to", "expand_dims",
    "bitcast",
}
# reductions: count input elements as flops (a tree of adds/compares)
_REDUCE = {
    "reduce_sum", "reduce_max", "reduce_min", "reduce_and", "reduce_or",
    "reduce_prod", "argmax", "argmin", "reduce_precision", "cumsum",
    "cummax", "cummin", "cumprod", "cumlogsumexp",
}
_ZERO_COST = {
    "program_id", "num_programs", "debug_print", "debug_callback",
    "stop_gradient", "eq_to", "pvary", "sharding_constraint", "axis_index",
    "optimization_barrier", "print", "callback", "pure_callback",
}


@dataclasses.dataclass
class OpCounts:
    flops: float = 0.0
    hard: float = 0.0
    vops: float = 0.0
    matmul_flops: float = 0.0
    mem_elems: float = 0.0
    hard_by_prim: dict = dataclasses.field(default_factory=dict)
    other: dict = dataclasses.field(default_factory=dict)
    whiles: list = dataclasses.field(default_factory=list)

    @property
    def vector_ops(self) -> float:
        """Total element ops (flops + hard + vops), unweighted: ``hard``
        ops cost several arithmetic ops each."""
        return self.flops + self.hard + self.vops

    def as_dict(self):
        return {
            "flops": self.flops,
            "hard": self.hard,
            "vops": self.vops,
            "vector_ops": self.vector_ops,
            "matmul_flops": self.matmul_flops,
            "mem_elems": self.mem_elems,
            "hard_by_prim": dict(self.hard_by_prim),
            "other": dict(self.other),
            "whiles": list(self.whiles),
        }


def _out_elems(eqn) -> int:
    n = 0
    for v in eqn.outvars:
        aval = v.aval
        n += int(math.prod(getattr(aval, "shape", ()) or (1,)))
    return n


def _in_elems(eqn) -> int:
    n = 0
    for v in eqn.invars:
        aval = getattr(v, "aval", None)
        if aval is not None and hasattr(aval, "shape"):
            n += int(math.prod(aval.shape or (1,)))
    return n


def _dot_flops(eqn) -> float:
    lhs, rhs = eqn.invars[0].aval.shape, eqn.invars[1].aval.shape
    ((lc, rc), (lb, rb)) = eqn.params["dimension_numbers"]
    k = math.prod(lhs[d] for d in lc)
    b = math.prod(lhs[d] for d in lb)
    m = math.prod(
        lhs[d] for d in range(len(lhs)) if d not in set(lc) | set(lb)
    )
    n = math.prod(
        rhs[d] for d in range(len(rhs)) if d not in set(rc) | set(rb)
    )
    return 2.0 * b * m * n * k


def _sub_jaxprs(params: dict):
    """Yield every jaxpr-valued entry in an eqn's params (generic
    fallback for higher-order primitives not special-cased below)."""
    for v in params.values():
        if hasattr(v, "jaxpr"):  # ClosedJaxpr
            yield v.jaxpr
        elif hasattr(v, "eqns"):  # raw Jaxpr
            yield v
        elif isinstance(v, (list, tuple)):
            for x in v:
                if hasattr(x, "jaxpr"):
                    yield x.jaxpr
                elif hasattr(x, "eqns"):
                    yield x


def count_jaxpr(
    jaxpr,
    counts: OpCounts,
    mult: float = 1.0,
    *,
    while_trips: Callable[[int, float], float],
    _state=None,
) -> OpCounts:
    state = _state if _state is not None else {"while_idx": 0}
    for eqn in jaxpr.eqns:
        name = eqn.primitive.name
        if name in ("pjit", "closed_call", "custom_jvp_call",
                    "custom_vjp_call", "custom_vjp_call_jaxpr", "remat",
                    "checkpoint", "remat2", "custom_gradient"):
            for key in ("jaxpr", "call_jaxpr", "fun_jaxpr"):
                sub = eqn.params.get(key)
                if sub is not None:
                    count_jaxpr(getattr(sub, "jaxpr", sub), counts, mult,
                                while_trips=while_trips, _state=state)
                    break
            else:
                for sub in _sub_jaxprs(eqn.params):
                    count_jaxpr(sub, counts, mult,
                                while_trips=while_trips, _state=state)
        elif name == "scan":
            length = eqn.params["length"]
            sub = eqn.params["jaxpr"]
            count_jaxpr(getattr(sub, "jaxpr", sub), counts, mult * length,
                        while_trips=while_trips, _state=state)
        elif name == "while":
            idx = state["while_idx"]
            state["while_idx"] += 1
            body = eqn.params["body_jaxpr"]
            body = getattr(body, "jaxpr", body)
            body_counts = OpCounts()
            # body cost measured once (mult=1) for the report, then
            # scaled into the totals by the assigned trip count
            count_jaxpr(body, body_counts, 1.0,
                        while_trips=while_trips,
                        _state={"while_idx": state["while_idx"]})
            trips = float(while_trips(idx, mult))
            counts.whiles.append({
                "index": idx,
                "trips": trips,
                "mult": mult,
                "body_vector_ops": body_counts.vector_ops,
            })
            count_jaxpr(body, counts, mult * trips,
                        while_trips=while_trips, _state=state)
            cond = eqn.params["cond_jaxpr"]
            count_jaxpr(getattr(cond, "jaxpr", cond), counts,
                        mult * (trips + 1.0),
                        while_trips=while_trips, _state=state)
        elif name == "cond":
            branches = eqn.params["branches"]
            # conservative: the most expensive branch
            best = None
            for br in branches:
                c = OpCounts()
                count_jaxpr(getattr(br, "jaxpr", br), c, mult,
                            while_trips=while_trips,
                            _state={"while_idx": state["while_idx"]})
                if best is None or c.vector_ops > best.vector_ops:
                    best = c
            if best is not None:
                counts.flops += best.flops
                counts.hard += best.hard
                counts.vops += best.vops
                counts.matmul_flops += best.matmul_flops
                counts.mem_elems += best.mem_elems
                for k2, v2 in best.hard_by_prim.items():
                    counts.hard_by_prim[k2] = (
                        counts.hard_by_prim.get(k2, 0.0) + v2)
                counts.whiles.extend(best.whiles)
        elif name == "pallas_call":
            grid = tuple(eqn.params["grid_mapping"].grid)
            gsz = float(math.prod(grid)) if grid else 1.0
            sub = eqn.params["jaxpr"]
            count_jaxpr(getattr(sub, "jaxpr", sub), counts, mult * gsz,
                        while_trips=while_trips, _state=state)
        elif name == "dot_general":
            counts.matmul_flops += mult * _dot_flops(eqn)
        elif name in _REDUCE:
            counts.flops += mult * _in_elems(eqn)
        elif name in _FLOPS:
            counts.flops += mult * _out_elems(eqn)
        elif name in _HARD:
            e = mult * _out_elems(eqn)
            counts.hard += e
            counts.hard_by_prim[name] = counts.hard_by_prim.get(name, 0.0) + e
        elif name in _VOPS:
            counts.vops += mult * _out_elems(eqn)
        elif name in _MEM:
            counts.mem_elems += mult * _out_elems(eqn)
        elif name in _ZERO_COST:
            pass
        else:
            sub_found = False
            for sub in _sub_jaxprs(eqn.params):
                count_jaxpr(sub, counts, mult,
                            while_trips=while_trips, _state=state)
                sub_found = True
            if not sub_found:
                key = name
                counts.other[key] = counts.other.get(key, 0.0) + (
                    mult * _out_elems(eqn)
                )
    return counts


def count_ops(
    fn: Callable,
    *args,
    while_trips: dict[int, float] | None = None,
    default_while_trips: float = 1.0,
    **kwargs,
) -> OpCounts:
    """Count element ops of ``fn(*args, **kwargs)`` as traced.

    ``while_trips`` assigns trip counts to data-dependent ``while`` loops
    by their order of first visit (see the ``whiles`` list in the result
    for each loop's per-trip body cost, so assignments can be checked).
    """
    wt = dict(while_trips or {})

    def lookup(idx, mult):
        return wt.get(idx, default_while_trips)

    jaxpr = jax.make_jaxpr(fn)(*args, **kwargs)
    counts = OpCounts()
    count_jaxpr(jaxpr.jaxpr, counts, 1.0, while_trips=lookup)
    return counts
