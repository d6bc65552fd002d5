"""Differentiable mesh pass (VERDICT r1 item 3; SURVEY §7 phase 4 applied
to meshes): make vertices and per-face albedo/emission traced pytree
inputs, with hit DECISIONS detached and every continuous quantity
(hit distance, normals, attribute products) recomputed differentiably.

How gradients flow per traversal mode:

- ``brute`` (the f64 oracle path): fully differentiable as-is —
  ``min``/``argmin`` hit selection is piecewise-smooth, gathers have
  scatter-add transposes (fine at oracle sizes).  This is the
  finite-difference gold standard (tests/test_mesh_grad.py).
- ``kernel`` / ``jnp`` (the BVH walks): the traversal returns the winning
  triangle (discrete, stopped); models/mesh._mesh_hit recomputes t from
  the winner's plane equation in jnp, so d(depth)/d(vertices) and all
  attribute gradients flow even though pallas_call and while_loop have
  no reverse-mode rule.  The kernel's BVH tables are a detached copy of
  the geometry; when vertices move materially during optimization,
  rebuild the device scene (``mesh_scene_to_device``) outside jit — the
  gradient is exact for the fixed hit topology either way
  (reparameterized discrete decisions are the stated scope).

The builders here mirror models/mesh.mesh_scene_to_device but construct
the leaf-ordered geometry/attribute planes IN-JIT from the traced
params, so AD reaches them.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ascendpathtracing.models import mesh as mesh_mod


def mesh_params(ms: mesh_mod.MeshScene, dtype=jnp.float32):
    """MeshScene -> traced parameter pytree (the differentiable leaves)."""
    return {
        "vertices": jnp.asarray(np.asarray(ms.vertices), dtype),
        "face_albedo": jnp.asarray(np.asarray(ms.face_albedo), dtype),
        "face_emission": jnp.asarray(np.asarray(ms.face_emission), dtype),
    }


def build_traced_dev(params, dev0, faces):
    """Rebuild the device scene's geometry/attribute planes from traced
    params (in-jit, differentiable), keeping dev0's non-diff parts
    (spheres, kernel tables, materials).

    faces: [F, 3] int device array.
    dev0:  pytree from mesh_scene_to_device (static config stripped).
    """
    v = params["vertices"]
    tri = v[faces]  # [F, 3, 3]
    v0f = tri[:, 0]
    e1f = tri[:, 1] - tri[:, 0]
    e2f = tri[:, 2] - tri[:, 0]
    albf = params["face_albedo"]
    emif = params["face_emission"]

    order = dev0["face_order"]
    v0s, e1s, e2s = v0f[order], e1f[order], e2f[order]
    alb, emi = albf[order], emif[order]

    fn = jnp.cross(e1s, e2s)
    fn = fn / jnp.maximum(
        jnp.linalg.norm(fn, axis=1, keepdims=True), jnp.asarray(1e-30, fn.dtype)
    )
    dev = dict(dev0)
    planes = lambda a: tuple(a[:, i] for i in range(3))
    dev["v0"] = planes(v0s)
    dev["e1"] = planes(e1s)
    dev["e2"] = planes(e2s)
    dev["fnormal"] = planes(fn)
    dev["f_albedo"] = planes(alb)
    dev["f_emission"] = planes(emi)
    return dev


def _strip(dev):
    traced, static = mesh_mod._split_static(dev)
    # gradients need the recompute/gather path regardless of how the
    # device scene was built
    return traced, static._replace(diff=True)


def render_pt_mesh_params_impl(
    key, rays, params, dev0, faces, *, bounces=4, rr_depth=5, eps=1e-4,
    static=None,
):
    dev = build_traced_dev(params, dev0, faces)
    return mesh_mod.render_pt_mesh_impl(
        key, rays, dev, bounces=bounces, rr_depth=rr_depth, eps=eps,
        static=static,
    )


def depth_aov_params_impl(rays, params, dev0, faces, *, eps=1e-4, static=None):
    """First-hit depth AOV [N], differentiable w.r.t. vertices: the mesh
    analogue of diff/camera.py's depth-based geometry gradients."""
    dev = build_traced_dev(params, dev0, faces)
    tmin, _kind, _hid = mesh_mod.first_hit_mesh_impl(
        rays, dev, eps=eps, static=static
    )
    return tmin


_render_jit = jax.jit(
    render_pt_mesh_params_impl,
    static_argnames=("bounces", "rr_depth", "eps", "static"),
)
_depth_jit = jax.jit(depth_aov_params_impl, static_argnames=("eps", "static"))


class StaleKernelTablesError(RuntimeError):
    """Traced vertices have drifted too far from the traversal kernel's
    frozen chunk tables — hit decisions come from stale geometry."""


def table_drift(params, dev, faces) -> float:
    """Max vertex displacement (fraction of the scene diagonal) between
    the traced ``params["vertices"]`` and the geometry frozen into the
    traversal kernel's tables at ``mesh_scene_to_device`` time.

    The kernel's BVH tables do NOT follow the traced vertices; beyond a
    small drift the detached hit decisions are for a different mesh and
    gradients silently rot (the failure mode the module docstring warns
    about).  Returns 0.0 for the jnp and brute traversals (they walk the
    traced planes themselves)."""
    if dev["static"].traversal != "kernel":
        return 0.0
    v = np.asarray(params["vertices"], np.float64)
    order = np.asarray(dev["face_order"])
    t_new = v[np.asarray(faces)][order]  # [F, 3, 3] traced, leaf order
    # frozen tables store v0/e1/e2 planes; reconstruct all THREE vertices
    # — drift concentrated in v1/v2 (a vertex that never occupies the v0
    # slot) must trip the guard too
    v0_f = np.stack([np.asarray(p, np.float64) for p in dev["v0"]], 1)
    e1_f = np.stack([np.asarray(p, np.float64) for p in dev["e1"]], 1)
    e2_f = np.stack([np.asarray(p, np.float64) for p in dev["e2"]], 1)
    frozen = np.stack([v0_f, v0_f + e1_f, v0_f + e2_f], 1)
    delta = float(np.abs(frozen - t_new).max()) if order.size else 0.0
    lo, hi = (np.asarray(x, np.float64) for x in dev["bounds"])
    diag = float(np.linalg.norm(hi - lo))
    return float(delta / max(diag, 1e-30))


def assert_tables_fresh(params, dev, faces, *, tol: float = 0.01):
    """Guard for vertex-optimization loops on the kernel traversal: raise
    :class:`StaleKernelTablesError` once drift exceeds ``tol`` (default
    1% of the scene diagonal) — the caller should rebuild the device
    scene (``mesh_scene_to_device``) outside jit and continue.  Returns
    the measured drift so callers can log it."""
    d = table_drift(params, dev, faces)
    if d > tol:
        raise StaleKernelTablesError(
            f"vertices drifted {d:.4f} of scene diagonal from the frozen "
            f"kernel tables (tol={tol}); rebuild the device scene with "
            "mesh_scene_to_device before continuing"
        )
    return d


def render_pt_mesh_params(key, rays, params, dev, faces, **kw):
    """Jitted differentiable render: radiance [N, 3] as a function of the
    traced params pytree (plus dev's sphere params if differentiated
    upstream)."""
    traced, static = _strip(dev)
    return _render_jit(key, rays, params, traced, faces, static=static, **kw)


def depth_aov_params(rays, params, dev, faces, **kw):
    """Jitted differentiable first-hit depth (see depth_aov_params_impl)."""
    traced, static = _strip(dev)
    return _depth_jit(rays, params, traced, faces, static=static, **kw)
