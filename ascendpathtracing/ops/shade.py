"""Shading ops: reflection, diffuse sampling, refraction, Russian roulette.

The reference implements pure specular reflection only
(``GenerateNewRays``, rt_helper.h:689-703 — no RNG on device, see the Q&A
comment at rt_helper.h:683-687).  The ``"pt"`` mode adds the full smallpt
BSDF set: cosine-weighted diffuse, mirror, and dielectric refraction with
Schlick-approximated Fresnel.

Layout: SoA components — every vector is a triple of 1-D [N] planes
(see ops/intersect.py for the layout rationale).  Vec3 = a plain
(x, y, z) tuple of arrays.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Scale-aware self-intersection offset.  The sphere quadratic's
# ``t0 = b - sqrt(b*b - c)`` cancels catastrophically for the 1e5-radius
# wall spheres: in float32, b ~ |oc| ~ r carries ulp(b) ~ r * 2^-23, so
# hit positions are off by ~r * 1e-6 along the ray (~0.01-0.02 for the
# walls) — far beyond a fixed eps=1e-4 origin offset.  Measured effect
# before this fix: 16.6% of secondary rays re-hit the wall they just
# left at t < 0.1, and the leaked paths (wandering inside wall interiors
# that overlap the light sphere) biased the f32 smallpt9 PT estimator
# +50% bright vs the f64 truth (cornell8: +13%).  Offsetting by
# max(eps, REL_OFFSET * r_winner) puts the new origin robustly outside
# the winning sphere at every scale; triangles (scene-scale geometry,
# position error ~1e-5) pass r2_winner = 0 and keep the eps floor.
# REL_OFFSET is the FLOAT32 margin (~8 ulp of f32); the Pallas kernels
# are f32-only and use it directly.  The XLA renderers scale the margin
# to the compute dtype instead (ADVICE r4 low #4): f64 hit error is
# ~8 * 2^-52 * r ~ 1.8e-15 * r — 1.8e-10 scene units on the 1e5 walls,
# far under the eps floor — so the f64 "truth" estimator (and the
# committed f64 radiance goldens) keeps near-exact diffuse origins
# instead of baking in a 0.1-unit geometric offset.
REL_OFFSET = 1e-6
_REL_OFFSET_F64 = 8 * 2.0 ** -52


def rel_offset_for(dtype) -> float:
    """Dtype-scaled relative offset coefficient: ~8 ulp of the compute
    dtype (1e-6 for float32 — the measured-robust f32 margin — and
    ~1.8e-15 for float64)."""
    return _REL_OFFSET_F64 if jnp.dtype(dtype) == jnp.float64 else REL_OFFSET


def scaled_origin_offset(r2_winner, eps):
    """Per-ray origin offset: max(eps, rel_offset_for(dtype) *
    sqrt(r2_winner)).  ``r2_winner`` is the winning sphere's r^2 carrier
    (0 for triangle or miss winners).  Detached: robustness term, not
    part of the estimator's differentiable surface."""
    r2 = jax.lax.stop_gradient(r2_winner)
    return jnp.maximum(
        jnp.asarray(eps, r2.dtype),
        jnp.asarray(rel_offset_for(r2.dtype), r2.dtype) * jnp.sqrt(r2),
    )


# ------------------------------------------------------------- vec3 SoA ----
def v3_dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def v3_cross(a, b):
    return (
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    )


def v3_scale(a, s):
    return (a[0] * s, a[1] * s, a[2] * s)


def v3_add(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def v3_sub(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def v3_where(m, a, b):
    return (jnp.where(m, a[0], b[0]), jnp.where(m, a[1], b[1]), jnp.where(m, a[2], b[2]))


def v3_normalize(a, eps=0.0):
    """Safe normalize: 0 where the norm is 0/inf (the reference's float32
    overflow path on missed rays: |v| ~ 1e20 -> norm^2 = inf -> v/inf = 0,
    leaving the direction unchanged downstream)."""
    n2 = v3_dot(a, a)
    inv = jnp.where(n2 > eps, jax.lax.rsqrt(n2), 0.0)
    return v3_scale(a, inv)


# ------------------------------------------------------------- BSDF ops ----
def reflect(d, n):
    """Mirror reflect: d' = d - 2 (d.n) n (rt_helper.h:689-703)."""
    return v3_sub(d, v3_scale(n, 2.0 * v3_dot(d, n)))


def specular_bounce(o, d, tmin, center_hit):
    """The reference's bounce: hitPos = o + d*t; normal = normalize(hitPos
    - center); reflect (rt_helper.h:504-709). All args SoA triples except
    tmin [N]. Op order mirrors the NumPy oracle for float parity."""
    hx = o[0] + d[0] * tmin
    hy = o[1] + d[1] * tmin
    hz = o[2] + d[2] * tmin
    nx = hx - center_hit[0]
    ny = hy - center_hit[1]
    nz = hz - center_hit[2]
    n2 = nx * nx + ny * ny + nz * nz
    inv = jnp.where(n2 > 0, 1.0 / jnp.sqrt(n2), 0.0)
    nx, ny, nz = nx * inv, ny * inv, nz * inv
    dn = d[0] * nx + d[1] * ny + d[2] * nz
    td = 2.0 * dn
    return (hx, hy, hz), (d[0] - td * nx, d[1] - td * ny, d[2] - td * nz)


def cosine_sample_hemisphere(nl, u1, u2):
    """Cosine-weighted direction about the oriented unit normal ``nl``
    (smallpt's w/u/v frame). u1, u2 uniform [N] in [0,1)."""
    r1 = (2.0 * jnp.pi) * u1
    r2s = jnp.sqrt(u2)
    w = nl
    flip = jnp.abs(w[0]) > 0.1
    a = (jnp.where(flip, 0.0, 1.0), jnp.where(flip, 1.0, 0.0), jnp.zeros_like(w[0]))
    u = v3_normalize(v3_cross(a, w))
    v = v3_cross(w, u)
    d = v3_add(
        v3_add(v3_scale(u, jnp.cos(r1) * r2s), v3_scale(v, jnp.sin(r1) * r2s)),
        v3_scale(w, jnp.sqrt(jnp.maximum(1.0 - u2, 0.0))),
    )
    return v3_normalize(d)


def refract_or_reflect(d, n, into, uniform, ior=1.5):
    """smallpt REFR: dielectric with Schlick Fresnel.

    Args: d = incident dir, n = geometric unit normal, into = bool [N]
    (ray entering the medium, i.e. d.n < 0), uniform [N] in [0,1).
    Returns (new_d, throughput_scale) — the reflect/refract branch chosen
    per ray, with the unbiased 1/p weight smallpt uses.
    """
    sign = jnp.where(into, 1.0, -1.0)
    nl = v3_scale(n, sign)  # oriented against the ray
    nnt = jnp.where(into, 1.0 / ior, ior)
    ddn = v3_dot(d, nl)  # negative
    cos2t = 1.0 - nnt * nnt * (1.0 - ddn * ddn)
    tir = cos2t < 0

    refl = reflect(d, n)
    sqrt_c = jnp.sqrt(jnp.maximum(cos2t, 0.0))
    tdir = v3_normalize(
        v3_sub(v3_scale(d, nnt), v3_scale(n, sign * (ddn * nnt + sqrt_c)))
    )
    a = ior - 1.0
    b = ior + 1.0
    r0 = (a * a) / (b * b)
    c = 1.0 - jnp.where(into, -ddn, v3_dot(tdir, n))
    re = r0 + (1.0 - r0) * c * c * c * c * c
    tr = 1.0 - re
    p = 0.25 + 0.5 * re
    pick_refl = (uniform < p) | tir
    new_d = v3_where(pick_refl, refl, tdir)
    scale = jnp.where(tir, 1.0, jnp.where(pick_refl, re / p, tr / (1.0 - p)))
    return new_d, scale


def russian_roulette(throughput, u, p_min=0.1, p_max=0.95):
    """Continue with probability p = clamp(max component); survivors get
    throughput / p (unbiased). throughput = (r, g, b) planes.
    Returns (new_throughput, survive_mask)."""
    p = jnp.clip(jnp.maximum(jnp.maximum(throughput[0], throughput[1]), throughput[2]),
                 p_min, p_max)
    survive = u < p
    inv = 1.0 / p
    scaled = v3_scale(throughput, inv)
    return v3_where(survive, scaled, throughput), survive
