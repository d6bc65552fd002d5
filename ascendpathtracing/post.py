"""Image post-processing: firefly clamping, tone mapping, edge-aware
denoising.

The reference has no post pipeline beyond clip-to-u8 PPM encode
(scripts/data_visualization.py:54-58); these are the standard production
stages a path-tracing framework is expected to ship: every op here is
pure jnp on [W, H, C] images, jit-able, gather-free.
The a-trous wavelet filter (Dammertz et al. 2010) is expressed as 25
static pad+slice shifts per iteration so XLA fuses the whole stencil
into one pass — no conv dynamic windows, no scatter.

Typical pipeline (what ``cli.py render --denoise --tonemap aces`` runs):

    colors  = firefly_clamp(colors, k)            # per-sample, pre-decode
    img     = io.decode_color_hdr(colors, w, h, s)
    img     = atrous_denoise(img, normal=n_img, depth=z_img, albedo=a_img)
    img     = tonemap_aces(img, exposure)
    u8      = to_u8(gamma_encode(img))
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


# ---------------------------------------------------------------- clamp ----
@partial(jax.jit, static_argnames=("max_radiance",))
def firefly_clamp(colors, max_radiance: float = 10.0):
    """Clamp per-sample radiance to bound outlier variance ("fireflies").

    Biased (energy loss on clamped paths) but the standard production
    trade; apply BEFORE sub-pixel averaging so one hot sample cannot
    dominate its pixel.  ``colors``: [N, 3] per-ray radiance.
    """
    lum = (
        0.2126 * colors[:, 0] + 0.7152 * colors[:, 1] + 0.0722 * colors[:, 2]
    )
    scale = jnp.where(
        lum > max_radiance, max_radiance / jnp.maximum(lum, 1e-12), 1.0
    )
    return colors * scale[:, None]


# -------------------------------------------------------------- tonemap ----
@jax.jit
def tonemap_reinhard(img, exposure: float = 1.0):
    """Reinhard global operator x/(1+x) on exposed linear radiance."""
    x = img * exposure
    return x / (1.0 + x)


@jax.jit
def tonemap_aces(img, exposure: float = 1.0):
    """ACES filmic fit (Narkowicz 2015): the industry-default S-curve."""
    x = img * exposure
    return jnp.clip(
        (x * (2.51 * x + 0.03)) / (x * (2.43 * x + 0.59) + 0.14), 0.0, 1.0
    )


@jax.jit
def gamma_encode(img, gamma: float = 2.2):
    """Linear -> display-encoded (smallpt uses the same 1/2.2 curve)."""
    return jnp.power(jnp.clip(img, 0.0, 1.0), 1.0 / gamma)


def to_u8(img):
    """[0,1] float image -> uint8 with round-half-away like smallpt's
    ``int(x*255+.5)``."""
    import numpy as np

    return np.asarray(
        jnp.clip(jnp.asarray(img) * 255.0 + 0.5, 0.0, 255.0)
    ).astype(np.uint8)


# -------------------------------------------------------------- denoise ----
def _shift2(x, dy: int, dx: int):
    """Static 2-D shift with edge replication: result[i,j] = x[i+dy, j+dx]
    (clamped).  Pure pad+slice — fuses into the surrounding stencil."""
    h, w = x.shape[0], x.shape[1]
    py0, py1 = max(dy, 0), max(-dy, 0)
    px0, px1 = max(dx, 0), max(-dx, 0)
    pad = ((py1, py0), (px1, px0)) + ((0, 0),) * (x.ndim - 2)
    xp = jnp.pad(x, pad, mode="edge")
    return jax.lax.slice(
        xp, (py0, px0) + (0,) * (x.ndim - 2), (py0 + h, px0 + w) + x.shape[2:]
    )


# B3-spline 5-tap weights (1,4,6,4,1)/16, separable
_H5 = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)


@partial(
    jax.jit,
    static_argnames=(
        "iterations", "sigma_color", "sigma_normal", "sigma_depth"
    ),
)
def atrous_denoise(
    img,
    normal=None,
    depth=None,
    albedo=None,
    *,
    iterations: int = 3,
    sigma_color: float = 0.4,
    sigma_normal: float = 0.35,
    sigma_depth: float = 0.02,
):
    """Edge-aware a-trous wavelet denoiser (Dammertz et al. 2010).

    Args:
      img:    [W, H, 3] linear radiance (decoded, pre-tonemap).
      normal: optional [W, H, 3] first-hit shading normals (unit).
      depth:  optional [W, H] or [W, H, 1] first-hit depth; internally
              normalized by its max so ``sigma_depth`` is scene-scale-free.
      albedo: optional [W, H, 3] first-hit albedo.  When given, the
        filter denoises *irradiance* (img / albedo) and re-modulates at
        the end — texture detail survives aggressive smoothing.
      iterations: a-trous levels; footprint grows as 2^iterations.
      sigma_*: edge-stopping strengths (color sigma is halved each level,
        per the paper).

    Per-tap weight: h_q * exp(-|c_p-c_q|^2/s_c) * max(0,n_p.n_q)^128-ish
    * exp(-|z_p-z_q|^2/s_d), normalized over the 25 taps.  Guides are
    optional; with none given this degrades to bilateral-in-color only.
    """
    orig_dtype = img.dtype
    c = jnp.asarray(img, jnp.float32)
    if albedo is not None:
        alb = jnp.maximum(jnp.asarray(albedo, jnp.float32), 1e-3)
        c = c / alb
    if depth is not None:
        z = jnp.asarray(depth, jnp.float32)
        z = z[..., 0] if z.ndim == 3 else z
        z = z / jnp.maximum(jnp.max(z), 1e-12)
    if normal is not None:
        nrm = jnp.asarray(normal, jnp.float32)

    sc = float(sigma_color)
    for it in range(iterations):
        step = 1 << it
        acc = jnp.zeros_like(c)
        wsum = jnp.zeros(c.shape[:2] + (1,), jnp.float32)
        for iy, hy in enumerate(_H5):
            for ix, hx in enumerate(_H5):
                dy, dx = (iy - 2) * step, (ix - 2) * step
                cq = _shift2(c, dy, dx)
                dc2 = jnp.sum((c - cq) ** 2, axis=-1)
                w = jnp.exp(-dc2 / max(sc * sc, 1e-12))
                if normal is not None:
                    ndot = jnp.clip(
                        jnp.sum(nrm * _shift2(nrm, dy, dx), axis=-1), 0.0, 1.0
                    )
                    # smooth power approximation of the paper's n-weight
                    w = w * ndot ** (1.0 / max(sigma_normal, 1e-3))
                if depth is not None:
                    dz = z - _shift2(z, dy, dx)
                    w = w * jnp.exp(-(dz * dz) / (sigma_depth * sigma_depth))
                w = (hy * hx) * w
                acc = acc + cq * w[..., None]
                wsum = wsum + w[..., None]
        c = acc / jnp.maximum(wsum, 1e-12)
        sc = sc * 0.5  # tighter color gate at coarser levels

    if albedo is not None:
        c = c * alb
    return c.astype(orig_dtype)
