"""Differentiable camera: the smallpt camera model (camera.py) with its
parameters lifted into a pytree and the whole ray build in jnp."""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ascendpathtracing.camera import CAMERA_POS, CAMERA_RAW_DIR, FOV_SCALE, ORIGIN_PUSH


def CameraParams(pos=CAMERA_POS, raw_dir=CAMERA_RAW_DIR, fov=FOV_SCALE, dtype=jnp.float32):
    """Camera parameter pytree (plain dict so optimizers treat it like any
    model params)."""
    return {
        "pos": jnp.asarray(pos, dtype),
        "raw_dir": jnp.asarray(raw_dir, dtype),
        "fov": jnp.asarray(fov, dtype),
    }


def camera_rays(params, width, height, samples, jitter=None, key=None,
                origin_push=ORIGIN_PUSH):
    """Build [N, 6] rays from camera params, differentiably.

    ``jitter``: optional [N, 2] tent-filter offsets in (-1, 1); when None
    they are drawn from ``key`` (or zeros if no key).  Matches the
    reference's ray math (gen_data.py:41-46): d = cx*su + cy*sv + dir,
    origin = pos + d*140, direction = normalize(d).
    """
    w, h, s = width, height, samples
    n = w * h * 4 * s
    dtype = params["pos"].dtype

    dirv = params["raw_dir"]
    dirn = dirv / jnp.linalg.norm(dirv)
    cx = jnp.stack([w * params["fov"] / h, jnp.zeros((), dtype), jnp.zeros((), dtype)])
    cross = jnp.cross(cx, dirn)
    cy = cross / jnp.linalg.norm(cross) * params["fov"]

    idx = jnp.arange(n)
    sx = (idx // s) % 2
    sy = (idx // (2 * s)) % 2
    j_idx = (idx // (4 * s)) % h
    i_idx = idx // (4 * s * h)

    if jitter is None:
        if key is not None:
            u = jax.random.uniform(key, (n, 2), dtype=dtype)
            r = 2.0 * u
            jitter = jnp.where(r < 1, jnp.sqrt(r) - 1, 1 - jnp.sqrt(jnp.maximum(2 - r, 0)))
        else:
            jitter = jnp.zeros((n, 2), dtype)

    su = ((sx + 0.5 + jitter[:, 0]) / 2.0 + i_idx) / w - 0.5
    sv = ((sy + 0.5 + jitter[:, 1]) / 2.0 + j_idx) / h - 0.5
    d = su[:, None] * cx[None, :] + sv[:, None] * cy[None, :] + dirn[None, :]
    o = params["pos"][None, :] + d * origin_push
    dn = d * jax.lax.rsqrt(jnp.sum(d * d, axis=1, keepdims=True))
    return jnp.concatenate([o, dn], axis=1).astype(dtype)
