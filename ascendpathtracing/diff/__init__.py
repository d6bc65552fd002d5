"""Differentiable rendering (BASELINE config 4).

The discrete hit decision (argmin over primitives) is detached — integer
indices carry no gradient — while every continuous quantity (hit
distance t, normals, throughput products, camera ray directions) flows
through reverse-mode AD.  This is the standard "detach discrete,
differentiate continuous" treatment; the branch-free intersection in
ops/intersect.py was designed so no NaN ever enters the backward graph
(SURVEY §7 hard-part 2).

- ``camera``  — camera parameters (position/orientation/fov) as a pytree
  with fully-jnp ray generation, so camera grads flow (the reference's
  camera is frozen host-side data, gen_data.py:24-29).
- ``fd``      — central-finite-difference gradient checking utilities
  (the config-4 allclose gate).
"""

from ascendpathtracing.diff.camera import CameraParams, camera_rays
from ascendpathtracing.diff.fd import fd_grad, check_grads_fd

__all__ = ["CameraParams", "camera_rays", "fd_grad", "check_grads_fd"]
