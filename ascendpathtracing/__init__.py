"""AscendPathTracing: a differentiable Monte-Carlo path tracing framework
for the GPU.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the reference
Ascend-C path tracer (KVM-Explorer/AscendPathTracing):

- ``config``     — single source of truth for render configuration
  (replaces the triplicated constants in reference src/common.h:4-14,
  scripts/gen_data.py:6-10, scripts/data_visualization.py:5-7).
- ``scenes``     — scene tables (Cornell 8-sphere per reference
  scripts/gen_data.py:92-132, full smallpt 9-sphere, triangle meshes).
- ``camera``     — smallpt camera ray generation with tent-filter jitter
  (reference scripts/gen_data.py:21-75).
- ``oracle``     — NumPy reference renderers (the float32 oracle mirrors
  reference scripts/gen_data.py:246-429 ``test_soa`` semantics).
- ``models``     — the renderers ("model zoo"): jit megakernel, Pallas
  fused megakernel, wavefront renderer (replaces reference src/render.cpp).
- ``ops``        — intersection/shading device ops (replaces reference
  src/rt_helper.h) incl. the Pallas kernels (Triton route).
- ``backend``    — the one module that chooses a path per platform.
- ``accel``      — BVH build (host, C++-accelerated) + traversal.
- ``parallel``   — mesh / sharding / multi-host collectives (new; the
  reference's only parallelism is 8 in-chip cores, src/render.cpp:9).
- ``diff``       — differentiable rendering pass (new; north-star).
- ``utils``      — binary SoA I/O + PPM codec (replaces reference
  src/data_utils.h and scripts/data_visualization.py), profiling.
"""

from ascendpathtracing.config import RenderConfig
from ascendpathtracing.scenes import SphereScene, get_scene

__version__ = "0.1.0"

__all__ = ["RenderConfig", "SphereScene", "get_scene", "__version__"]
