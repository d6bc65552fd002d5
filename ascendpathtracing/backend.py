"""Where each path runs: the one module that looks at the platform.

- On a GPU the two Pallas kernels (the fused sphere forward,
  ops/pallas_kernels.py, and the BVH traversal, ops/pallas_bvh.py)
  compile through Triton; everything else is XLA.
- On the CPU the XLA paths run.  A Pallas kernel runs on the CPU only in
  the Pallas interpreter, and only when the caller asked for it
  (``interpret=True``: the tests, ``--backend cpu``).  Nothing here falls
  back from the GPU to the CPU or to the interpreter on its own.

It also owns the persistent compile cache and the launch configurations
that the kernels pick by timing their candidates on the device.
"""

from __future__ import annotations

import os
import pathlib
import time

import jax

CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"
# fixed in-checkout path: the directory is part of the cache key, so one
# that moved between runs would never hit
DEFAULT_CACHE_DIR = pathlib.Path(__file__).resolve().parent.parent / ".jax_cache"


def on_gpu() -> bool:
    return jax.default_backend() == "gpu"


def require_gpu(what: str) -> None:
    """Raise unless JAX runs on a GPU: measurements and on-card checks
    must not quietly run on the CPU."""
    if not on_gpu():
        raise RuntimeError(
            f"{what} needs a GPU; JAX found only {jax.default_backend()!r} "
            f"devices ({jax.devices()[0].device_kind})"
        )


def use_kernels() -> bool:
    """The Pallas kernels are the default path on the GPU; elsewhere the
    XLA paths are."""
    return on_gpu()


def check_kernel_target(interpret: bool) -> None:
    """A compiled Pallas kernel needs a GPU.  Off the GPU the caller must
    ask for the interpreter explicitly."""
    if not interpret and not on_gpu():
        raise RuntimeError(
            "compiled Pallas kernels need a GPU; JAX found "
            f"{jax.default_backend()!r}. Pass interpret=True (CLI: "
            "--backend cpu) to run them in the Pallas interpreter."
        )


def compile_cache_dir() -> str:
    """``$JAX_COMPILATION_CACHE_DIR`` when set, else ``.jax_cache/`` at
    the root of the checkout."""
    return os.environ.get(CACHE_ENV) or str(DEFAULT_CACHE_DIR)


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compile cache (entry points call this
    before their first compile).  When the environment names a directory
    JAX already reads it, and no other is set here."""
    path = compile_cache_dir()
    if not os.environ.get(CACHE_ENV):
        jax.config.update("jax_compilation_cache_dir", path)
    return path


# (kernel name, shape key, device kind) -> launch configuration
_TUNED: dict = {}


def fastest_config(key, candidates, compile_cfg, args, *, reps: int = 3):
    """Return the fastest of ``candidates`` for ``key``, timing each once
    per process.

    ``compile_cfg(cfg)`` returns the kernel compiled ahead of time
    (``jax.jit(...).lower(...).compile()``) for launch configuration
    ``cfg``; it runs on ``args`` (host arrays).  This works while an outer
    function is being traced (the kernel wrappers pick their
    configuration at trace time): compiling needs no concrete values, and
    the timed runs execute eagerly."""
    full_key = (key, jax.devices()[0].device_kind)
    if full_key in _TUNED:
        return _TUNED[full_key]
    compiled = {cfg: compile_cfg(cfg) for cfg in candidates}
    times = {}
    with jax.ensure_compile_time_eval():
        dev_args = [jax.device_put(a) for a in args]
        for cfg, fn in compiled.items():
            jax.block_until_ready(fn(*dev_args))  # warm up
            t0 = time.perf_counter()
            for _ in range(reps):
                jax.block_until_ready(fn(*dev_args))
            times[cfg] = (time.perf_counter() - t0) / reps
    best = min(times, key=times.get)
    _TUNED[full_key] = best
    return best


def tuned_configs() -> dict:
    """The launch configurations picked so far in this process."""
    return dict(_TUNED)
