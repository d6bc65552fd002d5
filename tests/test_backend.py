"""The platform decisions (ascendpathtracing/backend.py) and the entry
points that must refuse to run without a GPU."""

import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

from ascendpathtracing import backend

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cpu_takes_the_xla_paths():
    assert not backend.on_gpu()
    assert not backend.use_kernels()


@pytest.mark.parametrize("interpret", [False, True])
def test_compiled_kernels_need_a_gpu(interpret):
    if interpret:
        backend.check_kernel_target(True)  # the interpreter is always fine
    else:
        with pytest.raises(RuntimeError, match="interpret=True"):
            backend.check_kernel_target(False)


def test_require_gpu_names_the_platform_found():
    with pytest.raises(RuntimeError, match="'cpu'"):
        backend.require_gpu("this measurement")


@pytest.mark.parametrize("env_dir", [None, "/somewhere/else/cache"])
def test_compile_cache_dir_rule(monkeypatch, env_dir):
    """$JAX_COMPILATION_CACHE_DIR when set (and then nothing is set in
    code), else the fixed .jax_cache/ at the root of the checkout."""
    updates = []
    monkeypatch.setattr(jax.config, "update", lambda k, v: updates.append((k, v)))
    if env_dir is None:
        monkeypatch.delenv(backend.CACHE_ENV, raising=False)
        expect = os.path.join(REPO, ".jax_cache")
    else:
        monkeypatch.setenv(backend.CACHE_ENV, env_dir)
        expect = env_dir
    assert backend.compile_cache_dir() == expect
    assert backend.enable_compile_cache() == expect
    if env_dir is None:
        assert updates == [("jax_compilation_cache_dir", expect)]
    else:
        assert updates == []


def test_jax_cache_is_ignored_by_git():
    with open(os.path.join(REPO, ".gitignore")) as fh:
        assert ".jax_cache/" in fh.read().split()


class _FakeCompiled:
    def __init__(self, clock, cost):
        self.clock, self.cost = clock, cost

    def __call__(self, *args):
        self.clock.now += self.cost
        return np.zeros(1)


def test_fastest_config_times_each_candidate_once(monkeypatch):
    class Clock:
        now = 0.0

    clock = Clock()
    monkeypatch.setattr(backend.time, "perf_counter", lambda: clock.now)
    monkeypatch.setattr(backend, "_TUNED", {})
    costs = {(128, 4): 3.0, (256, 4): 1.0, (512, 8): 2.0}
    compiled = []

    def compile_cfg(cfg):
        compiled.append(cfg)
        return _FakeCompiled(clock, costs[cfg])

    args = (np.zeros(4),)
    best = backend.fastest_config("k", tuple(costs), compile_cfg, args)
    assert best == (256, 4)
    assert compiled == list(costs)
    # cached per (key, device kind): no second round of compiles
    assert backend.fastest_config("k", tuple(costs), compile_cfg, args) == best
    assert compiled == list(costs)
    (key, kind), = backend.tuned_configs()
    assert key == "k" and kind == jax.devices()[0].device_kind


def _run(args, cwd, timeout=300):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def _ok_line(stdout):
    for line in stdout.splitlines():
        try:
            if json.loads(line).get("ok") is True:
                return True
        except (ValueError, AttributeError):
            pass
    return False


@pytest.mark.parametrize("script", ["bench.py", "chip_smoke.py"])
def test_measurement_scripts_fail_without_a_gpu(script):
    r = _run([script], REPO)
    assert r.returncode != 0
    assert "no GPU" in r.stderr or "needs a GPU" in r.stderr, r.stderr[-2000:]
    assert not _ok_line(r.stdout)


def test_chip_smoke_alone_fails(tmp_path):
    """Copied out of the repository it cannot import the program."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run(["chip_smoke.py"], str(tmp_path))
    assert r.returncode != 0
    assert not _ok_line(r.stdout)


def test_bench_main_refuses_cpu_in_process(capsys):
    import bench

    assert bench.main([]) == 2
    assert "needs a GPU" in capsys.readouterr().err
