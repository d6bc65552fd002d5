"""Steady-state timing (utils/profiling.benchmark): warm-up calls are not
timed, every timed step is fenced on its own result, and the statistics
come from the per-step times.

Timing is made deterministic by monkeypatching the module's clock: the
fake ``fn`` advances a virtual clock by a scripted per-call duration.
"""

import pytest

pytest.importorskip("jax")

from ascendpathtracing.utils import profiling  # noqa: E402


class _FakeClock:
    def __init__(self):
        self.now = 0.0

    def perf_counter(self):
        return self.now


@pytest.fixture
def fake_clock(monkeypatch):
    clock = _FakeClock()
    monkeypatch.setattr(profiling.time, "perf_counter", clock.perf_counter)
    return clock


@pytest.mark.parametrize("warmup", [1, 2, 3])
def test_warmup_steps_are_not_timed(fake_clock, warmup):
    calls = []

    def fn(i):
        calls.append(i)
        # a slow compile on the first call only
        fake_clock.now += 5.0 if i == 0 else 2e-3
        return i

    res = profiling.benchmark(fn, iters=4, warmup=warmup)
    assert calls == list(range(warmup + 4))
    assert res["step_s"] == pytest.approx(2e-3)
    assert res["max_s"] == pytest.approx(2e-3)
    assert res["out"] == warmup + 3


def test_median_resists_one_slow_step(fake_clock):
    durations = iter([1.0, 1e-3, 1e-3, 0.5, 1e-3, 2e-3])

    def fn(i):
        fake_clock.now += next(durations)
        return i

    res = profiling.benchmark(fn, iters=5, warmup=1)
    assert res["iters"] == 5 and len(res["times"]) == 5
    assert res["step_s"] == pytest.approx(1e-3)
    assert res["min_s"] == pytest.approx(1e-3)
    assert res["max_s"] == pytest.approx(0.5)


def test_each_step_waits_for_its_result(monkeypatch):
    import jax

    fenced = []
    monkeypatch.setattr(jax, "block_until_ready", lambda x: fenced.append(x) or x)
    profiling.benchmark(lambda i: ("out", i), iters=3, warmup=1)
    assert fenced == [("out", 0), ("out", 1), ("out", 2), ("out", 3)]


def test_mrays_counts_primary_rays():
    assert profiling.mrays(4_000_000, 2.0) == pytest.approx(2.0)
