"""Profiling / timing harness.

The reference's observability is manual time.time() prints and hard-coded
ETA messages (reference: model/count_co_events.py:199-229,
model/w2vec_aids.py:149-154, SURVEY.md §5.1). Here: a device timing
harness with warmup (compile) separation, plus jax.profiler trace capture
for roofline work.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, Dict, List, Optional

import jax


@dataclasses.dataclass
class TimingResult:
    name: str
    compile_s: float
    mean_s: float
    std_s: float
    runs: List[float]

    @property
    def per_second(self) -> float:
        return 1.0 / self.mean_s if self.mean_s > 0 else float("inf")

    def items_per_second(self, items: int) -> float:
        return items / self.mean_s if self.mean_s > 0 else float("inf")


def time_fn(
    name: str,
    fn: Callable,
    *args,
    iters: int = 5,
    warmup: int = 1,
    **kwargs,
) -> TimingResult:
    """Time a device function: the first call measures compile+run, the
    rest steady state. Every call ends in `jax.block_until_ready`, since
    dispatch returns before the device finishes."""
    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args, **kwargs))
    compile_s = time.perf_counter() - t0
    for _ in range(warmup - 1):
        jax.block_until_ready(fn(*args, **kwargs))
    runs = []
    for _ in range(iters):
        t = time.perf_counter()
        jax.block_until_ready(fn(*args, **kwargs))
        runs.append(time.perf_counter() - t)
    mean = sum(runs) / len(runs)
    std = (sum((r - mean) ** 2 for r in runs) / len(runs)) ** 0.5
    return TimingResult(name, compile_s, mean, std, runs)


@contextlib.contextmanager
def profiler_trace(log_dir: str):
    """jax.profiler trace context (view with tensorboard / xprof)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class StageTimer:
    """Accumulates named stage wall-clock times (the structured version of
    the reference's scattered log lines)."""

    def __init__(self):
        self.stages: Dict[str, float] = {}
        self._start: Optional[float] = None
        self._name: Optional[str] = None

    @contextlib.contextmanager
    def stage(self, name: str):
        t = time.perf_counter()
        try:
            yield
        finally:
            self.stages[name] = self.stages.get(name, 0.0) + time.perf_counter() - t

    def report(self) -> str:
        total = sum(self.stages.values())
        lines = [f"{name}: {s:.2f}s ({s / total * 100:.0f}%)"
                 for name, s in sorted(self.stages.items(), key=lambda kv: -kv[1])]
        return "\n".join(lines + [f"total: {total:.2f}s"])
