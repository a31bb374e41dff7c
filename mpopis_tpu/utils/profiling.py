"""Tracing / profiling utilities.

The reference has no profiling beyond coarse per-trial wall-clock
(car_example.jl:192,284-285). Here: per-phase wall timers around jitted
calls plus a jax.profiler trace helper for device timeline capture
(SURVEY.md §5 "New build" item).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import jax


class PhaseTimer:
    """Accumulates wall-clock per named phase.

    JAX dispatch is asynchronous, so the caller must block on the phase's
    device results INSIDE the with-block for the timing to mean anything:

        timer = PhaseTimer()
        with timer.phase("rollout"):
            costs = rollout(...)
            jax.block_until_ready(costs)
        print(timer.report())
    """

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        total = sum(self.totals.values())
        for name, t in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(
                f"{name:<24s} {t * 1e3:9.2f} ms total | {t / max(n, 1) * 1e3:8.3f} ms/call"
                f" | {n:5d} calls | {100 * t / max(total, 1e-12):5.1f}%"
            )
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str = "logs/trace"):
    """Capture a jax.profiler trace (view with TensorBoard / xprof)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


def timed(fn, *args, iters: int = 10, warmup: int = 2):
    """Steady-state seconds/call for a jitted function."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters
