"""Profiling and timing hooks.

The reference brackets each iteration with rusage/clock timers
(``src/util/util.h:66-89``) and logs ``time_learn``/``time_pred`` to RLog;
its ``getRSS.c`` memory probe is dead code.  Equivalents here: wall-clock
step timers, ``jax.profiler`` traces (viewable in TensorBoard/XProf), and
live device-memory statistics instead of the MemoryLog byte counter.
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional

import jax


class StepTimer:
    """Accumulates per-phase wall times; RLog-friendly."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str, sync: Optional[jax.Array] = None):
        t0 = time.perf_counter()
        yield
        if sync is not None:
            jax.block_until_ready(sync)
        dt = time.perf_counter() - t0
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    def mean(self, name: str) -> float:
        return self.totals.get(name, 0.0) / max(self.counts.get(name, 0), 1)

    def report(self) -> str:
        return "  ".join(f"{k}={self.mean(k)*1000:.1f}ms"
                         for k in sorted(self.totals))


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """jax.profiler trace wrapper (no-op when log_dir is falsy)."""
    if not log_dir:
        yield
        return
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def device_memory_stats() -> dict:
    """Per-device memory stats (bytes) where the backend reports them —
    the MemoryLog replacement (``src/util/memory.h:31-54``)."""
    out = {}
    for d in jax.devices():
        try:
            s = d.memory_stats()
        except Exception:
            s = None
        if s:
            out[str(d)] = {k: int(v) for k, v in s.items()
                           if isinstance(v, (int, float))}
    return out
