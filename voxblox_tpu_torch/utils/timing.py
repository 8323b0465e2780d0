"""Hierarchical timing registry (port of voxblox_tpu/utils/timing.py;
reference utils/timing.{h,cc}): named accumulator timers with rolling
window statistics and a formatted ``print_timing`` dump, tags after the
reference (``integrate/fast``, ``esdf/update_esdf``, ``mesh/update``...).

These are host clocks. The port launches CUDA work asynchronously, so a
timer around device work measures the time to enqueue it, as the JAX
package's timers measure dispatch; a caller that wants device time
synchronizes before the timer stops. A timer also names a
``torch.profiler`` span unless ``annotate=False``.
"""

from __future__ import annotations

import math
import time
from collections import deque
from contextlib import contextmanager
from typing import Dict

from torch.profiler import record_function

WINDOW = 200


class TimerStats:
    def __init__(self):
        self.total = 0.0
        self.count = 0
        self.window = deque(maxlen=WINDOW)

    def add(self, dt: float):
        self.total += dt
        self.count += 1
        self.window.append(dt)

    @property
    def mean(self):
        return self.total / self.count if self.count else 0.0

    @property
    def rolling_mean(self):
        return sum(self.window) / len(self.window) if self.window else 0.0

    @property
    def minimum(self):
        return min(self.window) if self.window else 0.0

    @property
    def maximum(self):
        return max(self.window) if self.window else 0.0

    @property
    def std(self):
        if len(self.window) < 2:
            return 0.0
        m = self.rolling_mean
        return math.sqrt(sum((x - m) ** 2 for x in self.window)
                         / (len(self.window) - 1))


_timers: Dict[str, TimerStats] = {}
enabled = True


def get(tag: str) -> TimerStats:
    if tag not in _timers:
        _timers[tag] = TimerStats()
    return _timers[tag]


@contextmanager
def timer(tag: str, annotate: bool = True):
    """Context timer; with ``annotate`` also a ``torch.profiler`` span."""
    if not enabled:
        yield
        return
    t0 = time.perf_counter()
    if annotate:
        with record_function(tag):
            yield
    else:
        yield
    get(tag).add(time.perf_counter() - t0)


class Timer:
    """Manual start/stop timer (reference timing::Timer)."""

    def __init__(self, tag: str):
        self.tag = tag
        self.t0 = time.perf_counter() if enabled else None
        self.stopped = not enabled

    def stop(self):
        if not self.stopped:
            get(self.tag).add(time.perf_counter() - self.t0)
            self.stopped = True


class DummyTimer:
    """Compile-out variant (timing.h:118-130)."""

    def __init__(self, tag: str):
        pass

    def stop(self):
        pass


def print_timing() -> str:
    """Formatted dump (timing.h Timing::Print)."""
    lines = ["Timing", "-------",
             "name\tcalls\ttotal\t(mean +- std)\t[min max]"]
    for tag in sorted(_timers):
        s = _timers[tag]
        lines.append(
            f"{tag}\t{s.count}\t{s.total:.4f}s\t"
            f"({s.rolling_mean * 1e3:.2f} +- {s.std * 1e3:.2f} ms)\t"
            f"[{s.minimum * 1e3:.2f} {s.maximum * 1e3:.2f} ms]")
    return "\n".join(lines)


def reset():
    _timers.clear()


def as_dict():
    return {tag: {"calls": s.count, "total_s": s.total,
                  "mean_ms": s.mean * 1e3,
                  "rolling_mean_ms": s.rolling_mean * 1e3}
            for tag, s in _timers.items()}
