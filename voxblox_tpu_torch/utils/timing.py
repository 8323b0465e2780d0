"""Spans and counters of the port (port of voxblox_tpu/utils/timing.py;
reference utils/timing.{h,cc}): named accumulator timers with rolling
window statistics and a formatted ``print_timing`` dump, tags after the
reference (``integrate/fast``, ``esdf/update_esdf``, ``mesh/update``...),
and a recorder of device time, host syncs and counters per span.

``timer(tag, label)`` is the one span call. It always opens the
``torch.profiler`` label ``label or tag`` and adds its host time to the
registry. Host clocks time the enqueue: the port launches CUDA work
asynchronously.

Recording is off by default; it is on between ``start_recording()`` and
``stop_recording()``, and while a ``torch.profiler`` session collects (a
span entered under the profiler opens a recording, the first span entered
after it closes it; ``summary()`` reads it). While on, every span keeps
its name, parent, scan, host start and end on the profiler's clock (Unix
time: a Chrome trace's ``ts`` plus ``baseTimeNanoseconds``), its own host
syncs (``_runtime.SYNCS``, less its children's) and, once CUDA is in use,
a CUDA event pair on the current stream; ``count(name, n)`` adds to a
counter. Device values are read only when the recording is summarized:
one sync. While off, a span allocates no record, creates no event,
launches nothing and reads nothing.
"""

from __future__ import annotations

import math
import time
from collections import deque
from contextlib import contextmanager
from typing import Dict, Optional

import torch
from torch.profiler import record_function

from .. import _runtime

WINDOW = 200
RECORDS = 1 << 16  # spans a recording keeps, the oldest dropped first
_FOLD = 1024  # device counts kept before they are summed on the device


class TimerStats:
    def __init__(self):
        self.total = 0.0
        self.count = 0
        self.window = deque(maxlen=WINDOW)
        self.recorded = 0  # calls made while recording
        self.syncs = 0  # their own host syncs
        self.device_ms = None  # their device time, once summarized

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


# ---------------------------------------------------------------------------
# The recorder
# ---------------------------------------------------------------------------


class _Span:
    __slots__ = ("id", "tag", "parent", "scan", "start_ns", "end_ns",
                 "syncs0", "syncs", "child_syncs", "child_ns", "events",
                 "device_ms")


class _Recording:
    def __init__(self):
        self.spans = deque(maxlen=RECORDS)
        self.stack = []
        self.host_counts: Dict[str, int] = {}
        self.device_counts: Dict[str, list] = {}
        self.next_id = 0
        self.closed = False  # a profiler session that has ended

    def open(self, tag: str, scan: Optional[int]) -> _Span:
        s = _Span()
        s.start_ns = time.time_ns()
        parent = self.stack[-1] if self.stack else None
        s.id, self.next_id = self.next_id, self.next_id + 1
        s.tag = tag
        s.parent = parent.id if parent is not None else None
        s.scan = scan if scan is not None or parent is None else parent.scan
        s.syncs0 = _runtime.SYNCS
        s.child_syncs = s.child_ns = 0
        s.device_ms = None
        s.events = None
        if torch.cuda.is_initialized():
            s.events = (torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))
            s.events[0].record()
        self.stack.append(s)
        return s

    def close(self, s: _Span):
        if s.events is not None:
            s.events[1].record()
        s.end_ns = time.time_ns()
        self.stack.remove(s)
        total = _runtime.SYNCS - s.syncs0
        s.syncs = total - s.child_syncs
        if self.stack:
            self.stack[-1].child_syncs += total
            self.stack[-1].child_ns += s.end_ns - s.start_ns
        st = get(s.tag)
        st.recorded += 1
        st.syncs += s.syncs
        self.spans.append(s)

    def count(self, name: str, n):
        if isinstance(n, torch.Tensor):
            kept = self.device_counts.setdefault(name, [])
            kept.append(n.detach().reshape(()))
            if len(kept) >= _FOLD:
                kept[:] = [_total(kept)]
        else:
            self.host_counts[name] = self.host_counts.get(name, 0) + int(n)

    def summary(self) -> dict:
        """Resolve the device values (one sync) and total per tag."""
        pending = [s for s in self.spans
                   if s.events is not None and s.device_ms is None]
        if pending:
            torch.cuda.synchronize()
        for s in pending:
            s.device_ms = s.events[0].elapsed_time(s.events[1])
            s.events = None
            st = get(s.tag)
            st.device_ms = (st.device_ms or 0.0) + s.device_ms
        names = sorted(self.device_counts)
        totals = _runtime.host_ints(
            [_total(self.device_counts[k]) for k in names])
        for k, v in zip(names, totals):
            self.host_counts[k] = self.host_counts.get(k, 0) + v
        self.device_counts = {}
        spans, records = {}, []
        for s in sorted(self.spans, key=lambda s: s.id):
            host_ms = (s.end_ns - s.start_ns) / 1e6
            t = spans.setdefault(s.tag, dict(calls=0, host_ms=0.0,
                                             self_host_ms=0.0,
                                             device_ms=None, syncs=0))
            t["calls"] += 1
            t["host_ms"] += host_ms
            t["self_host_ms"] += host_ms - s.child_ns / 1e6
            t["syncs"] += s.syncs
            if s.device_ms is not None:
                t["device_ms"] = (t["device_ms"] or 0.0) + s.device_ms
            records.append(dict(id=s.id, tag=s.tag, parent=s.parent,
                                scan=s.scan, start_ns=s.start_ns,
                                end_ns=s.end_ns, syncs=s.syncs,
                                device_ms=s.device_ms))
        return dict(spans=spans, counters=dict(self.host_counts),
                    records=records)


def _total(counts):
    """The int64 sum of 0-dim device counts, on the device."""
    return torch.stack([c.to(torch.int64) for c in counts]).sum()


_rec: Optional[_Recording] = None
_explicit = False  # started by start_recording()


def _recording() -> Optional[_Recording]:
    global _rec
    if _explicit:
        return _rec
    if torch.autograd._profiler_enabled():
        if _rec is None or _rec.closed:
            _rec = _Recording()
        return _rec
    if _rec is not None:
        _rec.closed = True
    return None


def recording() -> bool:
    """Whether spans and counters are being recorded now (a caller guards
    device work that only feeds a counter with it)."""
    return _recording() is not None


def start_recording():
    """Record every span and counter until ``stop_recording()``."""
    global _rec, _explicit
    _rec, _explicit = _Recording(), True


def stop_recording() -> dict:
    """End the recording; returns ``summary()`` of it."""
    global _rec, _explicit
    rec, _rec, _explicit = _rec, None, False
    return _empty() if rec is None else rec.summary()


def summary() -> dict:
    """The open or last recording: ``spans`` per tag (calls, host_ms,
    self_host_ms, device_ms event to event or None without CUDA, syncs),
    ``counters`` (totals) and ``records`` (one dict per kept span)."""
    return _empty() if _rec is None else _rec.summary()


def _empty():
    return dict(spans={}, counters={}, records=[])


def count(name: str, n):
    """Add ``n`` (a host int, or a device tensor summed on the device) to
    the counter ``name`` while recording."""
    rec = _recording()
    if rec is not None:
        rec.count(name, n)


@contextmanager
def timer(tag: str, label: Optional[str] = None, scan: Optional[int] = None):
    """A span: the host registry's ``tag``, the profiler label ``label or
    tag`` and, while recording, a record (``scan`` defaults to the
    enclosing span's)."""
    with record_function(label or tag):
        if not enabled:
            yield
            return
        rec = _recording()
        t0 = time.perf_counter()
        span = rec.open(tag, scan) if rec is not None else None
        try:
            yield
        finally:
            if span is not None:
                rec.close(span)
        get(tag).add(time.perf_counter() - t0)


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
    """Per tag: calls and host times; for tags recorded, also their own
    host syncs and their device ms summarized so far."""
    out = {}
    for tag, s in _timers.items():
        d = {"calls": s.count, "total_s": s.total, "mean_ms": s.mean * 1e3,
             "rolling_mean_ms": s.rolling_mean * 1e3}
        if s.recorded:
            d.update(device_ms=s.device_ms, syncs=s.syncs)
        out[tag] = d
    return out
