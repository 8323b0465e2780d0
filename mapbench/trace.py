"""The traced sub-window: torch.profiler over a few scans, read back from
its Chrome trace (written under TMPDIR and deleted once read).

Spans are the program's own (``insert_pointcloud``'s
``integrate_<method>``, among others) and one of the benchmark's,
``mapbench.window`` around the traced scans.
"""

from __future__ import annotations

import json
import os
import tempfile

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

BUSY_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "user_annotation")
GAPS_LABELLED = 400


class Tracer:
    def __init__(self, device):
        self.device = device
        self._prof = None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self):
        self._sync()
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.start()
        self._span = record_function("mapbench.window")
        self._span.__enter__()

    def stop(self, scans, host_syncs):
        self._sync()
        self._span.__exit__(None, None, None)
        self._prof.stop()
        path = os.path.join(tempfile.gettempdir(), "mapbench_trace.json")
        self._prof.export_chrome_trace(path)
        self._prof = None
        try:
            with open(path) as f:
                ev = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        self._read(ev)
        self.scans = scans
        self.host_syncs = host_syncs

    def _read(self, ev):
        win = [e for e in ev if e.get("cat") == "user_annotation"
               and e.get("name") == "mapbench.window"]
        w0 = float(win[0]["ts"])
        w1 = w0 + float(win[0]["dur"])
        busy = [e for e in ev if e.get("cat") in BUSY_CATS
                and w0 <= float(e["ts"]) <= w1]
        busy.sort(key=lambda e: float(e["ts"]))
        self.window = (w0, w1)
        self.kernels = [e for e in busy if e["cat"] == "kernel"]
        ks = np.array([float(e["ts"]) for e in self.kernels])
        kd = np.array([float(e["dur"]) for e in self.kernels])
        cum = np.concatenate([[0.0], np.cumsum(kd)])
        spans = {}
        for e in ev:
            if e.get("cat") != "gpu_user_annotation":
                continue
            a = float(e["ts"])
            b = a + float(e["dur"])
            i0 = np.searchsorted(ks, a, "left")
            i1 = np.searchsorted(ks, b, "right")
            us = float(cum[i1] - cum[i0])
            spans[e["name"]] = spans.get(e["name"], 0.0) + us
        self.span_us = spans
        # Union of the busy intervals inside the window.
        merged = []
        for e in busy:
            a = float(e["ts"])
            b = min(a + float(e["dur"]), w1)
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        self.busy_us = sum(b - a for a, b in merged)
        edges = [w0] + [x for ab in merged for x in ab] + [w1]
        gaps = [(edges[i], edges[i + 1] - edges[i])
                for i in range(0, len(edges) - 1, 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: -g[1])
        host = [e for e in ev if e.get("cat") in HOST_CATS
                and "dur" in e and e.get("name") != "mapbench.window"]
        hs = np.array([float(e["ts"]) for e in host])
        he = hs + np.array([float(e["dur"]) for e in host])
        hd = he - hs
        is_span = np.array([e["cat"] == "user_annotation" for e in host])
        by_label = {}
        for g, length in gaps[:GAPS_LABELLED]:
            inside = (hs <= g) & (he >= g)
            label = []
            for pick in (inside & is_span, inside & ~is_span):
                idx = np.nonzero(pick)[0]
                if len(idx):
                    label.append(host[idx[np.argmin(hd[idx])]]["name"])
            key = " > ".join(label) or "(host outside any recorded call)"
            by_label[key] = by_label.get(key, 0.0) + length
        self.idle_by_label = sorted(by_label.items(), key=lambda kv: -kv[1])
        ops = {}
        for e in busy:
            ops[e["name"]] = ops.get(e["name"], 0.0) + float(e["dur"])
        self.top_ops = sorted(ops.items(), key=lambda kv: -kv[1])

    def context(self):
        """What the per-layer metric readers read."""
        return dict(scans=self.scans, launches=len(self.kernels),
                    span_us=self.span_us, host_syncs=self.host_syncs,
                    busy_s=self.busy_us / 1e6,
                    window_s=(self.window[1] - self.window[0]) / 1e6)

    def breakdown(self):
        return {"device_ops": [[n[:200], us / 1e6]
                               for n, us in self.top_ops[:10]],
                "idle_gaps": [[n[:200], us / 1e6]
                              for n, us in self.idle_by_label[:10]]}
