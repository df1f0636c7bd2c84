"""Observability: operator and throughput metrics, and device traces.

``log_operator_stats`` and ``ThroughputMeter`` are copies of the JAX
package's (``jincresize_tpu/metrics.py``), logging to the
``jincresize_tpu_torch`` logger. ``device_trace`` is the port's counterpart
of its ``jax.profiler`` scope: a ``torch.profiler`` scope that records CPU
activity, and CUDA activity when a card is visible, and writes a Chrome
trace into ``logdir`` (open it in ``chrome://tracing`` or Perfetto);
``device_time_by_op`` and ``device_busy`` read that trace's device time.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import time
from dataclasses import dataclass, field

import torch

logger = logging.getLogger("jincresize_tpu_torch")


def log_operator_stats(op, label: str = "operator") -> dict:
    """Log (and return) the operator statistics dict."""
    st = op.stats()
    logger.info("%s stats: %s", label, json.dumps(st))
    return st


@dataclass
class ThroughputMeter:
    """Accumulates frame timings and reports px/s and nnz/s."""

    dst_pixels: int
    logical_nnz: int
    times_s: list = field(default_factory=list)

    def record(self, seconds: float) -> None:
        self.times_s.append(seconds)

    @contextlib.contextmanager
    def measure(self):
        t0 = time.perf_counter()
        yield
        self.record(time.perf_counter() - t0)

    def report(self) -> dict:
        if not self.times_s:
            return {}
        best = min(self.times_s)
        rep = {
            "frames": len(self.times_s),
            "best_s": best,
            "mean_s": sum(self.times_s) / len(self.times_s),
            "px_per_s": self.dst_pixels / best,
            "nnz_per_s": self.logical_nnz / best,
        }
        logger.info("throughput: %s", json.dumps(rep))
        return rep


@contextlib.contextmanager
def device_trace(logdir: str):
    """``torch.profiler`` scope; yields the profiler (``key_averages()`` for
    sums by operation) and writes ``logdir/trace.json`` on exit."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


# Chrome-trace categories of work on the card: kernels, copies and memsets.
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def _device_events(trace_path) -> list[dict]:
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES]


def device_time_by_op(trace_path) -> dict[str, tuple[float, int]]:
    """{name: (device ms, count)} of every device operation in a Chrome trace
    written by ``device_trace``, the largest time first. Copies keep their
    profiler names (``Memcpy HtoD (Pageable -> Device)``, ...); a trace with
    no CUDA activity gives ``{}``."""
    acc: dict[str, list] = {}
    for e in _device_events(trace_path):
        a = acc.setdefault(e["name"], [0.0, 0])
        a[0] += e["dur"] / 1e3
        a[1] += 1
    return {k: (t, n) for k, (t, n) in sorted(acc.items(), key=lambda kv: -kv[1][0])}


def device_busy(trace_path) -> tuple[float, float]:
    """(busy ms, span ms) of the device operations in a ``device_trace``
    trace: their summed time, and the time from the first one's start to
    the last one's end. ``1 - busy / span`` is the device's idle share over
    the span (below 0 where copies overlap kernels); (0, 0) without CUDA
    activity."""
    events = _device_events(trace_path)
    if not events:
        return 0.0, 0.0
    busy = sum(e["dur"] for e in events)
    span = max(e["ts"] + e["dur"] for e in events) - min(e["ts"] for e in events)
    return busy / 1e3, span / 1e3
