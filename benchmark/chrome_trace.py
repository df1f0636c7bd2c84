"""Read a ``torch.profiler`` Chrome trace of the traced calls of a window.

The harness marks each traced call with a ``record_function`` span named
``SPAN``; the traced window runs from the first such span's start to the
last one's end, on the trace's own clock, so host gaps between calls count.
Device work is every complete event of a kernel, copy or memset category.
Busy time is the union of device intervals, never their sum: a copy that
overlaps a kernel is counted once, so the idle share cannot fall below 0.
"""

from __future__ import annotations

import bisect
import json
import re
from collections import defaultdict
from dataclasses import dataclass

SPAN = "bench.call"
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


def union_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def gaps(intervals, t0: float, t1: float) -> list[tuple[float, float]]:
    """The stretches of [t0, t1] that no interval covers."""
    out, at = [], t0
    for a, b in sorted(intervals):
        if a > at:
            out.append((at, min(a, t1)))
        at = max(at, b)
        if at >= t1:
            break
    if at < t1:
        out.append((at, t1))
    return [(a, b) for a, b in out if b > a]


NOISE = ("(anonymous namespace)::", "at::native::", "void ")


def short_name(name: str, width: int = 120) -> str:
    """A device operation's name without the namespaces and return type
    that make every templated kernel's name alike, cut to ``width``."""
    for n in NOISE:
        name = name.replace(n, "")
    return name[:width]


def bare_name(name: str) -> str:
    """A kernel's function name without its return type, namespaces,
    template arguments and parameters: ``void (anonymous
    namespace)::fused_ws3_kernel<4, 4, true>((anonymous
    namespace)::FusedWsArgs)`` -> ``fused_ws3_kernel``."""
    head = re.split(r"[<(]", short_name(name, len(name)), maxsplit=1)[0].strip()
    return head.split()[-1].split("::")[-1] if head else name


@dataclass(frozen=True)
class Op:
    name: str
    cat: str
    start: float  # us
    end: float  # us


def is_copy(op: Op) -> bool:
    """A copy between host and device (not device to device)."""
    return op.cat == "gpu_memcpy" and ("HtoD" in op.name or "DtoH" in op.name)


class Trace:
    """The device and host events of the traced calls, and the frames they
    returned."""

    def __init__(self, events: list[dict], frames: int):
        spans = [
            e for e in events
            if e.get("ph") == "X" and e.get("name") == SPAN and e.get("cat") == "user_annotation"
        ]  # fmt: skip
        if not spans:
            raise ValueError(f"trace holds no {SPAN!r} span")
        self.t0 = min(float(e["ts"]) for e in spans)
        self.t1 = max(float(e["ts"]) + float(e["dur"]) for e in spans)
        self.calls = len(spans)
        self.frames = frames
        self.device: list[Op] = []
        self.host: list[Op] = []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            a = float(e["ts"])
            b = a + float(e["dur"])
            a, b = max(a, self.t0), min(b, self.t1)
            if b <= a and not (b == a and e.get("cat") in DEVICE_CATEGORIES):
                continue
            if e.get("cat") in DEVICE_CATEGORIES:
                self.device.append(Op(e["name"], e["cat"], a, b))
            elif e.get("cat") in HOST_CATEGORIES:
                self.host.append(Op(e["name"], e["cat"], a, b))
        self.host.sort(key=lambda o: o.start)
        self._host_starts = [o.start for o in self.host]

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def busy_s(self, keep=lambda op: True) -> float:
        """Seconds of the union of the device operations ``keep`` accepts."""
        return union_us((o.start, o.end) for o in self.device if keep(o)) / 1e6

    def device_ops(self, top: int = 10) -> list[list]:
        """[short name, seconds] of the device operations that took most
        time, summed by ``short_name``."""
        acc: dict[str, float] = defaultdict(float)
        for o in self.device:
            acc[short_name(o.name)] += (o.end - o.start) / 1e6
        return [[k, v] for k, v in sorted(acc.items(), key=lambda kv: -kv[1])[:top]]

    def host_at(self, t: float) -> str:
        """What the host was doing at ``t``: the innermost host event that
        covers it (of nested events, the one that started last), or
        'between calls'."""
        for i in range(bisect.bisect_right(self._host_starts, t) - 1, -1, -1):
            o = self.host[i]
            if o.end >= t:
                if o.name == SPAN:
                    return "host code in a call outside torch ops"
                return o.name
        return "between calls"

    def idle_gaps(self, top: int = 10) -> list[list]:
        """[what the host was doing, seconds] over the device's idle gaps in
        the traced window, summed by what the host was doing at each gap's
        middle, the most idle time first."""
        acc: dict[str, float] = defaultdict(float)
        busy = [(o.start, o.end) for o in self.device]
        for a, b in gaps(busy, self.t0, self.t1):
            acc[self.host_at((a + b) / 2)] += (b - a) / 1e6
        return [[k, v] for k, v in sorted(acc.items(), key=lambda kv: -kv[1])[:top]]


def load(path, frames: int) -> Trace:
    with open(path) as f:
        return Trace(json.load(f)["traceEvents"], frames)
