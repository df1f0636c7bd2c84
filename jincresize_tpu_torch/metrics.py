"""Observability: spans, counters, device traces, operator stats.

``span(name)`` marks one step of a call (``jinc.call``, ``jinc.plane.<name>``,
``jinc.upload``, ``jinc.engine``, ``jinc.interior``, ...) as a
``torch.profiler.record_function`` event while a profiler records, so the
steps land in the same trace as the device work, on its clock. With no
profiler recording a span costs one flag check: it dispatches no op and
allocates nothing.

``count(name, value)`` adds to a process-wide record, which ``counters()``
returns a copy of. It is always on and only grows. Its keys are fixed. What
set-up costs: ``operator_s`` (host seconds in ``JincResizer.__init__``
building or loading the plane operators and their LUT), ``engine_s`` (host
seconds in ``JincResizer._init_engines``: engine selection, the appliers'
tables, weight splits and uploads), ``operator_cache_loads`` and
``operator_cache_builds`` (entries ``cache.cached_build`` loaded or built).
What the calls' exception-line fixups (``kernels.lines.exc_lines``) do:
``exception_launches`` (launches of the kernel on the card, one a plane
call that has exception lines; its plain form on the CPU launches nothing)
and ``exception_lines`` (the exception columns and rows computed, by either
form). What the gather engine does: ``gather_launches`` (launches of
either gather interior kernel, ``kernels.gather.gather_interior_tile`` or
``gather_interior_grouped``, on the card, one a plane call; its plain form
on the CPU launches nothing) and ``gather_grouped_launches`` (those of them
that ran the class-grouped kernel, after each such launch). What the gather
and fused-seg engines' border strips do: ``strips_band_launches`` (launches
of ``kernels.band_strips.band_strips`` on the card, one a plane call,
counted after each; its plain form on the CPU launches nothing). What the
fused-seg engine does: ``seg_launches`` (launches of the seg interior kernel,
``kernels.seg.seg_interior``, on the card in any mode, one a plane call,
counted after each; its plain form on the CPU launches nothing). What the
engines hold: ``engine_bytes`` (bytes of the device tables that each
``JincResizer._init_engines`` left in its appliers and device operators --
dictionaries, padded blocks, weight splits, strip blocks, index tables --
as ``held_bytes`` counts them).

``device_trace`` is a ``torch.profiler`` scope that records CPU activity, and
CUDA activity when a card is visible, and writes a Chrome trace into
``logdir`` (open it in ``chrome://tracing`` or Perfetto); ``device_time_by_op``
and ``device_busy`` read that trace's device time. ``log_operator_stats`` is
a copy of the JAX package's (``jincresize_tpu/metrics.py``). Everything logs
to the ``jincresize_tpu_torch`` logger.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os

import torch

logger = logging.getLogger("jincresize_tpu_torch")

_profiling = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()


def span(name: str):
    """Context manager: a ``record_function(name)`` event while a profiler
    records, else a shared no-op."""
    if _profiling():
        return torch.profiler.record_function(name)
    return _OFF


_COUNTERS = {
    "operator_s": 0.0,
    "engine_s": 0.0,
    "operator_cache_loads": 0,
    "operator_cache_builds": 0,
    "exception_launches": 0,
    "exception_lines": 0,
    "gather_launches": 0,
    "gather_grouped_launches": 0,
    "strips_band_launches": 0,
    "seg_launches": 0,
    "engine_bytes": 0,
}


def count(name: str, value=1) -> None:
    """Add ``value`` to the counter ``name`` (one of ``counters()``'s keys)."""
    _COUNTERS[name] += value


def counters() -> dict:
    """A copy of the process-wide counters."""
    return dict(_COUNTERS)


def held_bytes(*objs) -> int:
    """Bytes of the tensor storages reachable from ``objs`` through dataclass
    fields and the attributes of the port's own objects, dicts, lists and
    tuples: the tables an applier or a device operator holds. A storage
    that several tensors view counts once, at its whole size."""
    storages, seen, todo = {}, set(), list(objs)
    while todo:
        o = todo.pop()
        if isinstance(o, torch.Tensor):
            s = o.untyped_storage()
            storages[(str(o.device), s.data_ptr())] = s.nbytes()
        elif id(o) in seen or o is None:
            continue
        elif isinstance(o, dict):
            seen.add(id(o))
            todo.extend(o.values())
        elif isinstance(o, (list, tuple)):
            seen.add(id(o))
            todo.extend(o)
        elif type(o).__module__.split(".")[0] == __package__ and hasattr(o, "__dict__"):
            seen.add(id(o))
            todo.extend(vars(o).values())
    return sum(storages.values())


def log_operator_stats(op, label: str = "operator") -> dict:
    """Log (and return) the operator statistics dict."""
    st = op.stats()
    logger.info("%s stats: %s", label, json.dumps(st))
    return st


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
    trace: the length of the union of their intervals, so a copy that
    overlaps a kernel counts once, and the time from the first one's start
    to the last one's end. ``1 - busy / span`` is the device's idle share
    over the span, never below 0; (0, 0) without CUDA activity."""
    events = _device_events(trace_path)
    if not events:
        return 0.0, 0.0
    busy, reach = 0.0, float("-inf")
    for a, b in sorted((e["ts"], e["ts"] + e["dur"]) for e in events):
        if b > reach:
            busy += b - max(a, reach)
            reach = b
    extent = max(e["ts"] + e["dur"] for e in events) - min(e["ts"] for e in events)
    return busy / 1e3, extent / 1e3
