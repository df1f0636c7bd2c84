"""The program's own spans in a traced run: the ``jinc.*`` events that
``jincresize_tpu_torch.metrics.span`` records as ``record_function`` spans
(``user_annotation`` in the Chrome trace), read from ``Trace.host`` on the
trace's own clock. A program without them (one older than its spans) gives
no interval, and each reader then reads nothing.
"""

from __future__ import annotations

import bisect

from benchmark.chrome_trace import union_us

# Host calls that put work on the device: kernel launches, copies, memsets.
LAUNCH_PREFIXES = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cudaMemset")
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")


def intervals(trace, names) -> list[tuple[float, float]]:
    """(start, end) of every span of the traced window named in ``names``."""
    return [(o.start, o.end) for o in trace.host if o.cat == "user_annotation" and o.name in names]


def ms_per_frame(run, names) -> float | None:
    """Host milliseconds a frame under the union of the spans ``names``."""
    t = run.trace
    spans = [] if t is None else intervals(t, names)
    if not spans:
        return None
    return union_us(spans) / 1e3 / t.frames


def launches_per_frame_in(run, names) -> float | None:
    """Launch, copy and memset calls whose start lies in a span of
    ``names``, per frame."""
    t = run.trace
    spans = [] if t is None else sorted(intervals(t, names))
    if not spans:
        return None
    merged = [list(spans[0])]
    for a, b in spans[1:]:
        if a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    starts = [a for a, _ in merged]
    n = 0
    for o in t.host:
        if o.cat in LAUNCH_CATEGORIES and o.name.startswith(LAUNCH_PREFIXES):
            i = bisect.bisect_right(starts, o.start) - 1
            n += i >= 0 and o.start <= merged[i][1]
    return n / t.frames
