"""glue_ms_per_frame (ms): device time outside the host copies and outside
the interior kernels (``interior_ms_per_frame``'s name prefixes): the
engines' fixups, strip glue, assembly and ``finalize``, per frame."""

from benchmark.chrome_trace import is_copy
from benchmark.metrics.interior_ms_per_frame import is_interior


def is_glue(op):
    return not is_copy(op) and not is_interior(op)


def read(run):
    t = run.trace
    if t is None or not any(is_glue(o) for o in t.device):
        return None
    return 1e3 * t.busy_s(is_glue) / t.frames
