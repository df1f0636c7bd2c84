"""interior_ms_per_frame (ms): device time of the hand-written resampling
kernels, by the function-name prefixes below (``kernels/fused.py``,
``seg.py``, ``gather.py``, ``strips.py`` -> ``csrc/*.cu``), per frame."""

from benchmark.chrome_trace import bare_name

PREFIXES = ("fused_", "seg_", "gather_", "strips")


def is_interior(op):
    return op.cat == "kernel" and bare_name(op.name).startswith(PREFIXES)


def read(run):
    t = run.trace
    if t is None or not any(is_interior(o) for o in t.device):
        return None
    return 1e3 * t.busy_s(is_interior) / t.frames
