"""gather_roofline (%): the least time an H100 could take for a frame's
gather work, over the device time of the gather kernels a frame took.

The least time is the larger of 2 x fs**2 an interior pixel of every plane at
989 TFLOP/s, and each source plane read once plus each interior written once
as float32 at 3.35 TB/s (``benchmark/gather_work.py``). The kernels are those
named ``gather_*`` (``interior_ms_per_frame``'s prefix for them). None where
no such kernel ran.
"""

import sys

from benchmark import gather_work
from benchmark.chrome_trace import bare_name


def is_gather(op):
    return op.cat == "kernel" and bare_name(op.name).startswith("gather_")


def read(run):
    t = run.trace
    if t is None or not any(is_gather(o) for o in t.device):
        return None
    spent = t.busy_s(is_gather) / t.frames
    least, by = gather_work.least_s(run.config)
    print(f"gather_roofline: least {least * 1e6:.3f} us a frame ({by}) over "
          f"{spent * 1e6:.3f} us of gather kernels", file=sys.stderr)  # fmt: skip
    return 100.0 * least / spent
