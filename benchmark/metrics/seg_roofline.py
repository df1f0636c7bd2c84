"""seg_roofline (%): the least time an H100 could take for a frame's
interior work, over the device time of the seg kernels a frame took.

The least time is ``gather_work.least_s``: the larger of 2 x fs**2 an
interior pixel of every plane at 989 TFLOP/s, and each source plane read
once plus each interior written once as float32 at 3.35 TB/s. That
interior (row and column non-border in the reference's geometry) is a
property of the deployment, whichever engine serves it. The kernels are
those named ``seg_*`` (``interior_ms_per_frame``'s prefix for them). None
where no such kernel ran.
"""

import sys

from benchmark import gather_work
from benchmark.chrome_trace import bare_name


def is_seg(op):
    return op.cat == "kernel" and bare_name(op.name).startswith("seg_")


def read(run):
    t = run.trace
    if t is None or not any(is_seg(o) for o in t.device):
        return None
    spent = t.busy_s(is_seg) / t.frames
    least, by = gather_work.least_s(run.config)
    print(f"seg_roofline: least {least * 1e6:.3f} us a frame ({by}) over "
          f"{spent * 1e6:.3f} us of seg kernels", file=sys.stderr)  # fmt: skip
    return 100.0 * least / spent
