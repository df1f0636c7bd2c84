"""resample_roofline (%): the least time an H100 could take for a frame's
resampling, over the device time a frame took outside host copies.

The least time is the larger of 2 x the nonzero weights the reference
applies over every output pixel of every plane at 989 TFLOP/s, and each
source plane read once plus each output plane written once at 3.35 TB/s
(``benchmark/work.py``). It counts the same work whatever implements it.
"""

import sys

from benchmark import work
from benchmark.chrome_trace import is_copy


def read(run):
    t = run.trace
    if t is None or not run.nnz_per_frame:
        return None
    spent = t.busy_s(lambda o: not is_copy(o)) / t.frames
    if spent <= 0:
        return None
    least, by = work.bound_s(2.0 * run.nnz_per_frame, work.frame_bytes(run.config))
    print(f"resample_roofline: least {least * 1e6:.3f} us a frame ({by}) over "
          f"{spent * 1e6:.3f} us of device time outside copies", file=sys.stderr)  # fmt: skip
    return 100.0 * least / spent
