"""Double-buffered input streaming: overlap the next batch's upload with compute.

Twin of ``tools/streaming_pipeline.py``, on the fused ``ConvApplier`` at
1920x1080 -> 3840x2160 tap 8 (``--small``: 960x540 -> 1920x1080),
``--frames`` frames a batch, ``--batches`` batches:

* serialized: upload a batch, compute, fetch a scalar of the result, one
  batch after another;
* pipelined: batch k+1 is copied with ``non_blocking`` on a side stream,
  into the other of two device buffers, while batch k computes. CUDA events
  order each compute after its copy and each copy after the compute that
  last read its buffer; the only host wait is for the previous batch's
  scalar. The buffers are allocated once, so no allocation waits on a
  stream inside the loop.

Both loops upload from the same pinned host buffers, so their ratio, the
overlap factor, measures overlap alone. The serialized time from pageable
host arrays (what ``JincResizer`` does) is printed on an earlier stderr
line. The two loops' sums must agree. On ``--device cpu`` nothing is
pinned and nothing overlaps.

Prints as its last line ``{"metric": "streaming_overlap_factor", "value",
"unit": "x", "vs_baseline"}``.

    python -m jincresize_tpu_torch.tools.streaming_pipeline [--frames 16] [--batches 8] [--small]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..apply_conv import ConvApplier
from ..operator import build_plane_operator, radius_for_tap
from ._timing import add_device_arg, open_device


def main(argv=None, size=None) -> dict:
    """Run both loops; returns the JSON object it prints last."""
    ap = argparse.ArgumentParser(prog="python -m jincresize_tpu_torch.tools.streaming_pipeline")
    ap.add_argument("--frames", type=int, default=16, help="frames per batch")
    ap.add_argument("--batches", type=int, default=8)
    ap.add_argument("--small", action="store_true")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device, card = open_device(args)
    cuda = device.type == "cuda"
    sw, sh, dw, dh = size or ((960, 540, 1920, 1080) if args.small else (1920, 1080, 3840, 2160))
    app = ConvApplier(build_plane_operator(sw, sh, dw, dh, radius_for_tap(8)), device=device)
    print(f"# engine: fused {sw}x{sh} -> {dw}x{dh} [{card}]", file=sys.stderr)

    rng = np.random.default_rng(0)
    host = [rng.random((args.frames, sh, sw), dtype=np.float32) for _ in range(args.batches)]
    staged = [torch.from_numpy(b) for b in host]
    if cuda:
        staged = [b.pin_memory() for b in staged]

    def force(x) -> float:
        return float(x.sum())

    force(app(staged[0].to(device)))  # warm-up: builds and loads the kernels

    def serialized(batches) -> tuple[float, float]:
        t0 = time.perf_counter()
        acc = sum(force(app(torch.as_tensor(b).to(device))) for b in batches)
        return time.perf_counter() - t0, acc

    t_pageable, _ = serialized(host)
    t_serial, acc = serialized(staged)

    side = torch.cuda.Stream(device) if cuda else None
    bufs = [torch.empty(staged[0].shape, dtype=torch.float32, device=device) for _ in range(2)]
    read = [None, None]  # event after the last compute that read each buffer

    def upload(k):
        """(buffer, event after its copy) of batch k."""
        buf = bufs[k % 2]
        if not cuda:
            return buf.copy_(staged[k]), None
        with torch.cuda.stream(side):
            if read[k % 2] is not None:
                side.wait_event(read[k % 2])
            buf.copy_(staged[k], non_blocking=True)
            done = torch.cuda.Event()
            done.record(side)
        return buf, done

    t0 = time.perf_counter()
    acc2 = 0.0
    cur, done = upload(0)
    pending = None
    for k in range(args.batches):
        if cuda:
            torch.cuda.current_stream(device).wait_event(done)
        out = app(cur).sum()  # queued; the host goes on
        if cuda:
            read[k % 2] = torch.cuda.Event()
            read[k % 2].record()
        if k + 1 < args.batches:
            cur, done = upload(k + 1)  # overlaps batch k's compute
        if pending is not None:
            acc2 += float(pending)
        pending = out
    acc2 += float(pending)
    t_pipe = time.perf_counter() - t0
    if abs(acc - acc2) >= 1e-3 * max(1.0, abs(acc)):
        raise AssertionError(f"pipelined sum {acc2} != serialized sum {acc}")

    px = dw * dh * args.frames * args.batches
    print(f"# serialized from pageable host arrays: {t_pageable:.3f}s "
          f"({px / t_pageable / 1e9:.2f} Gpx/s) [{card}]", file=sys.stderr)
    print(f"# serialized: {t_serial:.3f}s ({px / t_serial / 1e9:.2f} Gpx/s) | "
          f"pipelined: {t_pipe:.3f}s ({px / t_pipe / 1e9:.2f} Gpx/s) | "
          f"overlap factor {t_serial / t_pipe:.2f}x [{card}]", file=sys.stderr)
    res = {"metric": "streaming_overlap_factor", "value": t_serial / t_pipe, "unit": "x",
           "vs_baseline": t_serial / t_pipe}  # fmt: skip
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
