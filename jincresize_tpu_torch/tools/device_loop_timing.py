"""Separate per-launch overhead from device compute at 4K->8K tap 8.

Twin of ``tools/profiling/device_loop_timing.py``: four rows on an 8-frame
fp32 3840x2160 -> 7680x4320 batch, each timed as ``--reps`` back-to-back
calls between CUDA events:

1. ``torch.zeros`` of the (F, 4320, 7680) output (a memset);
2. the ``out_only`` probe kernel (``csrc/out_only.cu``) over (48, 256) tiles,
   2700 blocks a frame, writing the same zeros;
3. the fused interior kernel (``kernels/fused.py``);
4. the full ``ConvApplier`` call (interior, strips, assembly, finalize).

The probe and the fused interior are also timed as one replay of a CUDA
graph that captures the same calls: the port's twin of the TPU tool's
on-device ``fori_loop``. The gap between the eager and the graph time is
what the host costs per launch.

    python -m jincresize_tpu_torch.tools.device_loop_timing [--frames 8] [--reps 10]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..apply_conv import ConvApplier
from ..kernels import fused as fused_k
from ..kernels import probe
from ..operator import build_plane_operator, radius_for_tap
from ._timing import add_device_arg, calls_ms, graph_ms, open_device

SIZE = (3840, 2160, 7680, 4320)


def main(argv=None, size=None) -> dict:
    """Print the four rows; returns {row: ms per call} plus the graph times
    (``None`` on the CPU) and the probe's grid."""
    ap = argparse.ArgumentParser(prog="python -m jincresize_tpu_torch.tools.device_loop_timing")
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--reps", type=int, default=10, help="back-to-back calls per timing")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device, card = open_device(args)
    sw, sh, dw, dh = size or SIZE
    F, R = args.frames, args.reps
    src = torch.from_numpy(np.random.default_rng(0).random((F, sh, sw), dtype=np.float32))
    src = src.to(device)
    app = ConvApplier(build_plane_operator(sw, sh, dw, dh, radius_for_tap(8)), device=device)
    buf = torch.empty((F, dh, dw), dtype=torch.float32, device=device)
    th, tw = probe.TILE
    grid = -(-dh // th) * -(-dw // tw)
    rows = {
        "zeros": (f"torch.zeros {F}x{dh}x{dw}", lambda: torch.zeros((F, dh, dw), device=device)),
        "out_only": (f"out_only {th}x{tw} g={grid}", lambda: probe.out_only(buf)),
        "fused": ("fused interior", lambda: fused_k.fused_interior(app.fi, src)),
        "full": ("full ConvApplier call", lambda: app(src)),
    }
    res = {"frames": F, "reps": R, "grid_per_frame": grid, "device": card}
    graphs = {}
    if device.type == "cuda":
        for key in ("out_only", "fused"):
            graphs[key] = graph_ms(rows[key][1], R)
    for key, (name, fn) in rows.items():
        ms = calls_ms(fn, device, R)
        res[f"{key}_ms"] = ms
        line = f"{name:40s} {ms / F:8.4f} ms/frame ({R} back-to-back calls, {ms:.4f} ms/call)"
        if key in graphs:
            g = graphs[key]
            line += f"; one graph replay {g / F:.4f} ms/frame, host {ms - g:+.4f} ms/call"
        print(line)
    for key in ("out_only", "fused"):
        res[f"{key}_graph_ms"] = graphs.get(key)
    return res


if __name__ == "__main__":
    main()
