"""Sweep the fused interior kernel's shapes at its two main geometries.

Twin of ``tools/profiling/fused_tile_sweep.py``, which varies the Pallas
kernel's row band (``tmb``) and column tile (``tnb``). On Hopper the
counterpart is the kernel's shape (threads a block, anchors a thread along
x, accumulator rows a thread), compile-time constants of
``csrc/fused_interior.cu`` instantiated for ``kernels.fused.SHAPES``. Each
shape runs on the same 8-frame fp32 luma batch of 3840x2160 -> 7680x4320 tap
8 and 3840x2160 -> 1920x1080 tap 16, is checked against the default shape
(max |err| 0: the same sums in the same order) and timed as ``--reps``
back-to-back calls between CUDA events.

    python -m jincresize_tpu_torch.tools.fused_tile_sweep [--geometry all] [--frames 8] [--reps 10]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..kernels import fused as fused_k
from ..operator import build_plane_operator, radius_for_tap
from ..phase import plan_phases
from ._timing import add_device_arg, calls_ms, open_device

# name -> (src_w, src_h, dst_w, dst_h, tap)
GEOMETRIES = {
    "4k-8k": (3840, 2160, 7680, 4320, 8),
    "4k-1080p-tap16": (3840, 2160, 1920, 1080, 16),
}


def main(argv=None, size=None) -> dict:
    """Print one line a (geometry, shape); returns {"4k-8k/128t r4 cg8":
    {"ms": ms per call, "err": max |err| against the default}, ...}.
    ``size`` = (sw, sh, dw, dh) replaces every geometry's planes (tap kept)."""
    ap = argparse.ArgumentParser(prog="python -m jincresize_tpu_torch.tools.fused_tile_sweep")
    ap.add_argument("--geometry", choices=[*GEOMETRIES, "all"], default="all")
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--reps", type=int, default=10, help="back-to-back calls per timing")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device, card = open_device(args)
    F = args.frames
    names = list(GEOMETRIES) if args.geometry == "all" else [args.geometry]
    res = {}
    for geo in names:
        sw, sh, dw, dh, tap = GEOMETRIES[geo]
        if size is not None:
            sw, sh, dw, dh = size
        op = build_plane_operator(sw, sh, dw, dh, radius_for_tap(tap))
        fi = fused_k.make_fused_interior(op, plan_phases(op), device)
        rng = np.random.default_rng(0)
        src = torch.from_numpy(rng.random((F, sh, sw), dtype=np.float32)).to(device)
        ref = fused_k.fused_interior(fi, src)
        for shape in fused_k.SHAPES:
            err = float((fused_k.fused_interior(fi, src, shape) - ref).abs().max())
            ms = calls_ms(lambda: fused_k.fused_interior(fi, src, shape), device, args.reps)
            name = fused_k.shape_name(shape)
            res[f"{geo}/{name}"] = {"ms": ms, "err": err}
            tag = name + (" (default)" if shape == fused_k.DEFAULT_SHAPE else "")
            print(f"{geo} shape {tag:22s} {ms / F:7.3f} ms/frame  err={err:.1e}  [{card}]")
        del src, ref
    return res


if __name__ == "__main__":
    main()
