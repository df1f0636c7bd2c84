"""Sweep the fused interior kernel's thread-block shape at 4K->8K tap 8.

Twin of ``tools/profiling/fused_tile_sweep.py``, which varies the Pallas
kernel's row band (``tmb``) and column tile (``tnb``). On Hopper the
counterpart is the kernel's (x, y) thread block, a compile-time constant of
``csrc/fused_interior.cu`` instantiated for ``kernels.fused.TILES``. Each
shape runs on the same 8-frame fp32 3840x2160 luma batch, is checked
against the default 32x8 (max |err| 0: the same sums in the same order) and
timed as ``--reps`` back-to-back calls between CUDA events.

    python -m jincresize_tpu_torch.tools.fused_tile_sweep [--frames 8] [--reps 10]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..kernels import fused as fused_k
from ..operator import build_plane_operator, radius_for_tap
from ..phase import plan_phases
from ._timing import add_device_arg, calls_ms, open_device

SIZE = (3840, 2160, 7680, 4320)


def main(argv=None, size=None) -> dict:
    """Print one line a shape; returns {"32x8": {"ms": ms per call,
    "err": max |err| against the default}, ...}."""
    ap = argparse.ArgumentParser(prog="python -m jincresize_tpu_torch.tools.fused_tile_sweep")
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--reps", type=int, default=10, help="back-to-back calls per timing")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device, card = open_device(args)
    sw, sh, dw, dh = size or SIZE
    F = args.frames
    op = build_plane_operator(sw, sh, dw, dh, radius_for_tap(8))
    fi = fused_k.make_fused_interior(op, plan_phases(op), device)
    src = torch.from_numpy(np.random.default_rng(0).random((F, sh, sw), dtype=np.float32))
    src = src.to(device)
    ref = fused_k.fused_interior(fi, src)
    res = {}
    for tile in fused_k.TILES:
        err = float((fused_k.fused_interior(fi, src, tile) - ref).abs().max())
        ms = calls_ms(lambda: fused_k.fused_interior(fi, src, tile), device, args.reps)
        name = "{}x{}".format(*tile) + (" (default)" if tile == fused_k.DEFAULT_TILE else "")
        res["{}x{}".format(*tile)] = {"ms": ms, "err": err}
        print(f"tile {name:16s} {ms / F:7.3f} ms/frame  err={err:.1e}  [{card}]")
    return res


if __name__ == "__main__":
    main()
