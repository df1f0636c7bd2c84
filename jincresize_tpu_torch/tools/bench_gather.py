"""Device benchmark of the general-geometry engines on crop-0.3 geometries.

Twin of ``tools/bench_gather.py``, with its flags:

* ``--geometry 2x`` (1920x1080 -> 3840x2160, periodic: ``--impl gather``
  forces the general kernel onto it), ``1.5x`` (1920x1080 -> 2880x1620,
  quasi-periodic under float32 positions) or ``4k`` (2560x1440 ->
  3840x2160, drifted 1.5x at 4K output); every geometry is cropped by 0.3
  pixels at the left and top, so float32 position drift fragments the
  class dictionary;
* ``--impl gather|xla|auto|seg``: the engine, as ``api._select_engine``
  builds it (``auto`` is its rule on the device);
* ``--u8``: u8-valued sources and ``precision='fp32_u8src'``;
* ``--check``: frame 0 in u8 within 1 LSB of ``golden.apply_plane_numpy``;
* ``--pos-precision f64``: drift-free positions (the 1.5x geometries plan
  exactly periodic);
* ``--frames`` (default 8), ``--iters`` (default 4) CUDA-event windows of 4
  back-to-back calls.

Prints ``impl=... frames=...: X ms/frame (Y Gpx/s device)`` on stdout.

    python -m jincresize_tpu_torch.tools.bench_gather [--geometry 4k] [--impl seg] [--check]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..apply_xla import finalize
from ..bench import make_engine
from ..golden import apply_plane_numpy
from ..operator import build_plane_operator, radius_for_tap
from ..phase import plan_phases
from ._timing import add_device_arg, calls_ms, open_device

GEOMETRIES = {
    "2x": (1920, 1080, 3840, 2160),
    "1.5x": (1920, 1080, 2880, 1620),
    "4k": (2560, 1440, 3840, 2160),
}
R = 4  # calls per CUDA-event window


def main(argv=None, size=None) -> dict:
    """Run the benchmark; returns the measured numbers and the engine."""
    ap = argparse.ArgumentParser(prog="python -m jincresize_tpu_torch.tools.bench_gather")
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--impl", default="gather", choices=["gather", "xla", "auto", "seg"])
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--geometry", default="2x", choices=list(GEOMETRIES))
    ap.add_argument("--pos-precision", default="f32", choices=["f32", "f64"])
    ap.add_argument("--check", action="store_true",
                    help="frame 0 in u8 against the host golden (<= 1 LSB)")
    ap.add_argument("--u8", action="store_true",
                    help="u8-valued sources and precision='fp32_u8src'")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device, card = open_device(args)
    sw, sh, dw, dh = size or GEOMETRIES[args.geometry]

    t0 = time.perf_counter()
    op = build_plane_operator(
        sw, sh, dw, dh, radius_for_tap(8), crop_left=0.3, crop_top=0.3,
        pos_precision=None if args.pos_precision == "f32" else args.pos_precision,
    )  # fmt: skip
    print(f"# built in {time.perf_counter() - t0:.1f}s: {op.stats()} "
          f"periodic={plan_phases(op) is not None}", file=sys.stderr)
    fn, engine = make_engine(op, args.impl, "fp32_u8src" if args.u8 else "fp32", device)
    print(f"# engine: {engine}", file=sys.stderr)

    rng = np.random.default_rng(0)
    shape = (args.frames, sh, sw)
    if args.u8:
        src = rng.integers(0, 256, shape).astype(np.float32)
    else:
        src = rng.random(shape, dtype=np.float32)
    src_t = torch.from_numpy(src).to(device)

    t0 = time.perf_counter()
    float(fn(src_t).sum())
    print(f"# build+first run: {time.perf_counter() - t0:.1f}s", file=sys.stderr)

    lsb = None
    if args.check:
        got = finalize(fn(src_t[:1]), np.uint8, 255.0)[0].cpu().numpy()
        ref = apply_plane_numpy(op, src[0], out_dtype=np.uint8, peak=255.0)
        lsb = int(np.abs(got.astype(int) - ref.astype(int)).max())
        print(f"# parity check vs host golden: max LSB diff = {lsb}", file=sys.stderr)
        if lsb > 1:
            raise AssertionError(f"parity violated: {lsb} LSB")

    ms = sum(calls_ms(lambda: fn(src_t), device, R) for _ in range(args.iters)) / args.iters
    dt = ms / 1e3 / args.frames
    print(f"impl={args.impl} frames={args.frames}: {dt * 1e3:.4f} ms/frame "
          f"({dw * dh / dt / 1e9:.2f} Gpx/s device)")
    return {"impl": args.impl, "engine": engine, "frames": args.frames,
            "ms_per_frame": dt * 1e3, "gpx_per_s": dw * dh / dt / 1e9,
            "check_lsb": lsb, "device": card}  # fmt: skip


if __name__ == "__main__":
    main()
