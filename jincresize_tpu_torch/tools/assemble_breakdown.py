"""Where a ``ConvApplier`` call's time goes at 4K->8K tap 8.

Twin of ``tools/profiling/assemble_breakdown.py``: cumulative steps on
an 8-frame fp32 3840x2160 -> 7680x4320 batch, each timed as ``--reps``
back-to-back calls between CUDA events:

* ``interior only`` -- ``kernels.fused.fused_interior``;
* ``interior+paste`` -- and its paste into a zero canvas;
* ``interior+paste+strips`` -- and the border strips (``_strips``), with
  exception fixups, in ``canvas.Canvas``'s paste form;
* ``interior+concat+strips`` -- the same in its one-concatenate form, where
  the plane's strips frame the interior;
* ``full`` -- ``ConvApplier.__call__`` (the form its canvas chose, and
  ``finalize``).

    python -m jincresize_tpu_torch.tools.assemble_breakdown [--frames 8] [--reps 10]
"""

from __future__ import annotations

import argparse
import sys
from dataclasses import replace

import numpy as np
import torch

from ..apply_conv import ConvApplier
from ..kernels import fused as fused_k
from ..kernels import lines as lines_k
from ..operator import build_plane_operator, radius_for_tap
from ..phase import plan_phases
from ._timing import add_device_arg, calls_ms, open_device

SIZE = (3840, 2160, 7680, 4320)


def main(argv=None, size=None) -> dict:
    """Print one line a step; returns {step: ms per call}."""
    ap = argparse.ArgumentParser(prog="python -m jincresize_tpu_torch.tools.assemble_breakdown")
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--reps", type=int, default=10, help="back-to-back calls per timing")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device, card = open_device(args)
    sw, sh, dw, dh = size or SIZE
    F = args.frames
    op = build_plane_operator(sw, sh, dw, dh, radius_for_tap(8))
    plan = plan_phases(op)
    app = ConvApplier(op, plan=plan, device=device)
    exc = (plan.x.exceptions, plan.y.exceptions)
    print(f"# exc_x: {exc[0].shape} exc_y: {exc[1].shape}", file=sys.stderr)
    print(f"# strips: {[(s.y0, s.y1, s.x0, s.x1) for s in op.strips]}", file=sys.stderr)
    # The paste form, its lines over the whole canvas.
    paste_canvas = replace(app.canvas, concat=False, lines=lines_k.make_lines(app._dop, *exc))
    src = torch.from_numpy(np.random.default_rng(0).random((F, sh, sw), dtype=np.float32))
    src = src.to(device)
    ylo, yhi, xlo, xhi = app.canvas.rect

    def paste():
        canvas = torch.zeros((F, dh, dw), dtype=torch.float32, device=device)
        canvas[:, ylo:yhi, xlo:xhi] = fused_k.fused_interior(app.fi, src)
        return canvas

    def assembled(canvas):
        return lambda: canvas.assemble(fused_k.fused_interior(app.fi, src), app._strips(src), src)

    steps = {
        "interior only": lambda: fused_k.fused_interior(app.fi, src),
        "interior+paste": paste,
        "interior+paste+strips": assembled(paste_canvas),
    }
    if app.canvas.concat:
        steps["interior+concat+strips"] = assembled(app.canvas)
    steps["full (=+exceptions+finalize)"] = lambda: app(src)
    res = {}
    for name, fn in steps.items():
        res[name] = calls_ms(fn, device, args.reps)
        print(f"{name:40s} {res[name] / F:7.3f} ms/frame  [{card}]")
    return res


if __name__ == "__main__":
    main()
