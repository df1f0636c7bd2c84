"""Time the u8 weight-split kernels (``precision='wsplit3'``) on the main path's planes.

Each plane runs an 8-frame u8 luma batch (integers 0..255 held as float32,
from ``--seed``) through the fused or seg kernel in the wsplit3 mode, checked
against the fp32 plain form within ``kernels.fused.wsplit3_bound``, and is
timed beside the fp32 and bf16 kernels on the same batch. Each fused plane
is timed a second time in the other form of the kernel: with its weight rows
unpadded where its layout pads them for ``wgmma`` (``Ws3Layout.wgmma``), the
products then all ``mma.sync`` with B from ``ldmatrix`` (``wsplit3/mma.sync``),
else padded (``wsplit3/wgmma``), so that the two forms compare on one card in
one run. Times are CUDA-event medians of ``--rounds`` turns of ``--reps``
back-to-back calls, the forms in one order and then the other. Card only.

    python -m jincresize_tpu_torch.tools.u8_kernel_timing [--planes all] [--reps 10] [--rounds 2]

Prints one line a plane and, last, one JSON object: {plane: {form: ms/frame},
..., "card": "<name>, <power limit>"}.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics

import numpy as np
import torch

from ..kernels import fused, seg
from ..operator import build_plane_operator, radius_for_tap
from ..phase import plan_phases, plan_phases_seg
from ._timing import add_device_arg, calls_ms, open_device

# name -> (kernel, src_w, src_h, dst_w, dst_h, tap)
PLANES = {
    "fused 4K->8K tap8": ("fused", 3840, 2160, 7680, 4320, 8),
    "fused 4K->1080p tap16": ("fused", 3840, 2160, 1920, 1080, 16),
    "fused 4K->1440p tap16": ("fused", 3840, 2160, 2560, 1440, 16),
    "seg 1440p->4K tap8": ("seg", 2560, 1440, 3840, 2160, 8),
    "seg 1440p->1080p tap16": ("seg", 2560, 1440, 1920, 1080, 16),
}


def relaid(fi: fused.FusedInterior, pad: bool) -> fused.FusedInterior:
    """``fi`` with its weight rows laid out with the ``wgmma`` padding or
    without it (then the kernel runs its products as ``mma.sync``)."""
    nph, kh, kw = fi.kernels.shape
    geo = (fi.py, fi.px, fi.qy, fi.qx, kh, kw)
    lay = fused.ws3_layout(*geo, fi.shape, fi.g, last1=fi.ws3.last1, pad=pad)
    K = fi.kernels.cpu().numpy()
    w = fused.ws3_weights(fused.split_bf16x3(K), lay, fi.qy)
    wtc = torch.from_numpy(w).to(torch.bfloat16).to(fi.wtc.device)
    return dataclasses.replace(fi, ws3=lay, wtc=wtc)


def bound(tables, src: torch.Tensor) -> float:
    """``wsplit3_bound`` of ``tables`` (the fp32 mode's) on ``src``."""
    if isinstance(tables, fused.FusedInterior):
        _, kh, kw = tables.kernels.shape
        n, w = kh * kw, tables.kernels.abs().sum((1, 2)).max()
    else:
        n, w = tables.fs**2, tables.blocks.abs().sum((2, 3)).max()
    return fused.wsplit3_bound(n, float(w), float(src.abs().max()))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m jincresize_tpu_torch.tools.u8_kernel_timing")
    ap.add_argument("--planes", choices=[*PLANES, "fused", "seg", "all"], default="all")
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--reps", type=int, default=10, help="back-to-back calls per timing")
    ap.add_argument("--rounds", type=int, default=2, help="turns over the forms, each order")
    ap.add_argument("--seed", type=int, default=0)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device, card = open_device(args)
    names = [n for n in PLANES if args.planes in ("all", n, PLANES[n][0])]
    rng = np.random.default_rng(args.seed)
    res = {}
    for name in names:
        kind, sw, sh, dw, dh, tap = PLANES[name]
        op = build_plane_operator(sw, sh, dw, dh, radius_for_tap(tap))
        if kind == "fused":
            plan, make, run = plan_phases(op), fused.make_fused_interior, fused.fused_interior
            plain = fused.fused_interior_plain
        else:
            plan, make, run = plan_phases_seg(op), seg.make_seg_interior, seg.seg_interior
            plain = seg.seg_interior_plain
        t = {m: make(op, plan, device, m) for m in ("wsplit3", "fp32", "bf16")}
        forms = {"wsplit3": t["wsplit3"]}
        if kind == "fused":
            wg = t["wsplit3"].ws3.wgmma
            other = relaid(t["wsplit3"], not wg)
            if other.layout().smem_bytes <= fused.MAX_SMEM_BYTES:
                forms["wsplit3/" + ("mma.sync" if wg else "wgmma")] = other
        forms.update(fp32=t["fp32"], bf16=t["bf16"])
        shape = (args.frames, op.src_height, op.src_width)
        src = torch.from_numpy(rng.integers(0, 256, shape).astype(np.float32)).to(device)
        ref = plain(t["fp32"], src)
        wb = bound(t["fp32"], src)
        errs = {}
        for m in forms:
            if m.startswith("wsplit3"):
                errs[m] = float((run(forms[m], src) - ref).abs().max())
                assert errs[m] <= wb, (name, m, errs[m], wb)
        del ref
        times = {m: [] for m in forms}
        order = list(forms)
        for _ in range(args.rounds):
            for seq in (order, order[::-1]):
                for m in seq:
                    times[m].append(calls_ms(lambda m=m: run(forms[m], src), device, args.reps))
        ms = {m: statistics.median(v) / args.frames for m, v in times.items()}
        res[name] = ms
        print(f"{name}: " + ", ".join(f"{m} {v:.4f}" for m, v in ms.items())
              + " ms/frame; max |err| vs the fp32 plain form "
              + ", ".join(f"{m} {e:.3g}" for m, e in errs.items())
              + f" (wsplit3_bound {wb:.3g}) [{card}]")  # fmt: skip
        del src, t, forms
    res["card"] = card
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
