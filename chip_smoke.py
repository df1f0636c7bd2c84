#!/usr/bin/env python3
"""On-card smoke run of jincresize_tpu_torch: build, check, drive, time.

Run from the root of a checkout on a machine with one NVIDIA GPU (Hopper,
sm_90a) and the CUDA toolkit:

    python3 chip_smoke.py

Phases (each raises on failure; nothing catches it):

1. card and build -- the ``nvidia-smi`` name and power limit, torch and CUDA
   versions, then ``nvcc`` builds the kernels from ``jincresize_tpu_torch/csrc``;
2. kernel against plain -- both kernels and their plain PyTorch forms on the
   conv-path geometries of ``tests/tpu_smoke.py``, an exception-heavy 5/2
   upscale and the full 3840x2160 -> 7680x4320 tap-8 luma plane: 2e-6
   absolute for fp32 sources in [0, 1), <= 1 LSB after ``finalize`` for
   u8/u16;
3. end to end -- ``jinc_resize`` of a 4-frame 3840x2160 yuv420p8 clip to
   7680x4320 tap 8 on the card: both planes on the fused engine, every kernel
   launched, <= 1 LSB against the port's plain engine (``impl='xla'``) on the
   card and against the scalar oracle ``golden.reference_sample_pixels`` on
   sampled pixels (borders and corners included);
4. timing -- CUDA-event medians of each kernel and its plain form on an
   8-frame fp32 4K -> 8K luma batch, and the end-to-end ms/frame of phase 3
   with upload and download.

Prints the kernels' JSON line, then as its last line
``{"ok": true, "device": {...}}``. Exits non-zero, printing no result, when
no CUDA device is visible or the package is missing.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# (name, src_w, src_h, dst_w, dst_h, tap, bits, kwargs) -- the conv-path
# cases of tests/tpu_smoke.py plus the 5/2 exception case of
# tests/test_apply_conv.py. The plain 3/2 upscale is aperiodic at this size
# (it takes the general engine), so the 3/2 case is tpu_smoke's f64 3/2
# subpixel-crop geometry, which plans periodic.
CASES = [
    ("2x upscale qx=1", 96, 64, 192, 128, 8, 8, {}),
    ("2x downscale qx=2", 192, 128, 96, 64, 3, 8, {}),
    ("f64 3/2 subpixel crop", 128, 96, 192, 144, 4, 16,
     {"src_left": 0.123, "src_top": 0.456, "pos_precision": "f64"}),
    ("4x upscale px=4", 64, 48, 256, 192, 3, 32, {}),
    ("2/3 downscale px=2 qx=3", 192, 144, 128, 96, 3, 8, {}),
    ("subpixel crop", 100, 80, 160, 120, 4, 8, {"src_left": 1.25, "src_top": 0.5}),
    ("blur + quant1", 96, 64, 144, 96, 3, 16, {"blur": 0.98, "quant_x": 1, "quant_y": 1}),
    ("420 topleft chroma", 128, 96, 256, 192, 3, 8, {"cplace": "topleft", "fmt": "420"}),
    ("f64 8/3-by-4/3 px=8", 360, 240, 960, 320, 4, 8,
     {"src_left": 0.3, "src_top": 0.3, "pos_precision": "f64"}),
    ("5/2 upscale exceptions", 160, 120, 400, 300, 3, 32, {}),
]  # fmt: skip
SRC_W, SRC_H, DST_W, DST_H, TAP = 3840, 2160, 7680, 4320, 8
E2E_FRAMES = 4
TIMING_FRAMES = 8
F32_TOL = 2e-6  # exact fp32 products on both sides; only the summation order differs
ORACLE_SAMPLES = 2000


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]  # fmt: skip


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Median milliseconds of ``fn()`` over ``iters`` CUDA-event timed calls."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    os.environ.setdefault("JINCRESIZE_CACHE_DIR", str(ROOT / "build" / "cache"))
    import numpy as np

    from jincresize_tpu.clip import Clip, random_frame, yuv420p, yuv444p
    from jincresize_tpu.geometry import chroma_crop
    from jincresize_tpu.golden import reference_sample_pixels
    from jincresize_tpu.operator import radius_for_tap
    from jincresize_tpu.phase import plan_phases
    from jincresize_tpu_torch.api import JincConfig, JincResizer, jinc_resize
    from jincresize_tpu_torch.apply_xla import finalize, torch_dtype
    from jincresize_tpu_torch.kernels import _build
    from jincresize_tpu_torch.kernels import fused as fused_k
    from jincresize_tpu_torch.kernels import strips as strips_k

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # ---------------------------------------------------------------- phase 1
    card = card_line()
    print(f"[1] card: {card}")
    print(f"[1] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} devices {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    print(f"[1] kernels built in {time.perf_counter() - t0:.2f} s -> {lib_path}")
    for line in (lib_path.parent / "build.log").read_text().splitlines():
        if "registers" in line or "Compiling entry" in line:
            print(f"[1] ptxas: {line.strip()}")

    # ---------------------------------------------------------------- phase 2
    def check_kernels(name, op, bits, rng, frames=2):
        """Both kernels against their plain forms on ``op``; returns the
        largest fp32 |kernel - plain| (fp32 sources) or the LSB error."""
        plan = plan_phases(op)
        assert plan is not None and fused_k.is_supported(op, plan), name
        fi = fused_k.make_fused_interior(op, plan, dev)
        r = strips_k.make_strips(op, plan, dev)
        shape = (frames, op.src_height, op.src_width)
        if bits == 32:
            src = torch.from_numpy(rng.random(shape, dtype=np.float32)).to(dev)
        else:
            peak = (1 << bits) - 1
            src = torch.from_numpy(rng.integers(0, peak + 1, shape).astype(np.float32)).to(dev)
        before = (fused_k.fused_interior.launches, strips_k.strips.launches)
        pairs = [("fused", fused_k.fused_interior(fi, src), fused_k.fused_interior_plain(fi, src))]
        if r is not None:
            pairs.append(("strips", strips_k.strips(r[0], src), strips_k.strips_plain(r[0], src)))
        torch.cuda.synchronize()
        after = (fused_k.fused_interior.launches, strips_k.strips.launches)
        assert after == (before[0] + 1, before[1] + (r is not None)), (name, before, after)
        errs = {}
        for kname, got, ref in pairs:
            assert torch.isfinite(got).all(), (name, kname)
            if bits == 32:
                err = float((got - ref).abs().max())
                assert err <= F32_TOL, (name, kname, err)
            else:
                dt = torch_dtype(np.uint8 if bits == 8 else np.uint16)
                err = float((finalize(got, dt, float(peak)).int()
                             - finalize(ref, dt, float(peak)).int()).abs().max())
                assert err <= 1, (name, kname, err)
            errs[kname] = err
        print(f"[2] {name:28s} p=({plan.y.p},{plan.x.p}) q=({plan.y.q},{plan.x.q}) "
              f"fs={op.filter_size} strips_kernel={r is not None} "
              + " ".join(f"{k}_err={v:.3g}{'' if bits == 32 else ' LSB'}" for k, v in errs.items()))
        return errs, bits

    rng = np.random.default_rng(2026)
    max_err = {"fused": 0.0, "strips": 0.0}
    covered = {"fused": 0, "strips": 0}
    for name, sw, sh, dw, dh, tap, bits, kw in CASES:
        kw = dict(kw)
        fmt = yuv420p(bits) if kw.pop("fmt", None) == "420" else yuv444p(bits)
        cfg = JincConfig(target_width=dw, target_height=dh, tap=tap, operator_cache=False, **kw)
        r = JincResizer(fmt, sw, sh, cfg, device=dev)
        ops = [("luma", r.op_luma)] + ([("chroma", r.op_chroma)] if r.op_chroma else [])
        for plane, op in ops:
            errs, b = check_kernels(f"{name} {plane}", op, bits, rng)
            for k, v in errs.items():
                covered[k] += 1
                if b == 32:
                    max_err[k] = max(max_err[k], v)
        # The whole applier through the public API (upload, dtype casts,
        # fixups, assembly, finalize) against the host golden.
        clip = Clip.from_frames([random_frame(fmt, sw, sh, seed=7)])
        got = r(clip).frames[0]
        want = JincResizer(fmt, sw, sh, replace(cfg, impl="numpy"), device=dev)(clip).frames[0]
        d = max(
            float(np.abs(got.planes[n].astype(np.float64) - want.planes[n].astype(np.float64)).max())
            for n in fmt.plane_names
        )
        assert d <= (F32_TOL if bits == 32 else 1), (name, d)
        print(f"[2] {name:28s} jinc_resize vs host golden: max diff {d:.3g} ({r.engines})")

    t0 = time.perf_counter()
    fmt = yuv420p(8)
    clip = Clip.from_frames(
        [random_frame(fmt, SRC_W, SRC_H, seed=100 + i) for i in range(E2E_FRAMES)]
    )
    big_cfg = JincConfig(target_width=DST_W, target_height=DST_H, tap=TAP, operator_cache=False)
    resizer = JincResizer(fmt, SRC_W, SRC_H, big_cfg, frame0=clip.frames[0], device=dev)
    print(f"[2] 4K->8K tap8 resizer built in {time.perf_counter() - t0:.1f} s "
          f"(host operator build + upload); engines {resizer.engines}")
    errs, _ = check_kernels("3840x2160->7680x4320 tap8 luma", resizer.op_luma, 32, rng)
    for k, v in errs.items():
        covered[k] += 1
        max_err[k] = max(max_err[k], v)
    assert covered["fused"] and covered["strips"], covered

    # ---------------------------------------------------------------- phase 3
    assert resizer.engines == {"luma": "fused", "chroma": "fused"}, resizer.engines
    n_planes = len(fmt.plane_names)
    expect = {
        "fused": n_planes,
        "strips": sum(
            (resizer._applier_chroma if n in ("U", "V") else resizer._applier_luma).strips_spec
            is not None
            for n in fmt.plane_names
        ),
    }
    assert expect["strips"] > 0, "the strip kernel declined every 4K->8K plane"
    fused_k.fused_interior.launches = 0
    strips_k.strips.launches = 0
    t0 = time.perf_counter()
    out = jinc_resize(clip, DST_W, DST_H, tap=TAP, device="cuda", operator_cache=False)
    torch.cuda.synchronize()
    launches = {
        "fused": fused_k.fused_interior.launches,
        "strips": strips_k.strips.launches,
    }
    print(f"[3] jinc_resize 4x 3840x2160 yuv420p8 -> 7680x4320 tap8 in "
          f"{time.perf_counter() - t0:.1f} s (construction included); launches {launches}")
    assert launches == expect, (launches, expect)

    ref = jinc_resize(clip, DST_W, DST_H, tap=TAP, device="cuda", impl="xla", operator_cache=False)
    for fo, fr in zip(out.frames, ref.frames):
        fo.validate()
        for n in fmt.plane_names:
            d = int(np.abs(fo.planes[n].astype(np.int64) - fr.planes[n].astype(np.int64)).max())
            assert d <= 1, ("fused vs plain engine", n, d)
    print("[3] fused engine vs plain (impl='xla') engine on the card: <= 1 LSB on every plane")

    radius = radius_for_tap(TAP)
    srng = np.random.default_rng(7)
    for n in fmt.plane_names:
        pw, ph = fmt.plane_dims(n, DST_W, DST_H)
        sw_, sh_ = fmt.plane_dims(n, SRC_W, SRC_H)
        if n == "Y":
            crop = (0.0, 0.0, float(SRC_W), float(SRC_H))
        else:
            crop = chroma_crop(resizer.cplace, SRC_W, SRC_H, DST_W, DST_H, 0.0, 0.0,
                               float(SRC_W), float(SRC_H), fmt.sub_w, fmt.sub_h)
        nb = 24  # border band (covers every strip row/column at these sizes)
        ys = np.concatenate([
            srng.integers(0, ph, ORACLE_SAMPLES // 2),
            np.r_[srng.integers(0, nb, ORACLE_SAMPLES // 8), srng.integers(ph - nb, ph, ORACLE_SAMPLES // 8)],
            srng.integers(0, ph, ORACLE_SAMPLES // 4),
            [0, 0, ph - 1, ph - 1],
        ])  # fmt: skip
        xs = np.concatenate([
            srng.integers(0, pw, ORACLE_SAMPLES // 2),
            srng.integers(0, pw, ORACLE_SAMPLES // 4),
            np.r_[srng.integers(0, nb, ORACLE_SAMPLES // 8), srng.integers(pw - nb, pw, ORACLE_SAMPLES // 8)],
            [0, pw - 1, 0, pw - 1],
        ])  # fmt: skip
        t0 = time.perf_counter()
        vals, *_ = reference_sample_pixels(
            clip.frames[0].planes[n], ys, xs, pw, ph, radius,
            crop_left=crop[0], crop_top=crop[1], crop_width=crop[2], crop_height=crop[3],
        )  # fmt: skip
        want = np.rint(np.clip(vals, 0, 255)).astype(np.int64)
        got = out.frames[0].planes[n][ys, xs].astype(np.int64)
        d = int(np.abs(got - want).max())
        print(f"[3] plane {n} ({sw_}x{sh_}->{pw}x{ph}): {len(ys)} oracle samples "
              f"max diff {d} LSB ({time.perf_counter() - t0:.1f} s)")
        assert d <= 1, (n, d)

    # ---------------------------------------------------------------- phase 4
    card = card_line()
    app = resizer._applier_luma
    tsrc = torch.from_numpy(
        rng.random((TIMING_FRAMES, SRC_H, SRC_W), dtype=np.float32)
    ).to(dev)
    px_out = TIMING_FRAMES * DST_W * DST_H
    ms = {}
    for _ in range(2):  # plain, kernel, kernel, plain -- twice
        for k, fn in (
            ("fused_plain", lambda: fused_k.fused_interior_plain(app.fi, tsrc)),
            ("fused", lambda: fused_k.fused_interior(app.fi, tsrc)),
            ("strips", lambda: strips_k.strips(app.strips_spec, tsrc)),
            ("strips_plain", lambda: strips_k.strips_plain(app.strips_spec, tsrc)),
        ):
            iters = 3 if k.endswith("plain") else 20
            ms.setdefault(k, []).append(cuda_ms(fn, iters))
    ms = {k: statistics.median(v) for k, v in ms.items()}
    for k in ("fused", "fused_plain", "strips", "strips_plain"):
        print(f"[4] {k:13s} {ms[k]:10.3f} ms per {TIMING_FRAMES}-frame fp32 4K->8K luma "
              f"batch ({ms[k] / TIMING_FRAMES:.3f} ms/frame) [{card}]")
    del tsrc
    e2e = []
    for i in range(4):
        t0 = time.perf_counter()
        resizer(clip)
        torch.cuda.synchronize()
        if i:  # first call is warm-up
            e2e.append(time.perf_counter() - t0)
    e2e_ms = statistics.median(e2e) * 1000 / E2E_FRAMES
    # Where a call's time goes: the per-plane steps of JincResizer's batched
    # path, each closed by a synchronise (host clock, summed over planes).
    split = {"stack+upload": [], "device": [], "download": []}
    for _ in range(3):
        acc = dict.fromkeys(split, 0.0)
        for n in fmt.plane_names:
            _, _, plane_app = resizer._plane_op(n)
            t0 = time.perf_counter()
            t = torch.from_numpy(np.stack([f.planes[n] for f in clip.frames])).to(dev)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            o = plane_app(t, out_dtype=np.uint8, peak=255.0)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            o.cpu().numpy()
            t3 = time.perf_counter()
            acc["stack+upload"] += t1 - t0
            acc["device"] += t2 - t1
            acc["download"] += t3 - t2
        for k, v in acc.items():
            split[k].append(v)
    print("[4] split per frame: " + ", ".join(
        f"{k} {statistics.median(v) * 1000 / E2E_FRAMES:.2f} ms" for k, v in split.items()
    ) + f" [{card}]")  # fmt: skip
    print(f"[4] end to end (upload + 3 planes + download) {e2e_ms:.2f} ms/frame, "
          f"{DST_W * DST_H / e2e_ms / 1e6:.3f} Gpx/s luma [{card}]")
    print(f"[4] interior kernel {px_out / ms['fused'] / 1e6:.2f} Gpx/s "
          f"(output px / kernel time) [{card}]")

    print(card)
    kernels = [
        {
            "name": "fused_interior",
            "route": "cuda",
            "source": "jincresize_tpu_torch/csrc/fused_interior.cu",
            "replaces": "jincresize_tpu/kernels/pallas_fused.py:157",
            "launches": launches["fused"],
            "max_abs_err": max_err["fused"],
            "ms": ms["fused"],
            "plain_ms": ms["fused_plain"],
        },
        {
            "name": "strips",
            "route": "cuda",
            "source": "jincresize_tpu_torch/csrc/strips.cu",
            "replaces": "jincresize_tpu/kernels/pallas_strips.py:85",
            "launches": launches["strips"],
            "max_abs_err": max_err["strips"],
            "ms": ms["strips"],
            "plain_ms": ms["strips_plain"],
        },
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))  # fmt: skip
    return 0


if __name__ == "__main__":
    sys.exit(main())
