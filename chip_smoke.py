#!/usr/bin/env python3
"""On-card smoke run of jincresize_tpu_torch: build, check, drive, time.

Run from the root of a checkout on a machine with one NVIDIA GPU (Hopper,
sm_90a) and the CUDA toolkit:

    python3 chip_smoke.py

Phases (each raises on failure; nothing catches it):

1. card and build -- the ``nvidia-smi`` name and power limit, torch and CUDA
   versions, then ``nvcc`` builds the kernels from ``jincresize_tpu_torch/csrc``
   (one compiler per source, in parallel);
2. kernel against plain -- every kernel and its plain PyTorch form: the fused
   and strip kernels on the conv-path geometries of ``tests/tpu_smoke.py``
   (its two tap-16 deep-tap cases included), an exception-heavy 5/2 upscale,
   a tap-16 2/5 downscale whose weights take 105 KB of shared memory, the
   full 3840x2160 -> 7680x4320 tap-8 and 3840x2160 -> 1920x1080 tap-16 luma
   planes (the strip kernel also at F = 1, 2, 3, 4 and 8 there and on one
   case of each of its instances, qx = 1, 2, 3 and generic, each with a
   ragged last column tile); the gather and seg kernels on the geometries of
   ``tests/test_apply_gather.py`` and ``tests/test_apply_conv_seg.py`` (both
   kernels at F = 1, 2, 3, 4 and 8 frames, every frames-a-thread instance
   and a ragged group) and on the full 2560x1440 -> 3840x2160 and
   1920x1080 -> 3740x2104 tap-8 luma planes, the 2560x1440 -> 1920x1080
   tap-16 luma plane (fs 44: seg and gather) and the 3840x2160 -> 1366x768
   tap-16 luma plane (fs 92); the sharded engine's band kernel on every row
   shard of 96x72 -> 160x120 tap 3 (8 shards), a multi-hop and a replicated
   downscale (8 shards; F = 1, 2, 3, 4, 8) and the full 1920x1080 ->
   3740x2104 tap-8 and 3840x2160 -> 1366x768 tap-16 luma planes (4 shards):
   0 for the gather, band and seg kernels (their plain forms sum in the
   kernels' order), 0 for the strip kernel against ``strips_chain`` (its sums
   in its own float32 order; against the float64 ``strips_plain`` within
   ``f32_chain_bound``, on a second seed's sources too on the four strip
   cases), else 2e-6 absolute for fp32 sources in [0, 1) (4e-6 for deep
   taps, fs**2 > 1200), <= 1 LSB after ``finalize`` for u8/u16; the ``out_only``
   probe against ``torch.zeros`` at (8, 4320, 7680) and on a ragged
   (2, 100, 300) plane (0); the narrow shape of
   the fused kernel against the default on three of the conv cases, one of
   them tap 16 (0); the 4K -> 8K fp32 luma plane through its applier under
   ``torch.set_float32_matmul_precision('high')`` against the default run
   (2e-6: the port's glue sums in float64 einsums, which no float32 matmul
   setting reaches); then the chain of phase 3 is composed (host time
   printed) and the strip kernel is held to its plain form at every F on
   both composed planes, whose bottom strips step their window start from
   row to row (a plane it declines is printed with the reason); the bf16
   modes (``precision='bf16'``: operands rounded to bfloat16) of the fused
   kernel on every conv case's luma plane and of the narrow shape on the
   shape cases, and of the seg kernel on its two cases at F = 1, 2, 3, 4 and
   8, each against its plain form (2e-6, 4e-6 for deep taps; 0 expected) and
   against the fp32 mode (``kernels.fused.bf16_bound``); every launch counted;
3. end to end, one path after another, each with the launch counts set to 0
   just before and read just after, on 4-frame yuv420p8 clips:
   3840x2160 -> 7680x4320 tap 8 (periodic: ``fused``), 2560x1440 -> 3840x2160
   tap 8 (drifted 1.5x: ``fused-seg``), 1920x1080 -> 3740x2104 tap 8
   (aperiodic: ``gather``), 3840x2160 -> 1920x1080 tap 16 (deep taps:
   ``fused``), 3840x2160 -> 1366x768 tap 16 (deep aperiodic, fs 92:
   ``gather``, where the JAX package's envelope takes ``xla``) and
   2560x1440 -> 1920x1080 tap 16 (deep drifted, fs 44: ``fused-seg``, where
   the JAX package's takes ``xla``), each <= 1
   LSB against the port's plain engine
   (``impl='xla'``) on the card and against the scalar oracle
   ``golden.reference_sample_pixels`` on sampled pixels (borders and corners
   included); then the sharded engine on four row shards of ``cuda:0``:
   the aperiodic clip (``sharded/gather``, 12 band-kernel launches, <= 1 LSB
   against the single-card engine and the oracle) and 2-frame runs of the
   periodic and the deep-tap (``sharded/conv-fused``), drifted and deep
   drifted (``sharded/seg``) and deep aperiodic (``sharded/gather``) clips, each
   <= 1 LSB against its single-card engine; on
   a machine with several cards, the aperiodic clip on a mesh of distinct
   cards too; then the paths of the tools slice: a 2-frame yuv420p8 chain
   1920x1080 -> 3840x2160 -> 7680x4320 tap 3 through ``jinc_resize_chain``
   (the operators composed in phase 2, loaded from their cache; ``fused``,
   the strip kernel launched on the composed planes; <= 1 LSB against the
   same composed operators on ``impl='xla'``), the
   CLI on a 2-frame 4K -> 8K tap-8 yuv420p8 ``.npz`` in this process and as
   ``python -m jincresize_tpu_torch`` (exit 0, fused on both planes, 0 LSB
   against the API), ``entry.entry()`` and ``entry.dryrun_multichip(4)``
   on four shards of ``cuda:0``; ``precision='bf16'``: the 4-frame 4K -> 8K
   clip (``fused``, the fused kernel's bf16 mode) and two frames of the
   drifted clip on one card (``fused-seg``) and on four row shards
   (``sharded/seg``, <= 1 LSB against the single card), each applier's
   ``effective_precision`` asserted bf16 and each output within
   ``kernels.fused.bf16_lsb`` of the fp32 run. ``fused_interior_plain`` must be called 0
   times in the phase;
4. timing -- every tool of ``jincresize_tpu_torch.tools`` in this process at
   reduced repetitions, each with the launch counts set to 0 before and read
   after (``device_loop_timing`` is the probe's main path; the fused shape
   sweep must give max |err| 0 for every shape at both main geometries);
   one 4-frame 4K -> 8K and one 4-frame 4K -> 1080p tap-16 ``JincResizer``
   call, each inside ``metrics.device_trace`` (``torch.profiler``):
   the ten device operations with the most CUDA time, the summed HtoD and
   DtoH copies and the device's idle share over the call's span; then
   CUDA-event medians of each kernel and its plain form on 8-frame
   fp32 luma batches of each path (the band kernel summed over the four
   shards of the aperiodic plane), each beside its bound (operations or
   bytes over the H100's fp32 and HBM peaks; the bf16 modes' operations at
   its bf16 tensor-core peak, their fp32-FMA share printed beside), cuDNN's ``conv2d`` computing
   the fused interior at 4K -> 8K and at 4K -> 1080p tap 16 (checked against
   the kernel, 4e-6), the fused kernel's ms/frame, share of its bound and
   ratio to cuDNN's time at both, the same for the strip kernel against one
   ``torch.nn.functional.conv1d`` a strip (TF32 off; 4e-6), and on the
   chain's composed luma plane, the bf16 modes of the fused kernel at 4K ->
   8K and 4K -> 1080p tap 16 (beside cuDNN's conv2d on bfloat16 tensors) and
   of the seg kernel at 1440p -> 4K tap 8, each timed beside its fp32 mode
   in the same turns, its plain form once (held to it and to the fp32
   mode), the full-size 2/3 3840x2160 -> 2560x1440
   tap-16 plan once (against its plain form, 0), the seg and gather
   appliers on the same 1440p -> 4K plane, the seg and gather kernels on
   both drifted planes (1440p -> 4K tap 8, 1440p -> 1080p tap 16) beside
   their bounds, the previous seg kernel's time and each other, the gather and band kernels on
   the 8-frame 4K -> 1366x768 tap-16 luma batch beside their bounds (each
   plain form once, its output held to the kernel's: 0), the gather and
   band kernels' ms/frame at 1080p -> 3740x2104 beside the previous kernels',
   each path's
   end-to-end ms/frame
   with its upload / device / download split (the deep drifted path too; the sharded aperiodic path
   beside the single-card one; the deep aperiodic clip under ``auto`` beside
   ``impl='xla'``), ``python -m jincresize_tpu_torch.bench`` in
   its three modes and the default one under ``--precision bf16``, run in
   this process, and the probe beside its bound and
   ``torch.zeros``, in one order and the other;
5. two processes -- ``python3 chip_smoke.py --dist-worker <port> <rank>``,
   twice, joined by a gloo group (``distributed.init_distributed``; NCCL
   refuses two ranks on one card, so the halos cross through host buffers),
   each with two of the four row shards of ``distributed.global_mesh(n_rows=4,
   devices=[cuda:0] * 2)``: 4 fp32 frames of the 3840x2160 -> 7680x4320
   (``conv-fused``), 2560x1440 -> 3840x2160 (``seg``) and 1920x1080 ->
   3740x2104 (``gather``, the band kernel) tap-8 luma planes, the other
   rank's source rows NaN in each rank's copy, each rank's rows bit-equal
   (0) to the one-process ``ShardedApplier`` on four shards of the card over
   the clean source, no NaN, its kernel launched once a local shard (counts
   set to 0 before the two-rank call, read after); each rank prints the
   two-rank call's ms/frame beside the one-process call's (rank 0 alone),
   the halo bytes it sent and received a call and the exchange's share of
   the call. The parent raises on a nonzero exit, on a timeout of
   ``DIST_TIMEOUT`` seconds or on a missing ``DIST_OK`` line.

Prints the kernels' JSON line, then as its last line
``{"ok": true, "device": {...}}``. Exits non-zero, printing no result, when
no CUDA device is visible or the package is missing.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from dataclasses import replace
from pathlib import Path

ROOT = Path(__file__).resolve().parent
DEVICE = "cuda"

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
    # Deep taps (fs**2 > 1200): the two tap-16 cases of tests/tpu_smoke.py and
    # a 2/5 downscale whose four (84, 84) kernels take 113 KB of shared
    # memory (the kernel's opt-in above 48 KB). Each is also checked on fp32.
    ("tap16 2x down p=1 fs=65", 480, 270, 240, 135, 16, 8, {"fmt": "gray"}),
    ("tap16 2/3 down p=2 fs=49", 480, 270, 320, 180, 16, 8, {"fmt": "gray"}),
    ("tap16 2/5 down fs=82 113KB", 300, 200, 120, 80, 16, 8, {"fmt": "gray"}),
]  # fmt: skip
# (name, kernel, src_w, src_h, dst_w, dst_h, tap): tests/test_apply_gather.py
# (aperiodic upscale, tap-2 downscale) and tests/test_apply_conv_seg.py
# (drifted 1.5x, 2.5x with exception columns).
INTERIOR_CASES = [
    ("gather 96x64->167x113 tap3", "gather", 96, 64, 167, 113, 3),
    ("gather 120x80->77x53 tap2", "gather", 120, 80, 77, 53, 2),
    ("seg 640x360->960x540 tap8", "seg", 640, 360, 960, 540, 8),
    ("seg 1920x80->4800x200 tap2", "seg", 1920, 80, 4800, 200, 2),
]
# (name, src_w, src_h, dst_w, dst_h, tap, row shards): the band kernel on
# tests/test_torch_sharding.py's gather geometry, a multi-hop (2 hops each
# way) and a replicated downscale.
BAND_CASES = [
    ("band 96x72->160x120 tap3", 96, 72, 160, 120, 3, 8),
    ("band 128x96->21x16 tap2 multi-hop", 128, 96, 21, 16, 2, 8),
    ("band 64x48->10x8 tap2 replicated", 64, 48, 10, 8, 2, 8),
]
N_SHARDS = 4  # row shards of the sharded runs, all on cuda:0
SRC_W, SRC_H, DST_W, DST_H, TAP = 3840, 2160, 7680, 4320, 8
DRIFT = (2560, 1440, 3840, 2160)  # 1.5x: drifted under f32 positions, seg on both planes
APERIODIC = (1920, 1080, 3740, 2104)  # 1.947x: 256x256 classes, gather on both planes
DEEP = (3840, 2160, 1920, 1080)  # tap-16 2x downscale: p=1, q=2, fs=65 on both planes
DEEP_TAP = 16
# tap-16 2.8125x downscale to a laptop and streaming size: aperiodic columns,
# fs=92 on both planes, gather (the JAX package's envelope sends it to xla).
DEEP_APERIODIC = (3840, 2160, 1366, 768)
# tap-16 4/3 downscale, 1440p -> 1080p: drifted under f32 positions, fs 44,
# 12 x 27 classes, no periodic plan; fused-seg (the JAX package: xla).
DEEP_DRIFT = (2560, 1440, 1920, 1080)
KERNEL_FRAMES = (1, 2, 3, 4, 8)  # every frames-a-thread instance, a ragged group (3) included
THIRDS = (2560, 1440)  # 3840x2160 -> 2560x1440 tap 16: the 2/3 plan, timed once
E2E_FRAMES = 4
TIMING_FRAMES = 8
F32_TOL = 2e-6  # exact fp32 products on both sides; only the summation order differs
DEEP_TOL = 4e-6  # fs**2 > 1200 (4225 products a pixel at fs=65): the JAX deep-tap bound
ORACLE_SAMPLES = 2000
DEEP_ORACLE_SAMPLES = 128  # the scalar oracle costs ~45 ms a sample at fs=65
DEEP_APER_ORACLE_SAMPLES = 32  # ~90 ms a sample at fs=92
DEEP_DRIFT_ORACLE_SAMPLES = 64
# The previous gather and band kernels' ms/frame (one pixel a thread, the
# class-minor dictionary) on the 8-frame 1080p -> 3740x2104 tap-8 luma batch
# (PERF.md kernel table, H100 80GB HBM3, 700 W), printed beside this run's.
PREV_MS_PER_FRAME = {"gather": 1.345, "gather_band": 1.093}
# The previous seg kernel (one pixel a thread, up to 4 frames a block) at
# 1440p -> 4K tap 8 (PERF.md kernel table, H100 80GB HBM3, 700 W), printed
# beside this run's.
PREV_SEG_MS_PER_FRAME = 0.458
# The chain: 1080p -> 4K -> 8K tap 3 (2x then 2x), two frames.
CHAIN = ((1920, 1080), (3840, 2160), (7680, 4320))
CHAIN_TAP = 3
# The strip kernel at every F of KERNEL_FRAMES on these CASES: one each of
# its qx = 1, 2, 3 instances and of the generic one (qx = 5), each with a
# ragged last column tile.
STRIP_FRAME_CASES = ("2x upscale qx=1", "2x downscale qx=2", "2/3 downscale px=2 qx=3",
                     "tap16 2/5 down fs=82 113KB")
# Fused-kernel shapes checked against the default: on these CASES.
SHAPE_CASES = ("2x upscale qx=1", "5/2 upscale exceptions", "tap16 2/5 down fs=82 113KB")
PROBE_SHAPES = [((8, 4320, 7680), (48, 256)), ((2, 100, 300), (48, 256))]
TOOL_REPS = 5  # back-to-back calls per timing in the tools' runs
# Phase 5: two gloo ranks, two of the four row shards each, all on cuda:0;
# (name, (src_w, src_h, dst_w, dst_h), interior, kernel wrapper) at tap 8,
# four fp32 frames of the luma plane.
DIST_CASES = [
    ("4K->8K", (SRC_W, SRC_H, DST_W, DST_H), "conv-fused", "fused"),
    ("1440p->4K", DRIFT, "seg", "seg"),
    ("1080p->3740x2104", APERIODIC, "gather", "gather_band"),
]
DIST_RANKS = 2
DIST_FRAMES = 4
DIST_REPS = 3  # timed calls of each run after its checked one
DIST_TIMEOUT = 300  # seconds for both workers together
PROBE_REPS = 10  # back-to-back calls a sample of the probe and torch.zeros
# H100 SXM peaks (NVIDIA's data sheet, at 700 W): fp32 outside the tensor
# cores, and HBM3. A kernel's bound is the larger of its operations and its
# bytes (each input read once, each output written once) over these.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12
# The bf16 modes multiply bfloat16 operands exactly and sum in fp32, the
# work of the tensor cores' dense bf16 rate: their bound takes this peak.
PEAK_BF16_FLOPS = 989e12


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]  # fmt: skip


def f32_chain_bound(st, src) -> float:
    """The rounding of any float32 multiply-add chain over a strip pixel's
    n = fs**2 taps, against its exact value (the float64 ``strips_plain``,
    rounded once to float32): (gamma_n + u) * max sum|w| * max|src|, with
    u = 2**-24, gamma_n = n*u / (1 - n*u) and sum|w| over the strips' rows
    (a zero tap's multiply-add is exact). A bound of the arithmetic, not of
    the kernel: the kernel is held to ``strips_chain`` at 0."""
    from jincresize_tpu_torch.kernels.fused import f32_sum_bound
    from jincresize_tpu_torch.kernels.strips import band_anchors

    s = float(band_anchors(st).abs().sum((3, 4)).max())
    return f32_sum_bound(st.fs**2, s, float(src.abs().max()))


def bound_ms(ops: float, nbytes: float, peak: float = PEAK_FP32_FLOPS) -> tuple[float, str]:
    """The least time the card could take: (ms, 'operations' or 'bytes'),
    the operations at ``peak`` (fp32 outside the tensor cores by default)."""
    t_ops = ops / peak * 1e3
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def tensor_bytes(*objs, skip=()) -> int:
    """Bytes of the tensors given, and of the tensor fields of the
    dataclasses given (fields in ``skip`` left out: plain-form tables)."""
    import dataclasses

    import torch

    total = 0
    for o in objs:
        if isinstance(o, torch.Tensor):
            total += o.numel() * o.element_size()
        else:
            for f in dataclasses.fields(o):
                v = getattr(o, f.name)
                if f.name not in skip and isinstance(v, torch.Tensor):
                    total += v.numel() * v.element_size()
    return total


def strips_bound(st, src) -> tuple[float, str]:
    """(ms, by) of the strip kernel: 2 fs**2 flops a pixel of each strip's
    rows; each strip's source band, the kernel's weights and the output once."""
    F, _, W = src.shape
    out_px = F * sum(ny for _, ny, _ in st.rows) * st.px * st.nxb
    nbytes = (4 * F * W * sum(nb for *_, nb in st.rows) + tensor_bytes(st, skip=("cols",))
              + 4 * F * st.n_strips * st.ny_max * st.px * st.nxb)  # fmt: skip
    return bound_ms(2 * st.fs**2 * out_px, nbytes)


def strips_conv1d_weights(st) -> list:
    """Weights of the strips' yardstick: for each strip, (ny*px, nb,
    spread + fs), row m's phase rx at channel m*px + rx, its taps at the
    phase's column offset and at the row's offset in the band."""
    from jincresize_tpu_torch.kernels.strips import band_anchors

    A = band_anchors(st)  # (n_strips, rows, px, nb_max, fs)
    offs = st.offs_x.tolist()
    ws = []
    for si, (_, ny, nb) in enumerate(st.rows):
        wt = A.new_zeros((ny, st.px, nb, max(offs) + st.fs))
        for rx, o in enumerate(offs):
            wt[:, rx, :, o : o + st.fs] = A[si, :ny, rx, :nb]
        ws.append(wt.reshape(ny * st.px, nb, -1))
    return ws


def strips_conv1d(st, src, ws):
    """The strips' library yardstick: one ``torch.nn.functional.conv1d`` a
    strip (cuDNN; the caller sets ``torch.backends.cudnn.allow_tf32 =
    False``), the strip's source band as nb input channels from column
    base_x on, stride qx, then a permute to the kernel's layout. The port
    never calls it."""
    import torch

    F, H, _ = src.shape
    out = src.new_zeros((F, st.n_strips, st.ny_max, st.px * st.nxb))
    for si, ((row_min, ny, nb), wt) in enumerate(zip(st.rows, ws)):
        need = st.qx * (st.nxb - 1) + wt.shape[2]
        lo, hi = max(row_min, 0), min(row_min + nb, H)
        band = src[:, lo:hi, st.base_x : st.base_x + need]
        band = torch.nn.functional.pad(
            band, (0, need - band.shape[2], lo - row_min, row_min + nb - hi))
        y = torch.nn.functional.conv1d(band, wt, stride=st.qx)[:, :, : st.nxb]
        out[:, si, :ny] = y.view(F, ny, st.px, st.nxb).transpose(2, 3).reshape(F, ny, -1)
    return out


def cuda_ms(fn, iters: int, warmup: int = 2, reps: int = 1) -> float:
    """Median milliseconds a call of ``fn()`` over ``iters`` CUDA-event
    samples of ``reps`` back-to-back calls each."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def dist_phase(card: str) -> None:
    """Phase 5: start ``DIST_RANKS`` workers (``--dist-worker``), wait for
    both within ``DIST_TIMEOUT`` seconds, print their lines, and raise on a
    nonzero exit, a timeout or a missing ``DIST_OK`` line."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = {**os.environ, "GLOO_SOCKET_IFNAME": os.environ.get("GLOO_SOCKET_IFNAME", "lo")}
    procs = [
        subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--dist-worker", str(port), str(r)],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for r in range(DIST_RANKS)
    ]  # fmt: skip
    outs = []
    deadline = time.perf_counter() + DIST_TIMEOUT
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(1.0, deadline - time.perf_counter()))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        for line in out.splitlines():
            print(line if line.startswith("[5]") else f"[5] rank{r}| {line}")
        if p.returncode != 0:
            raise RuntimeError(f"phase 5: rank {r} exited with {p.returncode}")
        if f"DIST_OK rank{r}" not in out:
            raise RuntimeError(f"phase 5: rank {r} printed no DIST_OK line")
    print(f"[5] {DIST_RANKS} gloo ranks x {4 // DIST_RANKS} row shards on one card: every row "
          f"bit-equal to the one-process run, no NaN [{card}]")


def dist_worker(port: int, rank: int) -> int:
    """One rank of phase 5: join the gloo group, take two of the four row
    shards of ``global_mesh(n_rows=4, devices=[cuda:0] * 2)``, and run each
    of ``DIST_CASES`` on four fp32 frames whose other rank's source rows are
    NaN in this rank's copy: its rows must be bit-equal to the one-process
    ``ShardedApplier`` on four shards of the card over the clean source, with
    no NaN; then both runs are timed (host clock, the card synchronised
    around each call; the one-process run on rank 0 alone, rank 1 waiting)."""
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT))
    from jincresize_tpu_torch.distributed import global_mesh, init_distributed
    from jincresize_tpu_torch.kernels import fused as fused_k
    from jincresize_tpu_torch.kernels import gather as gather_k
    from jincresize_tpu_torch.kernels import seg as seg_k
    from jincresize_tpu_torch.operator import build_plane_operator, radius_for_tap
    from jincresize_tpu_torch.sharding import Shard, ShardedApplier, make_mesh

    dist = torch.distributed
    wrappers = {"fused": fused_k.fused_interior, "seg": seg_k.seg_interior,
                "gather_band": gather_k.gather_band}  # fmt: skip
    init_distributed(coordinator_address=f"127.0.0.1:{port}", num_processes=DIST_RANKS,
                     process_id=rank, backend="gloo")  # fmt: skip
    dev = torch.device("cuda", 0)
    n_rows = 4
    mesh = global_mesh(n_rows=n_rows, devices=[dev] * (n_rows // DIST_RANKS))
    assert mesh.ranks == (tuple(sorted(list(range(DIST_RANKS)) * (n_rows // DIST_RANKS))),)
    ref_mesh = make_mesh(n_rows=n_rows, devices=[dev] * n_rows)
    card = card_line()

    def timed(fn, x) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(x)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    for name, (sw, sh, dw, dh), interior, kind in DIST_CASES:
        t0 = time.perf_counter()
        op = build_plane_operator(sw, sh, dw, dh, radius_for_tap(TAP))
        app = ShardedApplier(op, mesh)
        ref = ShardedApplier(op, ref_mesh)
        built = time.perf_counter() - t0
        assert app.interior == ref.interior == interior, (name, app.interior, ref.interior)
        ts = app._fn.ts
        src = np.random.default_rng(5).random((DIST_FRAMES, sh, sw), dtype=np.float32)
        mine = [d for d in range(n_rows) if mesh.ranks[0][d] == rank]
        poisoned = src.copy()
        for d in range(n_rows):
            if d not in mine:
                poisoned[:, d * ts : (d + 1) * ts] = np.nan
        src_d = torch.from_numpy(src).to(dev)
        pois_d = torch.from_numpy(poisoned).to(dev)
        dist.barrier()
        want = ref(src_d)
        for w in wrappers.values():
            w.launches = 0
        got = app(pois_d)
        torch.cuda.synchronize()
        launched = {k: w.launches for k, w in wrappers.items()}
        n_local = sum(isinstance(s, Shard) for s in app._fn.shards[0])
        assert launched == {**dict.fromkeys(wrappers, 0), kind: n_local}, (name, launched)
        td = -(-dh // n_rows)
        assert sorted(s.index[1].start for s in got) == [d * td for d in mine], name
        err = 0.0
        for s in got:
            assert not torch.isnan(s.data).any(), (name, s.index)
            err = max(err, float((s.data - want[s.index]).abs().max()))
            assert torch.equal(s.data, want[s.index]), (name, s.index, err)
        del want, got
        # Timing: both ranks run the two-rank call together; then rank 0
        # runs the one-process call alone.
        two, share = [], []
        for _ in range(DIST_REPS):
            dist.barrier()
            dt = timed(app, pois_d)
            two.append(dt)
            share.append(app._fn.exchange["seconds"] / dt)
        ex = dict(app._fn.exchange)
        one = []
        dist.barrier()
        if rank == 0:
            timed(ref, src_d)
            one = [timed(ref, src_d) for _ in range(DIST_REPS)]
        dist.barrier()
        ms2 = statistics.median(two) * 1e3 / DIST_FRAMES
        ms1 = f"{statistics.median(one) * 1e3 / DIST_FRAMES:.3f} ms/frame" if one else "on rank 0"
        print(f"[5] rank{rank} {name} {sw}x{sh}->{dw}x{dh} tap{TAP} {interior} x{DIST_FRAMES} fp32 "
              f"(built in {built:.1f} s): shards {mine}, launches {launched}, max |2-rank - "
              f"one-process| {err:g}, no NaN; 2-rank call {ms2:.3f} ms/frame, one-process call "
              f"{ms1}; halo bytes sent {ex['bytes_sent']} received "
              f"{ex['bytes_received']} per call; exchange {statistics.median(share):.1%} of the "
              f"call ({ex['seconds'] * 1e3:.3f} ms) [{card}]", flush=True)  # fmt: skip
        del src_d, pois_d, app, ref
        torch.cuda.empty_cache()
    dist.barrier()
    dist.destroy_process_group()
    print(f"DIST_OK rank{rank}", flush=True)
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import numpy as np

    from jincresize_tpu_torch import bench, cli, metrics, sharding
    from jincresize_tpu_torch import entry as entry_mod
    from jincresize_tpu_torch.clip import Clip, gray, random_frame, yuv420p, yuv444p
    from jincresize_tpu_torch.geometry import chroma_crop
    from jincresize_tpu_torch.golden import apply_plane_numpy, reference_sample_pixels
    from jincresize_tpu_torch.operator import build_plane_operator, radius_for_tap
    from jincresize_tpu_torch.phase import plan_phases, plan_phases_seg
    from jincresize_tpu_torch.api import ChainResizer, JincConfig, JincResizer, jinc_resize
    from jincresize_tpu_torch.api import jinc_resize_chain
    from jincresize_tpu_torch.apply_gather import GatherApplier
    from jincresize_tpu_torch.apply_xla import finalize, torch_dtype
    from jincresize_tpu_torch.kernels import _build
    from jincresize_tpu_torch.kernels import fused as fused_k
    from jincresize_tpu_torch.kernels import gather as gather_k
    from jincresize_tpu_torch.kernels import probe
    from jincresize_tpu_torch.kernels import seg as seg_k
    from jincresize_tpu_torch.kernels import strips as strips_k
    from jincresize_tpu_torch.tools import (assemble_breakdown, bench_gather,
                                            device_loop_timing, fused_tile_sweep,
                                            streaming_pipeline)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)
    wrappers = {
        "fused": fused_k.fused_interior,
        "strips": strips_k.strips,
        "gather": gather_k.gather_interior,
        "seg": seg_k.seg_interior,
        "gather_band": gather_k.gather_band,
        "out_only": probe.out_only,
    }

    def counts():
        return {k: w.launches for k, w in wrappers.items()}

    def zero_counts():
        for w in wrappers.values():
            w.launches = 0

    # ---------------------------------------------------------------- phase 1
    t_start = time.perf_counter()
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
    print(f"[2] phase 2 starts at {time.perf_counter() - t_start:.1f} s")
    def rand_src(op, bits, rng, frames):
        shape = (frames, op.src_height, op.src_width)
        if bits == 32:
            return torch.from_numpy(rng.random(shape, dtype=np.float32)).to(dev)
        peak = (1 << bits) - 1
        return torch.from_numpy(rng.integers(0, peak + 1, shape).astype(np.float32)).to(dev)

    def err_of(got, ref, bits):
        """fp32: max |got - ref|; integers: max LSB difference after finalize."""
        if bits == 32:
            return float((got - ref).abs().max())
        peak = float((1 << bits) - 1)
        dt = torch_dtype(np.uint8 if bits == 8 else np.uint16)
        return float((finalize(got, dt, peak).int() - finalize(ref, dt, peak).int()).abs().max())

    def tol_of(op, bits):
        if bits != 32:
            return 1
        return DEEP_TOL if op.filter_size**2 > 1200 else F32_TOL

    def check_kernels(name, op, bits, rng, frames=2):
        """Both kernels against their plain forms on ``op``; returns the
        largest fp32 |kernel - plain| (fp32 sources) or the LSB error."""
        plan = plan_phases(op)
        assert plan is not None and fused_k.is_supported(op, plan), name
        fi = fused_k.make_fused_interior(op, plan, dev)
        r = strips_k.make_strips(op, plan, dev)
        src = rand_src(op, bits, rng, frames)
        before = (fused_k.fused_interior.launches, strips_k.strips.launches)
        pairs = [("fused", fused_k.fused_interior(fi, src), fused_k.fused_interior_plain(fi, src))]
        if r is not None:  # the strip kernel against its own fp32 chain: 0
            pairs.append(("strips", strips_k.strips(r[0], src), strips_k.strips_chain(r[0], src)))
        torch.cuda.synchronize()
        after = (fused_k.fused_interior.launches, strips_k.strips.launches)
        assert after == (before[0] + 1, before[1] + (r is not None)), (name, before, after)
        errs = {}
        for kname, got, ref in pairs:
            assert torch.isfinite(got).all(), (name, kname)
            err = err_of(got, ref, bits)
            assert err <= (0 if kname == "strips" else tol_of(op, bits)), (name, kname, err)
            errs[kname] = err
        print(f"[2] {name:28s} p=({plan.y.p},{plan.x.p}) q=({plan.y.q},{plan.x.q}) "
              f"fs={op.filter_size} strips_kernel={r is not None} "
              + " ".join(f"{k}_err={v:.3g}{'' if bits == 32 else ' LSB'}" for k, v in errs.items()))
        return errs, bits

    def check_strips(name, op, rng, frames_list=KERNEL_FRAMES):
        """The strip kernel on ``op``'s full-width strips at each frame count
        (fp32 sources) against ``strips_chain``, its sums in its own order
        (0), and against the float64 ``strips_plain`` (``f32_chain_bound``);
        returns the largest |kernel - strips_chain|."""
        plan = plan_phases(op)
        r = strips_k.make_strips(op, plan, dev)
        assert r is not None, (name, strips_k.verified_strips(op, plan)[1])
        st = r[0]
        worst = f64 = 0.0
        for frames in frames_list:
            src = rand_src(op, 32, rng, frames)
            before = counts()
            got = strips_k.strips(st, src)
            ref = strips_k.strips_chain(st, src)
            exact = strips_k.strips_plain(st, src)
            torch.cuda.synchronize()
            assert counts() == {**before, "strips": before["strips"] + 1}, (name, frames)
            assert torch.isfinite(got).all(), (name, frames)
            err = float((got - ref).abs().max())
            d64, bound = float((got - exact).abs().max()), f32_chain_bound(st, src)
            assert err == 0 and d64 <= bound, (name, frames, err, d64, bound)
            worst, f64 = max(worst, err), max(f64, d64)
            strips_f64.append((name, st.fs, frames, d64, bound))
        tail = st.nxb % strips_k.TILE or strips_k.TILE
        print(f"[2] {name:34s} strips rows (start, rows, band)={st.rows} p={st.px} q={st.qx} "
              f"fs={st.fs} {st.nxb} anchors a row (last column tile {tail} of "
              f"{strips_k.TILE}) F={list(frames_list)} max |err| {worst:.3g}; vs float64 "
              f"{f64:.3g} (f32_chain_bound {bound:.3g})")
        return worst

    def check_bf16_fused(name, op, rng, frames=2):
        """The fused kernel's bf16 mode against its plain form (tol_of: expect
        0, the fp32 mode's order on rounded operands) and against the fp32
        mode (bf16_bound), on fp32 sources; returns |bf16 kernel - plain|."""
        plan = plan_phases(op)
        fi = fused_k.make_fused_interior(op, plan, dev, "bf16")
        assert fi.bf16, name
        src = rand_src(op, 32, rng, frames)
        before = counts()
        got = fused_k.fused_interior(fi, src)
        ref = fused_k.fused_interior_plain(fi, src)
        torch.cuda.synchronize()
        assert counts() == {**before, "fused": before["fused"] + 1}, (name, before, counts())
        assert torch.isfinite(got).all(), name
        err = float((got - ref).abs().max())
        f32 = fused_k.fused_interior(fused_k.make_fused_interior(op, plan, dev), src)
        moved, bound = float((got - f32).abs().max()), fused_k.bf16_bound(op, float(src.max()))
        print(f"[2] {name:28s} fused bf16 mode fs={op.filter_size} shape="
              f"{fused_k.shape_name(fi.shape)} g={fi.g}: max |err| vs its plain form {err:.3g}, "
              f"vs the fp32 mode {moved:.3g} (bound {bound:.3g})")
        assert err <= tol_of(op, 32) and 0 < moved <= bound, (name, err, moved, bound)
        return err

    def check_interior(kind, name, op, bits, rng, frames=2, precision="fp32"):
        """The gather or seg kernel (seg: in its ``precision`` mode) against
        its plain form on ``op``."""
        if kind == "seg":
            plan = plan_phases_seg(op)
            assert plan is not None and seg_k.is_supported(op, plan), name
            tables = seg_k.make_seg_interior(op, plan, dev, precision)
            assert tables.bf16 == (precision == "bf16"), name
            plain = seg_k.seg_interior_plain
            info = (f"p=({plan.y.p},{plan.x.p}) q=({plan.y.q},{plan.x.q}) "
                    f"spread=({plan.y.spread},{plan.x.spread}) "
                    f"exc=({len(plan.y.exceptions)},{len(plan.x.exceptions)}) "
                    f"window={tables.win_h}x{tables.win_w} pairs={tables.pairs} "
                    f"frames<={tables.frames_per_block}")
        else:
            assert gather_k.is_supported(op), name
            tables = gather_k.make_gather_interior(op, dev)
            plain = gather_k.gather_interior_plain
            info = f"interior={tables.out_shape[1]}x{tables.out_shape[0]}"
        src = rand_src(op, bits, rng, frames)
        before = counts()
        got = wrappers[kind](tables, src)
        ref = plain(tables, src)
        torch.cuda.synchronize()
        assert counts() == {**before, kind: before[kind] + 1}, (name, before, counts())
        assert torch.isfinite(got).all(), name
        err = err_of(got, ref, bits)
        moved = ""
        if precision == "fp32":
            assert err == 0, (name, kind, err)  # both kernels sum in the plain form's order: exact
        else:  # the fp32 mode's limit (expect 0), and the fp32 mode within bf16_bound
            assert bits == 32 and err <= tol_of(op, bits), (name, kind, precision, err)
            f32 = wrappers[kind](seg_k.make_seg_interior(op, plan, dev), src)
            d, bound = float((got - f32).abs().max()), fused_k.bf16_bound(op, float(src.max()))
            assert 0 < d <= bound, (name, d, bound)
            moved = f", vs the fp32 mode {d:.3g} (bound {bound:.3g})"
        print(f"[2] {name:34s} {kind:6s} {info} classes={op.pair_blocks.shape[:2]} "
              f"fs={op.filter_size} F={frames} {precision} err={err:.3g}"
              f"{'' if bits == 32 else ' LSB'}{moved}")
        return err

    def check_band(name, op, n_rows, bits, rng, frames=2):
        """The band kernel against its plain form on every row shard of
        ``op`` over ``n_rows`` shards of the card; returns the largest error."""
        mesh = sharding.make_mesh(n_rows=n_rows, devices=[dev] * n_rows)
        built = sharding.make_sharded_apply_gather(op, mesh)
        assert built is not None, name
        fn, plan = built
        worst = 0.0
        src = rand_src(op, bits, rng, frames)
        for shard, band in zip(fn.shards[0], fn.bands(src)):
            if shard is None:
                continue
            gb = shard.tables
            shape = (frames, gb.rows, op.dst_width)
            before = counts()
            got = gather_k.gather_band(gb, band, torch.zeros(shape, device=dev))
            ref = gather_k.gather_band_plain(gb, band, torch.zeros(shape, device=dev))
            torch.cuda.synchronize()
            assert counts() == {**before, "gather_band": before["gather_band"] + 1}, name
            assert torch.isfinite(got).all(), name
            err = err_of(got, ref, bits)
            assert err == 0, (name, err)  # the plain form's order: exact
            worst = max(worst, err)
        print(f"[2] {name:34s} band   shards={n_rows} hops=({plan.hops_up},{plan.hops_dn}) "
              f"replicated={plan.replicate_src} fs={op.filter_size} F={frames} "
              f"err={worst:.3g}{'' if bits == 32 else ' LSB'}")
        return worst

    def check_shapes(name, op, rng, frames=2):
        """The fused kernel's narrow shape against the default on fp32
        sources, in the fp32 and the bf16 mode: the same sums in the same
        order, so 0."""
        errs = {}
        src = rand_src(op, 32, rng, frames)
        for precision in ("fp32", "bf16"):
            fi = fused_k.make_fused_interior(op, plan_phases(op), dev, precision)
            ref = fused_k.fused_interior(fi, src)
            for shape in fused_k.SHAPES[1:]:
                got = fused_k.fused_interior(fi, src, shape)
                errs[f"{fused_k.shape_name(shape)} {precision}"] = float((got - ref).abs().max())
        torch.cuda.synchronize()
        print(f"[2] {name:28s} fused shapes vs {fused_k.shape_name(fi.shape)} (smem "
              f"{fi.layout().smem_bytes} B, {fi.g} phases a block): max |err| {errs}")
        assert fi.shape == fused_k.DEFAULT_SHAPE and all(v == 0 for v in errs.values()), (name, errs)
        shapes_checked.append(name)

    def check_probe(shape, tile):
        """The out_only kernel against its plain form on a tensor filled
        with non-zeros; returns the max |err| (must be 0)."""
        buf = torch.full(shape, 7.0, device=dev)
        before = counts()
        probe.out_only(buf, tile)
        torch.cuda.synchronize()
        assert counts() == {**before, "out_only": before["out_only"] + 1}, shape
        err = float((buf - probe.out_only_plain(shape, dev)).abs().max())
        grid = -(-shape[1] // tile[0]) * -(-shape[2] // tile[1])
        print(f"[2] out_only {shape} tiles {tile} ({grid} blocks a frame): max |err| {err}")
        assert err == 0, (shape, err)
        return err

    def against_golden(name, fmt, r, cfg, sw, sh):
        """The whole applier through the public API (upload, dtype casts,
        fixups, assembly, finalize) against the host golden."""
        clip = Clip.from_frames([random_frame(fmt, sw, sh, seed=7)])
        got = r(clip).frames[0]
        want = JincResizer(fmt, sw, sh, replace(cfg, impl="numpy"), device=dev)(clip).frames[0]
        d = max(
            float(np.abs(got.planes[n].astype(np.float64) - want.planes[n].astype(np.float64)).max())
            for n in fmt.plane_names
        )
        assert d <= tol_of(r.op_luma, fmt.bits), (name, d)
        print(f"[2] {name:28s} jinc_resize vs host golden: max diff {d:.3g} ({r.engines})")

    rng = np.random.default_rng(2026)
    strips_f64 = []  # (plane, fs, F, |strip kernel - float64 plain form|, f32_chain_bound)
    # The bf16 modes of the fused and seg kernels are counted apart.
    max_err = dict.fromkeys([*wrappers, "fused_bf16", "seg_bf16"], 0.0)
    covered = dict.fromkeys(max_err, 0)
    shapes_checked = []
    for shape, tile in PROBE_SHAPES:
        max_err["out_only"] = max(max_err["out_only"], check_probe(shape, tile))
        covered["out_only"] += 1
    deep_err = dict.fromkeys(("fused", "strips"), 0.0)
    for name, sw, sh, dw, dh, tap, bits, kw in CASES:
        kw = dict(kw)
        fmt = {"420": yuv420p, "gray": gray}.get(kw.pop("fmt", None), yuv444p)(bits)
        cfg = JincConfig(target_width=dw, target_height=dh, tap=tap, operator_cache=False, **kw)
        r = JincResizer(fmt, sw, sh, cfg, device=dev)
        assert r.engines["luma"] == "fused", (name, r.engines)
        ops = [("luma", r.op_luma)] + ([("chroma", r.op_chroma)] if r.op_chroma else [])
        deep = r.op_luma.filter_size**2 > 1200
        for plane, op in ops:
            for b in sorted({bits, 32} if deep else {bits}):
                errs, _ = check_kernels(f"{name} {plane}", op, b, rng)
                for k, v in errs.items():
                    covered[k] += 1
                    if b == 32:
                        max_err[k] = max(max_err[k], v)
                        if deep:
                            deep_err[k] = max(deep_err[k], v)
        against_golden(name, fmt, r, cfg, sw, sh)
        err = check_bf16_fused(f"{name} luma", r.op_luma, rng)
        max_err["fused_bf16"] = max(max_err["fused_bf16"], err)
        covered["fused_bf16"] += 1
        if name in SHAPE_CASES:
            check_shapes(name, r.op_luma, rng)
        if name in STRIP_FRAME_CASES:
            # A second seed's sources too: the float64 readings move with the
            # data, the kernel's match with its own chain does not.
            for seed, g in (("", rng), (" seed 2027", np.random.default_rng(2027))):
                err = check_strips(f"{name} luma{seed}", r.op_luma, g)
                max_err["strips"] = max(max_err["strips"], err)
                covered["strips"] += 1

    for name, kind, sw, sh, dw, dh, tap in INTERIOR_CASES:
        cfg = JincConfig(target_width=dw, target_height=dh, tap=tap, impl=kind)
        r = JincResizer(gray(8), sw, sh, cfg, device=dev)
        assert r.engines == {"luma": {"seg": "fused-seg", "gather": "gather"}[kind]}, r.engines
        runs = [(32, f) for f in KERNEL_FRAMES] + [(8, 2)]
        for bits, frames in runs:
            err = check_interior(kind, name, r.op_luma, bits, rng, frames)
            covered[kind] += 1
            if bits == 32:
                max_err[kind] = max(max_err[kind], err)
        if kind == "seg":  # the bf16 mode's instances (frames a thread 1, 2, 4, 8)
            for frames in KERNEL_FRAMES:
                err = check_interior(kind, name, r.op_luma, 32, rng, frames, "bf16")
                covered["seg_bf16"] += 1
                max_err["seg_bf16"] = max(max_err["seg_bf16"], err)
        against_golden(name, gray(8), r, cfg, sw, sh)

    for name, sw, sh, dw, dh, tap, n_rows in BAND_CASES:
        op = build_plane_operator(sw, sh, dw, dh, radius_for_tap(tap))
        for bits, frames in [(32, f) for f in KERNEL_FRAMES] + [(8, 2)]:
            err = check_band(name, op, n_rows, bits, rng, frames)
            covered["gather_band"] += 1
            if bits == 32:
                max_err["gather_band"] = max(max_err["gather_band"], err)

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
    max_err["strips"] = max(max_err["strips"],
                            check_strips("3840x2160->7680x4320 tap8 luma", resizer.op_luma, rng))
    # The caller's matmul precision does not reach the port's fp32 results:
    # the 4K -> 8K fp32 luma plane under 'high' (TF32 matmuls) against the
    # default run, and the caller's setting is back after the call.
    f32_src = rand_src(resizer.op_luma, 32, rng, 2)
    want = resizer._applier_luma(f32_src)
    prec = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        got = resizer._applier_luma(f32_src)
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(prec)
    tf32_err = float((got - want).abs().max())
    print(f"[2] 3840x2160->7680x4320 tap8 fp32 luma under matmul precision 'high' vs the "
          f"default run: max |err| {tf32_err:.3g} (bound {F32_TOL:g})")
    assert tf32_err <= F32_TOL, tf32_err
    del f32_src, want, got

    # The deep-tap path: 4K -> 1080p tap 16 (fs = 65) on the same kernels.
    t0 = time.perf_counter()
    dclip = Clip.from_frames(
        [random_frame(fmt, DEEP[0], DEEP[1], seed=400 + i) for i in range(E2E_FRAMES)]
    )
    deep_cfg = JincConfig(DEEP[2], DEEP[3], tap=DEEP_TAP, operator_cache=False)
    deep_r = JincResizer(fmt, DEEP[0], DEEP[1], deep_cfg, frame0=dclip.frames[0], device=dev)
    print(f"[2] 4K->1080p tap16 resizer built in {time.perf_counter() - t0:.1f} s "
          f"(host operator build + upload); engines {deep_r.engines}")
    for bits in (32, 8):
        errs, _ = check_kernels("3840x2160->1920x1080 tap16 luma", deep_r.op_luma, bits, rng)
        for k, v in errs.items():
            covered[k] += 1
            if bits == 32:
                max_err[k] = max(max_err[k], v)
                deep_err[k] = max(deep_err[k], v)
    err = check_strips("3840x2160->1920x1080 tap16 luma", deep_r.op_luma, rng)
    max_err["strips"] = max(max_err["strips"], err)
    deep_err["strips"] = max(deep_err["strips"], err)
    print(f"[2] deep taps (fs**2 > 1200) on fp32 sources: max |fused kernel - plain form| "
          f"{deep_err['fused']:.3g} (bound {DEEP_TOL:g}), max |strip kernel - its fp32 chain| "
          f"{deep_err['strips']:.3g} (bound 0)")

    paths = {}
    for key, (sw, sh, dw, dh), seed in (("drift", DRIFT, 200), ("aperiodic", APERIODIC, 300)):
        t0 = time.perf_counter()
        pclip = Clip.from_frames([random_frame(fmt, sw, sh, seed=seed + i) for i in range(E2E_FRAMES)])
        pr = JincResizer(fmt, sw, sh, JincConfig(dw, dh, tap=TAP), frame0=pclip.frames[0], device=dev)
        print(f"[2] {sw}x{sh}->{dw}x{dh} tap8 resizer built in {time.perf_counter() - t0:.1f} s "
              f"(host operator build + upload); engines {pr.engines}")
        paths[key] = (pr, pclip)
        kinds = ("seg", "gather") if key == "drift" else ("gather",)
        for kind in kinds:
            err = check_interior(kind, f"{sw}x{sh}->{dw}x{dh} tap8 luma", pr.op_luma, 32, rng)
            covered[kind] += 1
            max_err[kind] = max(max_err[kind], err)
    sw, sh, dw, dh = APERIODIC
    for bits in (32, 8):
        err = check_band(f"{sw}x{sh}->{dw}x{dh} tap8 luma", paths["aperiodic"][0].op_luma,
                         N_SHARDS, bits, rng)
        covered["gather_band"] += 1
        if bits == 32:
            max_err["gather_band"] = max(max_err["gather_band"], err)

    # The deep drifted plane: 1440p -> 1080p tap 16 (fs = 44), the seg and
    # gather kernels at two frames (phase 4 holds the seg kernel to its plain
    # form on its 8-frame timing batch too).
    t0 = time.perf_counter()
    ddsw, ddsh, dddw, dddh = DEEP_DRIFT
    deep_drift_geo = f"{ddsw}x{ddsh}->{dddw}x{dddh}"
    ddclip = Clip.from_frames([random_frame(fmt, ddsw, ddsh, seed=700 + i) for i in range(E2E_FRAMES)])
    dd_cfg = JincConfig(dddw, dddh, tap=DEEP_TAP, operator_cache=False)
    deep_drift_r = JincResizer(fmt, ddsw, ddsh, dd_cfg, frame0=ddclip.frames[0], device=dev)
    print(f"[2] {deep_drift_geo} tap16 resizer built in {time.perf_counter() - t0:.1f} s "
          f"(host operator build + upload); engines {deep_drift_r.engines}")
    for kind in ("seg", "gather"):
        err = check_interior(kind, f"{deep_drift_geo} tap16 luma", deep_drift_r.op_luma, 32, rng)
        covered[kind] += 1
        max_err[kind] = max(max_err[kind], err)

    # The deep aperiodic plane: 4K -> 1366x768 tap 16 (fs = 92), the gather
    # kernel on two frames and the band kernel on its four row shards.
    t0 = time.perf_counter()
    dasw, dash, dadw, dadh = DEEP_APERIODIC
    deep_aper_geo = f"{dasw}x{dash}->{dadw}x{dadh}"
    aclip = Clip.from_frames([random_frame(fmt, dasw, dash, seed=600 + i) for i in range(E2E_FRAMES)])
    aper_cfg = JincConfig(dadw, dadh, tap=DEEP_TAP, operator_cache=False)
    deep_aper_r = JincResizer(fmt, dasw, dash, aper_cfg, frame0=aclip.frames[0], device=dev)
    print(f"[2] {deep_aper_geo} tap16 resizer built in {time.perf_counter() - t0:.1f} s "
          f"(host operator build + upload); engines {deep_aper_r.engines}")
    err = check_interior("gather", f"{deep_aper_geo} tap16 luma", deep_aper_r.op_luma, 32, rng)
    covered["gather"] += 1
    max_err["gather"] = max(max_err["gather"], err)
    err = check_band(f"{deep_aper_geo} tap16 luma", deep_aper_r.op_luma, N_SHARDS, 32, rng)
    covered["gather_band"] += 1
    max_err["gather_band"] = max(max_err["gather_band"], err)
    assert all(covered.values()), covered
    assert sorted(shapes_checked) == sorted(SHAPE_CASES), shapes_checked

    # The chain of phase 3: two 2x stages composed on the host into one
    # operator a plane, here, into a fresh cache directory (phase 3 loads
    # them). Their bottom strips step their window start from row to row;
    # the strip kernel on both composed planes against its plain form.
    (csw, csh), *chain_dst = CHAIN
    chain_geo = " -> ".join(f"{w}x{h}" for w, h in CHAIN)
    cclip = Clip.from_frames([random_frame(fmt, csw, csh, seed=500 + i) for i in range(2)])
    stages = [dict(target_width=w, target_height=h, tap=CHAIN_TAP) for w, h in chain_dst]
    (ROOT / "build").mkdir(exist_ok=True)
    chain_cache = tempfile.TemporaryDirectory(dir=ROOT / "build")
    old_cache = os.environ.get("JINCRESIZE_TORCH_CACHE_DIR")
    os.environ["JINCRESIZE_TORCH_CACHE_DIR"] = chain_cache.name
    t0 = time.perf_counter()
    cr = ChainResizer(fmt, csw, csh, [JincConfig(**st) for st in stages],
                      frame0=cclip.frames[0], device=dev)  # fmt: skip
    print(f"[2] chain {chain_geo} tap{CHAIN_TAP}: host composition "
          f"{time.perf_counter() - t0:.1f} s (stage operators built and composed); "
          f"composed fs luma {cr.op_luma.filter_size} chroma {cr.op_chroma.filter_size}; "
          f"engines {cr.engines}")
    assert cr.stages, "the first chain construction must compose"
    for plane, cop in (("luma", cr.op_luma), ("chroma", cr.op_chroma)):
        why = strips_k.verified_strips(cop, plan_phases(cop))[1]
        if why is not None:
            print(f"[2] chain {plane}: the strip kernel declines the composed plane: {why}")
            continue
        err = check_strips(f"chain {chain_geo} {plane}", cop, rng)
        max_err["strips"] = max(max_err["strips"], err)
    # The float32 chain's rounding against float64, by fs: its largest
    # reading and that reading's share of f32_chain_bound.
    for fs in sorted({r[1] for r in strips_f64}):
        name, _, frames, d64, bound = max((r for r in strips_f64 if r[1] == fs), key=lambda r: r[3])
        print(f"[2] strips fs={fs}: max |kernel - float64 plain form| {d64:.3g} ({name}, F={frames}), "
              f"{d64 / bound:.2%} of f32_chain_bound {bound:.3g}")

    # ---------------------------------------------------------------- phase 3
    print(f"[3] phase 3 starts at {time.perf_counter() - t_start:.1f} s")
    def oracle_check(tag, pclip, out, pr, sw, sh, dw, dh, tap=TAP, n_samples=ORACLE_SAMPLES):
        """<= 1 LSB against the scalar oracle on sampled pixels of frame 0."""
        radius = radius_for_tap(tap)
        srng = np.random.default_rng(7)
        for n in fmt.plane_names:
            pw, ph = fmt.plane_dims(n, dw, dh)
            sw_, sh_ = fmt.plane_dims(n, sw, sh)
            if n == "Y":
                crop = (0.0, 0.0, float(sw), float(sh))
            else:
                crop = chroma_crop(pr.cplace, sw, sh, dw, dh, 0.0, 0.0,
                                   float(sw), float(sh), fmt.sub_w, fmt.sub_h)
            nb = 24  # border band (covers every strip row/column at these sizes)
            ys = np.concatenate([
                srng.integers(0, ph, n_samples // 2),
                np.r_[srng.integers(0, nb, n_samples // 8), srng.integers(ph - nb, ph, n_samples // 8)],
                srng.integers(0, ph, n_samples // 4),
                [0, 0, ph - 1, ph - 1],
            ])  # fmt: skip
            xs = np.concatenate([
                srng.integers(0, pw, n_samples // 2),
                srng.integers(0, pw, n_samples // 4),
                np.r_[srng.integers(0, nb, n_samples // 8), srng.integers(pw - nb, pw, n_samples // 8)],
                [0, pw - 1, 0, pw - 1],
            ])  # fmt: skip
            t0 = time.perf_counter()
            vals, *_ = reference_sample_pixels(
                pclip.frames[0].planes[n], ys, xs, pw, ph, radius,
                crop_left=crop[0], crop_top=crop[1], crop_width=crop[2], crop_height=crop[3],
            )  # fmt: skip
            want = np.rint(np.clip(vals, 0, 255)).astype(np.int64)
            got = out.frames[0].planes[n][ys, xs].astype(np.int64)
            d = int(np.abs(got - want).max())
            print(f"[3] {tag}plane {n} ({sw_}x{sh_}->{pw}x{ph}): {len(ys)} oracle samples "
                  f"max diff {d} LSB ({time.perf_counter() - t0:.1f} s)")
            assert d <= 1, (tag, n, d)

    def against(what, out, ref, ref_name="plain (impl='xla') engine"):
        assert len(out.frames) == len(ref.frames), what
        d = 0
        for fo, fr in zip(out.frames, ref.frames):
            fo.validate()
            for n in fmt.plane_names:
                d = max(d, int(np.abs(fo.planes[n].astype(np.int64) - fr.planes[n].astype(np.int64)).max()))
        assert d <= 1, (what, ref_name, d)
        print(f"[3] {what} vs {ref_name} on the card: max {d} LSB over every plane")

    def conv_expect(r):
        """Launches of one call of a fused-engine resizer on every plane."""
        apps = [r._applier_chroma if n in ("U", "V") else r._applier_luma for n in fmt.plane_names]
        return {"fused": len(apps), "strips": sum(a.strips_spec is not None for a in apps)}

    fused_k.fused_interior_plain.calls = 0  # no engine may take the plain form in phase 3
    assert resizer.engines == {"luma": "fused", "chroma": "fused"}, resizer.engines
    n_planes = len(fmt.plane_names)
    expect = conv_expect(resizer)
    assert expect["strips"] > 0, "the strip kernel declined every 4K->8K plane"
    zero_counts()
    t0 = time.perf_counter()
    out = jinc_resize(clip, DST_W, DST_H, tap=TAP, device=DEVICE, operator_cache=False)
    torch.cuda.synchronize()
    launches = counts()
    print(f"[3] jinc_resize 4x 3840x2160 yuv420p8 -> 7680x4320 tap8 in "
          f"{time.perf_counter() - t0:.1f} s (construction included); launches {launches}")
    assert launches == {**dict.fromkeys(wrappers, 0), **expect}, (launches, expect)

    ref = jinc_resize(clip, DST_W, DST_H, tap=TAP, device=DEVICE, impl="xla", operator_cache=False)
    against("fused engine", out, ref)
    oracle_check("", clip, out, resizer, SRC_W, SRC_H, DST_W, DST_H)

    # The drifted and the aperiodic path, each through the resizer a caller
    # keeps (JincResizer.__call__), its kernel launched once per plane and no
    # other kernel launched.
    pouts = {}
    for key, engine, kind in (("drift", "fused-seg", "seg"), ("aperiodic", "gather", "gather")):
        pr, pclip = paths[key]
        sw, sh, dw, dh = DRIFT if key == "drift" else APERIODIC
        assert pr.engines == {"luma": engine, "chroma": engine}, pr.engines
        zero_counts()
        t0 = time.perf_counter()
        pout = pr(pclip)
        torch.cuda.synchronize()
        launches[kind] = counts()[kind]
        print(f"[3] JincResizer 4x {sw}x{sh} yuv420p8 -> {dw}x{dh} tap8 ({engine}) in "
              f"{time.perf_counter() - t0:.1f} s; launches {counts()}")
        assert counts() == {**dict.fromkeys(wrappers, 0), kind: n_planes}, counts()
        pref = JincResizer(fmt, sw, sh, replace(pr.cfg, impl="xla"), device=dev)(pclip)
        against(f"{engine} engine", pout, pref)
        oracle_check(f"{engine} ", pclip, pout, pr, sw, sh, dw, dh)
        pouts[key] = pout

    # The deep-tap path: 4K -> 1080p tap 16 through the resizer a caller
    # keeps, the fused and strip kernels launched as on the 4K -> 8K path.
    deep_geo = "{}x{}->{}x{}".format(*DEEP)
    assert deep_r.engines == {"luma": "fused", "chroma": "fused"}, deep_r.engines
    deep_expect = conv_expect(deep_r)
    zero_counts()
    t0 = time.perf_counter()
    dout = deep_r(dclip)
    torch.cuda.synchronize()
    got = counts()
    print(f"[3] JincResizer 4x {deep_geo} yuv420p8 tap16 (fused) in "
          f"{time.perf_counter() - t0:.1f} s; launches {got}")
    assert got == {**dict.fromkeys(wrappers, 0), **deep_expect}, (got, deep_expect)
    for k in deep_expect:
        launches[k] += got[k]
    dref = JincResizer(fmt, DEEP[0], DEEP[1], replace(deep_cfg, impl="xla"), device=dev)(dclip)
    against("deep-tap fused engine", dout, dref)
    oracle_check("tap16 fused ", dclip, dout, deep_r, *DEEP, tap=DEEP_TAP,
                 n_samples=DEEP_ORACLE_SAMPLES)
    del dref

    # The deep aperiodic path: 4K -> 1366x768 tap 16 through the resizer a
    # caller keeps, the gather kernel launched once a plane (the JAX
    # package's auto takes xla here).
    assert deep_aper_r.engines == {"luma": "gather", "chroma": "gather"}, deep_aper_r.engines
    zero_counts()
    t0 = time.perf_counter()
    aout = deep_aper_r(aclip)
    torch.cuda.synchronize()
    got = counts()
    print(f"[3] JincResizer 4x {deep_aper_geo} yuv420p8 tap16 (gather) in "
          f"{time.perf_counter() - t0:.1f} s; launches {got}")
    assert got == {**dict.fromkeys(wrappers, 0), "gather": n_planes}, got
    launches["gather"] += got["gather"]
    t0 = time.perf_counter()
    aref = JincResizer(fmt, dasw, dash, replace(aper_cfg, impl="xla"), device=dev)(aclip)
    torch.cuda.synchronize()
    print(f"[3] the same clip on impl='xla' in {time.perf_counter() - t0:.1f} s (construction included)")
    against("deep aperiodic gather engine", aout, aref)
    oracle_check("tap16 gather ", aclip, aout, deep_aper_r, *DEEP_APERIODIC, tap=DEEP_TAP,
                 n_samples=DEEP_APER_ORACLE_SAMPLES)
    del aref

    # The deep drifted path: 1440p -> 1080p tap 16 through the resizer a
    # caller keeps (impl 'auto'), the seg kernel launched once a plane (the
    # JAX package's envelope declines fs**2 > 1200 and its auto takes xla).
    assert deep_drift_r.engines == {"luma": "fused-seg", "chroma": "fused-seg"}, deep_drift_r.engines
    zero_counts()
    t0 = time.perf_counter()
    ddout = deep_drift_r(ddclip)
    torch.cuda.synchronize()
    got = counts()
    print(f"[3] JincResizer 4x {deep_drift_geo} yuv420p8 tap16 (auto: fused-seg) in "
          f"{time.perf_counter() - t0:.1f} s; launches {got}")
    assert got == {**dict.fromkeys(wrappers, 0), "seg": n_planes}, got
    launches["seg"] += got["seg"]
    t0 = time.perf_counter()
    ddref = JincResizer(fmt, ddsw, ddsh, replace(dd_cfg, impl="xla"), device=dev)(ddclip)
    torch.cuda.synchronize()
    print(f"[3] the same clip on impl='xla' in {time.perf_counter() - t0:.1f} s (construction included)")
    against("deep drifted fused-seg engine", ddout, ddref)
    oracle_check("tap16 fused-seg ", ddclip, ddout, deep_drift_r, *DEEP_DRIFT, tap=DEEP_TAP,
                 n_samples=DEEP_DRIFT_ORACLE_SAMPLES)
    del ddref

    # The sharded engine on N_SHARDS row shards of the card, through the
    # resizer a caller keeps: the aperiodic clip (band kernel), then two
    # frames of the periodic and the deep-tap (fused kernel), the drifted
    # (seg kernel) and the deep aperiodic (band kernel) clip.
    mesh = sharding.make_mesh(n_rows=N_SHARDS, devices=[dev] * N_SHARDS)
    sharded = {}
    for key, interior, kind, sclip, ref_out in (
        ("aperiodic", "gather", "gather_band", paths["aperiodic"][1], pouts["aperiodic"]),
        ("periodic", "conv-fused", "fused", Clip.from_frames(clip.frames[:2]),
         Clip.from_frames(out.frames[:2])),
        ("deep", "conv-fused", "fused", Clip.from_frames(dclip.frames[:2]),
         Clip.from_frames(dout.frames[:2])),
        ("drift", "seg", "seg", Clip.from_frames(paths["drift"][1].frames[:2]),
         Clip.from_frames(pouts["drift"].frames[:2])),
        ("deep-aperiodic", "gather", "gather_band", Clip.from_frames(aclip.frames[:2]),
         Clip.from_frames(aout.frames[:2])),
        ("deep-drift", "seg", "seg", Clip.from_frames(ddclip.frames[:2]),
         Clip.from_frames(ddout.frames[:2])),
    ):  # fmt: skip
        sw, sh, dw, dh = {"aperiodic": APERIODIC, "drift": DRIFT, "deep": DEEP,
                          "deep-aperiodic": DEEP_APERIODIC, "deep-drift": DEEP_DRIFT}.get(
                              key, (SRC_W, SRC_H, DST_W, DST_H))
        deep_key = key.startswith("deep")
        t0 = time.perf_counter()
        cfg = JincConfig(dw, dh, tap=DEEP_TAP if deep_key else TAP, impl="sharded",
                         operator_cache=not deep_key)  # no GB-sized cache file for one use
        sr = JincResizer(fmt, sw, sh, cfg, frame0=sclip.frames[0], device=dev, mesh=mesh)
        built = time.perf_counter() - t0
        assert sr.engines == {"luma": f"sharded/{interior}", "chroma": f"sharded/{interior}"}, sr.engines
        zero_counts()
        t0 = time.perf_counter()
        sout = sr(sclip)
        torch.cuda.synchronize()
        got = counts()
        print(f"[3] JincResizer {len(sclip.frames)}x {sw}x{sh} yuv420p8 -> {dw}x{dh} tap{cfg.tap} on "
              f"{N_SHARDS} row shards of {dev} (sharded/{interior}) in "
              f"{time.perf_counter() - t0:.1f} s (built in {built:.1f} s); launches {got}")
        assert got == {**dict.fromkeys(wrappers, 0), kind: N_SHARDS * n_planes}, got
        if kind in ("gather_band", "seg"):
            launches[kind] += got[kind]
        single = {"aperiodic": "gather", "drift": "fused-seg", "deep-aperiodic": "gather",
                  "deep-drift": "fused-seg"}.get(key, "fused")
        against(f"sharded/{interior} engine", sout, ref_out, f"single-card {single} engine")
        if key == "aperiodic":
            oracle_check("sharded/gather ", sclip, sout, sr, sw, sh, dw, dh)
        sharded[key] = sr

    n_cards = torch.cuda.device_count()
    if n_cards > 1:
        cards = [torch.device("cuda", i) for i in range(n_cards)][:N_SHARDS]
        sw, sh, dw, dh = APERIODIC
        cfg = JincConfig(dw, dh, tap=TAP, impl="sharded")
        mr = JincResizer(fmt, sw, sh, cfg, device=dev, mesh=sharding.make_mesh(devices=cards))
        mout = mr(paths["aperiodic"][1])
        torch.cuda.synchronize()
        against(f"sharded/gather on {len(cards)} cards", mout, pouts["aperiodic"],
                "single-card gather engine")
    else:
        print("[3] one visible card: the mesh of distinct cards was not run")

    zeros = dict.fromkeys(wrappers, 0)

    # precision='bf16' (the documented non-parity mode): the 4K -> 8K clip
    # through a resizer a caller keeps (the fused kernel in its bf16 mode,
    # the strips in fp32), then two frames of the drifted clip on one card
    # and on N_SHARDS row shards (the seg kernel in its bf16 mode). Every
    # launch counted here is a bf16 launch: each applier's tables are
    # asserted bf16. Each output is held to the fp32 run within bf16_lsb.
    def bf16_within(what, got_clip, f32_clip, r):
        d = {}
        for fo, ff in zip(got_clip.frames, f32_clip.frames):
            fo.validate()
            for n in fmt.plane_names:
                diff = np.abs(fo.planes[n].astype(np.int64) - ff.planes[n].astype(np.int64)).max()
                d[n] = max(d.get(n, 0), int(diff))
        bound = {n: fused_k.bf16_lsb(r.op_chroma if n in ("U", "V") else r.op_luma, 255.0)
                 for n in fmt.plane_names}  # fmt: skip
        print(f"[3] {what} vs the fp32 run: max LSB {d} (bound {bound})")
        assert all(d[n] <= bound[n] for n in d), (what, d, bound)

    t0 = time.perf_counter()
    bf_r = JincResizer(fmt, SRC_W, SRC_H, replace(big_cfg, precision="bf16"),
                       frame0=clip.frames[0], device=dev)  # fmt: skip
    built = time.perf_counter() - t0
    bf_apps = (bf_r._applier_luma, bf_r._applier_chroma)
    assert bf_r.engines == {"luma": "fused", "chroma": "fused"}, bf_r.engines
    assert all(a.effective_precision == "bf16" and a.fi.bf16 for a in bf_apps)
    bf_expect = conv_expect(bf_r)
    zero_counts()
    t0 = time.perf_counter()
    bf_out = bf_r(clip)
    torch.cuda.synchronize()
    got = counts()
    print(f"[3] JincResizer 4x {SRC_W}x{SRC_H} yuv420p8 -> {DST_W}x{DST_H} tap{TAP} "
          f"precision='bf16' (fused, effective_precision bf16) in {time.perf_counter() - t0:.1f} s "
          f"(built in {built:.1f} s); launches {got}")
    assert got == {**zeros, **bf_expect}, (got, bf_expect)
    launches["fused_bf16"] = got["fused"]
    bf16_within("bf16 fused engine", bf_out, out, bf_r)
    del bf_out, bf_apps

    dsw, dsh, ddw, ddh = DRIFT
    bclip = Clip.from_frames(paths["drift"][1].frames[:2])
    bf_seg_r = JincResizer(fmt, dsw, dsh, JincConfig(ddw, ddh, tap=TAP, precision="bf16"),
                           frame0=bclip.frames[0], device=dev)  # fmt: skip
    assert bf_seg_r.engines == {"luma": "fused-seg", "chroma": "fused-seg"}, bf_seg_r.engines
    for a in (bf_seg_r._applier_luma, bf_seg_r._applier_chroma):
        assert a.effective_precision == "bf16" and a.si.bf16
    zero_counts()
    bseg_out = bf_seg_r(bclip)
    torch.cuda.synchronize()
    got = counts()
    print(f"[3] JincResizer 2x {dsw}x{dsh} yuv420p8 -> {ddw}x{ddh} tap{TAP} precision='bf16' "
          f"(fused-seg): launches {got}")
    assert got == {**zeros, "seg": n_planes}, got
    launches["seg_bf16"] = got["seg"]
    bf16_within("bf16 fused-seg engine", bseg_out, Clip.from_frames(pouts["drift"].frames[:2]),
                bf_seg_r)  # fmt: skip
    t0 = time.perf_counter()
    bf_sh = JincResizer(fmt, dsw, dsh, JincConfig(ddw, ddh, tap=TAP, impl="sharded", precision="bf16"),
                        frame0=bclip.frames[0], device=dev, mesh=mesh)  # fmt: skip
    built = time.perf_counter() - t0
    assert bf_sh.engines == {"luma": "sharded/seg", "chroma": "sharded/seg"}, bf_sh.engines
    for a in (bf_sh._applier_luma, bf_sh._applier_chroma):
        assert a.effective_precision == "bf16"
        assert all(s.tables is None or s.tables.bf16 for s in a._fn.shards[0] if s is not None)
    zero_counts()
    t0 = time.perf_counter()
    bsh_out = bf_sh(bclip)
    torch.cuda.synchronize()
    got = counts()
    print(f"[3] JincResizer 2x {dsw}x{dsh} yuv420p8 -> {ddw}x{ddh} tap{TAP} precision='bf16' on "
          f"{N_SHARDS} row shards of {dev} (sharded/seg) in {time.perf_counter() - t0:.1f} s "
          f"(built in {built:.1f} s); launches {got}")
    assert got == {**zeros, "seg": N_SHARDS * n_planes}, got
    launches["seg_bf16"] += got["seg"]
    against("sharded/seg bf16 engine", bsh_out, bseg_out, "single-card fused-seg bf16 engine")
    del bsh_out, bseg_out, bf_sh, bclip

    # The chain composed in phase 2: jinc_resize_chain loads the composed
    # operators from the cache and is held to the same composed operators on
    # impl='xla'.
    try:
        assert cr.engines == {"luma": "fused", "chroma": "fused"}, cr.engines
        cexpect = conv_expect(cr)
        assert cexpect["strips"] > 0, "the strip kernel declined both composed chain planes"
        zero_counts()
        t0 = time.perf_counter()
        cout = jinc_resize_chain(cclip, stages, device=DEVICE)
        torch.cuda.synchronize()
        got = counts()
        print(f"[3] jinc_resize_chain 2x {chain_geo} yuv420p8 tap{CHAIN_TAP} in "
              f"{time.perf_counter() - t0:.1f} s (composed operators loaded); launches {got}")
        assert got == {**zeros, **cexpect}, (got, cexpect)
        launches["strips"] += got["strips"]
        cref = ChainResizer(fmt, csw, csh, [JincConfig(**st, impl="xla") for st in stages],
                            frame0=cclip.frames[0], device=dev)  # fmt: skip
        assert not cref.stages, "the reference chain must load the composed operators"
        against("chain (fused engine)", cout, cref(cclip),
                "the same composed operators on impl='xla'")
    finally:
        if old_cache is None:
            del os.environ["JINCRESIZE_TORCH_CACHE_DIR"]
        else:
            os.environ["JINCRESIZE_TORCH_CACHE_DIR"] = old_cache
        chain_cache.cleanup()
    chain_st, chain_op = cr._applier_luma.strips_spec, cr.op_luma  # timed in phase 4
    del cr, cref, cout, cclip

    # The CLI on the first two frames of the 4K clip, in this process
    # (launches counted) and as ``python -m jincresize_tpu_torch``: both must
    # write the API's output of phase 3, bit for bit.
    torch.cuda.empty_cache()  # room for the second process
    api_out = {n: np.stack([f.planes[n] for f in out.frames[:2]]) for n in fmt.plane_names}
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as cdir:
        cdir = Path(cdir)
        np.savez(cdir / "in.npz", _props=np.array(json.dumps(clip.frames[0].props)),
                 **{n: np.stack([f.planes[n] for f in clip.frames[:2]]) for n in fmt.plane_names})
        flags = ["--width", str(DST_W), "--height", str(DST_H), "--tap", str(TAP), "--no-cache"]
        zero_counts()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main([str(cdir / "in.npz"), str(cdir / "main.npz"), *flags])
        torch.cuda.synchronize()
        got = counts()
        print(f"[3] cli.main 2x {SRC_W}x{SRC_H} -> {DST_W}x{DST_H} tap{TAP} .npz in "
              f"{time.perf_counter() - t0:.1f} s: rc {rc}; launches {got}")
        assert rc == 0 and got == {**zeros, **expect}, (rc, got, expect)
        t0 = time.perf_counter()
        sub = subprocess.run(
            [sys.executable, "-m", "jincresize_tpu_torch", str(cdir / "in.npz"),
             str(cdir / "sub.npz"), *flags],
            cwd=ROOT, capture_output=True, text=True, timeout=600,
        )  # fmt: skip
        print(f"[3] python -m jincresize_tpu_torch in {time.perf_counter() - t0:.1f} s: "
              f"rc {sub.returncode}")
        assert sub.returncode == 0, sub.stderr[-4000:]
        for tag, line, name in (("cli.main", buf.getvalue(), "main.npz"),
                                ("python -m jincresize_tpu_torch", sub.stdout, "sub.npz")):
            line = line.strip().splitlines()[-1]
            with np.load(cdir / name) as z:
                d = max(int(np.abs(z[n].astype(np.int64) - api_out[n].astype(np.int64)).max())
                        for n in fmt.plane_names)  # fmt: skip
            print(f"[3] {tag}: {line!r}; max {d} LSB against jinc_resize")
            assert "engines: luma=fused,chroma=fused" in line and d == 0, (tag, line, d)
    del api_out

    # The entry points of entry.py: the one-card step against the host golden, and the
    # mesh dry run on four shards of the card against the host golden.
    zero_counts()
    efn, (esrc,) = entry_mod.entry()
    eout = efn(esrc)
    torch.cuda.synchronize()
    got = counts()
    sw, sh, dw, dh, tap = entry_mod.STEP
    ewant = apply_plane_numpy(build_plane_operator(sw, sh, dw, dh, radius_for_tap(tap)),
                              esrc.cpu().numpy())  # fmt: skip
    eerr = float(np.abs(eout.cpu().numpy() - ewant).max())
    print(f"[3] entry() {sw}x{sh} -> {dw}x{dh} tap{tap}: out {tuple(eout.shape)} max |err| "
          f"{eerr:.3g} against the host golden; launches {got}")
    assert tuple(eout.shape) == (dh, dw) and eerr <= F32_TOL, eerr
    assert got["fused"] == 1 and got == {**zeros, "fused": 1, "strips": got["strips"]}, got
    zero_counts()
    mout = entry_mod.dryrun_multichip(N_SHARDS, devices=[dev] * N_SHARDS)
    got = counts()
    sw, sh, dw, dh, tap = entry_mod.DRYRUN
    mop = build_plane_operator(sw, sh, dw, dh, radius_for_tap(tap))
    msrc = np.random.default_rng(0).random((mout.shape[0], sh, sw), dtype=np.float32)
    merr = max(float(np.abs(mout[i].cpu().numpy() - apply_plane_numpy(mop, msrc[i])).max())
               for i in range(mout.shape[0]))  # fmt: skip
    print(f"[3] dryrun_multichip({N_SHARDS}) on {N_SHARDS} shards of {dev}: out "
          f"{tuple(mout.shape)} max |err| {merr:.3g} against the host golden; launches {got}")
    assert merr <= F32_TOL and sum(got.values()) > 0, (merr, got)
    plain_calls = fused_k.fused_interior_plain.calls
    print(f"[3] fused_interior_plain called {plain_calls} times in phase 3")
    assert plain_calls == 0, plain_calls

    # ---------------------------------------------------------------- phase 4
    print(f"[4] phase 4 starts at {time.perf_counter() - t_start:.1f} s")
    def e2e(tag, pr, pclip, plane_px, split_too=True):
        """End-to-end ms/frame of ``pr(pclip)`` and where a call's time goes:
        the per-plane steps of JincResizer's batched path, each closed by a
        synchronise (host clock, summed over planes; not for ``impl='xla'``,
        which has no applier, when ``split_too`` is False)."""
        times = []
        for i in range(4):
            t0 = time.perf_counter()
            pr(pclip)
            torch.cuda.synchronize()
            if i:  # first call is warm-up
                times.append(time.perf_counter() - t0)
        e2e_ms = statistics.median(times) * 1000 / E2E_FRAMES
        split = {"stack+upload": [], "device": [], "download": []}
        for _ in range(3 if split_too else 0):
            acc = dict.fromkeys(split, 0.0)
            for n in fmt.plane_names:
                _, _, plane_app = pr._plane_op(n)
                t0 = time.perf_counter()
                t = torch.from_numpy(np.stack([f.planes[n] for f in pclip.frames])).to(dev)
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
        if split_too:
            print(f"[4] {tag}split per frame: " + ", ".join(
                f"{k} {statistics.median(v) * 1000 / E2E_FRAMES:.2f} ms" for k, v in split.items()
            ) + f" [{card}]")  # fmt: skip
        print(f"[4] {tag}end to end (upload + 3 planes + download) {e2e_ms:.2f} ms/frame, "
              f"{plane_px / e2e_ms / 1e6:.3f} Gpx/s luma [{card}]")
        return e2e_ms

    def plain_once(fn):
        """(fn(), its CUDA-event ms): one call of a slow plain form."""
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        b.synchronize()
        return out, a.elapsed_time(b)

    def conv2d_interior(fi, src, kernels=None):
        """The one PyTorch call that computes the fused interior: cuDNN's
        strided conv2d of the phase kernels (``build_conv_kernels``, or
        ``kernels``, of ``src``'s dtype; TF32 off), with the plain form's
        slice and the phase interleave."""
        F, H, W = src.shape
        kernels = fi.kernels if kernels is None else kernels
        nph, Kh, Kw = kernels.shape
        eh, ew = (fi.nyb - 1) * fi.qy + Kh, (fi.nxb - 1) * fi.qx + Kw
        pad = (0, max(0, fi.base_x + ew - W), 0, max(0, fi.base_y + eh - H))
        lhs = torch.nn.functional.pad(src, pad)[:, fi.base_y : fi.base_y + eh, fi.base_x : fi.base_x + ew]
        conv = torch.nn.functional.conv2d(lhs[:, None], kernels[:, None], stride=(fi.qy, fi.qx))
        return (conv.view(F, fi.py, fi.px, fi.nyb, fi.nxb).permute(0, 3, 1, 4, 2)
                .reshape(F, fi.py * fi.nyb, fi.px * fi.nxb))  # fmt: skip

    def fused_bound(fi, src):
        """(ms, by) of the fused interior on ``src``: 2 fs**2 flops per
        output pixel (at the bf16 peak in the bf16 mode); the source, the
        weights and the output once."""
        out_px = src.shape[0] * fi.out_shape[0] * fi.out_shape[1]
        return bound_ms(2 * fi.fs**2 * out_px, tensor_bytes(src, fi, skip=("kernels",)) + 4 * out_px,
                        PEAK_BF16_FLOPS if fi.bf16 else PEAK_FP32_FLOPS)  # fmt: skip

    card = card_line()

    def run_tool(mod, argv, kernels):
        """One tool's ``main`` in this process, its stdout echoed, the launch
        counts set to 0 before and read after; every kernel in ``kernels``
        must have been launched. Returns (result, launches)."""
        name = mod.__name__.rsplit(".", 1)[1]
        zero_counts()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            res = mod.main(argv)
        torch.cuda.synchronize()
        got = counts()
        for line in buf.getvalue().splitlines():
            print(f"[4] {name}: {line}")
        print(f"[4] {name} {' '.join(argv)} ({time.perf_counter() - t0:.1f} s): launches {got}")
        assert all(got[k] > 0 for k in kernels), (name, kernels, got)
        return res, got

    reps = ["--reps", str(TOOL_REPS)]
    # device_loop_timing is the probe kernel's main path.
    _, got = run_tool(device_loop_timing, reps, ("out_only", "fused", "strips"))
    launches["out_only"] = got["out_only"]
    sweep, _ = run_tool(fused_tile_sweep, reps, ("fused",))
    assert all(v["err"] == 0 for v in sweep.values()), sweep
    run_tool(assemble_breakdown, reps, ("fused", "strips"))
    res, _ = run_tool(bench_gather, ["--geometry", "4k", "--impl", "seg", "--check", "--iters", "1"],
                      ("seg",))  # fmt: skip
    assert res["engine"] == "fused-seg" and res["check_lsb"] <= 1, res
    res, _ = run_tool(bench_gather, ["--geometry", "4k", "--impl", "gather", "--iters", "1"],
                      ("gather",))  # fmt: skip
    assert res["engine"] == "gather", res
    res, _ = run_tool(streaming_pipeline, [], ("fused",))
    assert res["value"] > 0, res

    # One 4-frame 4K -> 8K call of the resizer a caller keeps, under
    # torch.profiler: where the call's device time goes.
    resizer(clip)
    torch.cuda.synchronize()
    with metrics.device_trace(str(ROOT / "build" / "trace")):
        resizer(clip)
        torch.cuda.synchronize()
    trace = ROOT / "build" / "trace" / "trace.json"
    ops = metrics.device_time_by_op(trace)
    busy, span = metrics.device_busy(trace)
    print(f"[4] torch.profiler: one JincResizer call, {E2E_FRAMES}x {SRC_W}x{SRC_H} yuv420p8 -> "
          f"{DST_W}x{DST_H} tap{TAP}: {busy:.3f} ms of device operations in "
          f"{sum(n for _, n in ops.values())} launches over a {span:.3f} ms span "
          f"(device idle {1 - busy / span:.1%} of it) [{card}]")
    for name, (t, n) in list(ops.items())[:10]:
        print(f"[4]   {t:10.3f} ms {n:4d}x  {name[:110]}")
    htod = sum(t for name, (t, _) in ops.items() if "HtoD" in name)
    dtoh = sum(t for name, (t, _) in ops.items() if "DtoH" in name)
    print(f"[4]   memcpy HtoD {htod:.3f} ms, DtoH {dtoh:.3f} ms, the rest "
          f"{busy - htod - dtoh:.3f} ms [{card}]")
    assert htod > 0 and dtoh > 0 and any("fused_interior" in k for k in ops), list(ops)[:10]
    # The same for one 4-frame 4K -> 1080p tap-16 call: the deep path's
    # device time by operation.
    deep_r(dclip)
    torch.cuda.synchronize()
    with metrics.device_trace(str(ROOT / "build" / "trace_tap16")):
        deep_r(dclip)
        torch.cuda.synchronize()
    trace = ROOT / "build" / "trace_tap16" / "trace.json"
    ops = metrics.device_time_by_op(trace)
    busy, span = metrics.device_busy(trace)
    print(f"[4] torch.profiler: one JincResizer call, {E2E_FRAMES}x {DEEP[0]}x{DEEP[1]} yuv420p8 -> "
          f"{DEEP[2]}x{DEEP[3]} tap{DEEP_TAP}: {busy:.3f} ms of device operations in "
          f"{sum(n for _, n in ops.values())} launches over a {span:.3f} ms span "
          f"(device idle {1 - busy / span:.1%} of it) [{card}]")
    for name, (t, n) in list(ops.items())[:10]:
        print(f"[4]   {t:10.3f} ms {n:4d}x  {name[:110]}")
    htod = sum(t for name, (t, _) in ops.items() if "HtoD" in name)
    dtoh = sum(t for name, (t, _) in ops.items() if "DtoH" in name)
    print(f"[4]   memcpy HtoD {htod:.3f} ms, DtoH {dtoh:.3f} ms, the rest "
          f"{busy - htod - dtoh:.3f} ms [{card}]")
    assert any("strips_kernel" in k for k in ops), list(ops)[:10]

    def bf16_mode(key, geo, op, err_key, run, plain, run32, src):
        """The bf16 mode ``key + '_bf16'`` on an 8-frame fp32 batch, its time
        (``ms``) taken beside the fp32 mode's (``key``) in the same turns:
        its plain form once (``plain_once``), |kernel - plain| (tol_of:
        expect 0) and |kernel - fp32 mode| (bf16_bound), its share of its
        bound (the bf16 tensor-core peak or bytes), then of the fp32 mode's
        (the fp32-FMA peak or bytes) and, for the fused kernel, cuDNN's bf16
        conv2d."""
        ref, ms[f"{key}_bf16_plain"] = plain_once(plain)
        got = run()
        err = float((got - ref).abs().max())
        moved, bound = float((got - run32()).abs().max()), fused_k.bf16_bound(op, float(src.max()))
        del ref, got
        t16, t32, (b, by) = ms[f"{key}_bf16"], ms[key], bounds[f"{key}_bf16"]
        b32, by32 = bounds[key]
        lib = ms.get(f"{key}_bf16_conv2d")
        print(f"[4] {key} bf16 mode {geo}: {t16 / TIMING_FRAMES:.4f} ms/frame, fp32 mode "
              f"{t32 / TIMING_FRAMES:.4f} (bf16/fp32 {t16 / t32:.3f}), bound {b / TIMING_FRAMES:.4f} "
              f"({by}, bf16 at {PEAK_BF16_FLOPS / 1e12:g} TFLOP/s), {b / t16:.1%} of it; "
              f"fp32-FMA bound {b32 / TIMING_FRAMES:.4f} ({by32}): bf16 mode {b32 / t16:.1%}, "
              f"fp32 mode {b32 / t32:.1%} of it; plain form "
              f"{ms[f'{key}_bf16_plain'] / TIMING_FRAMES:.3f} ms/frame"
              + (f", bf16 cuDNN conv2d {lib / TIMING_FRAMES:.4f} ms/frame (kernel {t16 / lib:.3f}x "
                 f"its time)" if lib is not None else "")
              + f"; max |err| vs its plain form {err:.3g}, vs the fp32 mode {moved:.3g} "
              f"(bound {bound:.3g}) [{card}]")  # fmt: skip
        assert err <= tol_of(op, 32) and 0 < moved <= bound, (key, err, moved, bound)
        max_err[err_key] = max(max_err[err_key], err)
        covered[err_key] += 1

    app = resizer._applier_luma
    tsrc = torch.from_numpy(
        rng.random((TIMING_FRAMES, SRC_H, SRC_W), dtype=np.float32)
    ).to(dev)
    px_out = TIMING_FRAMES * DST_W * DST_H
    strips_ws = strips_conv1d_weights(app.strips_spec)
    # The bf16 mode of the same plane, and cuDNN's conv2d on bf16 tensors
    # (its output is bf16: its time is the yardstick, not its numbers).
    fi16 = fused_k.make_fused_interior(resizer.op_luma, plan_phases(resizer.op_luma), dev, "bf16")
    tsrc16, k16 = tsrc.to(torch.bfloat16), fi16.kernels.to(torch.bfloat16)
    ms = {}
    for _ in range(2):  # plain, kernel, kernel, plain -- twice
        for k, fn in (
            ("fused_plain", lambda: fused_k.fused_interior_plain(app.fi, tsrc)),
            ("fused", lambda: fused_k.fused_interior(app.fi, tsrc)),
            ("fused_bf16", lambda: fused_k.fused_interior(fi16, tsrc)),
            ("fused_bf16_conv2d", lambda: conv2d_interior(fi16, tsrc16, k16)),
            ("fused_conv2d", lambda: conv2d_interior(app.fi, tsrc)),
            ("strips", lambda: strips_k.strips(app.strips_spec, tsrc)),
            ("strips_plain", lambda: strips_k.strips_plain(app.strips_spec, tsrc)),
            ("strips_conv1d", lambda: strips_conv1d(app.strips_spec, tsrc, strips_ws)),
        ):
            iters = 3 if k.endswith("plain") else 20
            ms.setdefault(k, []).append(cuda_ms(fn, iters))
    ms = {k: statistics.median(v) for k, v in ms.items()}
    for k in ("fused", "fused_plain", "fused_conv2d", "fused_bf16", "fused_bf16_conv2d", "strips",
              "strips_plain", "strips_conv1d"):
        print(f"[4] {k:13s} {ms[k]:10.3f} ms per {TIMING_FRAMES}-frame fp32 4K->8K luma "
              f"batch ({ms[k] / TIMING_FRAMES:.3f} ms/frame) [{card}]")
    lib_err = {"4K->8K tap8": float(
        (conv2d_interior(app.fi, tsrc) - fused_k.fused_interior(app.fi, tsrc)).abs().max()
    )}  # fmt: skip
    strips_lib_err = {"4K->8K tap8": float((strips_conv1d(app.strips_spec, tsrc, strips_ws)
                                            - strips_k.strips(app.strips_spec, tsrc)).abs().max())}
    bounds = {"fused": fused_bound(app.fi, tsrc), "strips": strips_bound(app.strips_spec, tsrc)}
    for k, (b, by) in bounds.items():
        print(f"[4] {k} bound {b:.3f} ms per batch ({by}): kernel at {b / ms[k]:.1%} of it [{card}]")
    bounds["fused_bf16"] = fused_bound(fi16, tsrc)
    bf16_mode("fused", "4K->8K tap8", resizer.op_luma, "fused_bf16",
              lambda: fused_k.fused_interior(fi16, tsrc),
              lambda: fused_k.fused_interior_plain(fi16, tsrc),
              lambda: fused_k.fused_interior(app.fi, tsrc), tsrc)  # fmt: skip
    del tsrc, tsrc16, k16, fi16
    e2e("", resizer, clip, DST_W * DST_H)
    print(f"[4] interior kernel {px_out / ms['fused'] / 1e6:.2f} Gpx/s "
          f"(output px / kernel time) [{card}]")

    # The deep-tap path: both kernels, their plain forms and cuDNN's conv2d
    # on an 8-frame fp32 4K -> 1080p tap-16 luma batch, then end to end.
    dapp = deep_r._applier_luma
    tsrc_deep = torch.from_numpy(
        rng.random((TIMING_FRAMES, DEEP[1], DEEP[0]), dtype=np.float32)
    ).to(dev)
    dfi16 = fused_k.make_fused_interior(deep_r.op_luma, plan_phases(deep_r.op_luma), dev, "bf16")
    dsrc16, dk16 = tsrc_deep.to(torch.bfloat16), dfi16.kernels.to(torch.bfloat16)
    deep_runs = [
        ("deep_fused_plain", lambda: fused_k.fused_interior_plain(dapp.fi, tsrc_deep)),
        ("deep_fused", lambda: fused_k.fused_interior(dapp.fi, tsrc_deep)),
        ("deep_fused_bf16", lambda: fused_k.fused_interior(dfi16, tsrc_deep)),
        ("deep_fused_bf16_conv2d", lambda: conv2d_interior(dfi16, dsrc16, dk16)),
        ("deep_fused_conv2d", lambda: conv2d_interior(dapp.fi, tsrc_deep)),
    ]
    deep_ws = strips_conv1d_weights(dapp.strips_spec)
    deep_runs += [
        ("deep_strips", lambda: strips_k.strips(dapp.strips_spec, tsrc_deep)),
        ("deep_strips_plain", lambda: strips_k.strips_plain(dapp.strips_spec, tsrc_deep)),
        ("deep_strips_conv1d", lambda: strips_conv1d(dapp.strips_spec, tsrc_deep, deep_ws)),
    ]
    deep_ms = {}
    for order in (deep_runs, deep_runs[::-1]):  # plain, kernel, ..., kernel, plain
        for k, fn in order:
            deep_ms.setdefault(k, []).append(cuda_ms(fn, 3 if k.endswith("plain") else 10))
    deep_ms = {k: statistics.median(v) for k, v in deep_ms.items()}
    ms.update(deep_ms)
    deep_bounds = {"deep_fused": fused_bound(dapp.fi, tsrc_deep),
                   "deep_strips": strips_bound(dapp.strips_spec, tsrc_deep)}
    bounds.update(deep_bounds)
    for k, _ in deep_runs:
        print(f"[4] {k:17s} {deep_ms[k]:10.3f} ms per {TIMING_FRAMES}-frame fp32 {deep_geo} tap16 "
              f"luma batch ({deep_ms[k] / TIMING_FRAMES:.3f} ms/frame) [{card}]")
    for k, (b, by) in deep_bounds.items():
        print(f"[4] {k} bound {b:.3f} ms per batch ({by}): kernel at {b / deep_ms[k]:.1%} of it [{card}]")
    print(f"[4] deep-tap interior kernel "
          f"{TIMING_FRAMES * DEEP[2] * DEEP[3] / deep_ms['deep_fused'] / 1e6:.2f} Gpx/s, "
          f"cuDNN conv2d takes {deep_ms['deep_fused_conv2d'] / deep_ms['deep_fused']:.3f}x the "
          f"kernel's time [{card}]")
    lib_err["4K->1080p tap16"] = float(
        (conv2d_interior(dapp.fi, tsrc_deep) - fused_k.fused_interior(dapp.fi, tsrc_deep)).abs().max()
    )
    strips_lib_err["4K->1080p tap16"] = float(
        (strips_conv1d(dapp.strips_spec, tsrc_deep, deep_ws)
         - strips_k.strips(dapp.strips_spec, tsrc_deep)).abs().max())  # fmt: skip
    bounds["deep_fused_bf16"] = fused_bound(dfi16, tsrc_deep)
    bf16_mode("deep_fused", f"{deep_geo} tap16", deep_r.op_luma, "fused_bf16",
              lambda: fused_k.fused_interior(dfi16, tsrc_deep),
              lambda: fused_k.fused_interior_plain(dfi16, tsrc_deep),
              lambda: fused_k.fused_interior(dapp.fi, tsrc_deep), tsrc_deep)  # fmt: skip
    del tsrc_deep, deep_ws, dfi16, dsrc16, dk16
    e2e(f"fused {deep_geo} tap16 ", deep_r, dclip, DEEP[2] * DEEP[3])
    for geo, k in (("4K->8K tap8", "fused"), (f"{deep_geo} tap16", "deep_fused")):
        print(f"[4] fused interior {geo}: {ms[k] / TIMING_FRAMES:.4f} ms/frame, "
              f"{bounds[k][0] / ms[k]:.1%} of its bound, {ms[k] / ms[k + '_conv2d']:.4f}x "
              f"cuDNN conv2d's time in this run [{card}]")
    # The strip kernel on the chain's composed luma plane (its bottom strip's
    # rows step their window start), an 8-frame fp32 batch.
    tsrc_c = torch.from_numpy(
        rng.random((TIMING_FRAMES, chain_op.src_height, chain_op.src_width), dtype=np.float32)
    ).to(dev)
    chain_ws = strips_conv1d_weights(chain_st)
    chain_runs = [("chain_strips_plain", lambda: strips_k.strips_plain(chain_st, tsrc_c)),
                  ("chain_strips", lambda: strips_k.strips(chain_st, tsrc_c)),
                  ("chain_strips_conv1d", lambda: strips_conv1d(chain_st, tsrc_c, chain_ws))]
    for order in (chain_runs, chain_runs[::-1]):
        for k, fn in order:
            ms.setdefault(k, []).append(cuda_ms(fn, 3 if k.endswith("plain") else 10))
    for k, _ in chain_runs:
        ms[k] = statistics.median(ms[k])
    bounds["chain_strips"] = strips_bound(chain_st, tsrc_c)
    strips_lib_err["chain luma"] = float(
        (strips_conv1d(chain_st, tsrc_c, chain_ws) - strips_k.strips(chain_st, tsrc_c)).abs().max())
    del tsrc_c, chain_ws
    for geo, k in (("4K->8K tap8", "strips"), (f"{deep_geo} tap16", "deep_strips"),
                   (f"chain {chain_geo} composed luma", "chain_strips")):
        b = bounds[k][0]
        print(f"[4] strips {geo}: {ms[k] / TIMING_FRAMES:.4f} ms/frame, bound "
              f"{b / TIMING_FRAMES:.4f} ({bounds[k][1]}), {b / ms[k]:.1%} of it, plain form "
              f"{ms[k + '_plain'] / TIMING_FRAMES:.4f}, conv1d (TF32 off) "
              f"{ms[k + '_conv1d'] / TIMING_FRAMES:.4f} ms/frame, kernel "
              f"{ms[k] / ms[k + '_conv1d']:.3f}x conv1d's time in this run [{card}]")

    # The full-size 2/3 plan (p=(2,2), q=(3,3), fs=49): the fused kernel
    # once against its plain form on an 8-frame fp32 4K -> 1440p tap-16 batch.
    op23 = build_plane_operator(DEEP[0], DEEP[1], *THIRDS, radius_for_tap(DEEP_TAP))
    plan23 = plan_phases(op23)
    fi23 = fused_k.make_fused_interior(op23, plan23, dev)
    tsrc23 = torch.from_numpy(rng.random((TIMING_FRAMES, DEEP[1], DEEP[0]), dtype=np.float32)).to(dev)
    err23 = float((fused_k.fused_interior(fi23, tsrc23)
                   - fused_k.fused_interior_plain(fi23, tsrc23)).abs().max())  # fmt: skip
    ms23 = cuda_ms(lambda: fused_k.fused_interior(fi23, tsrc23), 10)
    b23, by23 = fused_bound(fi23, tsrc23)
    print(f"[4] fused interior {DEEP[0]}x{DEEP[1]}->{THIRDS[0]}x{THIRDS[1]} tap16 p=({plan23.y.p},"
          f"{plan23.x.p}) q=({plan23.y.q},{plan23.x.q}) fs={op23.filter_size}: "
          f"{ms23 / TIMING_FRAMES:.4f} ms/frame, bound {b23 / TIMING_FRAMES:.4f} ({by23}), "
          f"{b23 / ms23:.1%} of it, max |err| vs plain {err23} [{card}]")
    assert err23 == 0, err23
    del tsrc23, fi23

    # The new paths: each kernel and its plain form on its own path's luma
    # plane, the gather kernel on the drifted plane too, and the two
    # appliers on the drifted plane (is seg before gather the right order?).
    drift_r, aper_r = paths["drift"][0], paths["aperiodic"][0]
    seg_app = drift_r._applier_luma
    gather_app = GatherApplier(drift_r.op_luma, device=dev)
    gi_aper = aper_r._applier_luma.gi
    tsrc_d = torch.from_numpy(
        rng.random((TIMING_FRAMES, DRIFT[1], DRIFT[0]), dtype=np.float32)
    ).to(dev)
    tsrc_a = torch.from_numpy(
        rng.random((TIMING_FRAMES, APERIODIC[1], APERIODIC[0]), dtype=np.float32)
    ).to(dev)
    si16 = bf_seg_r._applier_luma.si  # the bf16 mode's tables (phase 3)
    runs = (
        ("seg_plain", lambda: seg_k.seg_interior_plain(seg_app.si, tsrc_d)),
        ("seg", lambda: seg_k.seg_interior(seg_app.si, tsrc_d)),
        ("seg_bf16", lambda: seg_k.seg_interior(si16, tsrc_d)),
        ("gather_drift", lambda: gather_k.gather_interior(gather_app.gi, tsrc_d)),
        ("seg_applier", lambda: seg_app(tsrc_d)),
        ("gather_applier", lambda: gather_app(tsrc_d)),
        ("gather", lambda: gather_k.gather_interior(gi_aper, tsrc_a)),
        ("gather_plain", lambda: gather_k.gather_interior_plain(gi_aper, tsrc_a)),
    )
    new_ms = {}
    for order in (runs, runs[::-1]):  # plain, kernel, ..., kernel, plain
        for k, fn in order:
            new_ms.setdefault(k, []).append(cuda_ms(fn, 3 if k.endswith("plain") else 10))
    new_ms = {k: statistics.median(v) for k, v in new_ms.items()}
    ms.update(new_ms)
    drift_geo = "{}x{}->{}x{}".format(*DRIFT)
    aper_geo = "{}x{}->{}x{}".format(*APERIODIC)
    for k, _ in runs:
        geo = aper_geo if k in ("gather", "gather_plain") else drift_geo
        prev = f"; previous kernel: {PREV_MS_PER_FRAME[k]}" if k in PREV_MS_PER_FRAME else ""
        print(f"[4] {k:15s} {new_ms[k]:10.3f} ms per {TIMING_FRAMES}-frame fp32 {geo} luma "
              f"batch ({new_ms[k] / TIMING_FRAMES:.4f} ms/frame{prev}) [{card}]")
    print(f"[4] on the {drift_geo} plane the seg applier takes "
          f"{new_ms['seg_applier'] / new_ms['gather_applier']:.3f}x the gather applier's time "
          f"(seg interior {new_ms['seg'] / new_ms['gather_drift']:.3f}x gather interior) [{card}]")
    # The band kernel and its plain form on each row shard of the same
    # aperiodic batch, summed over the shards.
    sfn = sharded["aperiodic"]._applier_luma._fn
    shard_runs = []
    for shard, band in zip(sfn.shards[0], sfn.bands(tsrc_a)):
        canvas = torch.zeros((TIMING_FRAMES, shard.r1 - shard.r0, APERIODIC[2]), device=dev)
        shard_runs.append((shard.tables, band, canvas))
    band_ms = {"gather_band": [], "gather_band_plain": []}
    for k in ("gather_band_plain", "gather_band", "gather_band", "gather_band_plain"):
        fn = gather_k.gather_band_plain if k.endswith("plain") else gather_k.gather_band
        band_ms[k].append(sum(cuda_ms(lambda a=a: fn(*a), 3 if k.endswith("plain") else 10)
                              for a in shard_runs))
    for k, v in band_ms.items():
        ms[k] = statistics.median(v)
        prev = f"; previous kernel: {PREV_MS_PER_FRAME[k]}" if k in PREV_MS_PER_FRAME else ""
        print(f"[4] {k:17s} {ms[k]:10.3f} ms per {TIMING_FRAMES}-frame fp32 {aper_geo} luma "
              f"batch, summed over {N_SHARDS} row shards ({ms[k] / TIMING_FRAMES:.4f} ms/frame"
              f"{prev}) [{card}]")
    print(f"[4] band kernel over {N_SHARDS} shards takes {ms['gather_band'] / ms['gather']:.3f}x "
          f"the single-card gather kernel on the same batch [{card}]")

    def gather_like_bound(tables, src, rows, cols):
        """(ops, bytes) of a gather-family launch: 2 fs**2 flops a pixel;
        its source (or band), its tables and its output once."""
        out_px = src.shape[0] * rows * cols
        return 2 * tables.fs**2 * out_px, tensor_bytes(src, tables) + 4 * out_px

    def seg_bound(si, src):
        """(ms, by) of a seg launch: 2 fs**2 flops a pixel (at the bf16 peak
        in the bf16 mode); its source, the kernel's tables (not the plain
        form's) and its output once."""
        out_px = src.shape[0] * si.out_shape[0] * si.out_shape[1]
        plain_only = ("pair_blocks_t", "cls_y", "cls_x", "roff_y", "roff_x")
        return bound_ms(2 * si.fs**2 * out_px, tensor_bytes(src, si, skip=plain_only) + 4 * out_px,
                        PEAK_BF16_FLOPS if si.bf16 else PEAK_FP32_FLOPS)  # fmt: skip

    bounds["gather"] = bound_ms(*gather_like_bound(gi_aper, tsrc_a, *gi_aper.out_shape))
    bounds["seg"] = seg_bound(seg_app.si, tsrc_d)
    gi_drift = gather_app.gi
    bounds["gather_drift"] = bound_ms(*gather_like_bound(gi_drift, tsrc_d, *gi_drift.out_shape))
    band_work = [gather_like_bound(gb, band, gb.syl.numel(), gb.start_x.numel())
                 for gb, band, _ in shard_runs]  # fmt: skip
    bounds["gather_band"] = bound_ms(sum(o for o, _ in band_work), sum(b for _, b in band_work))
    for k in ("gather", "seg", "gather_band"):
        b, by = bounds[k]
        print(f"[4] {k} bound {b:.3f} ms per batch ({by}): kernel at {b / ms[k]:.1%} of it [{card}]")
    bounds["seg_bf16"] = seg_bound(si16, tsrc_d)
    bf16_mode("seg", f"{drift_geo} tap8", drift_r.op_luma, "seg_bf16",
              lambda: seg_k.seg_interior(si16, tsrc_d),
              lambda: seg_k.seg_interior_plain(si16, tsrc_d),
              lambda: seg_k.seg_interior(seg_app.si, tsrc_d), tsrc_d)  # fmt: skip
    del tsrc_d, tsrc_a, gather_app, shard_runs, si16, bf_seg_r

    # The deep aperiodic plane: the gather kernel and the band kernel (its
    # four row shards, summed) on an 8-frame fp32 4K -> 1366x768 tap-16 luma
    # batch beside their bounds. Each plain form runs once (2-3 s a call at
    # fs = 92), timed by events, and its output holds the kernel's (0).
    dgi = deep_aper_r._applier_luma.gi
    tsrc_da = torch.from_numpy(rng.random((TIMING_FRAMES, dash, dasw), dtype=np.float32)).to(dev)
    ms["deep_gather"] = cuda_ms(lambda: gather_k.gather_interior(dgi, tsrc_da), 10)
    ref, ms["deep_gather_plain"] = plain_once(lambda: gather_k.gather_interior_plain(dgi, tsrc_da))
    err = float((gather_k.gather_interior(dgi, tsrc_da) - ref).abs().max())
    print(f"[4] {deep_aper_geo} tap16 luma gather F={TIMING_FRAMES} (phase 4 batch): "
          f"max |err| {err} against the plain form")
    assert err == 0, err
    del ref
    sfn_d = sharded["deep-aperiodic"]._applier_luma._fn
    deep_band_ms, deep_band_plain_ms, deep_band_err, deep_band_work = 0.0, 0.0, 0.0, []
    for shard, band in zip(sfn_d.shards[0], sfn_d.bands(tsrc_da)):
        gb = shard.tables
        shape = (TIMING_FRAMES, gb.rows, dadw)
        canvas = torch.zeros(shape, device=dev)
        deep_band_ms += cuda_ms(lambda: gather_k.gather_band(gb, band, canvas), 10)
        ref, t = plain_once(lambda: gather_k.gather_band_plain(gb, band, torch.zeros(shape, device=dev)))
        deep_band_plain_ms += t
        deep_band_err = max(deep_band_err, float((gather_k.gather_band(gb, band, canvas) - ref).abs().max()))
        deep_band_work.append(gather_like_bound(gb, band, gb.rows, gb.start_x.numel()))
    print(f"[4] {deep_aper_geo} tap16 luma band F={TIMING_FRAMES} on {N_SHARDS} shards (phase 4 "
          f"batch): max |err| {deep_band_err} against the plain form")
    assert deep_band_err == 0, deep_band_err
    ms["deep_gather_band"], ms["deep_gather_band_plain"] = deep_band_ms, deep_band_plain_ms
    bounds["deep_gather"] = bound_ms(*gather_like_bound(dgi, tsrc_da, *dgi.out_shape))
    bounds["deep_gather_band"] = bound_ms(sum(o for o, _ in deep_band_work),
                                          sum(b for _, b in deep_band_work))  # fmt: skip
    for k in ("deep_gather", "deep_gather_plain", "deep_gather_band", "deep_gather_band_plain"):
        print(f"[4] {k:22s} {ms[k]:10.3f} ms per {TIMING_FRAMES}-frame fp32 {deep_aper_geo} tap16 "
              f"luma batch ({ms[k] / TIMING_FRAMES:.4f} ms/frame) [{card}]")
    for k in ("deep_gather", "deep_gather_band"):
        b, by = bounds[k]
        print(f"[4] {k} bound {b:.3f} ms per batch ({by}), {b / TIMING_FRAMES:.4f} ms/frame: kernel "
              f"at {b / ms[k]:.1%} of it [{card}]")
    for k in ("gather", "gather_band"):
        b, _ = bounds[k]
        print(f"[4] {k} {aper_geo} tap8: {ms[k] / TIMING_FRAMES:.4f} ms/frame, {b / ms[k]:.1%} of "
              f"its bound, {PREV_MS_PER_FRAME[k] / (ms[k] / TIMING_FRAMES):.2f}x faster than the previous kernel's "
              f"{PREV_MS_PER_FRAME[k]} [{card}]")
    del tsrc_da, dgi, sfn_d

    # The deep drifted plane: the seg and gather kernels on an 8-frame fp32
    # 1440p -> 1080p tap-16 luma batch beside their bounds (the seg plain
    # form once, its output held to the kernel's: 0); then both drifted
    # planes side by side, with the previous seg kernel's time.
    dd_si = deep_drift_r._applier_luma.si
    dd_gi = GatherApplier(deep_drift_r.op_luma, device=dev).gi
    tsrc_dd = torch.from_numpy(rng.random((TIMING_FRAMES, ddsh, ddsw), dtype=np.float32)).to(dev)
    dd_runs = (("deep_seg", lambda: seg_k.seg_interior(dd_si, tsrc_dd)),
               ("deep_gather_drift", lambda: gather_k.gather_interior(dd_gi, tsrc_dd)))  # fmt: skip
    dd_ms = {}
    for order in (dd_runs, dd_runs[::-1]):  # seg, gather, gather, seg
        for k, fn in order:
            dd_ms.setdefault(k, []).append(cuda_ms(fn, 10))
    ms.update({k: statistics.median(v) for k, v in dd_ms.items()})
    ref, ms["deep_seg_plain"] = plain_once(lambda: seg_k.seg_interior_plain(dd_si, tsrc_dd))
    err = float((seg_k.seg_interior(dd_si, tsrc_dd) - ref).abs().max())
    print(f"[4] {deep_drift_geo} tap16 luma seg F={TIMING_FRAMES} (phase 4 batch): "
          f"max |err| {err} against the plain form")
    assert err == 0, err
    del ref
    bounds["deep_seg"] = seg_bound(dd_si, tsrc_dd)
    bounds["deep_gather_drift"] = bound_ms(*gather_like_bound(dd_gi, tsrc_dd, *dd_gi.out_shape))
    for geo, tap, sk, gk, si, gi in ((drift_geo, 8, "seg", "gather_drift", seg_app.si, gi_drift),
                                     (deep_drift_geo, 16, "deep_seg", "deep_gather_drift", dd_si, dd_gi)):
        (bs, bys), (bg, byg) = bounds[sk], bounds[gk]
        prev = f"; previous seg kernel {PREV_SEG_MS_PER_FRAME}" if sk == "seg" else ""
        print(f"[4] {geo} tap{tap} fs={si.fs} 8-frame fp32 luma: seg interior "
              f"{ms[sk] / TIMING_FRAMES:.4f} ms/frame ({si.out_shape[1]}x{si.out_shape[0]}), bound "
              f"{bs / TIMING_FRAMES:.4f} ({bys}), {bs / ms[sk]:.1%} of it, plain form "
              f"{ms[sk + '_plain'] / TIMING_FRAMES:.3f}{prev}; gather interior "
              f"{ms[gk] / TIMING_FRAMES:.4f} ms/frame ({gi.out_shape[1]}x{gi.out_shape[0]}), bound "
              f"{bg / TIMING_FRAMES:.4f} ({byg}), {bg / ms[gk]:.1%} of it [{card}]")
        print(f"[4] {geo} tap{tap}: seg interior takes {ms[sk] / ms[gk]:.3f}x the gather "
              f"interior's time in this run [{card}]")
    print(f"[4] seg interior {drift_geo} tap8: {PREV_SEG_MS_PER_FRAME / (ms['seg'] / TIMING_FRAMES):.2f}x "
          f"faster than the previous kernel's {PREV_SEG_MS_PER_FRAME} [{card}]")
    del tsrc_dd, dd_gi, gi_drift
    for key, engine in (("drift", "fused-seg"), ("aperiodic", "gather")):
        pr, pclip = paths[key]
        sw, sh, dw, dh = DRIFT if key == "drift" else APERIODIC
        e2e(f"{engine} {sw}x{sh}->{dw}x{dh} ", pr, pclip, dw * dh)
    e2e(f"fused-seg (auto) {deep_drift_geo} tap16 ", deep_drift_r, ddclip, dddw * dddh)
    sw, sh, dw, dh = APERIODIC
    pr, pclip = paths["aperiodic"]
    tag = f"{sw}x{sh}->{dw}x{dh} "
    e_single = e2e(f"gather {tag}(again, beside sharded) ", pr, pclip, dw * dh)
    e_sharded = e2e(f"sharded/gather {N_SHARDS} shards {tag}", sharded["aperiodic"], pclip, dw * dh)
    print(f"[4] sharded/gather end to end takes {e_sharded / e_single:.3f}x the single-card "
          f"gather engine on the same clip [{card}]")
    # The deep aperiodic clip under auto (gather) beside impl='xla', the
    # engine that auto took before the gather kernel took deep taps.
    e_auto = e2e(f"gather (auto) {deep_aper_geo} tap16 ", deep_aper_r, aclip, dadw * dadh)
    xla_r = JincResizer(fmt, dasw, dash, replace(aper_cfg, impl="xla"), device=dev)
    e_xla = e2e(f"xla {deep_aper_geo} tap16 ", xla_r, aclip, dadw * dadh, split_too=False)
    print(f"[4] {deep_aper_geo} tap16 end to end: auto (gather) {e_auto:.2f} ms/frame, "
          f"impl='xla' {e_xla:.2f} ms/frame ({e_xla / e_auto:.2f}x) [{card}]")
    del xla_r

    # The bench twin in its three modes and the default one under
    # --precision bf16, in this process, at 2 queued calls.
    for mode in ([], ["--downscale"], ["--tap16-downscale"], ["--precision", "bf16"]):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            res = bench.main([*mode, "--iters", "2"])
        assert json.loads(buf.getvalue().strip().splitlines()[-1]) == res, buf.getvalue()
        assert res["engine"] == "fused" and res["value"] > 0, res
        want = "bf16" if "bf16" in mode else "fp32"
        assert res["precision"] == res["effective_precision"] == want, res
        print(f"[4] python -m jincresize_tpu_torch.bench {' '.join(mode)} --iters 2 "
              f"({time.perf_counter() - t0:.1f} s): {json.dumps(res)}")

    # The probe on an 8-frame 4K -> 8K output batch beside its bound (the
    # output's bytes once) and torch.zeros of the same shape (a memset), in
    # one order and then the other. A sample is
    # PROBE_REPS back-to-back calls between two events: the device's time,
    # not the host's launch (ctypes and PyTorch's dispatcher differ there;
    # device_loop_timing measures that cost).
    pbuf = torch.empty((TIMING_FRAMES, DST_H, DST_W), device=dev)
    probe_runs = [
        ("out_only_plain", lambda: probe.out_only_plain(pbuf.shape, dev)),
        ("out_only", lambda: probe.out_only(pbuf)),
        ("torch.zeros", lambda: torch.zeros(pbuf.shape, device=dev)),
    ]
    probe_ms = {}
    for i, order in enumerate((probe_runs, probe_runs[::-1])):
        got = {k: cuda_ms(fn, 7, reps=PROBE_REPS) for k, fn in order}
        for k, v in got.items():
            probe_ms.setdefault(k, []).append(v)
        print(f"[4] probe order {i + 1}: " + ", ".join(f"{k} {v:.4f}" for k, v in got.items())
              + f" ms per {tuple(pbuf.shape)} batch; out_only / torch.zeros "
              f"{got['out_only'] / got['torch.zeros']:.4f} [{card}]")
    for k, v in probe_ms.items():
        ms[k] = statistics.median(v)
    bounds["out_only"] = bound_ms(0, pbuf.numel() * pbuf.element_size())
    b, by = bounds["out_only"]
    print(f"[4] out_only {ms['out_only']:.4f} ms per {tuple(pbuf.shape)} "
          f"batch ({ms['out_only'] / TIMING_FRAMES:.4f} ms/frame), plain form "
          f"{ms['out_only_plain']:.4f} ms, torch.zeros {ms['torch.zeros']:.4f} ms; bound {b:.4f} ms "
          f"({by}): kernel at {b / ms['out_only']:.1%} of it [{card}]")
    del pbuf

    # cuDNN's conv2d (TF32 off) against the kernel, checked after every
    # number is printed.
    for k, v in lib_err.items():
        print(f"[4] cuDNN conv2d vs fused kernel at {k}: max |err| {v:.3g} (bound {DEEP_TOL:g})")
    assert all(v <= DEEP_TOL for v in lib_err.values()), lib_err
    for k, v in strips_lib_err.items():
        print(f"[4] conv1d vs strips kernel at {k}: max |err| {v:.3g} (bound {DEEP_TOL:g})")
    assert all(v <= DEEP_TOL for v in strips_lib_err.values()), strips_lib_err

    print(f"[4] phases 1-4 took {time.perf_counter() - t_start:.1f} s")

    # ---------------------------------------------------------------- phase 5
    print(f"[5] phase 5 starts at {time.perf_counter() - t_start:.1f} s")
    torch.cuda.empty_cache()  # the workers share the card
    dist_phase(card)
    print(f"[5] phases 1-5 took {time.perf_counter() - t_start:.1f} s")
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
            "bound_ms": bounds["fused"][0],
            "bound_by": bounds["fused"][1],
            "library_ms": ms["fused_conv2d"],
        },
        {
            "name": "fused_interior[bf16]",
            "route": "cuda",
            "source": "jincresize_tpu_torch/csrc/fused_interior.cu",
            "replaces": "jincresize_tpu/kernels/pallas_fused.py:235",
            "launches": launches["fused_bf16"],
            "max_abs_err": max_err["fused_bf16"],
            "ms": ms["fused_bf16"],
            "plain_ms": ms["fused_bf16_plain"],
            "bound_ms": bounds["fused_bf16"][0],
            "bound_by": bounds["fused_bf16"][1],
            "library_ms": ms["fused_bf16_conv2d"],
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
            "bound_ms": bounds["strips"][0],
            "bound_by": bounds["strips"][1],
            "library_ms": ms["strips_conv1d"],
        },
        {
            "name": "gather_interior",
            "route": "cuda",
            "source": "jincresize_tpu_torch/csrc/gather_interior.cu",
            "replaces": "jincresize_tpu/kernels/pallas_gather.py:137",
            "launches": launches["gather"],
            "max_abs_err": max_err["gather"],
            "ms": ms["gather"],
            "plain_ms": ms["gather_plain"],
            "bound_ms": bounds["gather"][0],
            "bound_by": bounds["gather"][1],
            "library_ms": None,
        },
        {
            "name": "seg_interior",
            "route": "cuda",
            "source": "jincresize_tpu_torch/csrc/seg_interior.cu",
            "replaces": "jincresize_tpu/kernels/pallas_fused_seg.py:318",
            "launches": launches["seg"],
            "max_abs_err": max_err["seg"],
            "ms": ms["seg"],
            "plain_ms": ms["seg_plain"],
            "bound_ms": bounds["seg"][0],
            "bound_by": bounds["seg"][1],
            "library_ms": None,
        },
        {
            "name": "seg_interior[bf16]",
            "route": "cuda",
            "source": "jincresize_tpu_torch/csrc/seg_interior.cu",
            "replaces": "jincresize_tpu/kernels/pallas_fused_seg.py:397",
            "launches": launches["seg_bf16"],
            "max_abs_err": max_err["seg_bf16"],
            "ms": ms["seg_bf16"],
            "plain_ms": ms["seg_bf16_plain"],
            "bound_ms": bounds["seg_bf16"][0],
            "bound_by": bounds["seg_bf16"][1],
            "library_ms": None,
        },
        {
            "name": "gather_band",
            "route": "cuda",
            "source": "jincresize_tpu_torch/csrc/gather_band.cu",
            "replaces": "jincresize_tpu/kernels/pallas_gather.py:306",
            "launches": launches["gather_band"],
            "max_abs_err": max_err["gather_band"],
            "ms": ms["gather_band"],
            "plain_ms": ms["gather_band_plain"],
            "bound_ms": bounds["gather_band"][0],
            "bound_by": bounds["gather_band"][1],
            "library_ms": None,
        },
        {
            "name": "out_only",
            "route": "cuda",
            "source": "jincresize_tpu_torch/csrc/out_only.cu",
            "replaces": "tools/profiling/device_loop_timing.py:47",
            "launches": launches["out_only"],
            "max_abs_err": max_err["out_only"],
            "ms": ms["out_only"],
            "plain_ms": ms["out_only_plain"],
            "bound_ms": bounds["out_only"][0],
            "bound_by": bounds["out_only"][1],
            "library_ms": ms["torch.zeros"],
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
    if sys.argv[1:2] == ["--dist-worker"]:
        sys.exit(dist_worker(int(sys.argv[2]), int(sys.argv[3])))
    sys.exit(main())
