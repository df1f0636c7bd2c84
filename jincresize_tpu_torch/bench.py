"""Benchmark: Jinc256 (tap 8) 4K->8K fp32 Y-plane throughput of the port on one card.

The twin of the root ``bench.py`` ``main()`` (the JAX package's headline
program), with the same modes, metric names and baseline:

    python -m jincresize_tpu_torch.bench                      # 3840x2160 -> 7680x4320 tap 8
    python -m jincresize_tpu_torch.bench --downscale          # 3840x2160 -> 1920x1080 tap 8 (fs 33)
    python -m jincresize_tpu_torch.bench --tap16-downscale    # 3840x2160 -> 1920x1080 tap 16 (fs 65)
    python -m jincresize_tpu_torch.bench --device cpu --small # control flow only, on the CPU
    python -m jincresize_tpu_torch.bench --scaling            # nnz/s over 1, 2, 4, 8 row shards

Flags: ``--small`` (the JAX bench's reduced sizes), ``--frames`` (default 32,
one resident batch), ``--iters`` (queued calls of the dispatch path),
``--impl {auto,conv,xla,pallas,seg,gather}`` (the API's engine selectors;
``auto`` is ``api._select_engine``'s rule), ``--precision`` (``bf16``: the
documented non-parity mode, the fused and seg interiors on bfloat16-rounded
operands; the metric names stay the JAX bench's) and ``--device`` (default
``cuda``; raises when no card is visible, never falls back). The operator is
built each run (seconds with the native builder), not taken from the
operator cache as the JAX bench does: a 4K -> 1080p tap-16 operator holds
1.6 GB of border-strip blocks, and the cache only saves start-up time.

Timing: device time from CUDA events around ``R`` back-to-back applier calls
on a resident batch (the twin of the JAX bench's on-device ``fori_loop``);
the dispatch path from ``iters`` queued calls and one synchronise. On
``--device cpu`` both are host-clock times of the CPU's plain forms, which
say nothing of a card: the JSON's ``device`` key names what ran.

``--scaling`` is the twin of the root bench's ``scaling_main``: 480x272 ->
960x544 tap 3 on ``F = max(2, min(frames, 4))`` frames, the single-card
engine at k = 1 and a ``ShardedApplier`` on ``k`` row shards of the one
device at k = 2, 4 and 8, each timed over 3 calls after a warm-up (CUDA
events; the host clock on ``--device cpu``). Its last stdout line has the
root harness's keys (``metric``, ``value`` = nnz/s at the largest k over k
times nnz/s at k = 1, ``unit``, ``vs_baseline`` = value / 0.9, ``per_k``,
``mode``, ``mesh_scaling_like_engine``, ``note``), also written to
``$JINCRESIZE_SCALING_OUT`` when that is set. Its shards share one device
and run one after another, so it shows the sharded engine's overhead, not
scaling (``mode`` says ``serial-shards-one-card`` or ``serial-shards-cpu``);
it runs in one process.

Prints diagnostics on stderr, each naming the engine, its interior and the
card (``nvidia-smi`` name and power limit), and as the last line of stdout
ONE JSON object ``{"metric", "value", "unit", "vs_baseline", "engine",
"precision", "effective_precision", "device"}``: ``effective_precision`` is
the engine's (``'fp32'`` where the engine has no precision mode).
``vs_baseline`` is computed as the JAX bench computes it: against the
reference's analytic AVX-512 per-socket bar (``BASELINE.md``), scaled to the
geometry's padded MAC cost for the downscales.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from . import apply_xla
from .api import _select_engine
from .operator import build_plane_operator, radius_for_tap

# Analytic AVX-512 per-socket-equivalent bar (root bench.py, BASELINE.md §2).
BASELINE_PX_PER_S = 7680 * 4320 * (1.54e12 / 18.05e9)
# Applier calls per CUDA-event window (the JAX bench's fori_loop count).
R = 4
# What each engine runs on a card.
INTERIORS = {
    "fused": "csrc/fused_interior.cu + csrc/strips.cu",
    "fused-seg": "csrc/seg_interior.cu",
    "gather": "csrc/gather_interior.cu",
    "xla": "plain torch gather-MAC (no kernel)",
}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m jincresize_tpu_torch.bench")
    ap.add_argument("--small", action="store_true", help="reduced size (CI/dev)")
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--downscale", action="store_true", help="4K->1080p tap 8 (fs 33)")
    ap.add_argument(
        "--tap16-downscale", action="store_true", help="4K->1080p tap 16 (fs 65, fs^2 = 4225)"
    )
    ap.add_argument(
        "--impl", default="auto", choices=["auto", "conv", "xla", "pallas", "seg", "gather"]
    )
    ap.add_argument("--precision", default="fp32", choices=["fp32", "bf16"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument(
        "--scaling", action="store_true", help="nnz/s over 1, 2, 4 and 8 row shards of the device"
    )
    return ap.parse_args(argv)


def geometry(args) -> tuple[int, int, int, int, int]:
    """(src_w, src_h, dst_w, dst_h, tap) of the mode, as in the root bench."""
    if args.tap16_downscale or args.downscale:
        tap = 16 if args.tap16_downscale else 8
        return (1920, 1080, 960, 540, tap) if args.small else (3840, 2160, 1920, 1080, tap)
    return (960, 540, 1920, 1080, 8) if args.small else (3840, 2160, 7680, 4320, 8)


def card_line(device: torch.device) -> str:
    """``nvidia-smi``'s name and power limit of the card, or ``cpu``."""
    if device.type != "cuda":
        return "cpu"
    idx = device.index if device.index is not None else torch.cuda.current_device()
    try:
        return subprocess.run(
            ["nvidia-smi", f"--id={idx}", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout.strip()  # fmt: skip
    except (OSError, subprocess.CalledProcessError):
        return f"{torch.cuda.get_device_name(idx)}, power limit not read"


def make_engine(op, impl: str, precision: str, device: torch.device):
    """(fn, engine): the applier ``impl`` selects, as ``JincResizer`` builds
    it; the plain ``xla`` engine is a function."""
    app, engine = (None, "xla") if impl == "xla" else _select_engine(op, impl, precision, device)
    if app is not None:
        return app, engine
    dop = apply_xla.to_device(op, device)
    return (lambda s: apply_xla.resize_plane_batch(dop, s)), "xla"


# The root harness's geometry and shard counts.
SCALING_SIZE = (480, 272, 960, 544)
SCALING_TAP = 3
SCALING_K = (1, 2, 4, 8)
SCALING_ITERS = 3


def scaling_main(args, device: torch.device, size=None) -> dict:
    """The ``--scaling`` harness; returns the JSON object it prints."""
    from .sharding import ShardedApplier, make_mesh

    sw, sh, dw, dh = size or SCALING_SIZE
    op = build_plane_operator(sw, sh, dw, dh, radius_for_tap(SCALING_TAP))
    nnz = op.stats()["logical_nnz"]
    F = max(2, min(args.frames, 4))
    src = torch.from_numpy(np.random.default_rng(0).random((F, sh, sw), dtype=np.float32))
    src = src.to(device)
    cuda = device.type == "cuda"
    print(f"# {card_line(device)}", file=sys.stderr)

    def seconds(fn) -> float:
        fn(src)  # warm-up: first launches build and load the kernels
        if cuda:
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(SCALING_ITERS):
                fn(src)
            b.record()
            b.synchronize()
            return a.elapsed_time(b) / 1e3 / SCALING_ITERS
        t0 = time.perf_counter()
        for _ in range(SCALING_ITERS):
            fn(src)
        return (time.perf_counter() - t0) / SCALING_ITERS

    rates, engines, per_k = {}, {}, []
    for k in SCALING_K:
        if k == 1:
            fn, engines[k] = make_engine(op, "auto", "fp32", device)
        else:
            fn = ShardedApplier(op, make_mesh(n_rows=k, devices=[device] * k))
            engines[k] = fn.interior
        dt = seconds(fn)
        rates[k] = nnz * F / dt
        per_k.append({"k": k, "ms_batch": dt * 1e3, "gnnz_s": rates[k] / 1e9, "interior": engines[k]})
        print(f"# n_rows={k}: {dt * 1e3:.3f} ms/batch ({F} frames), {rates[k] / 1e9:.3f} "
              f"Gnnz/s, interior={engines[k]}", file=sys.stderr)  # fmt: skip
    kmax = max(rates)
    eff = rates[kmax] / (kmax * rates[1])
    # Scaling from the smallest mesh whose interior is kmax's (the root
    # harness's engine-consistent ratio).
    k_like = [k for k in rates if k > 1 and engines[k] == engines[kmax]]
    eff_mesh = None
    if k_like and min(k_like) < kmax:
        k0 = min(k_like)
        eff_mesh = rates[kmax] / ((kmax / k0) * rates[k0])
    where = "one card" if cuda else "the CPU"
    result = {
        "metric": f"nnz_scaling_{kmax}dev",
        "value": eff,
        "unit": "fraction_of_linear",
        "vs_baseline": eff / 0.9,
        "per_k": per_k,
        "mode": "serial-shards-one-card" if cuda else "serial-shards-cpu",
        "mesh_scaling_like_engine": eff_mesh,
        "note": (
            f"every shard runs on {where}, one after another, so k shards do the work of "
            "one device in k pieces: 'value' is the sharded engine's overhead against the "
            "single-device engine, not scaling; scaling needs a mesh of distinct cards"
        ),
    }
    out_path = os.environ.get("JINCRESIZE_SCALING_OUT")
    if out_path:
        with open(out_path, "w") as f:
            json.dump(result, f, indent=1)
        print(f"# wrote {out_path}", file=sys.stderr)
    print(json.dumps(result))
    return result


def main(argv=None, size: tuple[int, int, int, int] | None = None) -> dict:
    """Run the bench; ``size`` = (src_w, src_h, dst_w, dst_h) overrides the
    mode's geometry (the tests run tiny planes on the CPU). Returns the
    JSON object it prints."""
    args = parse_args(argv)
    device = apply_xla.resolve_device(args.device)
    if args.scaling:
        return scaling_main(args, device, size)
    sw, sh, dw, dh, tap = geometry(args)
    if size is not None:
        sw, sh, dw, dh = size
    card = card_line(device)

    t0 = time.time()
    op = build_plane_operator(sw, sh, dw, dh, radius_for_tap(tap))
    print(f"# operator built in {time.time() - t0:.1f}s: {op.stats()}", file=sys.stderr)

    fn, engine = make_engine(op, args.impl, args.precision, device)
    effective = getattr(fn, "effective_precision", "fp32")
    interior = INTERIORS[engine] if device.type == "cuda" else "plain PyTorch forms (CPU tensors)"
    tag = f"engine={engine} interior={interior} precision={effective} [{card}]"
    print(f"# {tag}", file=sys.stderr)
    frames = max(args.frames, 1)
    rng = np.random.default_rng(0)
    shape = (frames, sh, sw) if args.frames > 1 else (sh, sw)
    src = torch.from_numpy(rng.random(shape, dtype=np.float32)).to(device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def run(x):
        return float(fn(x).sum())

    run(src)  # warm-up: first launches build and load the kernels
    # Dispatch path: queue `iters` calls, synchronise once.
    t0 = time.time()
    sums = [fn(src).sum() for _ in range(args.iters)]
    _ = [float(s) for s in sums]
    dt_dispatch = (time.time() - t0) / max(args.iters, 1)
    t1 = time.time()
    run(src)
    print(f"# sync per-call latency: {(time.time() - t1) * 1e3:.2f} ms {tag}", file=sys.stderr)

    # Device time: R back-to-back calls on the resident batch.
    def loop_s() -> float:
        if device.type != "cuda":
            t = time.time()
            for _ in range(R):
                fn(src)
            return time.time() - t
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(R):
            fn(src)
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / 1e3

    loop_s()
    sync()
    dt = loop_s() / R
    px_per_s = dw * dh * frames / dt
    print(
        f"# impl={args.impl} device={dt * 1e3:.2f} ms/batch (dispatch-path "
        f"{dt_dispatch * 1e3:.2f} ms) for {frames} frame(s) ({sw}x{sh} -> {dw}x{dh}), "
        f"{px_per_s / 1e9:.3f} Gpx/s device / {dw * dh * frames / dt_dispatch / 1e9:.3f} "
        f"Gpx/s dispatch-path {tag}",
        file=sys.stderr,
    )
    nnz_per_px = op.stats()["logical_nnz"] / (dw * dh)
    print(
        f"# logical nnz/s: {px_per_s * nnz_per_px / 1e12:.3f} T ({nnz_per_px:.0f} nnz/px) {tag}",
        file=sys.stderr,
    )

    if args.downscale or args.tap16_downscale:
        fs = op.filter_size
        base = 1.54e12 / (fs * ((fs + 15) & ~15))
        kind = "tap16" if args.tap16_downscale else "jinc256"
        metric = f"{kind}_4k_to_1080p_fp32_px_per_s_per_chip"
        if args.small:
            metric = f"{kind}_1080p_to_540p_fp32_px_per_s_per_chip"
        vs = px_per_s / base
    else:
        metric = "jinc256_4k_to_8k_fp32_px_per_s_per_chip"
        if args.small:
            metric = "jinc256_1080p_fp32_px_per_s_per_chip"
        vs = px_per_s / (BASELINE_PX_PER_S * (0.25 if args.small else 1.0))
    result = {
        "metric": metric,
        "value": px_per_s,
        "unit": "px/s",
        "vs_baseline": vs,
        "engine": engine,
        "precision": args.precision,
        "effective_precision": effective,
        "device": card,
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
