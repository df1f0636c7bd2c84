"""What the tools share: the device flag and the timing of back-to-back calls."""

from __future__ import annotations

import argparse
import sys
import time

import torch

from ..apply_xla import resolve_device
from ..bench import card_line


def add_device_arg(ap: argparse.ArgumentParser) -> None:
    ap.add_argument(
        "--device", default="cuda", help="torch device (default cuda; raises without a card)"
    )


def open_device(args) -> tuple[torch.device, str]:
    """(device, card line) of ``args.device``; prints the card on stderr."""
    device = resolve_device(args.device)
    card = card_line(device)
    print(f"# device {device} [{card}]", file=sys.stderr)
    return device, card


def calls_ms(fn, device: torch.device, reps: int) -> float:
    """Milliseconds a call of ``fn()`` over ``reps`` back-to-back calls,
    after one warm-up call: CUDA events on a card, the host clock on the CPU."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize(device)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def graph_ms(fn, reps: int) -> float:
    """Milliseconds a call of ``fn()`` when ``reps`` calls are captured in one
    CUDA graph and replayed at once: the device time without the host's
    per-launch cost (the twin of an on-device loop)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the capture, as PyTorch asks
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    g.replay()
    b.record()
    b.synchronize()
    del g
    return a.elapsed_time(b) / reps
