"""Zero-write probe: hand-written CUDA kernel and its plain form.

``out_only`` replaces the ``out_only`` probe of
``tools/profiling/device_loop_timing.py`` (``out_only_call`` -> ``kern``, a
``pallas_call`` that writes a zero (48, 256) block per grid step). The CUDA
kernel is ``csrc/out_only.cu``: one block per ``tile`` of an (F, H, W)
float32 tensor, frames on ``gridDim.z``. Nothing is read, so its bound is
the output's bytes over the card's memory rate, and its time against
``torch.zeros`` of the same shape (a memset) is what a launch pays per
tile. At (8, 4320, 7680) with the default (48, 256) tiles the grid has 2700
blocks a frame, as the TPU probe has grid steps.

A block of 1024 threads writes its tile as a 2-D map, 64 float4 lanes by
16 rows, with streaming stores and no division per store.
"""

from __future__ import annotations

import torch

from . import _build

TILE = (48, 256)


def out_only_plain(shape, device="cpu") -> torch.Tensor:
    """Plain form: a float32 tensor of zeros of ``shape``."""
    return torch.zeros(shape, dtype=torch.float32, device=device)


def out_only(out: torch.Tensor, tile=TILE) -> torch.Tensor:
    """Write zeros into ``out``, (H, W) or (F, H, W) float32, and return it.

    On a CPU tensor this copies ``out_only_plain``. On a CUDA tensor it
    launches ``csrc/out_only.cu`` over ``tile`` = (tile_h, tile_w) tiles
    (counted in ``out_only.launches``) or raises; it never falls back.
    """
    tile_h, tile_w = tile
    if tile_h < 1 or tile_w < 1:
        raise ValueError(f"out_only: tile {tile} must be positive")
    if out.dtype != torch.float32 or out.dim() not in (2, 3) or not out.is_contiguous():
        raise ValueError("out_only: out must be a contiguous (F, H, W) or (H, W) float32 tensor")
    if out.device.type == "cpu":
        return out.copy_(out_only_plain(out.shape))
    if out.device.type != "cuda":
        raise RuntimeError(f"out_only: unsupported device {out.device}")
    F, H, W = out.shape if out.dim() == 3 else (1, *out.shape)
    if out.numel() == 0:
        return out
    with torch.cuda.device(out.device):
        rc = _build.library().jt_out_only(
            out.data_ptr(), F, H, W, tile_h, tile_w, _build.stream_of(out)
        )
    _build.check(rc, "jt_out_only")
    out_only.launches += 1
    return out


out_only.launches = 0
