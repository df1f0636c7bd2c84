"""General apply path: gather-MAC over the device-resident operator.

Port of ``jincresize_tpu/apply_xla.py`` (the ``impl='xla'`` engine). It is
plain tensor code in the JAX package too, so it stays plain PyTorch here; it
serves any geometry and is the port's independent check of the kernel path.

The per-pixel weight for tap (ly, lx) is assembled from the class-pair
dictionary plus the border strips and multiplied with the separably gathered
source window; sums are float32. Frames are a leading batch dimension.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .operator import PlaneOperator

_TORCH_DTYPES = {
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.uint16): torch.uint16,
    np.dtype(np.float32): torch.float32,
}


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a numpy dtype (or a torch dtype, passed through)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return _TORCH_DTYPES[np.dtype(dtype)]


def resolve_device(device) -> torch.device:
    """``torch.device(device)``; a CUDA device without a visible GPU raises
    (the port's entry points run on the card unless asked for the CPU, and
    never fall back to it)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "JincResize: device='cuda' requested but no CUDA device is visible."
        )
    return device


def einsum64(equation: str, *operands: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` over float64 copies of ``operands``, rounded to
    float32: the glue's contractions where one gathered window serves many
    pixels' blocks (summed elementwise, their products would be that many
    times the window's size). A float32 matmul follows process-wide
    settings (``torch.set_float32_matmul_precision``,
    ``torch.backends.cuda.matmul.allow_tf32``: TF32 on the card, bf16 on
    the CPU); a float64 one follows none, so no caller's setting reaches
    the port's fp32 results and no global state is touched. The sums are
    then exact to the last float32 rounding."""
    return torch.einsum(equation, *(t.double() for t in operands)).float()


@dataclass(frozen=True)
class DeviceStrip:
    """Device-resident border strip (static rectangle, per-pixel blocks)."""

    blocks: torch.Tensor  # (ny, nx, fs, fs) float32
    y0: int = 0
    y1: int = 0
    x0: int = 0
    x1: int = 0


@dataclass(frozen=True)
class DevicePlaneOperator:
    """Frozen device mirror of a host PlaneOperator."""

    start_x: torch.Tensor  # (dst_w,) int64
    start_y: torch.Tensor  # (dst_h,) int64
    cx_idx: torch.Tensor  # (dst_w,) int64
    cy_idx: torch.Tensor  # (dst_h,) int64
    pair_blocks: torch.Tensor  # (n_uy, n_ux, fs, fs) float32
    strips: tuple[DeviceStrip, ...]
    src_width: int = 0
    src_height: int = 0
    dst_width: int = 0
    dst_height: int = 0
    filter_size: int = 0


def to_device(op: PlaneOperator, device="cuda") -> DevicePlaneOperator:
    """Carry a host-built PlaneOperator's arrays to ``device``."""
    device = resolve_device(device)

    def t(a, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(device)

    strips = tuple(
        DeviceStrip(blocks=t(s.blocks), y0=s.y0, y1=s.y1, x0=s.x0, x1=s.x1)
        for s in op.strips
    )
    pair = op.pair_blocks
    if pair.size == 0:
        # Degenerate fully-border geometry: keep a 1x1 zero dictionary so the
        # gather path stays shape-valid; strips overwrite every pixel.
        fs = op.filter_size
        pair = np.zeros((1, 1, fs, fs), dtype=np.float32)
    return DevicePlaneOperator(
        start_x=t(op.start_x, np.int64),
        start_y=t(op.start_y, np.int64),
        cx_idx=t(op.cx_idx, np.int64),
        cy_idx=t(op.cy_idx, np.int64),
        pair_blocks=t(pair),
        strips=strips,
        src_width=op.src_width,
        src_height=op.src_height,
        dst_width=op.dst_width,
        dst_height=op.dst_height,
        filter_size=op.filter_size,
    )


def _taps(dop: DevicePlaneOperator) -> torch.Tensor:
    return torch.arange(dop.filter_size, device=dop.start_x.device)


def source_f32(src: torch.Tensor, float_clamp_min: float | None) -> torch.Tensor:
    """Float32 source, with the SIMD kernels' float clamp when requested."""
    src_f = src.to(torch.float32)
    if float_clamp_min is not None:
        src_f = torch.clamp_min(src_f, float_clamp_min)
    return src_f.contiguous()


def apply_plane(
    dop: DevicePlaneOperator,
    src: torch.Tensor,
    float_clamp_min: float | None = None,
) -> torch.Tensor:
    """Resample (F, src_h, src_w) -> (F, dst_h, dst_w) float32 accumulators.

    A 2-D ``src`` is treated as one frame. Gather indices are clipped to the
    plane for degenerate tiny sources (the reference over-reads its padded
    frames). Output conversion is left to ``finalize``.
    """
    if src.dim() == 2:
        return apply_plane(dop, src[None], float_clamp_min)[0]
    fs = dop.filter_size
    F, H, W = src.shape
    src_f = source_f32(src, float_clamp_min)
    taps = _taps(dop)
    n_uy = dop.pair_blocks.shape[0]
    # Horizontal im2col: (F, H, dst_w, fs). cols[x, lx] = clip(start_x + lx).
    cols = torch.clamp(dop.start_x[:, None] + taps[None, :], 0, W - 1)
    P = src_f[:, :, cols]
    acc = torch.zeros(
        (F, dop.dst_height, dop.dst_width), dtype=torch.float32, device=src.device
    )

    if n_uy * H <= 2 * dop.dst_height:
        # Class-contraction variant: contract the horizontal taps once per row
        # class over source rows, then gather each destination row's (class,
        # source row) pair.
        P64 = P.double()  # converted once, not by each einsum64
        for ly in range(fs):
            panex = dop.pair_blocks[:, dop.cx_idx, ly, :]  # (n_uy, dst_w, fs)
            T = einsum64("fhwk,cwk->fchw", P64, panex)
            rows = torch.clamp(dop.start_y + ly, 0, H - 1)
            flat = dop.cy_idx * H + rows
            acc += T.reshape(F, n_uy * H, dop.dst_width)[:, flat]
        # Border pixels got interior-pattern weights above; overwrite them
        # with their true per-pixel strip values.
        for s in dop.strips:
            cols_s = torch.clamp(
                dop.start_x[s.x0 : s.x1, None] + taps[None, :], 0, W - 1
            )
            Ps = src_f[:, :, cols_s]  # (F, H, nx, fs)
            rows_s = torch.clamp(
                dop.start_y[s.y0 : s.y1, None] + taps[None, :], 0, H - 1
            )
            G = Ps[:, rows_s]  # (F, ny, k, nx, l)
            acc[:, s.y0 : s.y1, s.x0 : s.x1] = (G.permute(0, 1, 3, 2, 4) * s.blocks).sum((-2, -1))
        return acc

    for ly in range(fs):
        rows = torch.clamp(dop.start_y + ly, 0, H - 1)
        Prow = P[:, rows]  # (F, dst_h, dst_w, fs) row gather
        panex = dop.pair_blocks[:, dop.cx_idx, ly, :]  # (n_uy, dst_w, fs)
        Wrow = panex[dop.cy_idx]  # (dst_h, dst_w, fs)
        for s in dop.strips:
            Wrow[s.y0 : s.y1, s.x0 : s.x1] = s.blocks[:, :, ly, :]
        acc += (Prow * Wrow).sum(-1)
    return acc


def finalize(acc: torch.Tensor, out_dtype, peak: float | None) -> torch.Tensor:
    """Reference output conversion: lrintf(clamp(r, 0, peak)) for integers
    (``torch.round`` rounds half to even), raw float32 otherwise."""
    out_dtype = torch_dtype(out_dtype)
    if out_dtype.is_floating_point:
        return acc.to(out_dtype)
    return torch.round(torch.clamp(acc, 0.0, peak)).to(out_dtype)


def resize_plane_batch(
    dop: DevicePlaneOperator,
    src: torch.Tensor,  # (F, src_h, src_w)
    out_dtype=torch.float32,
    peak: float | None = None,
    float_clamp_min: float | None = None,
) -> torch.Tensor:
    """Batched resize with output conversion: frames share every gather."""
    return finalize(apply_plane(dop, src, float_clamp_min), out_dtype, peak)
