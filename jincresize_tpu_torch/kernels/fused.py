"""Fused phase-conv interior: hand-written CUDA kernel and its plain form.

``fused_interior`` replaces ``jincresize_tpu/kernels/pallas_fused.py``
``make_fused_interior``/``_fused_kernel``: it computes the whole periodic
interior of a phase plan directly in destination layout ``(F, py*nyb,
px*nxb)`` (the block that belongs at ``canvas[ylo:, xlo:]``). The CUDA kernel
is ``csrc/fused_interior.cu``: one thread per output pixel, the ``(py*px, fs,
fs)`` weight set staged in shared memory, fp32 FMA accumulation.

What bounds it on an H100: each output pixel costs ``fs**2`` FMAs, each with
one L1-cached source load and one shared-memory weight load, so the simple
form is bound by load-issue rate, not by HBM (4K->8K tap 8 reads 33 MB and
writes 133 MB per frame but issues 9.6 G loads). Reusing a staged source tile
across a thread's neighbours is the next step.

TPU workarounds of the Pallas kernel that this one drops:

* the ``split3`` 0/1 scatter-matmul column-phase interleave -- a GPU thread
  stores to any column, so the output is written interleaved directly;
* ``residue_planes`` -- Mosaic cannot lower lane-strided slices; a GPU thread
  reads column ``qx*j + c`` directly;
* the ``wsplit3`` bf16 weight split -- fp32 FMA is already exact, so
  ``precision='fp32_u8src'`` runs the same fp32 kernel;
* ``_choose_tmb``, ``_vmem_bytes`` and ``VMEM_BUDGET`` -- no row-band tiling
  against a VMEM budget; the envelope is the shared-memory size of the weights;
* the Mosaic deep-tap envelope (``py*px <= 4``, ``fs**2 <= 4500``,
  ``JINCRESIZE_FUSED_FS2_MAX``) -- the kernel reads ``fs`` at run time, so a
  deep tap (fs = 49 or 65 at tap 16) is the same loop, only longer;
* the ``JINCRESIZE_DEEP_FUSED_MIN_PIXELS`` output-size gate
  (``jincresize_tpu/apply_conv.py``), which exists because a Mosaic compile
  takes minutes -- a deep-tap plan takes this kernel at every output size.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..operator import PlaneOperator
from ..phase import PhasePlan, build_conv_kernels

from . import _build

# Per-block shared memory an H100 kernel may opt into (227 KB).
MAX_SMEM_BYTES = 232448
# The gather and seg kernels' envelope (fs**2 <= 1200, as the JAX gather
# kernel's); the fused kernel has none beyond its shared memory.
FS2_MAX = 1200
# The kernel's (x, y) thread-block shapes (compile-time constants of
# csrc/fused_interior.cu); every engine runs the first.
TILES = ((32, 8), (32, 4), (32, 16), (64, 4), (16, 16))
DEFAULT_TILE = TILES[0]


def _odd_stride(n: int) -> int:
    """Per-phase stride of a weight set: odd, so phases hit distinct banks."""
    return n if n % 2 else n + 1


@dataclass(frozen=True)
class FusedInterior:
    """Device operator of the fused interior for one phase plan."""

    w: torch.Tensor  # (py*px, wstride) f32: phase ry*px+rx's (fs, fs) block, flat
    offs: torch.Tensor  # (py + px,) int32: [offs_y..., offs_x...]
    kernels: torch.Tensor  # (py*px, Kh, Kw) f32: phase.build_conv_kernels (plain form)
    py: int
    px: int
    qy: int
    qx: int
    base_y: int
    base_x: int
    nyb: int
    nxb: int
    fs: int
    wstride: int

    @property
    def out_shape(self) -> tuple[int, int]:
        return self.py * self.nyb, self.px * self.nxb


def smem_bytes(py: int, px: int, fs: int) -> int:
    return py * px * _odd_stride(fs * fs) * 4


def is_supported(op: PlaneOperator, plan: PhasePlan) -> bool:
    """Envelope: the weight set fits one block's shared memory.

    ``phase.plan_phases`` caps ``py*px*fs**2`` at 32768, i.e. 128 KB of
    weights, so every plan it returns is admitted, deep taps included; the
    shared-memory check keeps the kernel honest if that cap ever moves.
    """
    return smem_bytes(plan.y.p, plan.x.p, op.filter_size) <= MAX_SMEM_BYTES


def make_fused_interior(
    op: PlaneOperator,
    plan: PhasePlan,
    device: torch.device | str = "cpu",
    precision: str = "fp32",
) -> FusedInterior:
    """Host build of the fused interior's weights for ``plan`` on ``device``."""
    if precision == "bf16":
        raise NotImplementedError(
            "precision='bf16' (one-pass bf16 interior) is not ported yet "
            "(ROADMAP, still to port #2)"
        )
    if precision not in ("fp32", "fp32_u8src"):
        raise ValueError(f"make_fused_interior: unknown precision {precision!r}")
    if not is_supported(op, plan):
        raise ValueError("make_fused_interior: plan outside the kernel envelope")
    fs = op.filter_size
    py, px = plan.y.p, plan.x.p
    wstride = _odd_stride(fs * fs)
    w = np.zeros((py * px, wstride), dtype=np.float32)
    for ry in range(py):
        for rx in range(px):
            blk = op.pair_blocks[plan.y.anchor_cls[ry], plan.x.anchor_cls[rx]]
            w[ry * px + rx, : fs * fs] = blk.reshape(-1)
    offs = np.concatenate([plan.y.offsets, plan.x.offsets]).astype(np.int32)
    K = build_conv_kernels(op, plan)[:, 0]
    return FusedInterior(
        w=torch.from_numpy(w).to(device),
        offs=torch.from_numpy(offs).to(device),
        kernels=torch.from_numpy(K).to(device),
        py=py,
        px=px,
        qy=plan.y.q,
        qx=plan.x.q,
        base_y=plan.y.base,
        base_x=plan.x.base,
        nyb=plan.y.nblocks,
        nxb=plan.x.nblocks,
        fs=fs,
        wstride=wstride,
    )


def fused_interior_plain(fi: FusedInterior, src_f: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch form: shift-sum over the conv kernels + phase interleave.

    ``src_f`` (F, H, W) float32 -> (F, py*nyb, px*nxb) float32. Reads past the
    plane are zeros (padding), as in the kernel. Calls are counted in
    ``fused_interior_plain.calls``, so that a run on the card can show that
    no engine took the plain form.
    """
    fused_interior_plain.calls += 1
    F, H, W = src_f.shape
    K = fi.kernels
    nph, Kh, Kw = K.shape
    qy, qx, nyb, nxb = fi.qy, fi.qx, fi.nyb, fi.nxb
    eh = (nyb - 1) * qy + Kh
    ew = (nxb - 1) * qx + Kw
    pad_h = max(0, fi.base_y + eh - H)
    pad_w = max(0, fi.base_x + ew - W)
    lhs = torch.nn.functional.pad(src_f, (0, pad_w, 0, pad_h))
    lhs = lhs[:, fi.base_y : fi.base_y + eh, fi.base_x : fi.base_x + ew]
    conv = torch.zeros((F, nph, nyb, nxb), dtype=torch.float32, device=src_f.device)
    for a in range(Kh):
        for b in range(Kw):
            win = lhs[:, a : a + (nyb - 1) * qy + 1 : qy, b : b + (nxb - 1) * qx + 1 : qx]
            conv.addcmul_(K[:, a, b].view(1, nph, 1, 1), win.unsqueeze(1))
    return (
        conv.view(F, fi.py, fi.px, nyb, nxb)
        .permute(0, 3, 1, 4, 2)
        .reshape(F, fi.py * nyb, fi.px * nxb)
    )


fused_interior_plain.calls = 0


def fused_interior(fi: FusedInterior, src_f: torch.Tensor, tile=DEFAULT_TILE) -> torch.Tensor:
    """Fused interior of ``src_f`` (F, H, W) float32 in destination layout.

    On a CPU tensor this is ``fused_interior_plain``. On a CUDA tensor it
    launches ``csrc/fused_interior.cu`` (counted in ``fused_interior.launches``)
    or raises; it never falls back. ``tile`` is the kernel's (x, y) thread
    block, one of ``TILES``; every shape gives the same result.
    """
    if tuple(tile) not in TILES:
        raise ValueError(f"fused_interior: tile {tile} is not one of {TILES}")
    if src_f.device.type == "cpu":
        return fused_interior_plain(fi, src_f)
    if src_f.device.type != "cuda":
        raise RuntimeError(f"fused_interior: unsupported device {src_f.device}")
    if src_f.dtype != torch.float32 or src_f.dim() != 3 or not src_f.is_contiguous():
        raise ValueError("fused_interior: src must be a contiguous (F, H, W) float32 tensor")
    if fi.w.device != src_f.device:
        raise ValueError("fused_interior: operator and source on different devices")
    F, H, W = src_f.shape
    hout, wout = fi.out_shape
    out = torch.empty((F, hout, wout), dtype=torch.float32, device=src_f.device)
    if F == 0:
        return out
    with torch.cuda.device(src_f.device):
        rc = _build.library().jt_fused_interior(
            src_f.data_ptr(), fi.w.data_ptr(), fi.offs.data_ptr(), out.data_ptr(),
            F, H, W, fi.py, fi.px, fi.qy, fi.qx, fi.base_y, fi.base_x,
            fi.nyb, fi.nxb, fi.fs, fi.wstride, *tile, _build.stream_of(src_f),
        )  # fmt: skip
    _build.check(rc, "jt_fused_interior")
    fused_interior.launches += 1
    return out


fused_interior.launches = 0
