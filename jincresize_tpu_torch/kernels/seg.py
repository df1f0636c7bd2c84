"""Segment-periodic interior: hand-written CUDA kernel and its plain form.

``seg_interior`` replaces ``jincresize_tpu/kernels/pallas_fused_seg.py``
``make_seg_interior``/``_seg_kernel``. Under the parity default
(``pos_precision='f32'``) the reference's float32 position walk fragments
rational scales: ``phase.plan_phases_seg`` proves that the window starts stay
affine per axis, ``start[k] = base + q*(k // p) + roff[k]`` with
``0 <= roff <= spread <= 8``, while the dictionary classes ``cls[k]`` drift
as staircases. The kernel computes the plan-covered block
``[y.lo, y.hi) x [x.lo, x.hi)`` exactly, each pixel at its own start and its
true class:

    out[f, Y, X] = sum src[f, sy[Y] + ly, sx[X] + lx]
                       * pair_blocks[cls_y[Y], cls_x[X], ly, lx]

At exception coordinates the plan's placeholder values (clamped ``roff``,
real class) are computed; the applier overwrites them (``apply_conv_seg``).

The CUDA kernel is ``csrc/seg_interior.cu``. The affine starts bound the
source window of a 32 x 8 output tile (sized here over every tile), so a
block stages that window once per frame in shared memory and every thread
reads its fs x fs window from there. That is what separates it from the
gather kernel, which reads every source window from device memory. The
weights come from the compact dictionary (0.1-1.3 MB at 1080p- to 4K-class
geometries, L2-resident), stored class-minor like the gather kernel's so
that the few column classes of a warp share one or two cache lines per tap.
Up to four frames share a block, so one weight load serves each of them. What bounds it on an H100: one shared-memory load per
FMA plus a quarter of an L1 weight load -- load issue, not bytes or FLOPs.

The envelope: fs**2 <= ``FS2_MAX`` and one frame's staged window within the
227 KB of shared memory a block may use. Every window start, placeholder
ones included, lies inside the source plane (placeholders clamp ``roff``
down, below the true start); ``make_seg_interior`` checks that on the host.

TPU workarounds of the Pallas kernel that this one drops:

* the MXU variant groups per column tile (``_tile_groups``) and their 0/1
  select tensor -- a GPU thread indexes its own class in the dictionary;
* ``_dedup_bands`` and ``_chunk_layout`` -- there are no expanded weight
  slabs to deduplicate and no dot-M to bucket;
* ``_expand_w`` (the HIGHEST-precision device einsum that builds the slabs)
  and the ``wsplit3``/``wsplit3_vmem`` weight splits -- fp32 FMA is exact, so
  ``precision='fp32_u8src'`` runs the same fp32 kernel;
* ``residue_planes`` -- Mosaic cannot slice lanes with a stride; a thread
  reads column ``qx*j + roff + lx`` of its staged window directly;
* the ``split3``/``xla`` phase interleave -- the output is stored in
  destination layout directly;
* the ``WMAX``/``WMAX_BUILD`` weight gates, the 12 MB VMEM budget and the
  ``JINCRESIZE_SEG_*`` overrides -- the compact dictionary is the only weight
  tensor, and the envelope is shared memory.

``precision='bf16'`` (one-pass bf16) raises NotImplementedError (ROADMAP,
still to port #2).

Weights and state: the operator and the plan are the shared NumPy
``PlaneOperator`` and ``SegPhasePlan`` that the JAX package uses too, so the
device tables are made from the same objects and no carry-over function is
needed.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..operator import PlaneOperator
from ..phase import SegAxisPlan, SegPhasePlan

from . import _build
from .fused import FS2_MAX, MAX_SMEM_BYTES
from .gather import check_window_starts, class_minor, window_sum_plain

TILE_X = 32  # output tile of one thread block; csrc/seg_interior.cu kTileX
TILE_Y = 8  # csrc/seg_interior.cu kTileY
MAX_FRAMES = 4  # frames staged per block; csrc/seg_interior.cu kMaxFrames


@dataclass(frozen=True)
class SegInterior:
    """Device tables of the segment-periodic interior for one plan."""

    pair_blocks_t: torch.Tensor  # (n_uy, fs, fs, n_ux) f32, the dictionary class-minor
    cls_y: torch.Tensor  # (py*nyb,) int32 true row classes
    roff_y: torch.Tensor  # (py*nyb,) int32 row start offsets
    cls_x: torch.Tensor  # (px*nxb,) int32
    roff_x: torch.Tensor  # (px*nxb,) int32
    start_y: torch.Tensor  # (py*nyb,) int32 base_y + qy*(k // py) + roff_y (plain form)
    start_x: torch.Tensor  # (px*nxb,) int32
    py: int
    qy: int
    base_y: int
    px: int
    qx: int
    base_x: int
    src_height: int
    src_width: int
    fs: int
    win_h: int  # staged source window of one tile
    win_w: int
    frames_per_block: int

    @property
    def out_shape(self) -> tuple[int, int]:
        return self.cls_y.shape[0], self.cls_x.shape[0]


def _starts(ax: SegAxisPlan) -> np.ndarray:
    k = np.arange(ax.hi - ax.lo)
    return ax.base + ax.q * (k // ax.p) + ax.roff.astype(np.int64)


def _window_extent(ax: SegAxisPlan, tile: int, fs: int) -> int:
    """Largest staged extent over tiles: max start in a tile, less the
    tile's origin ``base + q*(k0 // p)``, plus ``fs``."""
    k = np.arange(ax.hi - ax.lo)
    rel = ax.q * (k // ax.p) + ax.roff.astype(np.int64)
    origin = ax.q * ((k // tile * tile) // ax.p)
    return int((rel - origin).max()) + fs


def _layout(op: PlaneOperator, plan: SegPhasePlan) -> tuple[int, int, int] | None:
    """(win_h, win_w, frames_per_block), or None outside the envelope."""
    fs = op.filter_size
    if fs * fs > FS2_MAX or op.pair_blocks.size == 0:
        return None
    if plan.y.hi <= plan.y.lo or plan.x.hi <= plan.x.lo:
        return None
    win_h = _window_extent(plan.y, TILE_Y, fs)
    win_w = _window_extent(plan.x, TILE_X, fs)
    nfb = min(MAX_FRAMES, MAX_SMEM_BYTES // (win_h * win_w * 4))
    if nfb < 1:
        return None
    return win_h, win_w, nfb


def is_supported(op: PlaneOperator, plan: SegPhasePlan) -> bool:
    """Envelope: fs**2 <= FS2_MAX and a staged window that fits shared memory."""
    return _layout(op, plan) is not None


def make_seg_interior(
    op: PlaneOperator,
    plan: SegPhasePlan,
    device: torch.device | str = "cpu",
    precision: str = "fp32",
) -> SegInterior:
    """Host tables of ``plan`` plus the device dictionary."""
    if precision == "bf16":
        raise NotImplementedError(
            "precision='bf16' (one-pass bf16 interior) is not ported yet "
            "(ROADMAP, still to port #2)"
        )
    if precision not in ("fp32", "fp32_u8src"):
        raise ValueError(f"make_seg_interior: unknown precision {precision!r}")
    L = _layout(op, plan)
    if L is None:
        raise ValueError("make_seg_interior: plan outside the kernel envelope")
    win_h, win_w, nfb = L
    fs = op.filter_size
    sy, sx = _starts(plan.y), _starts(plan.x)
    check_window_starts(sy, op.src_height, fs, "make_seg_interior rows")
    check_window_starts(sx, op.src_width, fs, "make_seg_interior columns")

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(device)

    return SegInterior(
        pair_blocks_t=class_minor(op.pair_blocks, device),
        cls_y=t(plan.y.cls),
        roff_y=t(plan.y.roff),
        cls_x=t(plan.x.cls),
        roff_x=t(plan.x.roff),
        start_y=t(sy),
        start_x=t(sx),
        py=plan.y.p,
        qy=plan.y.q,
        base_y=plan.y.base,
        px=plan.x.p,
        qx=plan.x.q,
        base_x=plan.x.base,
        src_height=op.src_height,
        src_width=op.src_width,
        fs=fs,
        win_h=win_h,
        win_w=win_w,
        frames_per_block=nfb,
    )


def seg_interior_plain(si: SegInterior, src_f: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch form: (F, H, W) -> (F, py*nyb, px*nxb)."""
    return window_sum_plain(src_f, si.start_y, si.cls_y, si.start_x, si.cls_x, si.pair_blocks_t)


def seg_interior(si: SegInterior, src_f: torch.Tensor) -> torch.Tensor:
    """Segment-periodic interior of ``src_f`` (F, H, W) float32.

    On a CPU tensor this is ``seg_interior_plain``. On a CUDA tensor it
    launches ``csrc/seg_interior.cu`` (counted in ``seg_interior.launches``)
    or raises; it never falls back.
    """
    if src_f.device.type == "cpu":
        return seg_interior_plain(si, src_f)
    if src_f.device.type != "cuda":
        raise RuntimeError(f"seg_interior: unsupported device {src_f.device}")
    if src_f.dtype != torch.float32 or src_f.dim() != 3 or not src_f.is_contiguous():
        raise ValueError("seg_interior: src must be a contiguous (F, H, W) float32 tensor")
    F, H, W = src_f.shape
    if (H, W) != (si.src_height, si.src_width):
        raise ValueError(f"seg_interior: source {W}x{H} does not match the plan")
    if si.pair_blocks_t.device != src_f.device:
        raise ValueError("seg_interior: operator and source on different devices")
    hout, wout = si.out_shape
    out = torch.empty((F, hout, wout), dtype=torch.float32, device=src_f.device)
    if F == 0:
        return out
    with torch.cuda.device(src_f.device):
        rc = _build.library().jt_seg_interior(
            src_f.data_ptr(), si.pair_blocks_t.data_ptr(), si.cls_y.data_ptr(),
            si.roff_y.data_ptr(), si.cls_x.data_ptr(), si.roff_x.data_ptr(), out.data_ptr(),
            F, H, W, si.py, si.qy, si.base_y, si.px, si.qx, si.base_x, hout, wout,
            si.pair_blocks_t.shape[3], si.fs, si.win_h, si.win_w, si.frames_per_block,
            _build.stream_of(src_f),
        )  # fmt: skip
    _build.check(rc, "jt_seg_interior")
    seg_interior.launches += 1
    return out


seg_interior.launches = 0
