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

The CUDA kernel is ``csrc/seg_interior.cu``. Unlike the gather kernel's
pixels, the pixels of a seg tile share few dictionary blocks (at most 4 row
and 5 column classes in a 32 x 32 output tile at 1440p -> 4K tap 8 and
1440p -> 1080p tap 16), so a block stages its tile's class-pair blocks in
shared memory once (``tile_classes`` lists each tile's classes; pair
blocks ``block_stride`` floats apart) and every weight load is a broadcast.
Each warp takes 4 rows of the tile and streams its own source window
through its own ring of 3 staged rows (``SLOTS``), frames side by side,
synchronised within the warp alone: with one ring shared by the block,
every barrier held the warps back for the ones the staged rows fed (the
row windows of a tall tile are staggered). A thread owns one column, its warp's 4 rows and up to 8
frames (``FRAMES``, chosen from F by ``frames_of``): at 8 frames, 8 source
and 4 weight loads feed 128 FMAs.
Per pixel and frame the sum is an ``fmaf`` chain along each tap row, the
row sums added in ly order, as ``seg_interior_plain`` sums: the kernel and
the plain form agree bit for bit. The device dictionary is the gather
kernel's ``padded_blocks`` (``[cy, cx, ly, lx]``, tap rows padded to 4
floats); the plain form reads the same values through
``class_minor_view``.

The envelope: a non-empty dictionary and covered block, and the largest
tile's pair blocks beside one-frame rings within the 227 KB of shared
memory a block may use (``smem_bytes``): 155 KB at 1440p -> 1080p tap 16
(fs 44, 20 pairs). The TPU's ``fs**2 <= 1200`` (the Mosaic VMEM budget,
``pallas_fused_seg.py:225``) is gone, so drifted deep-tap plans take this
kernel; a plan whose pairs do not fit goes on to ``gather``. Every window
start, placeholder ones included, lies inside the source plane
(placeholders clamp ``roff`` down, below the true start);
``make_seg_interior`` checks that on the host.

TPU workarounds of the Pallas kernel that this one drops:

* the MXU variant's per-column-tile groups (``_tile_groups``) and their
  0/1 select tensor -- the per-tile class lists only choose what a block
  stages; a thread indexes its own pair block;
* ``_dedup_bands`` and ``_chunk_layout`` -- there are no expanded weight
  slabs to deduplicate and no dot-M to bucket;
* ``_expand_w`` (the HIGHEST-precision device einsum that builds the slabs)
  and the stacked ``wsplit3`` weight split (three copies of the slabs; its
  in-kernel twin ``wsplit3_vmem`` is ported, below);
* ``residue_planes`` -- Mosaic cannot slice lanes with a stride; a thread
  reads its column's window from the staged rows directly;
* the ``split3``/``xla`` phase interleave -- the output is stored in
  destination layout directly;
* the ``WMAX``/``WMAX_BUILD`` weight gates, the 12 MB VMEM budget, the
  ``JINCRESIZE_SEG_*`` overrides and ``FS2_MAX`` -- the compact dictionary
  is the only weight tensor, and the envelope is shared memory.

``precision='bf16'`` (the documented non-parity mode, the Pallas kernel's
DEFAULT dot at ``pallas_fused_seg.py:397``: both operands rounded to
bfloat16 in one MXU pass, fp32 sums) runs a second kernel of the same
source on the tensor cores (``mma.sync`` m16n8k16 and m16n8k8, bf16 in,
fp32 sums). Per column class of a tile the interior is a product: M slots
(column, frame) of one class (``tile_columns`` lists each tile's columns
grouped by class; frames fill the slots a class's few columns leave), N 8
output rows each with its own block and start, K the taps of one staged
source row (``fused.k_slots``). The pair blocks are rounded on the host
once (``fused.round_bf16``) and shipped as bfloat16 (``tc_blocks``, tap rows
zero-padded to ``k_slots(fs)``); the kernel stages the tile's whole source
window for its frames once, rounded to bfloat16 (``tc_smem_bytes``), so
``frames_of`` picks the most frames whose windows fit beside the pairs
(``tc_frames``), and the fp32 mode's ``frames_per_block`` is kept as it
was. The products are exact; the sums run in the tensor core's order, so
the kernel is held to ``seg_interior_plain`` (which rounds the source
first) within ``fused.tc_sum_bound``, not bit for bit.

``precision='wsplit3'`` is the Pallas kernel's ``wsplit3_vmem`` mode
(``pallas_fused_seg.py:371-389``), the mode u8 planes take
(``fused.KERNEL_PRECISION['fp32_u8src']``): the same tensor-core
kernel on the fp32 mode's own blocks (``blocks``, tap rows of
``fsp_of(fs)`` floats; ``tc_blocks`` is None), each B fragment split at
its load into three bfloat16 parts, ``w == hi + mid + lo``
(``fused.split_bf16x3``'s split, in registers), and three mmas an A
fragment. Rows of ``fsp`` floats rather than the k-slots' leave room for
two frames a block at 1440p -> 1080p tap 16 (fs 44; ``tc_words``,
``frames_of``), so that a class's ~8 columns fill an m-tile. Products of
u8 values and bfloat16 parts are exact, so the kernel is held to
``seg_interior_plain`` in the fp32 mode within ``fused.wsplit3_bound``. A
plan whose blocks and one frame's window do not fit runs the fp32 kernel
(``kernel_precision``).

Weights and state: the operator and the plan are the port's copies of the
JAX package's NumPy ``PlaneOperator`` and ``SegPhasePlan`` (the same arrays,
``tests/test_torch_host.py``), so the device tables come from the same
values and no carry-over function is needed.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import metrics
from ..operator import PlaneOperator
from ..phase import SegAxisPlan, SegPhasePlan

from . import _build
from .fused import MAX_SMEM_BYTES, PRECISIONS, TC_PARTS, k_slots, round_bf16
from .gather import (
    FRAMES,
    check_window_starts,
    class_minor_view,
    frames_per_thread,
    fsp_of,
    padded_blocks,
    tile_span,
    window_sum_plain,
)

TILE_X = 32  # output columns of a block (csrc/seg_interior.cu kTX)
TILE_Y = 32  # output rows of a block (kSegTY)
WARPS = 8  # warps of a block, 4 rows each, each with its own ring (kSegGroups)
SLOTS = 3  # staged source rows of a warp's ring (kSlots)


@dataclass(frozen=True)
class TileClasses:
    """The distinct dictionary classes of each tile of one axis."""

    ids: np.ndarray  # (tiles, k) int32: each tile's classes ascending, padded with its last
    count: np.ndarray  # (tiles,) int32: classes of each tile
    local: np.ndarray  # (n,) int32: each coordinate's class as an index into its tile's ids


def tile_classes(cls: np.ndarray, tile: int) -> TileClasses:
    """``TileClasses`` of ``cls`` cut into tiles of ``tile`` coordinates."""
    cls = np.asarray(cls)
    uniq = [np.unique(cls[i : i + tile]) for i in range(0, len(cls), tile)]
    k = max(len(u) for u in uniq)
    ids = np.stack([np.pad(u, (0, k - len(u)), mode="edge") for u in uniq]).astype(np.int32)
    local = np.concatenate(
        [np.searchsorted(u, cls[i * tile : (i + 1) * tile]) for i, u in enumerate(uniq)]
    )
    return TileClasses(ids, np.array([len(u) for u in uniq], np.int32), local.astype(np.int32))


def tile_columns(tc: TileClasses, tile: int) -> tuple[np.ndarray, np.ndarray]:
    """Each tile's columns grouped by class, for the bf16 kernel's m-tiles,
    from ``tile_classes`` of tiles of ``tile`` columns: ``(pcx, scx)``,
    ``pcx`` (tiles, tile) int32 the tile-local columns in order of their
    class (the order of ``tc.ids``), then of the column (0 past a ragged
    last tile's end); ``scx`` (tiles, k + 1) int32 where class i's run
    starts in ``pcx`` (``scx[:, i + 1] - scx[:, i]`` columns; the tile's
    column count from its last class on)."""
    n_tiles, k = tc.ids.shape
    pcx = np.zeros((n_tiles, tile), np.int32)
    scx = np.zeros((n_tiles, k + 1), np.int32)
    for i in range(n_tiles):
        local = tc.local[i * tile : (i + 1) * tile]
        pcx[i, : len(local)] = np.argsort(local, kind="stable")
        scx[i, 1:] = np.cumsum(np.bincount(local, minlength=k)[:k])
    return pcx, scx


def tc_words(fs: int, win_h: int, win_w: int, f32_blocks: bool = False) -> tuple[int, int, int]:
    """(bs, cw, plane) of the tensor-core kernel, in 4-byte words: a staged
    pair block (``fs`` tap rows of ``k_slots(fs)`` bf16, a multiple of 4
    words; with ``f32_blocks``, the wsplit3 mode's, the fp32 mode's rows of
    ``fsp_of(fs)`` floats), a copy row of the staged source (the widest
    window's columns and its last k-slot, two bf16 a word) and a staged
    frame (the tallest window's rows of two copy rows, 16 mod 32, so that
    adjacent frames' words fall on the other half of the banks)."""
    fsk = k_slots(fs)
    bs = fs * fsp_of(fs) if f32_blocks else -(-(fs * fsk // 2) // 4) * 4
    cw = -(-(win_w - fs + fsk + 1) // 2)
    cw += cw & 1
    plane = win_h * 2 * cw
    plane += (16 - plane) % 32
    return bs, cw, plane


def tc_table_words(frames: int) -> int:
    """Words of the bf16 kernel's per-block tables (csrc/seg_interior.cu
    kTab*): 162 fixed, then one a m-tile, at most 2 * frames + 32 of them;
    a multiple of 4."""
    return -(-(162 + 2 * frames + 32) // 4) * 4


def tc_smem_bytes(
    pairs: int, fs: int, win_h: int, win_w: int, frames: int, f32_blocks: bool = False
) -> int:
    """Shared memory of a tensor-core launch: ``pairs`` staged blocks
    (float32 with ``f32_blocks``), the block's tables, then the whole
    source window of each of ``frames`` frames."""
    bs, _, plane = tc_words(fs, win_h, win_w, f32_blocks)
    return 4 * (pairs * bs + tc_table_words(frames) + frames * plane)


def block_stride(fs: int) -> int:
    """Floats between two staged pair blocks: at least ``fs * fsp`` and 4
    mod 32, so that the lanes of up to 8 column classes, reading the same
    tap of their blocks, hit 8 distinct 16-byte bank groups."""
    n = fs * fsp_of(fs)
    return n + (4 - n) % 32


def row_floats(span_w: int, frames: int) -> int:
    """Floats of a staged source row: ``span_w`` columns padded to 4 (the
    kernel's ``swp``), ``frames`` frames each."""
    return -(-span_w // 4) * 4 * frames


def smem_bytes(pairs: int, fs: int, span_w: int, frames: int) -> int:
    """Shared memory of a launch: ``pairs`` staged blocks, then each warp's
    ring of ``SLOTS`` rows of ``frames`` frames."""
    return 4 * (pairs * block_stride(fs) + WARPS * SLOTS * row_floats(span_w, frames))


@dataclass(frozen=True)
class SegInterior:
    """Device tables of the segment-periodic interior for one plan."""

    blocks: torch.Tensor  # (n_uy, n_ux, fs, fsp) f32, gather.padded_blocks (the kernel's)
    pair_blocks_t: torch.Tensor  # (n_uy, fs, fs, n_ux) view of blocks, class-minor (plain form)
    cls_y: torch.Tensor  # (py*nyb,) int32 true row classes
    roff_y: torch.Tensor  # (py*nyb,) int32 row start offsets
    cls_x: torch.Tensor  # (px*nxb,) int32
    roff_x: torch.Tensor  # (px*nxb,) int32
    start_y: torch.Tensor  # (py*nyb,) int32 base_y + qy*(k // py) + roff_y
    start_x: torch.Tensor  # (px*nxb,) int32
    lcy: torch.Tensor  # (py*nyb,) int32 row class within its tile (tile_classes.local)
    lcx: torch.Tensor  # (px*nxb,) int32
    tcy: torch.Tensor  # (row tiles, ky) int32 each tile's row classes
    tcx: torch.Tensor  # (column tiles, kx) int32
    ncy: torch.Tensor  # (row tiles,) int32 row classes of each tile
    ncx: torch.Tensor  # (column tiles,) int32
    py: int
    qy: int
    base_y: int
    px: int
    qx: int
    base_x: int
    src_height: int
    src_width: int
    fs: int
    win_h: int  # source rows of the tallest tile window (tile_span of start_y)
    win_w: int  # source columns of the widest tile window: a staged row's span
    pairs: int  # pair blocks of the largest tile (ky * kx)
    frames_per_block: int  # the most frames a thread that fit beside the pairs
    # the mode that runs (fused.PRECISIONS): 'bf16' rounds the blocks; 'bf16'
    # and 'wsplit3' launch the tensor-core kernel; 'wsplit3' keeps the blocks
    # unrounded (its plain form is the fp32 mode's)
    precision: str
    # the tensor-core modes only (None otherwise): the tensor-core kernel's tables
    # (n_uy, n_ux, fs, k_slots(fs)) bf16 in the bf16 mode (wsplit3 reads blocks)
    tc_blocks: torch.Tensor | None = None
    pcx: torch.Tensor | None = None  # (column tiles, TILE_X) int32, tile_columns
    scx: torch.Tensor | None = None  # (column tiles, kx + 1) int32
    tc_frames: int = 0  # the most frames whose windows fit beside the pairs

    @property
    def bf16(self) -> bool:
        return self.precision == "bf16"

    @property
    def out_shape(self) -> tuple[int, int]:
        return self.cls_y.shape[0], self.cls_x.shape[0]


def _starts(ax: SegAxisPlan) -> np.ndarray:
    k = np.arange(ax.hi - ax.lo)
    return ax.base + ax.q * (k // ax.p) + ax.roff.astype(np.int64)


def _layout(op: PlaneOperator, plan: SegPhasePlan):
    """(win_h, win_w, row TileClasses, column TileClasses, frames a thread
    at most), or None outside the envelope."""
    fs = op.filter_size
    if op.pair_blocks.size == 0 or plan.y.hi <= plan.y.lo or plan.x.hi <= plan.x.lo:
        return None
    ty, tx = tile_classes(plan.y.cls, TILE_Y), tile_classes(plan.x.cls, TILE_X)
    pairs = ty.ids.shape[1] * tx.ids.shape[1]
    win_w = tile_span(_starts(plan.x), TILE_X, fs)
    fits = [f for f in FRAMES if smem_bytes(pairs, fs, win_w, f) <= MAX_SMEM_BYTES]
    if not fits:
        return None
    return tile_span(_starts(plan.y), TILE_Y, fs), win_w, ty, tx, max(fits)


def is_supported(op: PlaneOperator, plan: SegPhasePlan) -> bool:
    """Envelope: a dictionary, a covered block, and the largest tile's pair
    blocks beside one-frame rings within the shared memory. Any fs."""
    return _layout(op, plan) is not None


def _tc_frames(op: PlaneOperator, L, f32_blocks: bool) -> list[int]:
    """The frames a block of ``FRAMES`` whose windows fit beside the
    largest tile's pair blocks in the tensor-core kernel, for ``_layout``'s
    ``L``."""
    win_h, win_w, ty, tx, _ = L
    pairs = ty.ids.shape[1] * tx.ids.shape[1]
    fs = op.filter_size
    return [
        f
        for f in FRAMES
        if tc_smem_bytes(pairs, fs, win_h, win_w, f, f32_blocks) <= MAX_SMEM_BYTES
    ]


def kernel_precision(op: PlaneOperator, plan: SegPhasePlan, precision: str) -> str:
    """The mode ``make_seg_interior`` builds for ``precision`` on a plan
    inside ``is_supported``: ``'wsplit3'`` only where the largest tile's
    float32 pair blocks and one frame's window fit ``MAX_SMEM_BYTES``, else
    the exact ``'fp32'`` kernel (an envelope decision taken at the build;
    nothing falls back at run time)."""
    if precision == "wsplit3" and not _tc_frames(op, _layout(op, plan), True):
        return "fp32"
    return precision


def make_seg_interior(
    op: PlaneOperator,
    plan: SegPhasePlan,
    device: torch.device | str = "cpu",
    precision: str = "fp32",
) -> SegInterior:
    """Host tables of ``plan`` plus the device dictionary in the kernel mode
    ``precision`` (``fused.PRECISIONS``), once per geometry: ``'bf16'``
    rounds the blocks to bfloat16; ``'wsplit3'`` stages them in float32 for
    the in-kernel split, or, where they do not fit (``kernel_precision``),
    builds the fp32 mode; the result's ``precision`` says which."""
    if precision not in PRECISIONS:
        raise ValueError(f"make_seg_interior: unknown precision {precision!r}")
    L = _layout(op, plan)
    if L is None:
        raise ValueError("make_seg_interior: plan outside the kernel envelope")
    precision = kernel_precision(op, plan, precision)
    win_h, win_w, ty, tx, nfb = L
    fs = op.filter_size
    sy, sx = _starts(plan.y), _starts(plan.x)
    check_window_starts(sy, op.src_height, fs, "make_seg_interior rows")
    check_window_starts(sx, op.src_width, fs, "make_seg_interior columns")

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(device)

    pair_blocks = op.pair_blocks
    tc = {}
    if precision == "bf16":
        pair_blocks = round_bf16(torch.from_numpy(pair_blocks)).numpy()
    if precision in TC_PARTS:
        fits = _tc_frames(op, L, precision == "wsplit3")
        if not fits:
            raise ValueError("make_seg_interior: plan outside the tensor-core kernel's envelope")
        tc_blocks = None
        if precision == "bf16":
            n_uy, n_ux = pair_blocks.shape[:2]
            padded = np.zeros((n_uy, n_ux, fs, k_slots(fs)), np.float32)
            padded[..., :fs] = pair_blocks
            tc_blocks = torch.from_numpy(padded).to(torch.bfloat16).to(device)
        pcx, scx = tile_columns(tx, TILE_X)
        tc = dict(tc_blocks=tc_blocks, pcx=t(pcx), scx=t(scx), tc_frames=max(fits))
    blocks = padded_blocks(pair_blocks, device)
    return SegInterior(
        blocks=blocks,
        pair_blocks_t=class_minor_view(blocks),
        cls_y=t(plan.y.cls),
        roff_y=t(plan.y.roff),
        cls_x=t(plan.x.cls),
        roff_x=t(plan.x.roff),
        start_y=t(sy),
        start_x=t(sx),
        lcy=t(ty.local),
        lcx=t(tx.local),
        tcy=t(ty.ids),
        tcx=t(tx.ids),
        ncy=t(ty.count),
        ncx=t(tx.count),
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
        pairs=ty.ids.shape[1] * tx.ids.shape[1],
        frames_per_block=nfb,
        precision=precision,
        **tc,
    )


def frames_of(si: SegInterior, n_frames: int) -> int:
    """Frames a block of a launch over ``n_frames``: ``frames_per_thread``,
    at most ``frames_per_block`` (the most whose rings fit beside the pair
    blocks), or in the bf16 mode ``tc_frames`` (the most whose windows
    do)."""
    tc = si.precision in TC_PARTS
    return min(frames_per_thread(n_frames), si.tc_frames if tc else si.frames_per_block)


def seg_interior_plain(si: SegInterior, src_f: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch form: (F, H, W) -> (F, py*nyb, px*nxb); under
    ``si.bf16`` the source is rounded to bfloat16 first (the blocks come
    rounded); under ``'wsplit3'`` this is the fp32 mode's form, whose
    products are exact for u8 sources. Calls are counted in
    ``seg_interior_plain.calls``, so that a run on the card can show that
    no engine took the plain form."""
    seg_interior_plain.calls += 1
    if si.bf16:
        src_f = round_bf16(src_f)
    return window_sum_plain(src_f, si.start_y, si.cls_y, si.start_x, si.cls_x, si.pair_blocks_t)


seg_interior_plain.calls = 0


def seg_interior(si: SegInterior, src_f: torch.Tensor) -> torch.Tensor:
    """Segment-periodic interior of ``src_f`` (F, H, W) float32.

    On a CPU tensor this is ``seg_interior_plain``. On a CUDA tensor it
    launches ``csrc/seg_interior.cu`` (counted in ``seg_interior.launches``,
    by ``si.precision`` in ``seg_interior.mode_launches`` and in the counter
    ``seg_launches``, after the launch; the bf16 and wsplit3 modes launch
    its tensor-core kernel) or raises; it never falls back.
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
    if si.blocks.device != src_f.device:
        raise ValueError("seg_interior: operator and source on different devices")
    hout, wout = si.out_shape
    out = torch.empty((F, hout, wout), dtype=torch.float32, device=src_f.device)
    if F == 0:
        return out
    with torch.cuda.device(src_f.device):
        if si.precision in TC_PARTS:
            bs, cw, plane = tc_words(si.fs, si.win_h, si.win_w, not si.bf16)
            nf = frames_of(si, F)
            tables = (
                si.start_y.data_ptr(), si.start_x.data_ptr(), si.lcy.data_ptr(),
                si.tcy.data_ptr(), si.tcx.data_ptr(), si.ncy.data_ptr(), si.ncx.data_ptr(),
                si.pcx.data_ptr(), si.scx.data_ptr(), out.data_ptr(), F, H, W, hout, wout,
                si.blocks.shape[1], si.fs, k_slots(si.fs),
            )  # fmt: skip
            tail = (si.tcy.shape[1], si.tcx.shape[1], si.pairs, bs, tc_table_words(nf), cw, plane,
                    nf, _build.stream_of(src_f))  # fmt: skip
            if si.bf16:
                rc = _build.library().jt_seg_interior_bf16(
                    src_f.data_ptr(), si.tc_blocks.data_ptr(), *tables, *tail
                )
            else:
                rc = _build.library().jt_seg_interior_wsplit3(
                    src_f.data_ptr(), si.blocks.data_ptr(), *tables, si.blocks.shape[3], *tail
                )
        else:
            rc = _build.library().jt_seg_interior(
                src_f.data_ptr(), si.blocks.data_ptr(), si.start_y.data_ptr(),
                si.start_x.data_ptr(), si.lcy.data_ptr(), si.lcx.data_ptr(), si.tcy.data_ptr(),
                si.tcx.data_ptr(), si.ncy.data_ptr(), si.ncx.data_ptr(), out.data_ptr(), F, H, W,
                hout, wout, si.blocks.shape[1], si.fs, si.blocks.shape[3], block_stride(si.fs),
                si.tcy.shape[1], si.tcx.shape[1], si.pairs, frames_of(si, F),
                row_floats(si.win_w, 1), _build.stream_of(src_f),
            )  # fmt: skip
    _build.check(rc, "jt_seg_interior")
    seg_interior.launches += 1
    seg_interior.mode_launches[si.precision] += 1
    metrics.count("seg_launches")
    return out


seg_interior.launches = 0
seg_interior.mode_launches = dict.fromkeys(PRECISIONS, 0)
