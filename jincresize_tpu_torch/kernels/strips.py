"""Full-width top/bottom border strips: hand-written CUDA kernel and plain form.

``strips`` replaces ``jincresize_tpu/kernels/pallas_strips.py``
``make_strips_interior``/``_strips_kernel``. The reference builds border
pixels from raw positions with clamped windows, so the operator stores
per-pixel strip blocks (442 MB at 4K->8K tap 8). ``start_x`` does not depend
on the row, so a strip row's blocks repeat with the interior's column phase
pattern: the host verifies that bit for bit (``_anchor_blocks``) and the
kernel reads ``px`` anchor blocks per row plus the strip's source row band
instead of the per-pixel blocks. Corner columns and verified exceptions are
patched per pixel by the caller (``apply_conv``).

Each strip row keeps its own window start. The clamped top/bottom strips of
a plane's own operator share one start; a composed chain operator's bottom
strip steps from row to row (``compose``), and its windows may leave the
source, where the reference clamps the row and the kernel reads zeros. The
weights on such rows are zero in the composed operators, and ``make_strips``
declines an operator where one is not. The JAX kernel declines every strip
whose rows do not share a start, so on composed operators the port runs this
kernel where the JAX package takes its value path (same values).

The CUDA kernel is ``csrc/strips.cu``: a block takes 128 anchor columns of
one phase, up to 32 rows of one strip and one frame; the strip's source band
and each band row's weights stream through shared memory once and serve
every row; a thread holds 4 anchors x 4 rows, with each tap's 4 row weights
in one broadcast 16-byte load. What bounds it on an H100: fp32 FMA issue
(255 M FMAs a frame at 4K->1080p tap 16, against 1.3 MB of bytes); it runs
at a quarter to a sixth of that bound, its FMAs waiting on shared memory
(``PERF.md`` §6).

TPU workarounds of the Pallas kernel that this one drops:

* the VMEM-OOM gate ``px * round_up(fs, 8) > 120`` -- the envelope is the
  shared memory of a two-stage ring (``layout``), which fits every plan of
  ``phase.plan_phases``;
* the residue planes and the 0/1 scatter-matmul phase interleave -- a GPU
  thread reads strided columns and stores interleaved columns directly;
* the K-packing of taps and the padding of rows to multiples of 8.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..apply_xla import einsum64
from ..operator import BorderStrip, PlaneOperator
from ..phase import PhasePlan

from . import _build
from .fused import MAX_SMEM_BYTES

# Compile-time constants of csrc/strips.cu.
ANCHORS = 4  # anchor columns a thread (kR)
ROWS = 4  # strip rows a warp (kRows)
CHUNK = 8  # taps of a register window (kChunk)
TILE = 32 * ANCHORS  # anchor columns a block (kBJ)
MAX_WARPS = 8  # a block's warps: at most 32 strip rows (the kernel's 256-thread bound)
# Shared memory a block aims to stay under: band rows stream in stages of a
# few rows, so a block of a deep-tap strip leaves room for a second one.
SMEM_TARGET = 64 * 1024


def _skew(x: int) -> int:
    """Physical offset of window column ``x`` in a staged row: 4 floats of
    padding after every 32, so lanes ``qx*4`` columns apart hit distinct
    banks with 16-byte loads."""
    return x + 4 * (x >> 5)


@dataclass(frozen=True)
class Layout:
    """How the kernel tiles one operator (mirrors ``csrc/strips.cu``)."""

    rbr: int  # strip rows a block (ROWS a warp)
    nrb: int  # row blocks of a strip
    ch: int  # band rows a stage of the ring (2*ch slots)
    sw: int  # staged source columns: qx*(TILE - 1) + fs
    swp: int  # floats of a staged source row (skewed, with the windows' overrun)
    smem_bytes: int


def layout(ny_max: int, nb_max: int, fs: int, qx: int) -> Layout:
    """The kernel's tiling for strips of up to ``ny_max`` rows over bands of
    up to ``nb_max`` rows."""
    warps = min(MAX_WARPS, -(-ny_max // ROWS))
    rbr = ROWS * warps
    sw = qx * (TILE - 1) + fs
    # A register window reads up to 3 floats past the last staged column
    # (into the padding; those values are loaded, never used).
    swp = -(-(_skew(sw + 3) + 1) // 4) * 4
    row = fs * rbr + swp
    ch = max(1, min(nb_max, SMEM_TARGET // (2 * 4 * row)))
    smem = 4 * max(2 * ch * row, warps * ROWS * TILE)
    return Layout(rbr, -(-ny_max // rbr), ch, sw, swp, smem)


def _anchor_blocks(
    s: BorderStrip, plan_x, fs: int
) -> tuple[np.ndarray, np.ndarray] | None:
    """Per-(row, phase) anchor blocks + exact exception column set.

    Returns (anchors[ny, px, fs, fs], exc_cols absolute) or None when the
    pattern covers too little of the strip. A copy of
    ``jincresize_tpu.kernels.pallas_strips._anchor_blocks``, which imports jax.
    """
    lo, hi, px = plan_x.lo, plan_x.hi, plan_x.p
    B = s.blocks  # (ny, nx, fs, fs)
    ny = B.shape[0]
    anchors = np.zeros((ny, px, fs, fs), dtype=np.float32)
    plan_exc = set(int(v) for v in plan_x.exceptions)
    exc = []
    # Pick anchors from the first non-exception occurrence of each phase.
    for r in range(px):
        col = None
        for k in range((hi - lo) // px):
            c = lo + k * px + r
            if c not in plan_exc:
                col = c
                break
        if col is None:
            return None
        anchors[:, r] = B[:, col - s.x0]
    # Exact bitwise verification over the pattern-covered interior columns.
    cols = np.arange(lo, hi)
    ph = (cols - lo) % px
    for r in range(px):
        sel = cols[ph == r]
        eq = (B[:, sel - s.x0] == anchors[:, r][:, None]).all(axis=(0, 2, 3))
        exc.extend(int(c) for c in sel[~eq])
    exc.extend(c for c in plan_exc if lo <= c < hi)
    if len(exc) > (hi - lo) // 4:
        return None  # pattern mostly broken: fall back entirely
    return anchors, np.asarray(sorted(set(exc)), dtype=np.int64)


@dataclass(frozen=True)
class Strips:
    """Device operator of the strip kernel for the full-width strips of a plan."""

    # (n_strips, px, nrb, nb_max, fs, rbr) f32: band row k's tap lx of strip
    # row m = rb*rbr + mm at [si, rx, rb, k, lx, mm]; zero where the row's
    # window misses band row k and on rows >= ny.
    w: torch.Tensor
    info: torch.Tensor  # (3*n_strips,) int32: [row_min..., ny..., nb...]
    offs_x: torch.Tensor  # (px,) int32
    cols: torch.Tensor  # (nxb, px, fs) int64 source columns (plain form)
    rows: tuple  # ((row_min, ny, nb), ...) per strip, on the host
    px: int
    qx: int
    base_x: int
    nxb: int
    fs: int
    layout: Layout

    @property
    def n_strips(self) -> int:
        return len(self.rows)

    @property
    def ny_max(self) -> int:
        return max(ny for _, ny, _ in self.rows)

    @property
    def nb_max(self) -> int:
        return self.w.shape[3]


def verified_strips(op: PlaneOperator, plan: PhasePlan):
    """The full-width strips the kernel can take: ``(entries, None)`` with
    one ``(strip, anchors, exception columns, per-row window starts)`` a
    strip, or ``(None, why)`` when it declines the operator's strips."""
    fs = op.filter_size
    full = [
        s
        for s in op.strips
        if s.x0 == 0 and s.x1 == op.dst_width and (s.y1 - s.y0) > 0
    ]
    if not full:
        return None, "no full-width strip"
    entries = []
    for s in full:
        r = _anchor_blocks(s, plan.x, fs)
        if r is None:
            return None, f"rows {s.y0}-{s.y1}: anchor pattern too broken"
        anchors, exc = r
        row0 = np.asarray(op.start_y[s.y0 : s.y1], dtype=np.int64)
        ys = row0[:, None] + np.arange(fs)  # (ny, fs) window rows
        outside = (ys < 0) | (ys >= op.src_height)
        if anchors.transpose(0, 2, 1, 3)[outside].any():
            return None, f"rows {s.y0}-{s.y1}: weight on a window row outside the source"
        entries.append((s, anchors, exc, row0))
    return entries, None


def make_strips(op: PlaneOperator, plan: PhasePlan, device="cpu"):
    """Build the top/bottom strip kernel's operator.

    Returns None if no full-width strip qualifies, else ``(strips, patches,
    meta)``: ``strips(src_f)`` computes the pattern-covered values ``(F,
    n_strips, ny_max, px*nxb)`` (paste at column ``meta['xlo']``; strip si's
    first ``y1 - y0`` rows); ``patches`` is a list of (strip, cols) whose
    columns (corners + verified exceptions) the caller recomputes per pixel;
    ``meta`` holds ``strips`` (y0, y1) per strip, ``ny_p`` (rows per strip
    slot), ``xlo`` and ``width``. The JAX builder returns the same triple,
    though its docstring names only ``(fn, patches)``.

    Declines (None) when a strip's anchor pattern is too broken
    (``_anchor_blocks``) or a strip has a nonzero anchor weight on a window
    row outside the source: the kernel reads zeros there, the reference the
    clamped row.
    """
    entries, _why = verified_strips(op, plan)
    if entries is None:
        return None
    fs = op.filter_size
    px, qx = plan.x.p, plan.x.q
    nxb = plan.x.nblocks
    xlo = plan.x.lo

    ny_max = max(len(row0) for *_, row0 in entries)
    rows = tuple(
        (int(row0.min()), len(row0), int(row0.max() - row0.min()) + fs)
        for *_, row0 in entries
    )
    nb_max = max(nb for *_, nb in rows)
    lay = layout(ny_max, nb_max, fs, qx)
    if lay.smem_bytes > MAX_SMEM_BYTES:
        return None
    n_strips = len(entries)
    A = np.zeros((n_strips, px, lay.nrb * lay.rbr, nb_max, fs), dtype=np.float32)
    for si, (_s, anchors, _exc, row0) in enumerate(entries):
        for m, d in enumerate(row0 - row0.min()):
            A[si, :, m, d : d + fs] = anchors[m]
    A = A.reshape(n_strips, px, lay.nrb, lay.rbr, nb_max, fs).transpose(0, 1, 2, 4, 5, 3)
    info = np.array([v for i in range(3) for v in (r[i] for r in rows)], dtype=np.int32)
    offs_x = plan.x.offsets.astype(np.int32)
    cols = (
        plan.x.base
        + offs_x[None, :, None]
        + qx * np.arange(nxb)[:, None, None]
        + np.arange(fs)[None, None, :]
    )
    spec = Strips(
        w=torch.from_numpy(np.ascontiguousarray(A)).to(device),
        info=torch.from_numpy(info).to(device),
        offs_x=torch.from_numpy(offs_x).to(device),
        cols=torch.from_numpy(cols.astype(np.int64)).to(device),
        rows=rows,
        px=px,
        qx=qx,
        base_x=plan.x.base,
        nxb=nxb,
        fs=fs,
        layout=lay,
    )

    patches = []
    for s, _a, exc, _row0 in entries:
        # Corner columns + verified exceptions -> per-pixel recompute.
        pcols = sorted(
            set(range(0, xlo))
            | set(range(xlo + px * nxb, op.dst_width))
            | set(int(c) for c in exc)
        )
        patches.append((s, np.asarray(pcols, dtype=np.int64)))
    meta = {
        "strips": [(s.y0, s.y1) for s, *_ in entries],
        "ny_p": ny_max,
        "xlo": xlo,
        "width": px * nxb,
    }
    return spec, patches, meta


def band_anchors(st: Strips) -> torch.Tensor:
    """The kernel's weights as (n_strips, rows, px, nb_max, fs): strip row
    m's taps at its own offset in the strip's band, zeros elsewhere."""
    lay = st.layout
    return st.w.permute(0, 2, 5, 1, 3, 4).reshape(
        st.n_strips, lay.nrb * lay.rbr, st.px, st.nb_max, st.fs
    )


def _strip_windows(st: Strips, src_f: torch.Tensor):
    """Each strip's ``(si, ny, P, A)``: ``P`` (F, nb, nxb, px, fs) the
    source windows of its band (zeros past the plane, as in the kernel),
    ``A`` (ny, px, nb, fs) its rows' banded anchors."""
    F, H, W = src_f.shape
    need_w = int(st.cols.max()) + 1
    src_p = torch.nn.functional.pad(src_f, (0, max(0, need_w - W)))
    A = band_anchors(st)
    for si, (row_min, ny, nb) in enumerate(st.rows):
        band = src_p.new_zeros((F, nb, src_p.shape[2]))
        lo, hi = max(row_min, 0), min(row_min + nb, H)
        if hi > lo:
            band[:, lo - row_min : hi - row_min] = src_p[:, lo:hi]
        yield si, ny, band[:, :, st.cols], A[si, :ny, :, :nb]


def strips_plain(st: Strips, src_f: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch form: band im2col + einsum against the banded anchors.

    ``src_f`` (F, H, W) float32 -> (F, n_strips, ny_max, px*nxb) float32.
    Reads past the plane are zeros, as in the kernel.
    """
    F = src_f.shape[0]
    out = src_f.new_zeros((F, st.n_strips, st.ny_max, st.px * st.nxb))
    for si, ny, P, A in _strip_windows(st, src_f):
        vals = einsum64("fkjrl,mrkl->fmjr", P, A)
        out[:, si, :ny] = vals.reshape(F, ny, st.nxb * st.px)
    return out


def strips_chain(st: Strips, src_f: torch.Tensor) -> torch.Tensor:
    """``strips_plain``'s sums as the kernel takes them: float32, one
    multiply-add a tap in (band row, tap) order, zero taps included (exact
    no-ops). On a CUDA tensor each ``addcmul_`` step is one fused
    multiply-add, so this equals ``csrc/strips.cu`` bit for bit; it is the
    reference the kernel is held to at 0, where the float64 ``strips_plain``
    differs from any float32 chain by that chain's rounding."""
    F = src_f.shape[0]
    out = src_f.new_zeros((F, st.n_strips, st.ny_max, st.px * st.nxb))
    for si, ny, P, A in _strip_windows(st, src_f):
        acc = src_f.new_zeros((F, ny, st.nxb, st.px))
        for k in range(P.shape[1]):
            for lx in range(st.fs):
                acc.addcmul_(A[None, :, None, :, k, lx], P[:, None, k, :, :, lx])
        out[:, si, :ny] = acc.reshape(F, ny, st.nxb * st.px)
    return out


def strips(st: Strips, src_f: torch.Tensor) -> torch.Tensor:
    """Full-width strip values of ``src_f`` (F, H, W) float32.

    On a CPU tensor this is ``strips_plain``. On a CUDA tensor it launches
    ``csrc/strips.cu`` (counted in ``strips.launches``) or raises; it never
    falls back.
    """
    if src_f.device.type == "cpu":
        return strips_plain(st, src_f)
    if src_f.device.type != "cuda":
        raise RuntimeError(f"strips: unsupported device {src_f.device}")
    if src_f.dtype != torch.float32 or src_f.dim() != 3 or not src_f.is_contiguous():
        raise ValueError("strips: src must be a contiguous (F, H, W) float32 tensor")
    if st.w.device != src_f.device:
        raise ValueError("strips: operator and source on different devices")
    F, H, W = src_f.shape
    out = torch.empty(
        (F, st.n_strips, st.ny_max, st.px * st.nxb),
        dtype=torch.float32,
        device=src_f.device,
    )
    if F == 0:
        return out
    lay = st.layout
    with torch.cuda.device(src_f.device):
        rc = _build.library().jt_strips(
            src_f.data_ptr(), st.w.data_ptr(), st.info.data_ptr(), st.offs_x.data_ptr(),
            out.data_ptr(), F, H, W, st.n_strips, st.ny_max, st.px, st.qx, st.base_x, st.nxb,
            st.fs, st.nb_max, lay.rbr, lay.nrb, lay.ch, lay.swp, _build.stream_of(src_f),
        )  # fmt: skip
    _build.check(rc, "jt_strips")
    strips.launches += 1
    return out


strips.launches = 0
