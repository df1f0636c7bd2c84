"""Full-width top/bottom border strips: hand-written CUDA kernel and plain form.

``strips`` replaces ``jincresize_tpu/kernels/pallas_strips.py``
``make_strips_interior``/``_strips_kernel``. The reference builds border
pixels from raw positions with clamped windows, so the operator stores
per-pixel strip blocks (442 MB at 4K->8K tap 8). Every row of a top/bottom
strip reads one constant source window row, and ``start_x`` does not depend
on the row, so a strip row's blocks repeat with the interior's column phase
pattern: the host verifies that bit for bit (``_anchor_blocks``) and the
kernel reads ``px`` anchor blocks per row plus an ``fs``-row source band
instead of the per-pixel blocks. Corner columns and verified exceptions are
patched per pixel by the caller (``apply_conv``).

The CUDA kernel is ``csrc/strips.cu``: one block per (column tile, strip row,
frame x strip), the row's ``(px, fs, fs)`` anchors in shared memory, fp32
FMA. What bounds it on an H100: it is tiny (two strips of ~16 rows at 8K),
so launch latency and the ``fs**2`` load-issue chain per pixel, not bytes.

TPU workarounds of the Pallas kernel that this one drops:

* the VMEM-OOM gate ``px * round_up(fs, 8) > 120`` -- the envelope is the
  shared-memory size of one row's anchors, ``px * fs**2 * 4`` bytes, which
  ``phase.plan_phases``'s cost cap keeps under 128 KB;
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


def _odd_stride(n: int) -> int:
    """Per-phase stride of an anchor set: odd, so phases hit distinct banks."""
    return n if n % 2 else n + 1


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

    anchors: torch.Tensor  # (n_strips, ny_max, px, astride) f32, rows >= ny zero
    info: torch.Tensor  # (2*n_strips,) int32: [row0..., ny...]
    offs_x: torch.Tensor  # (px,) int32
    cols: torch.Tensor  # (nxb, px, fs) int64 source columns (plain form)
    rows: tuple  # ((row0, ny), ...) per strip, on the host
    px: int
    qx: int
    base_x: int
    nxb: int
    fs: int
    astride: int

    @property
    def n_strips(self) -> int:
        return len(self.rows)

    @property
    def ny_max(self) -> int:
        return self.anchors.shape[1]


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
    """
    fs = op.filter_size
    px, qx = plan.x.p, plan.x.q
    astride = _odd_stride(fs * fs)
    if px * astride * 4 > MAX_SMEM_BYTES:
        return None
    nxb = plan.x.nblocks
    xlo = plan.x.lo

    full = [
        s
        for s in op.strips
        if s.x0 == 0 and s.x1 == op.dst_width and (s.y1 - s.y0) > 0
    ]
    if not full:
        return None

    entries = []  # (strip, anchors, exc_cols, const_row)
    for s in full:
        # Constant window row: verified via start_y over the strip rows.
        sy = op.start_y[s.y0 : s.y1]
        if not (sy == sy[0]).all():
            return None
        r = _anchor_blocks(s, plan.x, fs)
        if r is None:
            return None
        anchors, exc = r
        entries.append((s, anchors, exc, int(sy[0])))

    ny_max = max(s.y1 - s.y0 for s, *_ in entries)
    A = np.zeros((len(entries), ny_max, px, astride), dtype=np.float32)
    for si, (s, anchors, _exc, _row) in enumerate(entries):
        A[si, : s.y1 - s.y0, :, : fs * fs] = anchors.reshape(s.y1 - s.y0, px, -1)
    rows = tuple((row, s.y1 - s.y0) for s, _a, _e, row in entries)
    info = np.array([r for r, _ in rows] + [n for _, n in rows], dtype=np.int32)
    offs_x = plan.x.offsets.astype(np.int32)
    cols = (
        plan.x.base
        + offs_x[None, :, None]
        + qx * np.arange(nxb)[:, None, None]
        + np.arange(fs)[None, None, :]
    )
    spec = Strips(
        anchors=torch.from_numpy(A).to(device),
        info=torch.from_numpy(info).to(device),
        offs_x=torch.from_numpy(offs_x).to(device),
        cols=torch.from_numpy(cols.astype(np.int64)).to(device),
        rows=rows,
        px=px,
        qx=qx,
        base_x=plan.x.base,
        nxb=nxb,
        fs=fs,
        astride=astride,
    )

    patches = []
    for s, _a, exc, _row in entries:
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


def strips_plain(st: Strips, src_f: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch form: band im2col + einsum against the anchors.

    ``src_f`` (F, H, W) float32 -> (F, n_strips, ny_max, px*nxb) float32.
    Reads past the plane are zeros, as in the kernel.
    """
    F, H, W = src_f.shape
    fs = st.fs
    need_w = int(st.cols.max()) + 1
    src_p = torch.nn.functional.pad(src_f, (0, max(0, need_w - W)))
    out = torch.zeros(
        (F, st.n_strips, st.ny_max, st.px * st.nxb),
        dtype=torch.float32,
        device=src_f.device,
    )
    A = st.anchors[..., : fs * fs].reshape(st.n_strips, st.ny_max, st.px, fs, fs)
    for si, (row0, ny) in enumerate(st.rows):
        band = src_p[:, row0 : row0 + fs]
        band = torch.nn.functional.pad(band, (0, 0, 0, fs - band.shape[1]))
        P = band[:, :, st.cols]  # (F, fs_ly, nxb, px, fs_lx)
        vals = einsum64("fkjrl,mrkl->fmjr", P, A[si, :ny])
        out[:, si, :ny] = vals.reshape(F, ny, st.nxb * st.px)
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
    if st.anchors.device != src_f.device:
        raise ValueError("strips: operator and source on different devices")
    F, H, W = src_f.shape
    out = torch.empty(
        (F, st.n_strips, st.ny_max, st.px * st.nxb),
        dtype=torch.float32,
        device=src_f.device,
    )
    if F == 0:
        return out
    with torch.cuda.device(src_f.device):
        rc = _build.library().jt_strips(
            src_f.data_ptr(), st.anchors.data_ptr(), st.info.data_ptr(),
            st.offs_x.data_ptr(), out.data_ptr(),
            F, H, W, st.n_strips, st.ny_max, st.px, st.qx, st.base_x, st.nxb,
            st.fs, st.astride, _build.stream_of(src_f),
        )  # fmt: skip
    _build.check(rc, "jt_strips")
    strips.launches += 1
    return out


strips.launches = 0
