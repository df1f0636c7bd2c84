"""Gather-light border-strip apply for periodic geometries.

Port of ``jincresize_tpu/apply_strips_fast.py``. Every top-strip pixel has
window start_y == 0, bottom-strip rows share start_y == src_h - fs, and
left/right strip columns share start_x == 0 / src_w - fs; the other axis of
each strip follows the interior's periodic pattern with exceptions. A strip
therefore touches only an (fs x W) or (H x fs) source band: all its windows
come from one sliding-window view of that band, picked per destination
coordinate by the pattern (and by the operator's starts at exceptions), and
one einsum against the per-pixel strip blocks (``apply_xla.einsum64``)
gives the strip.

In the fused engine the top/bottom strips run on ``kernels/strips.py``; this
module computes the left/right strips (and any strip the kernel declines).

It also holds the strips' per-pixel form, which needs no periodic plan:
``_strip_values`` gathers each strip's windows from a full-height im2col
(the fused engine's strips where ``plan_strips`` declines). The
segment-periodic and gather engines' strips run on
``kernels/band_strips.py``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .apply_xla import DevicePlaneOperator, einsum64


@dataclass(frozen=True)
class StripPlan:
    """Static recipe for one strip's gather-light apply."""

    kind: str  # 'top' | 'bottom' | 'left' | 'right'
    const_start: int  # shared window start on the clamped axis
    # Free-axis periodic pattern (from the interior phase plan):
    lo: int  # first pattern-covered coordinate (absolute)
    p: int
    q: int
    anchor_start: tuple  # (p,) window starts of the anchor period
    nblocks: int
    exc: np.ndarray  # absolute free-axis coords needing the gather path
    rect: tuple  # (y0, y1, x0, x1)


def plan_strips(op, phase_plan) -> list[StripPlan] | None:
    """Build strip plans; None if preconditions fail (use the einsum path).

    A copy of ``jincresize_tpu.apply_strips_fast.plan_strips``, whose module
    imports jax.
    """
    fs = op.filter_size
    if op.src_width < fs or op.src_height < fs:
        return None
    plans = []
    px_plan, py_plan = phase_plan.x, phase_plan.y
    for s in op.strips:
        full_width = s.x0 == 0 and s.x1 == op.dst_width
        if full_width and s.y1 <= op.y_lo:
            kind, const, ax = "top", 0, px_plan
        elif full_width and s.y0 >= op.y_hi:
            kind, const, ax = "bottom", op.src_height - fs, px_plan
        elif s.x1 <= op.x_lo:
            kind, const, ax = "left", 0, py_plan
        elif s.x0 >= op.x_hi:
            kind, const, ax = "right", op.src_width - fs, py_plan
        else:
            return None
        if kind in ("top", "bottom"):
            starts = op.start_y[s.y0 : s.y1]
            f0, f1 = s.x0, s.x1
        else:
            starts = op.start_x[s.x0 : s.x1]
            f0, f1 = s.y0, s.y1
        if not (starts == const).all():
            return None
        rng = np.arange(f0, f1)
        exc_set = set(int(e) for e in ax.exceptions)
        exc = np.array(
            sorted(
                int(c)
                for c in rng
                if (c < ax.lo or c >= ax.lo + ax.p * ax.nblocks or c in exc_set)
            ),
            dtype=np.int32,
        )
        plans.append(
            StripPlan(
                kind=kind,
                const_start=const,
                lo=ax.lo,
                p=ax.p,
                q=ax.q,
                anchor_start=tuple(int(v) for v in ax.anchor_start),
                nblocks=ax.nblocks,
                exc=exc,
                rect=(s.y0, s.y1, s.x0, s.x1),
            )
        )
    return plans


def _window_index(
    sp: StripPlan, free_len: int, free0: int, starts: torch.Tensor
) -> torch.Tensor:
    """Per-destination-coordinate window start on the free axis.

    Pattern coordinates ``lo + p*k + r`` take ``anchor_start[r] + q*k``;
    exception coordinates take the operator's own start. ``plan_strips``
    lists every strip coordinate outside the pattern as an exception, so
    every one of the ``free_len`` coordinates gets a window.
    """
    dev = starts.device
    k = torch.arange(sp.p * sp.nblocks, device=dev)
    anchor = torch.tensor(sp.anchor_start, dtype=torch.int64, device=dev)
    idx = torch.zeros(free_len, dtype=torch.int64, device=dev)
    off = sp.lo - free0
    idx[off : off + len(k)] = anchor[k % sp.p] + sp.q * (k // sp.p)
    if len(sp.exc):
        exc = torch.from_numpy(sp.exc.astype(np.int64)).to(dev)
        idx[exc - free0] = starts[exc]
    return idx


def window_indices(dop, strip_plans) -> list[torch.Tensor]:
    """Every strip's window starts on its free axis (``_window_index``), on
    the operator's device. Built once per applier: the anchors come from the
    host, and a host-to-device copy per call would wait for the stream."""
    out = []
    for sp in strip_plans:
        y0, y1, x0, x1 = sp.rect
        if sp.kind in ("top", "bottom"):
            out.append(_window_index(sp, x1 - x0, x0, dop.start_x))
        else:
            out.append(_window_index(sp, y1 - y0, y0, dop.start_y))
    return out


def strip_values_fast(dop, strip_plans, idxs, src_f, only=None):
    """Compute strip value blocks from one source band per strip.

    ``src_f`` is (F, H, W) float32; ``idxs`` are the strips'
    ``window_indices``. Returns [(index, (y0, y1, x0, x1), values (F, ny,
    nx))]; ``only`` (tuple of indices into dop.strips) restricts which
    strips are computed -- used when the strip kernel already covered the
    rest.
    """
    fs = dop.filter_size
    out = []
    for i, (s, sp, idx) in enumerate(zip(dop.strips, strip_plans, idxs)):
        if only is not None and i not in only:
            continue
        c = sp.const_start
        if sp.kind in ("top", "bottom"):
            band = src_f[:, c : c + fs, :]  # (F, fs_ly, W)
            S = band.unfold(2, fs, 1)  # (F, fs_ly, U, fs_lx)
            vec = S[:, :, idx, :]  # (F, fs_ly, nx, fs_lx)
            acc = einsum64("fkxl,yxkl->fyx", vec, s.blocks)
        else:
            band = src_f[:, :, c : c + fs]  # (F, H, fs_lx)
            S = band.unfold(1, fs, 1)  # (F, U, fs_lx, fs_ly)
            vec = S[:, idx]  # (F, ny, fs_lx, fs_ly)
            acc = einsum64("fylk,yxkl->fyx", vec, s.blocks)
        out.append((i, sp.rect, acc))
    return out


# ---------------------------------------------------------------------------
# Per-pixel strip values. Sources are (F, H, W) float32; results carry the
# frame dimension first.
# ---------------------------------------------------------------------------


def _strip_values(dop: DevicePlaneOperator, src_f, s) -> torch.Tensor:
    """Per-pixel border strip apply: (F, ny, nx) via one im2col and tap sums."""
    fs = dop.filter_size
    F, H, W = src_f.shape
    taps = torch.arange(fs, device=src_f.device)
    cols = torch.clamp(dop.start_x[s.x0 : s.x1][:, None] + taps[None, :], 0, W - 1)
    P = src_f[:, :, cols]  # (F, H, nx, fs)
    rows = torch.clamp(dop.start_y[s.y0 : s.y1][:, None] + taps[None, :], 0, H - 1)
    G = P[:, rows]  # (F, ny, k, nx, l)
    return (G.permute(0, 1, 3, 2, 4) * s.blocks).sum((-2, -1))
