"""Phase compiler: detect periodic structure of the resampling geometry.

The reference's quantized geometry is, for rational scale factors, periodic:
destination columns repeat their (quantization class, window-start advance)
pattern with period p while the source window advances by q — float32
position drift (the reference accumulates ``xpos += x_step`` in float32,
JincResize.cpp:524) breaks the pattern at a small set of *exception* columns.

This module detects, per axis, the smallest (p, q) pattern over the interior
coordinates and the exception set. A periodic axis pair turns the interior
apply into a phase-decomposed strided convolution (see apply_conv.py) with
zero gathers; exceptions and borders are patched separately. This has no
analog in the reference (its gather-MAC is insensitive to periodicity). A copy
of ``jincresize_tpu/phase.py`` with its code unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .operator import PlaneOperator


@dataclass(frozen=True)
class AxisPhasePlan:
    """Periodic structure of one destination axis over its interior range."""

    lo: int  # interior start (first non-border coordinate)
    hi: int  # end of the phase-covered range (lo + p * nblocks)
    p: int  # destination period
    q: int  # source window advance per period
    anchor_start: np.ndarray  # (p,) int: start[lo + r]
    anchor_cls: np.ndarray  # (p,) int32: dictionary index cx_idx[lo + r]
    exceptions: np.ndarray  # coordinates (absolute) deviating from the pattern
    nblocks: int  # number of full periods covered

    @property
    def offsets(self) -> np.ndarray:
        """Kernel embedding offsets per phase: start relative to the minimum."""
        return self.anchor_start - self.anchor_start.min()

    @property
    def base(self) -> int:
        """Source base coordinate of block 0 (minimum anchor start)."""
        return int(self.anchor_start.min())


def _plan_axis(
    cls_idx: np.ndarray,
    start: np.ndarray,
    lo: int,
    hi: int,
    max_period: int = 64,
    max_exception_frac: float = 0.25,
) -> AxisPhasePlan | None:
    """Find the smallest (p, q) pattern on [lo, hi); None if nothing usable."""
    n = hi - lo
    if n < 2:
        return None
    c = cls_idx[lo:hi]
    s = start[lo:hi]
    best = None
    # A usable period must actually repeat: p close to n makes every axis
    # trivially "periodic" (k//p == 0 almost everywhere) and explodes the
    # phase count — require at least 3 full repetitions.
    for p in range(1, min(max_period, n // 3) + 1):
        q = int(s[p] - s[0])
        if q < 0:
            continue
        k = np.arange(n)
        expected_s = s[k % p] + (k // p) * q
        dev = (c != c[k % p]) | (s != expected_s)
        n_exc = int(dev.sum())
        if n_exc == 0:
            best = (p, q, dev)
            break
        if n_exc <= n * max_exception_frac and (
            best is None or n_exc < int(best[2].sum())
        ):
            best = (p, q, dev)
    if best is None:
        return None
    p, q, dev = best
    nblocks = n // p
    # Trailing partial period: treat as exceptions.
    tail = np.zeros(n, dtype=bool)
    tail[nblocks * p :] = True
    dev = dev | tail
    exceptions = lo + np.flatnonzero(dev)
    if len(exceptions) > n * max_exception_frac:
        return None
    return AxisPhasePlan(
        lo=lo,
        hi=lo + nblocks * p,
        p=p,
        q=q,
        anchor_start=s[:p].astype(np.int64),
        anchor_cls=c[:p].astype(np.int32),
        exceptions=exceptions,
        nblocks=nblocks,
    )


@dataclass(frozen=True)
class PhasePlan:
    """Joint plan: both axes periodic => interior is a strided convolution."""

    x: AxisPhasePlan
    y: AxisPhasePlan


# Conv-path cost guard: the unrolled interior does py*px*fs^2 scalar-weight
# FMAs worth of HLO; past ~32k ops compile time dwarfs any conv win — the
# gather path handles such geometries better. Shared by plan_phases and the
# geometry_is_periodic probe so the drift hint can never claim a conv path
# that planning would decline.
MAX_UNROLL_OPS = 32768


def _within_cost_guard(p_y: int, p_x: int, fs: int) -> bool:
    return p_y * p_x * fs * fs <= MAX_UNROLL_OPS


def plan_phases(op: PlaneOperator, max_period: int = 64) -> PhasePlan | None:
    """Build the phase plan for an operator; None if either axis is aperiodic."""
    if op.x_hi <= op.x_lo or op.y_hi <= op.y_lo:
        return None
    px = _plan_axis(op.cx_idx, op.start_x, op.x_lo, op.x_hi, max_period)
    if px is None:
        return None
    py = _plan_axis(op.cy_idx, op.start_y, op.y_lo, op.y_hi, max_period)
    if py is None:
        return None
    if px.nblocks < 1 or py.nblocks < 1:
        return None
    if not _within_cost_guard(py.p, px.p, op.filter_size):
        return None
    return PhasePlan(x=px, y=py)


def geometry_is_periodic(g, max_period: int = 64) -> bool:
    """Cheap phase-plan probe on a PlaneGeometry (no coefficient build).

    Used for the drift hint (api.py): when the parity (f32-position) operator
    lands on the gather or general path, this checks whether the same request under
    ``pos_dtype='f64'`` would plan onto the conv path — classes and starts
    are all that planning needs, and a geometry build is milliseconds while
    an operator build is seconds. Uses the same _plan_axis detector and
    _within_cost_guard predicate as plan_phases, so the two cannot drift.
    """
    from .operator import _contiguous_border

    fs = g.filter_size
    plans = []
    for ax in (g.y, g.x):
        lo, hi = _contiguous_border(ax.border)
        p = _plan_axis(ax.qclass, ax.start, lo, hi, max_period)
        if p is None:
            return False
        plans.append(p)
    return _within_cost_guard(plans[0].p, plans[1].p, fs)


# ---------------------------------------------------------------------------
# Segment-periodic plans: the bit-parity answer to float32 position drift.
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SegAxisPlan:
    """Quasi-periodic structure of one axis under float32 position drift.

    The reference's f32 position walk (JincResize.cpp:524) keeps window
    starts affine for rational scale ratios — measured at 1.5x/2.5x up to 4K,
    ``start[k] = base + q*((k-lo)//p) + roff[k]`` with a small bounded
    per-coordinate offset ``roff`` — while the quantization classes drift as
    per-residue staircases (~20-250 steps per axis). This plan keeps the
    per-coordinate truth (classes and relative offsets) instead of a single
    anchor pattern, so the fused kernel can run the drifted geometry exactly
    (bit parity): classes become per-band/per-tile weight
    variants, offsets fold into the extended tap range like phase offsets do.
    """

    lo: int  # pattern-covered range start (first non-border coordinate)
    hi: int  # lo + p * nblocks
    p: int  # destination period of the window-start pattern
    q: int  # source advance per period
    nblocks: int
    base: int  # source coordinate of block 0 (min start - q*j over range)
    roff: np.ndarray  # (p*nblocks,) int16 start offset rel. to base + q*j
    cls: np.ndarray  # (p*nblocks,) int32 dictionary index per coordinate
    exceptions: np.ndarray  # absolute coords excluded from the pattern

    @property
    def spread(self) -> int:
        return int(self.roff.max()) if len(self.roff) else 0


@dataclass(frozen=True)
class SegPhasePlan:
    """Joint segment-periodic plan: both axes quasi-periodic."""

    x: SegAxisPlan
    y: SegAxisPlan


def _plan_axis_seg(
    cls_idx: np.ndarray,
    start: np.ndarray,
    lo: int,
    hi: int,
    max_period: int = 64,
    max_spread: int = 8,
    max_exception_frac: float = 0.25,
    max_step_density: float = 0.25,
) -> SegAxisPlan | None:
    """Fit the smallest (p, q) start pattern allowing class drift.

    Unlike ``_plan_axis``, classes are unconstrained (any staircase is
    representable as kernel weight variants) — only the start structure and
    the variant *density* gate the plan: the fused-seg kernel's dot cost
    scales with the number of distinct classes per column tile, so axes whose
    class runs are shorter than ~1/max_step_density blocks fall back to the
    gather path.
    """
    n = hi - lo
    if n < 8:
        return None
    s = start[lo:hi].astype(np.int64)
    c = cls_idx[lo:hi].astype(np.int64)
    best = None
    for p in range(1, min(max_period, n // 3) + 1):
        dq = s[p:] - s[:-p]
        # Mode, not int(median): for even-length dq the median can be a
        # half-integer average and int() truncates, mis-fitting a valid
        # (p, q) pattern (ADVICE r4). The modal advance is always an actual
        # observed integer step.
        vals, counts = np.unique(dq, return_counts=True)
        q = int(vals[np.argmax(counts)])
        if q < max(1, p // 8):  # degenerate: no source advance
            continue
        k = np.arange(n)
        j = k // p
        r = k % p
        res = s - q * j  # affine residue; constant-per-residue if exact
        # Per-residue modal offset; deviations stay as roff as long as the
        # total spread is small, else the coordinate becomes an exception.
        base = int(res.min())
        roff = res - base
        exc = roff > max_spread
        n_exc = int(exc.sum())
        if n_exc > n * max_exception_frac:
            continue
        # Class-step density per residue (drift staircases): the kernel cost
        # gate. Steps counted on non-exception coords only.
        steps = 0
        for rr in range(p):
            cr = c[rr::p][~exc[rr::p]]
            if len(cr) > 1:
                steps += int((np.diff(cr) != 0).sum())
        density = steps / max(1, n // p)
        if density > max_step_density * p:
            continue
        score = (n_exc, steps, p)
        if best is None or score < best[0]:
            best = (score, p, q, base, roff, exc)
        if n_exc == 0 and steps == 0:
            break  # exactly periodic: smallest p wins outright
    if best is None:
        return None
    _, p, q, base, roff, exc = best
    nblocks = n // p
    tail = np.zeros(n, dtype=bool)
    tail[nblocks * p :] = True
    exc = exc | tail
    exceptions = lo + np.flatnonzero(exc)
    if len(exceptions) > n * max_exception_frac:
        return None
    cov = nblocks * p
    # Exception coords keep placeholder pattern values (clamped roff, real
    # class) — they are recomputed by the fixup pass, so any in-range value
    # is safe for the kernel.
    roff_cov = np.clip(roff[:cov], 0, max_spread).astype(np.int16)
    return SegAxisPlan(
        lo=lo,
        hi=lo + cov,
        p=p,
        q=q,
        nblocks=nblocks,
        base=base,
        roff=roff_cov,
        cls=c[:cov].astype(np.int32),
        exceptions=exceptions,
    )


def plan_phases_seg(op: PlaneOperator, max_period: int = 64) -> SegPhasePlan | None:
    """Segment-periodic plan for a drifted operator; None if unstructured.

    This is the planner behind the bit-parity seg path for drifted rational
    scales (1.5x, 2.5x, ... upscales under pos_precision='f32'): where
    ``plan_phases`` demands one exact anchor pattern, this accepts any
    bounded-offset start structure plus class staircases. Geometries that are
    exactly periodic should use ``plan_phases`` (cheaper kernel); callers try
    that first.
    """
    if op.x_hi <= op.x_lo or op.y_hi <= op.y_lo:
        return None
    px = _plan_axis_seg(op.cx_idx, op.start_x, op.x_lo, op.x_hi, max_period)
    if px is None:
        return None
    py = _plan_axis_seg(op.cy_idx, op.start_y, op.y_lo, op.y_hi, max_period)
    if py is None:
        return None
    if px.nblocks < 2 or py.nblocks < 2:
        return None
    return SegPhasePlan(x=px, y=py)


def build_conv_kernels(op: PlaneOperator, plan: PhasePlan) -> np.ndarray:
    """Embed per-phase-pair coefficient blocks into conv kernels.

    Returns (py*px, 1, Kh, Kw) float32 with each phase's (fs, fs) block placed
    at its source-offset within the enlarged shared window, so one VALID
    conv with strides (qy, qx) computes every phase as an output channel.
    """
    fs = op.filter_size
    offs_y = plan.y.offsets
    offs_x = plan.x.offsets
    Kh = fs + int(offs_y.max())
    Kw = fs + int(offs_x.max())
    py, px = plan.y.p, plan.x.p
    K = np.zeros((py * px, 1, Kh, Kw), dtype=np.float32)
    for ry in range(py):
        for rx in range(px):
            blk = op.pair_blocks[plan.y.anchor_cls[ry], plan.x.anchor_cls[rx]]
            oy, ox = int(offs_y[ry]), int(offs_x[rx])
            K[ry * px + rx, 0, oy : oy + fs, ox : ox + fs] = blk
    return K
