"""The exception-line fixups (``kernels/lines.py``) on the CPU, through their
plain form: against the per-tap sums the appliers ran before the fixups had
a kernel (``_cols_subset`` / ``_rows_subset``, copied below as they were),
the appliers against the host golden, the pixels where a column crosses a
row, the spec's segments and the fixups' counters. The CUDA kernel is held
to the same plain form at 0 difference on the card by ``chip_smoke.py``.

Tolerances: 2e-6 absolute for fp32 sources in [0, 1) (exact fp32 products,
only the summation order differs), <= 1 LSB for u8/u16 after ``finalize``.
"""

import numpy as np
import pytest
import torch

from jincresize_tpu_torch import metrics
from jincresize_tpu_torch.apply_conv import ConvApplier
from jincresize_tpu_torch.apply_conv_seg import SegConvApplier
from jincresize_tpu_torch.apply_xla import to_device
from jincresize_tpu_torch.golden import apply_plane_numpy
from jincresize_tpu_torch.kernels import lines
from jincresize_tpu_torch.operator import build_plane_operator, radius_for_tap
from jincresize_tpu_torch.phase import plan_phases, plan_phases_seg


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread for this module's tests: pytest-xdist runs
    several workers on one machine, and each worker's default pool (a
    thread a core) oversubscribes the cores. The old count is back after
    the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


F32_TOL = 2e-6

# (src_w, src_h, dst_w, dst_h, tap, planner): tests/test_torch_conv.py's 5/2
# upscale (one-concatenate assembly) and 3/2 drift (paste assembly),
# tests/test_torch_seg.py's 2.5x plane with exception columns, and the luma
# plane of the tap-16 1440p -> 1080p benchmark cell (fs 44: one exception
# column, 1903, and one row, 1063, which cross).
GEOMS = {
    "5/2-exceptions": (160, 120, 400, 300, 3, plan_phases),
    "3/2-drift": (320, 180, 480, 270, 3, plan_phases),
    "2.5x-exceptions": (1920, 80, 4800, 200, 2, plan_phases_seg),
    "tap16-fs44-luma": (2560, 1440, 1920, 1080, 16, plan_phases_seg),
}


@pytest.fixture(scope="module")
def planes():
    """{name: (operator, plan)}, built on first use."""
    cache = {}

    def get(name):
        if name not in cache:
            sw, sh, dw, dh, tap, planner = GEOMS[name]
            op = build_plane_operator(sw, sh, dw, dh, radius_for_tap(tap))
            cache[name] = (op, planner(op))
        return cache[name]

    return get


def _src(op, dtype=np.float32, peak=None, seed=0, frames=2):
    rng = np.random.default_rng(seed)
    shape = (frames, op.src_height, op.src_width)
    if dtype == np.float32:
        return rng.random(shape, dtype=np.float32)
    return rng.integers(0, int(peak) + 1, shape).astype(dtype)


def _maxdiff(a, b):
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


# The parent's fixups, as apply_conv held them: each exception column (all
# rows) and row (all columns) in torch ops, a loop over the vertical taps.
def _cols_subset(dop, src_f, sel):
    fs = dop.filter_size
    F, H, W = src_f.shape
    taps = torch.arange(fs)
    cols = torch.clamp(dop.start_x[sel][:, None] + taps[None, :], 0, W - 1)
    P = src_f[:, :, cols]  # (F, H, m, fs)
    cxs = dop.cx_idx[sel]
    acc = torch.zeros((F, dop.dst_height, sel.shape[0]), dtype=torch.float32)
    for ly in range(fs):
        rows = torch.clamp(dop.start_y + ly, 0, H - 1)
        Wrow = dop.pair_blocks[:, cxs, ly, :][dop.cy_idx]  # (dst_h, m, fs)
        acc += (P[:, rows] * Wrow).sum(-1)
    return acc


def _rows_subset(dop, src_f, sel):
    fs = dop.filter_size
    F, H, W = src_f.shape
    m = sel.shape[0]
    taps = torch.arange(fs)
    rows_n = torch.clamp(dop.start_y[sel][:, None] + taps[None, :], 0, H - 1)
    S = src_f[:, rows_n.reshape(-1)]  # (F, m*fs, W)
    cols = torch.clamp(dop.start_x[:, None] + taps[None, :], 0, W - 1)
    P = S[:, :, cols].reshape(F, m, fs, dop.dst_width, fs)  # (F, m, k, w, l)
    Wm = dop.pair_blocks[dop.cy_idx[sel]][:, dop.cx_idx]  # (m, w, fs, fs)
    return (P.permute(0, 1, 3, 2, 4) * Wm).sum((-2, -1))


@pytest.mark.parametrize("name", list(GEOMS))
def test_lines_match_the_parent_fixups(name, planes):
    """Every pixel of the exception columns and rows, over the whole plane:
    the same pixels written as the parent's column-then-row paste, and the
    same values within fp32 summation order."""
    op, plan = planes(name)
    ex, ey = plan.x.exceptions, plan.y.exceptions
    assert len(ex) + len(ey) > 0
    if name == "tap16-fs44-luma":
        assert list(ex) == [1903] and list(ey) == [1063]
    dop = to_device(op, "cpu")
    src = torch.from_numpy(_src(op, seed=len(name)))
    shape = (src.shape[0], op.dst_height, op.dst_width)
    got = torch.full(shape, float("nan"))
    lines.exc_lines(lines.make_lines(dop, ex, ey), src, got)
    want = torch.full(shape, float("nan"))
    ex_t, ey_t = torch.from_numpy(ex.astype(np.int64)), torch.from_numpy(ey.astype(np.int64))
    if len(ex):
        want[:, :, ex_t] = _cols_subset(dop, src, ex_t)
    if len(ey):
        want[:, ey_t, :] = _rows_subset(dop, src, ey_t)
    written = ~torch.isnan(want)
    assert torch.equal(~torch.isnan(got), written)
    assert _maxdiff(got[written], want[written]) <= F32_TOL


APPLIER_CASES = [
    ("5/2-exceptions", ConvApplier, np.float32, None),
    ("5/2-exceptions", ConvApplier, np.uint8, 255.0),
    ("3/2-drift", ConvApplier, np.float32, None),
    ("3/2-drift", ConvApplier, np.uint16, 1023.0),
    ("2.5x-exceptions", SegConvApplier, np.float32, None),
    ("2.5x-exceptions", SegConvApplier, np.uint16, 1023.0),
]


@pytest.mark.parametrize(
    "name,cls,dtype,peak",
    APPLIER_CASES,
    ids=[f"{c[0]}-{np.dtype(c[2]).name}" for c in APPLIER_CASES],
)
def test_appliers_with_lines_meet_the_golden(name, cls, dtype, peak, planes):
    op, plan = planes(name)
    ap = cls(op, plan=plan, device="cpu")
    assert ap.canvas.lines is not None
    src = _src(op, dtype, peak, seed=7)
    got = ap(torch.from_numpy(src), out_dtype=dtype, peak=peak).numpy()
    golden = np.stack([apply_plane_numpy(op, s, out_dtype=dtype, peak=peak) for s in src])
    assert got.dtype == np.dtype(dtype)
    assert _maxdiff(got, golden) <= (F32_TOL if dtype == np.float32 else 1)


def test_line_segments_give_crossings_to_the_rows():
    """Columns 2 and 9 over rows [1, 8), rows 3 and 5 over columns [0, 6):
    column 2 leaves rows 3 and 5 to the rows; column 9 lies outside the
    rows' columns and keeps all its rows."""
    got = lines.line_segments([2, 9], [3, 5], col_rows=(1, 8), row_cols=(0, 6))
    C, R = lines.COLUMN, lines.ROW
    want = [(C, 2, 1, 3), (C, 2, 4, 5), (C, 2, 6, 8), (C, 9, 1, 8), (R, 3, 0, 6), (R, 5, 0, 6)]
    assert got.dtype == np.int32
    assert [tuple(r) for r in got.tolist()] == want


@pytest.mark.parametrize("name", ["5/2-exceptions", "tap16-fs44-luma"])
def test_a_crossing_pixel_is_written_once_by_its_row(name, planes):
    """Each pixel of the spec once; a crossing of an exception column and
    row only in the row's segment. 5/2: the concatenate window, where rows
    span the interior's columns; tap 16: the whole canvas."""
    op, plan = planes(name)
    ex, ey = plan.x.exceptions, plan.y.exceptions
    if name == "5/2-exceptions":
        spec = ConvApplier(op, plan=plan, device="cpu").canvas.lines
        ylo, xlo, yhi, xhi = 8, 8, 293, 393
        assert spec.origin == (ylo, 0)
    else:
        spec = lines.make_lines(to_device(op, "cpu"), ex, ey)
        xlo, xhi = 0, op.dst_width
    pix = list(zip(*(a.tolist() for a in lines.pixels(spec)), strict=True))
    assert len(pix) == len(set(pix)) == spec.n_pixels
    crossings = {(int(y), int(x)) for y in ey for x in ex if xlo <= x < xhi}
    assert crossings and crossings <= set(pix)
    for kind, i, lo, hi in spec.lines.tolist():
        if kind == lines.COLUMN:
            assert not any((y, i) in crossings for y in range(lo, hi))
    assert spec.n_lines == len(ex) + len(ey)
    assert spec.max_len == int((spec.lines[:, 3] - spec.lines[:, 2]).max())


def test_make_lines_without_exceptions_and_outside_rows(planes):
    op, plan = planes("5/2-exceptions")
    dop = to_device(op, "cpu")
    empty = np.zeros(0, dtype=np.int64)
    assert lines.make_lines(dop, empty, empty) is None
    with pytest.raises(ValueError, match="outside the rows"):
        lines.make_lines(dop, plan.x.exceptions, plan.y.exceptions, col_rows=(20, 30))


COUNTER_CASES = [
    ("5/2-exceptions", ConvApplier, True),
    ("2.5x-exceptions", SegConvApplier, True),
    ("2x-tap8", ConvApplier, False),
]


@pytest.mark.parametrize("name,cls,has_lines", COUNTER_CASES, ids=[c[0] for c in COUNTER_CASES])
def test_exception_counters_count_a_launch_a_plane_call(name, cls, has_lines, planes):
    """On the CPU the plain form computes the lines and launches nothing:
    ``exception_lines`` rises by the plan's lines a plane call that has
    them, ``exception_launches`` and ``exc_lines.launches`` (one a plane
    call on the card) not at all; a 2x tap-8 plane has no lines and counts
    nothing."""
    if name == "2x-tap8":
        op = build_plane_operator(64, 48, 128, 96, radius_for_tap(8))
        ap = cls(op, device="cpu")
        n_lines = 0
    else:
        op, plan = planes(name)
        ap = cls(op, plan=plan, device="cpu")
        n_lines = len(plan.x.exceptions) + len(plan.y.exceptions)
    assert (ap.canvas.lines is not None) == has_lines and (n_lines > 0) == has_lines
    src = torch.from_numpy(_src(op, seed=1, frames=3))
    before, launches = metrics.counters(), lines.exc_lines.launches
    ap(src)
    ap(src[0])
    after = metrics.counters()
    assert after["exception_launches"] == before["exception_launches"]
    assert lines.exc_lines.launches == launches
    assert after["exception_lines"] - before["exception_lines"] == 2 * n_lines


def test_lines_count_nothing_when_they_raise_or_have_no_frames(planes):
    """A canvas that does not hold the lines raises, on the CPU as on the
    card, before any pixel is written or counted; an empty batch writes and
    counts nothing."""
    op, plan = planes("5/2-exceptions")
    spec = lines.make_lines(to_device(op, "cpu"), plan.x.exceptions, plan.y.exceptions)
    y0, y1, x0, x1 = spec.extent
    assert (y1, x1) == (op.dst_height, op.dst_width)
    src = torch.from_numpy(_src(op))
    before = metrics.counters()
    for h, w in ((y1 - 1, x1), (y1, x1 - 1)):
        out = torch.zeros((src.shape[0], h, w))
        with pytest.raises(ValueError, match="does not hold"):
            lines.exc_lines(spec, src, out)
        assert not out.any()
    lines.exc_lines(spec, src[:0], torch.zeros((0, y1, x1)))
    assert metrics.counters() == before
