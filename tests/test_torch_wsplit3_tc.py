"""The u8 weight-split kernels' layouts and orders, held to the plain forms
without a card.

``precision='wsplit3'`` runs u8 planes on the tensor cores with three
bfloat16 parts of each weight. ``csrc/fused_interior.cu``'s
``fused_ws3_kernel`` stages the window a stage ahead of its products
(landed in float32, rounded to bfloat16 once, two copies of each row),
walks several frames a block (``fused.ws3_frames``), and keeps each phase
group's three weight parts in 16-byte weight rows (``fused.ws3_layout``,
``fused.ws3_weights``, ``fused.weight_row``), running each staged row
against the n-tiles whose anchor rows read it alone (``fused.live_tiles``):
a B fragment is one ``ldmatrix``, or, where zero rows pad each residue
(the default shape with 4 phases a block), the rows that reach every
n-tile run as ``wgmma`` with B read through a descriptor.
``csrc/seg_interior.cu``'s ``seg_tc_kernel`` stages a tile's pair blocks
in float32, split at each B load, at the fp32 mode's ``fsp``-float rows
so that two frames a block fit at 1440p -> 1080p tap 16.

This module checks those host layouts (each weight part at its slot
exactly once, zeros elsewhere; the envelope; the frames a block) and
emulates the fused kernel in NumPy from them -- shared memory word by
word (unwritten words NaN, so a read of one poisons the output), the
``ldmatrix`` rows lane by lane, every mma as one fp32 product of its
matrices added to its accumulator -- against the port's fp32 plain form
on u8 sources within ``fused.wsplit3_bound``.
``tests/test_torch_u8src.py`` holds this emulation, and the seg kernel's
(``tests/test_torch_bf16_tc.py`` ``emulate_seg``), to the JAX package's
``wsplit3`` and ``wsplit3_vmem`` Pallas kernels in interpret mode.
"""

import numpy as np
import pytest
import torch

from jincresize_tpu_torch.kernels import fused, seg
from jincresize_tpu_torch.kernels.fused import WS3_MW, WS3_PARTS
from jincresize_tpu_torch.operator import build_plane_operator, radius_for_tap
from jincresize_tpu_torch.phase import plan_phases, plan_phases_seg
from jincresize_tpu_torch.tools import kernel_variants, u8_kernel_timing

from test_torch_bf16_tc import G_ID, T_ID, _mma, _r16


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread for this module's tests (the workers of
    pytest-xdist share the machine's cores); the old count is back after
    the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# Fused planes: 2x up tap 3 (kw 7: a k8 chunk alone), 2x up tap 8 (kw 17:
# the packed one-tap tail), 2x down tap 4 (one phase, qy 2, kw 17), the
# 2/3 plan (qx 3, kw 15: a zero-padded k16 chunk) and 2/5 down tap 3 (qx
# 5, kw 10: a k16 chunk). Seg planes: 1.5x up tap 3 (fs 7), 4/3 down tap
# 4 (fs 12), 2x down tap 4 on its seg plan (fs 17).
FUSED_GEOMS = {
    "2x-tap3": (48, 36, 96, 72, 3),
    "2x-tap8": (40, 30, 80, 60, 8),
    "2x-down-tap4": (96, 72, 48, 36, 4),
    "2/3-tap4": (90, 60, 60, 40, 4),
    "2/5-down-tap3": (100, 60, 40, 24, 3),
}
SEG_GEOMS = {
    "1.5x-tap3": (64, 48, 96, 72, 3),
    "4/3-down-tap4": (96, 72, 72, 54, 4),
    "2x-down-tap4": (96, 72, 48, 36, 4),
}
# The main-path planes: (geometry, the frames a seg block takes at least).
MAIN_FUSED = {
    "4K->8K tap8": (3840, 2160, 7680, 4320, 8),
    "4K->1080p tap16": (3840, 2160, 1920, 1080, 16),
    "4K->1440p tap16": (3840, 2160, 2560, 1440, 16),
}
MAIN_SEG = {"1440p->4K tap8": ((2560, 1440, 3840, 2160, 8), 8),
            "1440p->1080p tap16": ((2560, 1440, 1920, 1080, 16), 2)}  # fmt: skip


def _op(g):
    sw, sh, dw, dh, tap = g
    return build_plane_operator(sw, sh, dw, dh, radius_for_tap(tap))


def _geo(op, plan):
    lay = fused.plan_layout(op, plan)
    return plan.y.p, plan.x.p, plan.y.q, plan.x.q, lay.kh, lay.kw


def _u8(op, seed, frames):
    shape = (frames, op.src_height, op.src_width)
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.float32)


def _bound(n, blocks, src):
    wsum = float(np.abs(blocks).sum(axis=(-2, -1)).max())
    return fused.wsplit3_bound(n, wsum, float(np.abs(src).max()))


# ---- the fused kernel, emulated


def _ldsm(w16, addr):
    """``ldmatrix`` on bfloat16 values ``w16`` (flat, float32): lane L
    gives the word address ``addr[L]`` of row L % 8 of matrix L // 8 (of
    ``len(addr) // 8`` matrices); returns (matrices, 32 lanes, 2): lane L's
    register of each matrix, the pair (row L // 4, columns 2 (L % 4), + 1)."""
    lane = np.arange(32)
    rows = np.asarray(addr).reshape(-1, 8)
    return w16[2 * rows[:, lane // 4, None] + 2 * (lane % 4)[:, None] + np.arange(2)]


def _desc(w16, word):
    """A wgmma B read through a descriptor: lane L's register, the pair of
    bfloat16 values at word ``word[L]`` of ``w16`` (flat, float32)."""
    return w16[2 * np.asarray(word)[:, None] + np.arange(2)]


def _ws3_block(fi, lay, plane, w16, by, bx):
    """One block of ``fused_ws3_kernel`` on one frame's ``plane`` (H, W)
    with its phase group's three weight parts ``w16`` (3 * 2 * wn bfloat16
    values): its accumulators (warps, WS3_MW m-tiles, 4 n-tiles,
    32 lanes, 4)."""
    H, W = plane.shape
    qy, qx, G = fi.qy, fi.qx, lay.g
    g, tq, lane = G_ID, T_ID, np.arange(32)
    row0, col0 = fi.base_y + qy * by * lay.c, fi.base_x + qx * bx * lay.bj
    # The staging: each window row's columns [0, 2nw] rounded into two
    # copies of word pairs (copy 1 only for odd qx); zeros past the plane.
    ring = np.full((lay.nr, 2 * lay.cw, 2), np.nan, np.float32)
    m = np.arange(lay.nw)
    xs = col0 + np.arange(2 * lay.nw + 1)
    for r in range(lay.nr):
        y = row0 + r
        ok = (0 <= y < H) & (xs >= 0) & (xs < W)
        v = _r16(np.where(ok, plane[min(max(y, 0), H - 1)][np.clip(xs, 0, W - 1)], 0))
        ring[r, m] = np.stack([v[2 * m], v[2 * m + 1]], 1)
        if qx % 2:
            ring[r, lay.cw + m] = np.stack([v[2 * m + 1], v[2 * m + 2]], 1)
    # The lane's A rows: anchors warp*MW*16 + mw*16 + g (+ 8), a word of copy (qx*j) & 1.
    j = (np.arange(lay.warps)[:, None, None, None] * WS3_MW * 16
         + np.arange(WS3_MW)[:, None, None] * 16 + 8 * np.arange(2)[:, None] + g)  # fmt: skip
    aoff = (qx * j & 1) * lay.cw + (qx * j >> 1)  # (warp, mw, h, lane)
    # ldmatrix rows: lane L gives row L % 8 of matrix L // 8, column 8n + lcol
    # of a pair of n-tiles from n, chunk half lk.
    lcol, lk = 8 * (lane >> 4) + (lane & 7), 4 * lay.rows * ((lane >> 3) & 1)
    acc = np.zeros((lay.warps, WS3_MW, 4, 32, 4), np.float32)

    def areg(row, o):  # (warp, mw, lane, h, 2): word o of rows g and g + 8
        return row[aoff + o].swapaxes(2, 3)

    def mma_all(n, a, b, k):
        for w, mw in np.ndindex(lay.warps, WS3_MW):
            _mma(acc[w, mw, n], a[w, mw], b, k)

    for s in range(lay.nr):
        live = fused.live_tiles(lay, qy, s)
        if live is None:
            continue
        lo, hi = live
        row = ring[s]
        r0 = int(fused.weight_row(lay, qy, s, 0))  # R0(s)
        wg = lay.wgmma and (lo, hi) == (0, 3)  # rows that reach every n-tile
        for q in range(lay.nq16):
            o = 8 * q + tq  # taps 16q + 2tq, + 1; + 8
            a = np.concatenate([areg(row, o), areg(row, o + 4)], -2)  # a0 a1 a2 a3
            for p in range(WS3_PARTS):
                b = {}
                for n in range(lo, hi + 1) if wg else ():
                    # wgmma: the core matrices of chunks 2q, 2q + 1 at rows R0(s) + 8n ..
                    word = 4 * (r0 + 8 * n + g) + p * lay.wn + 8 * q * lay.rows + tq
                    b[n] = np.stack([_desc(w16, word), _desc(w16, word + 4 * lay.rows)], 1)
                for n in range(lo, hi + 1, 2) if not wg else ():
                    bq = 4 * fused.b_row(lay, qy, s, 8 * n + lcol) + lk + p * lay.wn + 8 * q * lay.rows
                    if n + 1 <= hi:  # .x4: matrices (n, 2q), (n, 2q + 1), (n + 1, ..)
                        r = _ldsm(w16, bq)
                        b[n], b[n + 1] = r[:2].swapaxes(0, 1), r[2:].swapaxes(0, 1)
                    else:  # .x2: lanes 0-15
                        b[n] = _ldsm(w16, bq[:16]).swapaxes(0, 1)
                for n in range(lo, hi + 1):
                    mma_all(n, a, b[n], 16)
        if lay.k8:  # wgmma: a k16 one, the second A half zeros (its B the same chunk)
            a = areg(row, 8 * lay.nq16 + tq)
            lt = lo + np.minimum(lane >> 3, hi - lo)  # matrix i: n-tile lo + i
            b8 = 4 * fused.b_row(lay, qy, s, 8 * lt + (lane & 7)) + 8 * lay.nq16 * lay.rows
            for p in range(WS3_PARTS):
                r = _ldsm(w16, b8 + p * lay.wn)
                for n in range(lo, hi + 1):
                    if wg:
                        word = 4 * (r0 + 8 * n + g) + p * lay.wn + 8 * lay.nq16 * lay.rows + tq
                        r[n - lo] = _desc(w16, word)
                    mma_all(n, a, r[n - lo][:, None], 8)
    for k in range(lay.nst if lay.last1 else 0):
        # The last tap of the stage's 8 rows in one k8 mma, k = row r0 + k.
        r0, r1 = lay.ch * k, min(lay.nr, lay.ch * k + lay.ch)
        rr = r0 + 2 * tq[:, None] + np.arange(2)  # (lane, i)
        av = ring[np.minimum(rr, r1 - 1), aoff[..., None] + 8 * lay.nq16, 0]  # low halves
        a = np.where(rr < r1, av, 0).swapaxes(2, 3)  # (warp, mw, lane, h, i)
        rb = fused.weight_row(lay, qy, rr, 0)
        for p, n in np.ndindex(WS3_PARTS, 4):
            col = 8 * n + g
            ar = rr - qy * (col // G)[:, None]
            ok = (ar >= 0) & (ar < lay.kh)
            idx = 2 * p * lay.wn + 8 * lay.nk8 * lay.rows + np.where(ok, rb + col[:, None], 0)
            mma_all(n, a, np.where(ok, w16[idx], 0)[:, None], 8)
    return acc


def emulate_fused_ws3(fi, src, shape=None):
    """``fused_ws3_kernel`` on ``src`` (F, H, W), bfloat16-exact (u8), in
    NumPy, at ``shape``'s warps (default ``fi.shape``)."""
    lay = fi.layout(shape)
    F = src.shape[0]
    py, px, G = fi.py, fi.px, lay.g
    w16 = fi.wtc.float().numpy().reshape(lay.ngroups, -1)
    out = np.full((F, py * fi.nyb, px * fi.nxb), np.nan, np.float32)
    # Fragment d_i of lane (g, t): anchor g + 8*(i >> 1), column 2t + (i & 1).
    i = np.arange(4)
    jj = (np.arange(lay.warps)[:, None, None, None] * WS3_MW * 16
          + np.arange(WS3_MW)[:, None, None] * 16)  # fmt: skip
    jj = jj[..., None] + G_ID[:, None] + 8 * (i >> 1)  # (w, mw, 1, lane, i)
    col = 8 * np.arange(4)[:, None, None] + 2 * T_ID[:, None] + (i & 1)  # (n, lane, i)
    c, e = col // G, col % G
    for f, grp in np.ndindex(F, lay.ngroups):
        ry, rx = divmod(grp * G + e, px)
        for by, bx in np.ndindex(-(-fi.nyb // lay.c), -(-fi.nxb // lay.bj)):
            acc = _ws3_block(fi, lay, src[f], w16[grp], by, bx)
            i0, j0 = by * lay.c, bx * lay.bj
            cc, aa = np.broadcast_arrays(i0 + c, j0 + jj)
            keep = (cc < fi.nyb) & (aa < fi.nxb)
            yy = np.broadcast_to(py * cc + ry, keep.shape)
            xx = np.broadcast_to(px * aa + rx, keep.shape)
            out[f, yy[keep], xx[keep]] = acc[keep]
    return out


def _fused(name, precision="wsplit3"):
    op = _op(FUSED_GEOMS[name])
    return op, fused.make_fused_interior(op, plan_phases(op), precision=precision)


# ---- the fused kernel's tables


@pytest.mark.parametrize("name", list(FUSED_GEOMS))
def test_fused_weight_rows_hold_each_part_once(name):
    """``ws3_weights``: part p of phase grp*g + e's kernel row a, taps 8k ..
    8k + 7, at the 16-byte weight row ``weight_row(a, e)`` of chunk k of
    part p; the last tap of a ``last1`` plan in the last-tap column; every
    value of the three parts once, and zeros everywhere else; the parts
    are ``split_bf16x3`` of the fp32 kernels, summing to them bit for bit."""
    op, fi = _fused(name)
    lay = fi.layout()
    K = fi.kernels.numpy()
    nph, kh, kw = K.shape
    parts = fused.split_bf16x3(K)
    fused.check_split(K, parts)
    w = fi.wtc.float().numpy().reshape(lay.ngroups, WS3_PARTS, 2 * lay.wn)
    assert fi.wtc.dtype == torch.bfloat16 and lay.wn % 4 == 0
    seen = np.zeros(w.shape, bool)
    ntap = 16 * lay.nq16 + 8 * lay.k8  # taps the chunks hold
    for ph, a in np.ndindex(nph, kh):
        grp, e = divmod(ph, lay.g)
        R = int(fused.weight_row(lay, fi.qy, a, e))
        assert 0 <= R < lay.rows - 1  # the last row is the zero row
        for p in range(WS3_PARTS):
            for k in range(lay.nk8):
                o = 8 * (k * lay.rows + R)
                taps = np.arange(8 * k, 8 * k + 8)
                want = np.where(taps < min(kw, ntap), parts[p, ph, a, np.minimum(taps, kw - 1)], 0)
                assert np.array_equal(w[grp, p, o : o + 8], want)
                assert not seen[grp, p, o : o + 8].any()
                seen[grp, p, o : o + 8] = True
            if lay.last1:
                o = 8 * lay.nk8 * lay.rows + R
                assert w[grp, p, o] == parts[p, ph, a, kw - 1] and not seen[grp, p, o]
                seen[grp, p, o] = True
    assert not w[~seen].any()
    assert lay.last1 == (kw % 16 == 1) and lay.k8 == (2 <= kw % 16 <= 8)


@pytest.mark.parametrize("name", list(FUSED_GEOMS))
def test_live_tiles_hold_every_row_an_anchor_row_reads(name):
    """``live_tiles``: for every staged row, the n-tiles it runs are the
    ones holding an anchor row c with 0 <= s - qy*c < kh; the weight rows
    of the columns that read it are ``R0(s) + col`` (``weight_row``),
    inside the layout, the others' the zero row (``b_row``) for ``ldmatrix``
    and, for ``wgmma`` (the padded rows, which the default shape takes with
    4 phases a block), ``R0(s) + col`` too, a slot of no kernel row; a row
    past them is one no anchor row reads (its products would be zeros)."""
    op, fi = _fused(name)
    lay = fi.layout()
    assert lay.wgmma == (lay.g == 4)  # the default shape pads for wgmma with 4 phases
    nph, kh, kw = fi.kernels.shape
    pad = fused.ws3_layout(fi.py, fi.px, fi.qy, fi.qx, kh, kw, fi.shape, fi.g, pad=True)
    assert pad.lp == pad.cpt - 1
    c = np.arange(lay.c)
    a, e = np.meshgrid(np.arange(lay.kh), np.arange(lay.g))
    kernel_rows = fused.weight_row(pad, fi.qy, a, e)
    skipped = 0
    for s in range(lay.nr):
        reads = (s - fi.qy * c >= 0) & (s - fi.qy * c < lay.kh)
        live = fused.live_tiles(lay, fi.qy, s)
        if live is None:
            assert not reads.any()
            continue
        lo, hi = live
        tiles = np.unique(c[reads] // lay.cpt)
        assert list(tiles) == list(range(lo, hi + 1))
        skipped += 4 - len(tiles)
        cols = np.arange(8 * lo, 8 * hi + 8)
        a = s - fi.qy * (cols // lay.g)
        ok = (a >= 0) & (a < lay.kh)
        R = fused.weight_row(lay, fi.qy, a[ok], cols[ok] % lay.g)
        assert np.array_equal(R, fused.weight_row(lay, fi.qy, s, 0) + cols[ok])
        assert np.array_equal(fused.b_row(lay, fi.qy, s, cols)[ok], R)
        assert (fused.b_row(lay, fi.qy, s, cols)[~ok] == lay.rows - 1).all()
        assert R.min() >= 0 and R.max() < lay.rows - 1
        # wgmma reads row R0(s) + col for every column: a zero slot where the
        # kernel row is outside [0, kh), inside the part.
        assert np.array_equal(fused.weight_row(pad, fi.qy, s, 0) + cols[ok],
                              fused.weight_row(pad, fi.qy, a[ok], cols[ok] % lay.g))
        zero = fused.weight_row(pad, fi.qy, s, 0) + cols[~ok]
        assert ((zero >= 0) & (zero < pad.rows - 1)).all()
        assert not np.isin(zero, kernel_rows).any()
    assert skipped > 0  # the n-tiles a row does not reach run no mma


def _planes_smem(py, px, q, k, shape, g):
    """Shared memory of the earlier wsplit3 form (the bf16 kernel's layout
    with three planes of its weight rows), at ``shape``: the envelope it
    set."""
    old = fused.tc_layout(py, px, q, q, k, k, shape, g)
    row = fused.TC_LAND * old.swf + 2 * old.cw
    _, dcw, dswf = fused.copy_rows(q, fused.DEFAULT_SHAPE[0] // 32 * fused.TC_MW * 16, old.kwk)
    ch = max(1, min(-(-old.nr // 3), (fused.TC_SMEM_TARGET // 4 - 3 * old.wn)
                    // (fused.TC_LAND * dswf + 2 * dcw)))  # fmt: skip
    return 4 * (3 * old.wn + max(ch * row, old.c * g * (old.bj + old.bj // 32 + 1)))


def _admitted():
    """(py, px, q, fs, k, g) of every plan that ``fit_shape`` admits (the
    sweep of tests/test_torch_bf16_tc.py) that the earlier wsplit3 form
    admitted (its three weight planes and stages within 227 KB)."""
    for py in (1, 2, 3, 4, 5, 8):
        for px in (1, 2, 3, 4, 5, 8):
            fs_max = int((32768 // (py * px)) ** 0.5)
            for fs in sorted({3, 7, 17, fs_max // 2, fs_max}):
                for q in range(1, 33):
                    k = fs + min(q, fs) - 1
                    shape, g = fused.fit_shape(py, px, q, q, k, k)
                    if _planes_smem(py, px, q, k, shape, g) <= fused.MAX_SMEM_BYTES:
                        yield py, px, q, fs, k, g


def test_ws3_layout_fits_every_plan_the_earlier_envelope_admitted():
    """For every plan of ``_admitted``, the wsplit3 layout fits at some
    shape (``ws3_shape``, the fp32 fit's phases a block); the main-path
    planes fit at the default shape."""
    admitted = 0
    for py, px, q, fs, k, g in _admitted():
        admitted += 1
        ws = fused.ws3_shape(py, px, q, q, k, k, g)
        assert ws is not None, (py, px, q, fs)
        lay = fused.ws3_layout(py, px, q, q, k, k, ws, g)
        assert lay.smem_bytes <= fused.MAX_SMEM_BYTES
        assert lay.cw >= lay.nw and lay.cw % 32 == 16 and lay.swf >= 2 * lay.nw + 4
    assert admitted > 1000
    for g in MAIN_FUSED.values():
        op = _op(g)
        plan = plan_phases(op)
        geo = _geo(op, plan)
        assert fused.kernel_precision(op, plan, "wsplit3") == "wsplit3"
        assert fused.ws3_shape(*geo, fused.fit_shape(*geo)[1]) == fused.DEFAULT_SHAPE


WEIGHT_FIELDS = ("nq16", "k8", "last1", "nk8", "lq", "lp", "rows", "wn")


def test_every_shape_launches_the_build_weight_layout():
    """The weights are laid out once, at the build's shape (``ws3_shape``);
    a launch at any shape of ``SHAPES`` whose layout fits reads them in
    that layout: for every plan of ``_admitted``, the fields that place a
    weight (``WEIGHT_FIELDS``) are the build's at every shape, its stages
    taking the build's tail (``last1``) and zero rows (``lp``). Among them
    are plans whose default stages are fewer than 8 rows while the narrow
    shape's are 8 (3x down tap 16: kh = kw = 97, q = 3), where a narrow
    layout of its own would pack the one-tap tail and read the k8 chunk's
    weights as that column, and plans whose default layout pads its rows
    for ``wgmma`` while a narrow layout of its own would not."""
    fields = lambda lay: tuple(getattr(lay, f) for f in WEIGHT_FIELDS)  # noqa: E731
    tails = pads = 0
    for py, px, q, fs, k, g in _admitted():
        build = fused.ws3_layout(py, px, q, q, k, k, fused.ws3_shape(py, px, q, q, k, k, g), g)
        for shape in fused.SHAPES:
            lay = fused.ws3_layout(py, px, q, q, k, k, shape, g, last1=build.last1,
                                   pad=build.lp > 0)
            if lay.smem_bytes <= fused.MAX_SMEM_BYTES:
                assert fields(lay) == fields(build), (py, px, q, fs, shape)
                assert lay.ch == 8 or not lay.last1
            own = fused.ws3_layout(py, px, q, q, k, k, shape, g)
            tails += own.smem_bytes <= fused.MAX_SMEM_BYTES and own.last1 != build.last1
            pads += own.smem_bytes <= fused.MAX_SMEM_BYTES and own.lp != build.lp
    assert tails > 0 and pads > 0  # the sweep holds plans that a layout a shape would mislay
    # FusedInterior.layout: that plan's launches at both shapes.
    geo = (1, 1, 3, 3, 97, 97)
    build = fused.ws3_layout(*geo, fused.ws3_shape(*geo, 1), 1)
    fi = fused.FusedInterior(
        w=None, kernels=torch.zeros(1, 97, 97), py=1, px=1, qy=3, qx=3, base_y=0, base_x=0,
        nyb=64, nxb=64, fs=95, shape=fused.DEFAULT_SHAPE, g=1, precision="wsplit3",
        wtc=torch.zeros(1, WS3_PARTS * 2 * build.wn), ws3=build,
    )  # fmt: skip
    lays = [fi.layout(s) for s in fused.SHAPES]
    assert not fi.ws3.last1 and lays[0].ch < 8 and lays[1].ch == 8
    assert fields(lays[0]) == fields(lays[1]) == fields(build)
    assert fused.ws3_layout(*geo, fused.NARROW_SHAPE, 1).last1  # its own layout would differ


@pytest.mark.parametrize("name", list(FUSED_GEOMS))
def test_fused_ws3_emulation_matches_the_plain_form(name):
    """The wsplit3 fused kernel's decomposition, emulated on a u8 source
    at both shapes, within ``wsplit3_bound`` (n = Kh*Kw) of the port's
    fp32 plain form, every interior pixel written; both shapes agree to
    the bit (they add alike: the same stages and n-tiles)."""
    op, fi = _fused(name)
    src = _u8(op, 41, 2)
    plain = fused.fused_interior_plain(fi, torch.from_numpy(src)).numpy()
    nph, kh, kw = fi.kernels.shape
    bound = _bound(kh * kw, fi.kernels.numpy(), src)
    got = {s: emulate_fused_ws3(fi, src, s) for s in fused.SHAPES}
    for out in got.values():
        assert out.shape == plain.shape and np.isfinite(out).all()
        assert np.abs(out - plain).max() <= bound
    assert np.array_equal(*got.values())


# ---- the seg kernel's tables


def test_seg_f32_rows_fit_two_frames_at_fs44():
    """The wsplit3 seg kernel stages the fp32 mode's blocks at their
    ``fsp``-float rows (``tc_words``): the main-path planes fit at least
    the frames named -- two at 1440p -> 1080p tap 16 (fs 44), where
    rows of ``k_slots(fs)`` floats fit one -- and ``frames_of``
    gives them; each layout fits 227 KB."""
    for name, (g, frames) in MAIN_SEG.items():
        op = _op(g)
        plan = plan_phases_seg(op)
        si = seg.make_seg_interior(op, plan, precision="wsplit3")
        assert si.precision == "wsplit3" and si.tc_blocks is None, name
        assert seg.frames_of(si, 8) >= frames and si.tc_frames >= frames, name
        smem = seg.tc_smem_bytes(si.pairs, si.fs, si.win_h, si.win_w, si.tc_frames, True)
        assert smem <= fused.MAX_SMEM_BYTES
        bs, _, _ = seg.tc_words(si.fs, si.win_h, si.win_w, True)
        assert bs == si.fs * si.blocks.shape[3] and bs % 4 == 0
        if si.fs == 44:
            old = 4 * si.pairs * (si.fs * fused.k_slots(si.fs) - bs)  # rows of fsk floats
            assert smem + old > fused.MAX_SMEM_BYTES and si.tc_frames == 2


@pytest.mark.parametrize("name", list(SEG_GEOMS))
@pytest.mark.parametrize("frames", [1, 2])
def test_seg_ws3_emulation_matches_the_plain_form(name, frames):
    """The seg kernel's wsplit3 decomposition, emulated on a u8 source at
    1 and 2 frames a block, within ``wsplit3_bound`` (n = fs**2) of the
    port's fp32 plain form, every pixel written."""
    from test_torch_bf16_tc import emulate_seg

    op = _op(SEG_GEOMS[name])
    si = seg.make_seg_interior(op, plan_phases_seg(op), precision="wsplit3")
    src = _u8(op, 42, 3)
    got = emulate_seg(si, src, frames)
    plain = seg.seg_interior_plain(si, torch.from_numpy(src)).numpy()
    assert got.shape == plain.shape and np.isfinite(got).all()
    assert np.abs(got - plain).max() <= _bound(si.fs**2, si.blocks.numpy(), src)


# ---- the tools that time the fused kernel's forms


@pytest.mark.parametrize("name", list(kernel_variants.EXPERIMENTS))
def test_kernel_variants_edits_match_the_kernel_source(name, tmp_path):
    """Every edit of ``tools.kernel_variants`` matches
    ``csrc/fused_interior.cu`` as it is (the tool stops on one that does
    not), and the edited copy differs from it only where the edits say."""
    from jincresize_tpu_torch.kernels import _build

    d = kernel_variants._edit(name, tmp_path)
    src = (_build.CSRC / "fused_interior.cu").read_text()
    got = (d / "fused_interior.cu").read_text()
    for old, new in kernel_variants.EXPERIMENTS[name][1]:
        assert old in src and new in got
        src = src.replace(old, new)
    assert got == src
    assert (d / "seg_interior.cu").read_text() == (_build.CSRC / "seg_interior.cu").read_text()


@pytest.mark.parametrize("pad", [False, True])
def test_relaid_weights_hold_the_build_parts(pad):
    """``tools.u8_kernel_timing.relaid``: the plane's weights in the other
    form's layout (padded for wgmma, or not), each part at its weight row
    (``ws3_weights`` of the same split), the tail kept; the plain form and
    the envelope unchanged."""
    op, fi = _fused("2x-tap8")
    other = u8_kernel_timing.relaid(fi, pad)
    assert other.ws3.lp == (other.ws3.cpt - 1 if pad else 0)
    assert other.ws3.last1 == fi.ws3.last1 and other.layout() == other.ws3
    parts = fused.split_bf16x3(fi.kernels.numpy())
    want = fused.ws3_weights(parts, other.ws3, fi.qy)
    assert np.array_equal(other.wtc.float().numpy(), want)
    assert other.wtc.shape[-1] == WS3_PARTS * 2 * other.ws3.wn
    assert other.ws3.smem_bytes <= fused.MAX_SMEM_BYTES
