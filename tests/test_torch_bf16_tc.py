"""The tensor-core decomposition of the bf16 kernels, held to the JAX package
without a card.

``csrc/fused_interior.cu`` and ``csrc/seg_interior.cu`` run
``precision='bf16'`` on the tensor cores (``mma.sync`` m16n8k16 and
m16n8k8, bf16 in, fp32 sums). A CUDA kernel cannot run here, so this
module emulates each one in NumPy from the port's Python mirrors of its
index maps -- the PTX fragment maps (``fused.mma_maps``), the K packing
(``fused.tap_of_k``, ``fused.k_slots``), the fused kernel's weight rows
(``fused.tc_layout``, ``fused.tc_weights``) and the seg kernel's per-tile
column grouping and window words (``seg.tile_columns``, ``seg.tc_words``):
shared memory word by word (unstaged words are NaN, so a read of one
poisons the output), every fragment lane by lane, every mma as one fp32
product of its 16 x k and k x 8 matrices added to its accumulator. The
seg emulation takes the three-part weight split of ``precision='wsplit3'``
too (the fp32 mode's float32 blocks split at each B load);
``tests/test_torch_u8src.py`` holds it, and the wsplit3 fused kernel's own
emulation (``tests/test_torch_wsplit3_tc.py``), to the JAX package's
``wsplit3`` kernels.

The oracle is ``tests/test_torch_bf16.py``'s: the JAX package's Pallas
kernels in interpret mode at HIGHEST on the same bfloat16-rounded operands.
Each emulation is held within ``fused.tc_sum_bound(n, max sum|w|,
max|src|)`` of it, n the taps a pixel sums (Kh*Kw, fs**2).
"""

import dataclasses

import ml_dtypes
import numpy as np
import pytest
import torch

from jincresize_tpu import operator as joperator
from jincresize_tpu import phase as jphase
from jincresize_tpu_torch.kernels import fused, seg
from jincresize_tpu_torch.kernels.fused import TC_LAND
from jincresize_tpu_torch.kernels.gather import FRAMES
from jincresize_tpu_torch.operator import build_plane_operator, radius_for_tap
from jincresize_tpu_torch.phase import plan_phases, plan_phases_seg


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread for this module's tests (the workers of
    pytest-xdist share the machine's cores); the old count is back after
    the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# tests/test_torch_bf16.py's planes: qx 1 (2x tap 8, 4 phases), qx 3 (the
# 2/3 planes, 4 phases), qx 2 with one phase and fs 65 (deep taps).
FUSED_GEOMS = {
    "2x-tap8": (64, 48, 128, 96, 8),
    "down-tap3": (96, 60, 64, 40, 3),
    "2/3-tap4": (90, 60, 60, 40, 4),
    "deep-fs65": (160, 120, 80, 60, 16),
}
FUSED_CASES = [(n, fused.DEFAULT_SHAPE) for n in FUSED_GEOMS] + [("deep-fs65", fused.NARROW_SHAPE)]
# Drifted planes: 1.5x tap 3 over two frames (m-tiles mix frames), a 3x
# tap 2 and a 1.5x tap 8; every tile's classes have fewer than 16 columns.
SEG_GEOMS = {
    "1.5x-tap3": ((64, 48, 96, 72, 3), 2),
    "3x-tap2": ((96, 64, 288, 192, 2), 1),
    "1.5x-tap8": ((96, 64, 144, 96, 8), 1),
}


def _op(g):
    sw, sh, dw, dh, tap = g
    return build_plane_operator(sw, sh, dw, dh, radius_for_tap(tap))


def _jop(g):
    sw, sh, dw, dh, tap = g
    return joperator.build_plane_operator(sw, sh, dw, dh, joperator.radius_for_tap(tap))


def _r16(a):
    return np.asarray(a, np.float32).astype(ml_dtypes.bfloat16).astype(np.float32)


def _src16(op, seed, frames):
    src = np.random.default_rng(seed).random((frames, op.src_height, op.src_width), np.float32)
    return _r16(src)


@pytest.fixture(scope="module")
def oracles():
    """{name: (rounded source, JAX Pallas interior)}: interpret mode, HIGHEST,
    rounded pair blocks (one call a frame)."""
    import jax.numpy as jnp

    from jincresize_tpu.kernels.pallas_fused import make_fused_interior
    from jincresize_tpu.kernels.pallas_fused_seg import make_seg_interior

    out = {}
    for name, g in FUSED_GEOMS.items():
        jop = _jop(g)
        jr = dataclasses.replace(jop, pair_blocks=_r16(jop.pair_blocks))
        src = _src16(jop, 21, 1)
        fn = make_fused_interior(jr, jphase.plan_phases(jop), interpret=True)
        out[name] = (src, np.asarray(fn(jnp.asarray(src[0])))[None])
    for name, (g, frames) in SEG_GEOMS.items():
        jop = _jop(g)
        jr = dataclasses.replace(jop, pair_blocks=_r16(jop.pair_blocks))
        src = _src16(jop, 22, frames)
        fn = make_seg_interior(jr, jphase.plan_phases_seg(jop), interpret=True)
        out[name] = (src, np.stack([np.asarray(fn(jnp.asarray(s), fn.params)) for s in src]))
    return out


# ---- the emulated mma


MAPS = {k: fused.mma_maps(k) for k in (16, 8)}


def _mma(acc, a, b, k):
    """One mma.sync on lane fragments: ``acc`` (32, 4) f32 D=C fragments,
    ``a`` (32, k // 4, 2) and ``b`` (32, k // 8, 2) operand values; the
    product of the assembled matrices in fp32, added in fp32."""
    m = MAPS[k]
    A = np.full((16, k), np.nan, np.float32)
    B = np.full((k, 8), np.nan, np.float32)
    A[m["a"][..., 0], m["a"][..., 1]] = a
    B[m["b"][..., 0], m["b"][..., 1]] = b
    D = (A @ B).astype(np.float32)
    acc += D[m["d"][..., 0], m["d"][..., 1]]


# ---- the fused kernel, emulated

LANE = np.arange(32)
G_ID, T_ID = LANE >> 2, LANE & 3  # groupID, threadID_in_group


def _lo(words):
    """The low halves (the first value) of ``words`` (..., 2)."""
    return words[..., 0]


def _fused_block(fi, lay, plane, wsm, by, bx):
    """One block of ``fused_tc_kernel`` on one frame's ``plane`` (H, W) with
    its phase group's ``lay.wn`` weight words ``wsm``: its accumulators
    (warps, 2 m-tiles, 4 n-tiles, 32 lanes, 4)."""
    H, W = plane.shape
    qy, qx, G = fi.qy, fi.qx, lay.g
    g, tq = G_ID, T_ID
    row0, col0 = fi.base_y + qy * by * lay.c, fi.base_x + qx * bx * lay.bj
    n16, tail8, last1 = lay.kwk // 16, lay.kwk % 16 != 0, lay.kw % 16 == 1
    rw, nsw, nst = 2 * lay.cw, 2 * lay.nw + 1, -(-lay.nr // lay.ch)
    dx = col0 % 4 if W % 4 == 0 and col0 >= 0 else 0  # 16-byte landing copies
    land = np.full((TC_LAND, lay.ch, lay.swf), np.nan, np.float32)
    ring = np.full((lay.ch * rw, 2), np.nan, np.float32)

    def stage_rows(k):
        return range(min(lay.nr, (k + 1) * lay.ch) - k * lay.ch)

    def issue(k):  # stage k's rows, f32, into landing buffer k % TC_LAND
        if k >= nst:
            return
        n = -(-(dx + nsw) // 4) * 4 if W % 4 == 0 else nsw
        xs = col0 - dx + np.arange(n)
        for r in stage_rows(k):
            y = row0 + k * lay.ch + r
            ok = (0 <= y < H) & (xs >= 0) & (xs < W)
            land[k % TC_LAND, r, :n] = np.where(ok, plane[min(max(y, 0), H - 1)][xs % W], 0)

    def convert(k):  # ... as two copies of word pairs into the ring
        m = np.arange(lay.nw)
        for r in stage_rows(k):
            v = land[k % TC_LAND, r, dx:]
            ring[r * rw + m] = np.stack([v[2 * m], v[2 * m + 1]], 1)
            if qx % 2:
                ring[r * rw + lay.cw + m] = np.stack([v[2 * m + 1], v[2 * m + 2]], 1)

    acc = np.zeros((lay.warps, 2, 4, 32, 4), np.float32)
    jj = np.arange(lay.warps)[:, None, None, None] * 32 + np.arange(2)[:, None, None] * 16
    x = qx * (jj + np.arange(2)[:, None] * 8 + g)  # (warps, mw, h, lane)
    aoff = (x & 1) * lay.cw + (x >> 1)
    for k in range(TC_LAND - 1):
        issue(k)
    for k in range(nst):
        issue(k + TC_LAND - 1)
        convert(k)
        s1 = min(lay.nr, (k + 1) * lay.ch)
        for s in range(k * lay.ch, s1):
            rb = (s - k * lay.ch) * rw
            col = 8 * np.arange(4)[:, None] + g  # (n, lane)
            ar = s - qy * (col // G)
            bok = (ar >= 0) & (ar < lay.kh)
            bp = (np.where(bok, ar, 0) * G + col % G) * lay.ws
            for q in range(n16):
                o = 8 * q + 2 * tq
                # a0 a1 a2 a3: words o of rows g, g + 8, then words o + 1.
                af = ring[rb + aoff[:, :, [0, 1, 0, 1]] + o + np.array([0, 0, 1, 1])[:, None]]
                bw = wsm[bp[..., None] + o[:, None] + np.arange(2)]  # B: words o, o + 1
                bf = np.where(bok[..., None, None], bw, 0)
                for w, n, mw in np.ndindex(lay.warps, 4, 2):
                    _mma(acc[w, mw, n], af[w, mw].swapaxes(0, 1), bf[n], 16)
            if tail8 and not last1:
                o = 8 * n16 + tq
                af = ring[rb + aoff + o]
                bf = np.where(bok[..., None], wsm[bp + o], 0)
                for w, n, mw in np.ndindex(lay.warps, 4, 2):
                    _mma(acc[w, mw, n], af[w, mw].swapaxes(0, 1), bf[n][:, None], 8)
        for r0 in range(k * lay.ch, s1 if last1 else 0, 8):
            # The last tap of 8 stage rows in one k8 mma, k = row r0 + k.
            o = 8 * n16
            r = r0 + 2 * tq[:, None] + np.arange(2)  # (lane, half)
            rb = (np.minimum(r, s1 - 1) - k * lay.ch) * rw
            af = np.where(r < s1, _lo(ring[rb + aoff[..., None] + o]), 0)  # (w, mw, h, lane, half)
            for n in range(4):
                col = 8 * n + g
                ar = r - qy * (col // G)[:, None]
                ok = (ar >= 0) & (ar < lay.kh)
                idx = (np.where(ok, ar, 0) * G + (col % G)[:, None]) * lay.ws + o
                b = np.where(ok, _lo(wsm[idx]), 0)
                for w, mw in np.ndindex(lay.warps, 2):
                    _mma(acc[w, mw, n], af[w, mw].swapaxes(0, 1), b[:, None], 8)
    return acc


def emulate_fused(fi, src16, shape):
    """``fused_tc_kernel`` on ``src16`` (F, H, W), rounded (bf16-exact), in
    NumPy (the bf16 mode)."""
    lay = fi.layout(shape)
    F = src16.shape[0]
    py, px, G = fi.py, fi.px, lay.g
    wwords = fi.wtc.float().numpy().reshape(lay.ngroups, lay.wn, 2)
    out = np.full((F, py * fi.nyb, px * fi.nxb), np.nan, np.float32)
    # Fragment d_i of lane (g, t): anchor g + 8*(i >> 1), column 2t + (i & 1).
    i = np.arange(4)
    jj = np.arange(lay.warps)[:, None, None, None] * 32 + np.arange(2)[:, None, None] * 16
    jj = jj[..., None] + G_ID[:, None] + 8 * (i >> 1)  # (w, mw, 1, lane, i)
    col = 8 * np.arange(4)[:, None, None] + 2 * T_ID[:, None] + (i & 1)  # (n, lane, i)
    c, e = col // G, col % G
    for f, grp in np.ndindex(F, lay.ngroups):
        ry, rx = divmod(grp * G + e, px)
        for by, bx in np.ndindex(-(-fi.nyb // lay.c), -(-fi.nxb // lay.bj)):
            acc = _fused_block(fi, lay, src16[f], wwords[grp], by, bx)
            i0, j0 = by * lay.c, bx * lay.bj
            cc, aa = np.broadcast_arrays(i0 + c, j0 + jj)
            keep = (cc < fi.nyb) & (aa < fi.nxb)
            yy = np.broadcast_to(py * cc + ry, keep.shape)
            xx = np.broadcast_to(px * aa + rx, keep.shape)
            out[f, yy[keep], xx[keep]] = acc[keep]
    return out


# ---- the seg kernel, emulated


def _split3(v):
    """The three bfloat16 parts of float32 ``v`` (3, ...), as the wsplit3
    seg kernel splits its float32 B values (csrc/common.cuh
    jt_split3_pack): hi, mid, then the rest, each stored as bfloat16."""
    v = np.asarray(v, np.float32)
    hi = _r16(v)
    r = v - hi
    mid = _r16(r)
    return np.stack([hi, mid, _r16(r - mid)])


def _seg_tile(si, src16, nf, tyi, txi, f0, tc):
    """One block of ``seg_tc_kernel``: ``[(frames, rows, columns, sums)]``,
    one entry an item and half-tile of slots. With ``tc['split']``
    (wsplit3) the fp32 mode's blocks are staged in float32 (``wf``, rows of
    ``fsp`` floats) and each B value is split into three parts at its
    load, three mmas an A fragment."""
    F, H, W = src16.shape
    hout, wout = si.out_shape
    fs, fsk, fsp, split = si.fs, tc["fsk"], tc["fsp"], tc["split"]
    bs, cw, plane = seg.tc_words(fs, si.win_h, si.win_w, split)
    hw = fsp if split else fsk // 2  # words of a staged tap row
    g, tq = G_ID, T_ID
    n16, tail8, last1 = fsk // 16, fsk % 16 != 0, fs % 16 == 1
    sy, sx, lcy = tc["sy"], tc["sx"], tc["lcy"]
    ncy, ncx = tc["ncy"][tyi], tc["ncx"][txi]
    x0, y0 = txi * seg.TILE_X, tyi * seg.TILE_Y
    nfv = min(nf, F - f0)
    tab = seg.tc_table_words(nf)
    smem = np.full((si.pairs * bs + tab + nf * plane, 2), np.nan, np.float32)
    wf = np.full(si.pairs * bs, np.nan, np.float32)  # the float32 blocks (split)
    for p in range(ncy * ncx):
        cy, cx = tc["tcy"][tyi, p // ncx], tc["tcx"][txi, p % ncx]
        if split:
            wf[p * bs : p * bs + fs * fsp] = tc["f32"][cy, cx].ravel()
        else:
            smem[p * bs : p * bs + fs * fsk // 2] = tc["bwords"][cy, cx]
    cols, rows = sx[x0 : x0 + seg.TILE_X], sy[y0 : y0 + seg.TILE_Y]
    col_lo, row_lo = cols.min(), rows.min()
    nr, nw = rows.max() - row_lo + fs, (cols.max() - col_lo + fsk + 1) // 2
    win = si.pairs * bs + tab
    xs = col_lo + 2 * np.arange(nw)[:, None] + np.arange(3)
    for e, r in np.ndindex(nfv, nr):
        v = np.where(xs < W, src16[f0 + e, row_lo + r][np.minimum(xs, W - 1)], 0)
        d = win + e * plane + r * 2 * cw
        smem[d : d + nw] = v[:, :2]
        smem[d + cw : d + cw + nw] = v[:, 1:]

    def b_regs(br, bok, o, n):
        """The B registers of ``n`` taps (4: a k16 chunk's b0 | b1, 2: a k8
        chunk's b0) at word ``o`` of each lane's tap row ``br``, one (32,
        n // 2, 2) array a part."""
        if split:  # the f32 taps at word 2o (none past the row), split
            ok = bok[:, None] & (2 * o < fsp)
            v = np.where(ok, wf[np.where(ok, br[:, None] + 2 * o + np.arange(n), 0)], 0)
            return list(_split3(v).reshape(3, 32, n // 2, 2))
        return [np.where(bok[:, None, None], smem[br[:, None] + o + np.arange(n // 2)], 0)]

    starts = tc["scx"][txi]
    counts = np.diff(starts)[:ncx]
    mtc = (counts * nfv + 15) // 16
    nt = (min(seg.TILE_Y, hout - y0) + 7) // 8
    items = []
    for j, k in np.ndindex(mtc.sum(), nt):
        c = int(np.searchsorted(np.cumsum(mtc), j, side="right"))
        base, cnt, jc = starts[c], counts[c], j - np.cumsum(mtc)[c] + mtc[c]
        slot = jc * 16 + g[:, None] + 8 * np.arange(2)  # (lane, h): rows g, g + 8
        sok = slot < cnt * nfv
        fr = np.where(sok, slot // cnt, 0)
        col = tc["pcx"][txi, base + np.where(sok, slot - fr * cnt, 0)]
        xsl = sx[x0 + col] - col_lo
        aoff = win + fr * plane + (xsl & 1) * cw + (xsl >> 1)  # (lane, h)
        m = y0 + 8 * k + g
        mok = m < hout
        syr = np.where(mok, sy[np.minimum(m, hout - 1)] - row_lo, 1 << 20)
        boff = (np.where(mok, lcy[np.minimum(m, hout - 1)], 0) * ncx + c) * bs
        s_lo, s_hi = syr[mok].min(), syr[mok].max() + fs
        acc = np.zeros((2, 32, 4), np.float32)
        for s in range(s_lo, s_hi):
            ly = s - syr
            bok = (ly >= 0) & (ly < fs)
            ar = aoff + s * 2 * cw
            br = boff + np.where(bok, ly, 0) * hw
            for q in range(n16):
                o = (8 * q + 2 * tq)[:, None]
                a = smem[np.concatenate([ar + o, ar + o + 1], 1)]  # a0 a1 a2 a3
                for b in b_regs(br, bok, o, 4):
                    _mma(acc[q & 1], a, b, 16)
            if tail8 and not last1:
                o = (8 * n16 + tq)[:, None]
                for b in b_regs(br, bok, o, 2):
                    _mma(acc[n16 & 1], smem[ar + o], b, 8)
        for r0 in range(s_lo, s_hi if last1 else 0, 8):
            # The last tap of 8 rows in one k8 mma, k = row r0 + k.
            o = 8 * n16
            r = r0 + 2 * tq[:, None] + np.arange(2)  # (lane, half)
            rc = np.minimum(r, s_hi - 1) * 2 * cw
            a = np.where(r[:, None] < s_hi, _lo(smem[aoff[..., None] + rc[:, None] + o]), 0)
            ly = r - syr[:, None]
            ok = (ly >= 0) & (ly < fs)
            at = boff[:, None] + np.where(ok, ly, 0) * hw
            if split:  # the tap's float32 at word 2o of its row, split
                bparts = _split3(np.where(ok, wf[at + 2 * o], 0))
            else:
                bparts = [np.where(ok, _lo(smem[at + o]), 0)]
            for b in bparts:
                _mma(acc[1], a, b[:, None], 8)
        d = acc[0] + acc[1]  # d0, d1: slot g, rows 2t, 2t + 1; d2, d3: slot g + 8
        for h, i in np.ndindex(2, 2):
            mm = y0 + 8 * k + 2 * tq + i
            keep = sok[:, h] & (mm < hout)
            items.append((f0 + fr[keep, h], mm[keep], x0 + col[keep, h], d[keep, 2 * h + i]))
    return items


def emulate_seg(si, src16, nf):
    """``seg_tc_kernel`` at ``nf`` frames a block on ``src16`` (F, H, W),
    rounded (bf16-exact), in NumPy, in ``si``'s mode (bf16, or wsplit3's
    split of the float32 blocks)."""
    fsp = si.blocks.shape[3]
    fsk = fused.k_slots(si.fs)
    tc = {
        "fsk": fsk,
        "fsp": fsp,
        "split": not si.bf16,
        "f32": si.blocks.numpy(),
        **{k: getattr(si, n).numpy() for k, n in (
            ("sy", "start_y"), ("sx", "start_x"), ("lcy", "lcy"), ("tcy", "tcy"), ("tcx", "tcx"),
            ("ncy", "ncy"), ("ncx", "ncx"), ("pcx", "pcx"), ("scx", "scx"))},
    }  # fmt: skip
    if si.bf16:
        blocks = si.tc_blocks.float().numpy()
        n_uy, n_ux, fs, _ = blocks.shape
        tc["bwords"] = blocks.reshape(n_uy, n_ux, fs * fsk // 2, 2)
    hout, wout = si.out_shape
    out = np.full((src16.shape[0], hout, wout), np.nan, np.float32)
    for tyi, txi, fz in np.ndindex(-(-hout // seg.TILE_Y), -(-wout // seg.TILE_X),
                                   -(-src16.shape[0] // nf)):  # fmt: skip
        for fr, mm, xx, v in _seg_tile(si, src16, nf, tyi, txi, fz * nf, tc):
            out[fr, mm, xx] = v
    return out


# ---- the maps


@pytest.mark.parametrize("k", [16, 8])
def test_fragment_maps_cover_each_element_once(k):
    """The PTX maps of ``fused.mma_maps``: A (16 x k), B (k x 8) and D
    (16 x 8) each held once over the 32 lanes; a register's two halves are
    consecutive k of one row (A) or column (B)."""
    m = fused.mma_maps(k)
    for key, shape in (("a", (16, k)), ("b", (k, 8)), ("d", (16, 8))):
        idx = m[key].reshape(-1, 2)
        assert len(idx) == shape[0] * shape[1]
        assert len({tuple(p) for p in idx}) == len(idx)
        assert (idx >= 0).all() and (idx < shape).all()
    for key, k_axis in (("a", 1), ("b", 0)):
        step = np.diff(m[key], axis=-2)  # the second value of a register less the first
        assert (step[..., k_axis] == 1).all() and (step[..., 1 - k_axis] == 0).all()


def test_k_packing_gives_each_lane_one_run_of_taps():
    """``tap_of_k`` is a permutation of a k16 chunk under which lane t's A
    registers a0 | a2 and B registers b0 | b1 hold taps 4t .. 4t + 3 in
    order: one run of two words (A) and one 8-byte load (B)."""
    taps = fused.tap_of_k(np.arange(16))
    assert sorted(taps) == list(range(16))
    m = fused.mma_maps(16)
    for lane in range(32):
        t = lane & 3
        a = taps[m["a"][lane][[0, 2]][..., 1]].ravel()
        b = taps[m["b"][lane][..., 0]].ravel()
        assert list(a) == list(b) == list(range(4 * t, 4 * t + 4))


@pytest.mark.parametrize("n", [1, 7, 8, 9, 16, 17, 24, 33, 44, 65, 92])
def test_k_slots(n):
    """Taps padded to k16 chunks and at most one k8 tail chunk."""
    k = fused.k_slots(n)
    assert n <= k < n + 16 and k % 8 == 0
    assert (k % 16 == 0) == (n % 16 == 0 or n % 16 > 8)


@pytest.mark.parametrize("n", [1, 17, 289, 1936, 4225, 8464])
def test_tc_sum_bound_covers_the_fp32_bound_and_grows(n):
    """One ulp an addition (2u) and one more for the rounding: never below
    the fp32 chain's (gamma_n(u) + u), about twice it, growing with n."""
    b = fused.tc_sum_bound(n, 3.0, 1.0)
    assert b >= fused.f32_sum_bound(n, 3.0, 1.0)
    assert b < 2.01 * fused.f32_sum_bound(n, 3.0, 1.0)
    assert fused.tc_sum_bound(n + 1, 3.0, 1.0) > b
    assert fused.tc_sum_bound(n, 6.0, 0.5) == pytest.approx(b)


# ---- the fused kernel's tables


@pytest.mark.parametrize("name", list(FUSED_GEOMS))
def test_fused_weight_rows_hold_the_rounded_kernels(name):
    """``tc_weights``: phase grp*G + e's row a at bf16 offset 2*(a*G + e)*ws,
    the rounded kernel's taps then zeros to the group's 2*wn values; the
    layout is the same for both shapes (one weight tensor serves both)."""
    op = _op(FUSED_GEOMS[name])
    plan = plan_phases(op)
    fi = fused.make_fused_interior(op, plan, precision="bf16")
    K = fi.kernels.numpy()
    nph, kh, kw = K.shape
    lays = [fi.layout(s) for s in fused.SHAPES]
    assert len({(lay.ws, lay.wn) for lay in lays}) == 1
    lay = lays[0]
    w = fi.wtc.float().numpy()
    assert w.shape == (lay.ngroups, 2 * lay.wn) and fi.wtc.dtype == torch.bfloat16
    assert lay.ws % 2 == 0 and 2 * lay.ws >= lay.kwk >= kw and lay.wn % 4 == 0
    seen = np.zeros_like(w, bool)
    for ph in range(nph):
        grp, e = divmod(ph, lay.g)
        for a in range(kh):
            o = 2 * (a * lay.g + e) * lay.ws
            assert np.array_equal(w[grp, o : o + kw], K[ph, a])
            seen[grp, o : o + kw] = True
    assert not w[~seen].any()


def test_fused_weight_stride_spreads_the_b_loads():
    """The 8-word B reads of a half warp's four lane groups land on four
    distinct 8-bank groups at the planes' strides (4 phases a block: rows e
    apart; one phase: qy*g apart)."""
    for kwk, qy, g in ((24, 1, 4), (72, 2, 1), (56, 3, 4), (88, 5, 4), (16, 1, 1)):
        ws = fused.weight_stride(kwk, qy, g)
        d = ws if g == 4 else qy * ws
        banks = [{(i * d + j) % 32 for j in range(8)} for i in range(4)]
        assert sum(map(len, banks)) == len(set().union(*banks)) == 32, (kwk, qy, g, ws)


def test_tc_layout_fits_every_plan_the_fp32_layout_fits():
    """For every (p, fs, q) that ``fit_shape`` admits (the sweep of
    tests/test_torch_kernels.py) the bf16 kernel's layout at the same shape
    and phase group fits the shared memory too: the bf16 mode serves every
    plan the fp32 mode does. The ring carries whole stages: two, or every
    window row."""
    for py in (1, 2, 3, 4, 5, 8):
        for px in (1, 2, 3, 4, 5, 8):
            fs_max = int((32768 // (py * px)) ** 0.5)
            for fs in sorted({3, 7, 17, fs_max // 2, fs_max}):
                for q in range(1, 33):
                    k = fs + min(q, fs) - 1
                    shape, g = fused.fit_shape(py, px, q, q, k, k)
                    lay = fused.tc_layout(py, px, q, q, k, k, shape, g)
                    assert lay.smem_bytes <= fused.MAX_SMEM_BYTES, (py, px, q, fs)
                    assert 1 <= lay.ch <= lay.nr and lay.cw >= lay.nw and lay.swf >= 2 * lay.nw + 4
                    assert lay.c * lay.g == 8 * fused.TC_NT


# ---- the seg kernel's tables


@pytest.mark.parametrize("tile", [32, 7])
def test_seg_column_lists_are_a_permutation_of_each_tile(tile):
    """``tile_columns``: each tile's list is a permutation of its columns,
    grouped by class in the order of ``tile_classes``' ids, ascending
    within a class; ``scx`` marks each class's run (on drifted staircases
    of the seg planes and a random class array with a ragged last tile)."""
    arrays = [plan_phases_seg(_op(g)).x.cls for g, _ in SEG_GEOMS.values()]
    arrays.append(np.random.default_rng(3).integers(0, 5, 101))
    for cls in arrays:
        tc = seg.tile_classes(cls, tile)
        pcx, scx = seg.tile_columns(tc, tile)
        for i in range(len(tc.count)):
            n = min(tile, len(cls) - i * tile)
            assert sorted(pcx[i, :n]) == list(range(n))
            assert scx[i, 0] == 0 and scx[i, tc.count[i]] == n
            local = tc.local[i * tile : i * tile + n]
            for c in range(tc.count[i]):
                run = pcx[i, scx[i, c] : scx[i, c + 1]]
                assert (local[run] == c).all() and (np.diff(run) > 0).all()


def test_seg_bf16_envelope_covers_the_fp32_one():
    """The bf16 kernel stages its tile's whole window: on the seg planes of
    this module, tests/test_torch_seg.py and test_torch_bf16.py and the
    deep drifted 1440p -> 1080p tap-16 plane (fs 44), it fits wherever the
    fp32 kernel does (at fs 44 four frames of windows beside the pairs)."""
    geoms = [g for g, _ in SEG_GEOMS.values()]
    geoms += [(64, 48, 160, 120, 3), (2560, 1440, 1920, 1080, 16)]
    for g in geoms:
        op = _op(g)
        plan = plan_phases_seg(op)
        assert seg.is_supported(op, plan)
        si = seg.make_seg_interior(op, plan, precision="bf16")
        assert si.tc_frames in FRAMES
        smem = seg.tc_smem_bytes(si.pairs, si.fs, si.win_h, si.win_w, si.tc_frames)
        assert smem <= fused.MAX_SMEM_BYTES
        if g[-1] == 16:
            assert si.fs == 44 and si.tc_frames == 4


# ---- the emulations against the JAX Pallas kernels


def _bound(n, blocks, src16):
    wsum = float(np.abs(blocks).sum(axis=(-2, -1)).max())
    return fused.tc_sum_bound(n, wsum, float(np.abs(src16).max()))


def _case_id(v):
    return v if isinstance(v, str) else fused.shape_name(v)


@pytest.mark.parametrize("name,shape", FUSED_CASES, ids=_case_id)
def test_fused_emulation_matches_pallas(name, shape, oracles):
    """The fused kernel's tensor-core decomposition, emulated, within
    ``tc_sum_bound`` (n = Kh*Kw) of the JAX Pallas kernel on the same
    rounded operands, every interior pixel written; the plain form on the
    same operands within the same bound."""
    src16, want = oracles[name]
    op = _op(FUSED_GEOMS[name])
    fi = fused.make_fused_interior(op, plan_phases(op), precision="bf16")
    got = emulate_fused(fi, src16, shape)
    nph, kh, kw = fi.kernels.shape
    bound = _bound(kh * kw, fi.kernels.numpy(), src16)
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.abs(got - want).max() <= bound
    plain = fused.fused_interior_plain(fi, torch.from_numpy(src16)).numpy()
    assert np.abs(got - plain).max() <= bound


@pytest.mark.parametrize("name", list(SEG_GEOMS))
def test_seg_emulation_matches_pallas(name, oracles):
    """The seg kernel's tensor-core decomposition, emulated at the frames a
    block the wrapper picks, within ``tc_sum_bound`` (n = fs**2) of the JAX
    Pallas kernel on the same rounded operands, every pixel written; the
    plain form within the same bound."""
    src16, want = oracles[name]
    op = _op(SEG_GEOMS[name][0])
    si = seg.make_seg_interior(op, plan_phases_seg(op), precision="bf16")
    nf = seg.frames_of(si, src16.shape[0])
    assert nf == src16.shape[0]
    got = emulate_seg(si, src16, nf)
    bound = _bound(si.fs**2, si.blocks.numpy(), src16)
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.abs(got - want).max() <= bound
    plain = seg.seg_interior_plain(si, torch.from_numpy(src16)).numpy()
    assert np.abs(got - plain).max() <= bound
