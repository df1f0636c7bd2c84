"""SpGEMM operator composition: fuse resize chains into one operator.

``compose(A, B)`` returns a single PlaneOperator equivalent to applying A
(src -> mid) then B (mid -> dst) — the sparse-sparse product of the two banded
operators (SURVEY.md §7 step 6; BASELINE.json north star "SpGEMM pre-composes
crop+resize operators into one pass"). New capability: the reference has no
composition — chained script calls resample twice, with an intermediate
rounding step for integer formats. The composed operator:

  * skips the intermediate frame entirely (one gather-MAC pass, half the
    bandwidth, no mid-chain quantization loss);
  * preserves the separable-metadata structure — composed interior blocks
    depend on an (extended y-key, extended x-key) pair, so the result is a
    regular PlaneOperator that re-enters every fast path (phase conv,
    sharding, Pallas) unchanged.

Composition arithmetic is float64 over the float32 source blocks, cast to
float32 at the end. Since each factor's rows sum to 1, composed rows sum to 1
by construction.

A copy of ``jincresize_tpu/compose.py``, NumPy only, over the port's own
``operator`` module, with one difference: ``_axis_keys`` clamps the
intermediate coordinates that B's windows cover to A's destination plane.
Where B's filter is wider than that plane (a steep second stage, a narrow
chroma plane), its windows run past the plane's edge; the JAX module indexes
A's tables there and raises ``IndexError``, while the golden clamps those
coordinates to the edge, whose taps carry weight. The clamp composes what
the nested stages compute; where the JAX module does not raise, the two give
bit-identical operators.
"""

from __future__ import annotations

import numpy as np

from .operator import BorderStrip, PlaneOperator

f32 = np.float32
f64 = np.float64


def _axis_keys(opA: PlaneOperator, opB: PlaneOperator, axis: str):
    """Per-dst-coordinate composed keys and geometry along one axis.

    Returns (comp_start, width, regular_mask, key_ids, uniq_info) where
    ``key_ids`` indexes the deduplicated regular keys, and uniq_info carries,
    per unique key, the B class and the A (class, offset) vectors needed to
    assemble composed blocks.
    """
    if axis == "x":
        startB, clsB, loB, hiB = opB.start_x, opB.cx_idx, opB.x_lo, opB.x_hi
        startA, clsA, loA, hiA = opA.start_x, opA.cx_idx, opA.x_lo, opA.x_hi
        n = opB.dst_width
    else:
        startB, clsB, loB, hiB = opB.start_y, opB.cy_idx, opB.y_lo, opB.y_hi
        startA, clsA, loA, hiA = opA.start_y, opA.cy_idx, opA.y_lo, opA.y_hi
        n = opB.dst_height
    fsB = opB.filter_size

    # Mid coordinates covered per dst coordinate: (n, fsB), clamped to the
    # intermediate plane as the golden clamps window coordinates. Where B's
    # filter is wider than that plane its windows run past the edge, and
    # the taps there weigh the edge row or column: a repeated coordinate
    # keeps its offset, so its weights add into the same composed taps.
    mids = startB[:, None].astype(np.int64) + np.arange(fsB)[None, :]
    mids = np.clip(mids, 0, len(startA) - 1)
    sA = startA[mids]  # (n, fsB) A window starts of covered mid coords
    comp_start = sA[:, 0]
    width = sA[:, -1] + opA.filter_size - comp_start

    # Regular: B coordinate interior AND every covered mid coordinate interior.
    idx = np.arange(n)
    b_interior = (idx >= loB) & (idx < hiB)
    a_interior = ((mids >= loA) & (mids < hiA)).all(axis=1)
    regular = b_interior & a_interior

    offs = sA - comp_start[:, None]  # (n, fsB) embedding offsets
    aCls = clsA[mids]  # (n, fsB)
    # Key per coordinate: (B class, A classes tuple, offsets tuple).
    key_mat = np.concatenate(
        [clsB[:, None].astype(np.int64), aCls.astype(np.int64), offs], axis=1
    )
    reg_idx = np.flatnonzero(regular)
    if len(reg_idx):
        uniq, inv = np.unique(key_mat[reg_idx], axis=0, return_inverse=True)
        key_ids = np.zeros(n, dtype=np.int64)
        key_ids[reg_idx] = inv
        u_bcls = uniq[:, 0].astype(np.int64)
        u_acls = uniq[:, 1 : 1 + fsB].astype(np.int64)
        u_offs = uniq[:, 1 + fsB :].astype(np.int64)
    else:
        key_ids = np.zeros(n, dtype=np.int64)
        u_bcls = np.zeros(0, dtype=np.int64)
        u_acls = np.zeros((0, fsB), dtype=np.int64)
        u_offs = np.zeros((0, fsB), dtype=np.int64)
    return comp_start, width, regular, key_ids, (u_bcls, u_acls, u_offs), (
        aCls,
        offs,
        mids,
    )


def _pixel_block(op: PlaneOperator, y: int, x: int) -> np.ndarray:
    """Per-pixel coefficient block of any operator pixel (interior or strip)."""
    if op.y_lo <= y < op.y_hi and op.x_lo <= x < op.x_hi:
        return op.pair_blocks[op.cy_idx[y], op.cx_idx[x]]
    for s in op.strips:
        if s.y0 <= y < s.y1 and s.x0 <= x < s.x1:
            return s.blocks[y - s.y0, x - s.x0]
    raise IndexError((y, x))


def _block_id_map(op: PlaneOperator) -> np.ndarray:
    """Per-pixel block CONTENT identity over the whole plane (dst_h, dst_w).

    Two pixels share an id iff their coefficient blocks are bitwise equal:
    interior pixels via their (cy, cx) dictionary pair, strip pixels via
    byte-level dedup of the strip slabs. Lets the strip composer dedup
    soundly even where windows straddle per-pixel border blocks.
    """
    ids = np.full((op.dst_height, op.dst_width), -1, dtype=np.int64)
    ncx = op.pair_blocks.shape[1]
    iy = op.cy_idx[op.y_lo : op.y_hi].astype(np.int64)
    ix = op.cx_idx[op.x_lo : op.x_hi].astype(np.int64)
    ids[op.y_lo : op.y_hi, op.x_lo : op.x_hi] = iy[:, None] * ncx + ix[None, :]
    base = op.pair_blocks.shape[0] * ncx
    for s in op.strips:
        ny, nx = s.y1 - s.y0, s.x1 - s.x0
        flat = np.ascontiguousarray(s.blocks).reshape(ny * nx, -1)
        _, inv = np.unique(flat.view(np.uint32), axis=0, return_inverse=True)
        ids[s.y0 : s.y1, s.x0 : s.x1] = base + inv.reshape(ny, nx)
        base += int(inv.max(initial=-1)) + 1
    return ids


def _compose_block(
    opA: PlaneOperator,
    opB: PlaneOperator,
    Bblk: np.ndarray,  # (fsB, fsB) float32 block of the outer operator
    mids_y: np.ndarray,  # (fsB,) covered mid rows
    mids_x: np.ndarray,
    offs_y: np.ndarray,  # (fsB,) embedding offsets
    offs_x: np.ndarray,
    fs_comp: int,
) -> np.ndarray:
    """Dense float64 composition of one output pixel's block (scalar path)."""
    out = np.zeros((fs_comp, fs_comp), dtype=f64)
    fsA = opA.filter_size
    for ly in range(opB.filter_size):
        for lx in range(opB.filter_size):
            w = f64(Bblk[ly, lx])
            if w == 0.0:
                continue
            a = _pixel_block(opA, int(mids_y[ly]), int(mids_x[lx])).astype(f64)
            oy, ox = int(offs_y[ly]), int(offs_x[lx])
            out[oy : oy + fsA, ox : ox + fsA] += w * a
    return out


def compose(opA: PlaneOperator, opB: PlaneOperator) -> PlaneOperator:
    """Compose: result applies A then B in a single pass (R = B . A)."""
    if (opB.src_width, opB.src_height) != (opA.dst_width, opA.dst_height):
        raise ValueError(
            "compose: B's source geometry must match A's destination "
            f"({opB.src_width}x{opB.src_height} vs {opA.dst_width}x{opA.dst_height})"
        )
    fsA, fsB = opA.filter_size, opB.filter_size

    csx, wx, reg_x, kx, (uxb, uxa, uxo), (aClsX, offsX, midsX) = _axis_keys(
        opA, opB, "x"
    )
    csy, wy, reg_y, ky, (uyb, uya, uyo), (aClsY, offsY, midsY) = _axis_keys(
        opA, opB, "y"
    )
    fs_comp = int(max(wx.max(), wy.max()))

    # ---------------------------------------------------------------- interior
    nuy, nux = len(uyb), len(uxb)
    pair = np.zeros((max(nuy, 1), max(nux, 1), fs_comp, fs_comp), dtype=f64)
    if nuy and nux:
        Bp = opB.pair_blocks.astype(f64)  # (BY, BX, fsB, fsB)
        Ap = opA.pair_blocks.astype(f64)  # (AY, AX, fsA, fsA)
        for ly in range(fsB):
            for lx in range(fsB):
                w = Bp[uyb[:, None], uxb[None, :], ly, lx]  # (nuy, nux)
                ablk = Ap[uya[:, None, ly], uxa[None, :, lx]]  # (nuy,nux,fsA,fsA)
                # Scatter-add at per-key offsets: group by (oy, ox) values.
                oy = uyo[:, ly]
                ox = uxo[:, lx]
                for voy in np.unique(oy):
                    my = oy == voy
                    for vox in np.unique(ox):
                        mx = ox == vox
                        pair[
                            np.ix_(
                                np.flatnonzero(my),
                                np.flatnonzero(mx),
                                range(voy, voy + fsA),
                                range(vox, vox + fsA),
                            )
                        ] += (w[my][:, mx][:, :, None, None] * ablk[my][:, mx])
    pair = pair.astype(f32)

    # ------------------------------------------------------------------ border
    # Irregular coordinates are a prefix/suffix on each axis (monotone window
    # structure); pixels in irregular rows/columns get per-pixel blocks.
    def pre_suf(regular):
        idxs = np.flatnonzero(regular)
        if len(idxs) == 0:
            return 0, 0
        return int(idxs[0]), int(idxs[-1]) + 1

    x_lo, x_hi = pre_suf(reg_x)
    y_lo, y_hi = pre_suf(reg_y)

    dst_h, dst_w = opB.dst_height, opB.dst_width

    # Border blocks dedup by content identity (ROADMAP 9: the per-pixel
    # Python composition was O(strip_px * fsB^2) interpreter work — hours at
    # 8K). Key = (B block id, A block-id grid over covered mids, embedding
    # offsets); identical keys provably compose to identical blocks, and real
    # geometries collapse strips to a few hundred uniques.
    idA = _block_id_map(opA)
    idB = _block_id_map(opB)

    def strip(y0, y1, x0, x1):
        if y1 <= y0 or x1 <= x0:
            return None
        ny, nx = y1 - y0, x1 - x0
        my = midsY[y0:y1]  # (ny, fsB)
        mx = midsX[x0:x1]  # (nx, fsB)
        grid = idA[my[:, None, :, None], mx[None, :, None, :]]
        key = np.concatenate(
            [
                idB[y0:y1, x0:x1].reshape(ny * nx, 1),
                grid.reshape(ny * nx, fsB * fsB),
                np.repeat(offsY[y0:y1], nx, axis=0),
                np.tile(offsX[x0:x1], (ny, 1)),
            ],
            axis=1,
        )
        _, first, inv = np.unique(
            key, axis=0, return_index=True, return_inverse=True
        )
        ub = np.zeros((len(first), fs_comp, fs_comp), dtype=f32)
        for u, pi in enumerate(first):
            yy, xx = y0 + int(pi) // nx, x0 + int(pi) % nx
            ub[u] = _compose_block(
                opA,
                opB,
                _pixel_block(opB, yy, xx),
                midsY[yy],
                midsX[xx],
                offsY[yy],
                offsX[xx],
                fs_comp,
            ).astype(f32)
        blocks = ub[inv.reshape(-1)].reshape(ny, nx, fs_comp, fs_comp)
        return BorderStrip(y0=y0, y1=y1, x0=x0, x1=x1, blocks=blocks)

    strips = [
        strip(0, y_lo, 0, dst_w),
        strip(y_hi, dst_h, 0, dst_w),
        strip(y_lo, y_hi, 0, x_lo),
        strip(y_lo, y_hi, x_hi, dst_w),
    ]
    strips = tuple(s for s in strips if s is not None)

    # Composed windows may extend past the source for pixels whose width is
    # below fs_comp — those taps carry zero weight and every apply path clips
    # gather indices, so no start clamping is needed (or wanted: shifting the
    # start would misalign the embedded offsets).

    return PlaneOperator(
        src_width=opA.src_width,
        src_height=opA.src_height,
        dst_width=dst_w,
        dst_height=dst_h,
        filter_size=fs_comp,
        radius=opB.radius,
        start_x=csx.astype(np.int32),
        start_y=csy.astype(np.int32),
        x_lo=x_lo,
        x_hi=x_hi,
        y_lo=y_lo,
        y_hi=y_hi,
        cx_idx=kx.astype(np.int32),
        cy_idx=ky.astype(np.int32),
        pair_blocks=pair,
        strips=strips,
    )
