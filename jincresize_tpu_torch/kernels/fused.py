"""Fused phase-conv interior: hand-written CUDA kernel and its plain form.

``fused_interior`` replaces ``jincresize_tpu/kernels/pallas_fused.py``
``make_fused_interior``/``_fused_kernel``: it computes the whole periodic
interior of a phase plan directly in destination layout ``(F, py*nyb,
px*nxb)`` (the block that belongs at ``canvas[ylo:, xlo:]``). The CUDA kernel
is ``csrc/fused_interior.cu``.

What bounds it on an H100: each output pixel costs ``Kh*Kw`` fp32 FMAs
(``fs**2`` plus the phases' offset padding), 9.6 G FMAs a frame at 4K->8K
tap 8 and 8.8 G at 4K->1080p tap 16, against 67 TFLOP/s of fp32 FMA; its
bytes (33 MB in, 133 MB out at 4K->8K) take a sixth of that time. So the
kernel is bound by FMA issue, and the design keeps every other instruction
rare beside the FMAs:

* all phases share one window: each phase's (fs, fs) block is placed at its
  source offset in a zero-padded ``(Kh, Kw)`` kernel (``build_conv_kernels``,
  the plain form's own kernels), so output (i, j) of every phase reads the
  source from ``(base_y + qy*i, base_x + qx*j)``;
* a block computes ``C`` anchor rows by ``TX*R`` anchor columns of one group
  of ``G`` phases (``G`` = 4 where the phase count allows, else 1). It
  streams its source window through shared memory once, row by row, in a
  double-buffered ring of ``ch`` rows a stage (4-byte ``cp.async``; zeros
  past the plane);
* a thread holds ``R`` consecutive anchors of ``C`` rows for all ``G``
  phases in registers (``R*C*G`` = 32 accumulators). For each staged source
  row and chunk of 8 taps it loads its register window (``qx*(R-1) + 8``
  values, as 16-byte loads) once and the chunk's weights of each of its
  rows (``8*G`` floats, one 16-byte load per 4, at one address for the whole
  block: a shared-memory broadcast), then runs ``8*R*C*G`` FMAs; the rows
  are padded every 32 floats, so the lanes' 16-byte window loads hit
  distinct banks;
* the accumulators go through shared memory to coalesced output rows.

Every output is one ``fmaf`` chain over its ``(Kh, Kw)`` kernel in row-major
order, the plain form's order (the zero taps of the offset padding add
exact zeros), so the kernel equals ``fused_interior_plain`` bit for bit.

``precision='bf16'`` is the documented non-parity mode, the Pallas kernel's
DEFAULT dot (``pallas_fused.py:235``): the MXU rounds both operands to
bfloat16 in one pass, multiplies exactly and sums in fp32. Here the kernels
are rounded once on the host (``round_bf16``: ties to even; ``w`` and
``kernels`` keep the rounded values in float32, and ``wtc`` holds them as
bfloat16 weight rows, ``tc_weights``), and a second kernel of the same
source runs the sums on the tensor cores (``mma.sync`` m16n8k16 and
m16n8k8, bf16 in, fp32 sums): for each staged source row, M = 16 anchor
columns, K = the taps of the row (``k_slots``, in the packing of
``tap_of_k``), N = 8 (anchor row, phase) pairs whose weight row the source
row meets, 2 m-tiles by 4 n-tiles a warp (``tc_layout``). The source is
staged in bfloat16, rounded once as it lands. The products are exact, but
the tensor core sums in its own order, so the kernel is held to
``fused_interior_plain`` (which rounds the source first and sums in fp32
FMA order) within ``tc_sum_bound``, not bit for bit.

``precision='wsplit3'`` is the Pallas kernel's weight split
(``pallas_fused.py:383-393``, 3 DEFAULT dots a pack at :236-251), the
mode u8 planes take (``KERNEL_PRECISION['fp32_u8src']``). The
host splits each unrounded fp32 kernel value into three bfloat16 parts,
``K == c0 + c1 + c2`` exactly (``split_bf16x3``, checked bit for bit at
the build). A u8 source value has 8 significant bits, as a bfloat16 part
does, so its staged bfloat16 copy is exact and every product is exact in
fp32: the three passes compute the fp32 products at a third of an fp32
dot's cost on a matrix unit, and only the order of the sums differs from
``fused_interior_plain`` in the fp32 mode (``wsplit3_bound``). For a
source that is not bfloat16-exact the staged copy rounds; the mode is
for u8 planes only. It runs a kernel of its own (``fused_ws3_kernel``): the
window is staged and rounded a stage ahead of the products, each staged
row runs against the n-tiles whose anchor rows read it
(``live_tiles``), their B fragments read from 16-byte weight rows
(``ws3_layout``, ``ws3_weights``, ``weight_row``, ``b_row``) by one
``wgmma`` a warpgroup where zero rows pad each residue (``Ws3Layout.lp``)
and by ``ldmatrix`` otherwise, and a block walks several frames
(``ws3_frames``). A plan
whose three parts and stages pass ``MAX_SMEM_BYTES`` at every shape runs
the fp32 kernel (``kernel_precision``).
``layout`` keeps in Python the arithmetic that places a block's staged
window and a thread's register window; the tests check it on the CPU.

TPU workarounds of the Pallas kernel that this one drops:

* the ``split3`` 0/1 scatter-matmul column-phase interleave -- the block
  writes interleaved output rows directly;
* ``residue_planes`` -- Mosaic cannot lower lane-strided slices; a thread
  reads its strided anchors from its register window;
* ``_choose_tmb``, ``_vmem_bytes`` and ``VMEM_BUDGET`` -- the row band is
  ``C`` anchor rows, and shared memory holds one phase group's weights and
  a ring of source rows, not the band;
* the Mosaic deep-tap envelope (``py*px <= 4``, ``fs**2 <= 4500``,
  ``JINCRESIZE_FUSED_FS2_MAX``) -- the kernel reads ``Kh`` and ``Kw`` at run
  time, so a deep tap (fs = 49 or 65 at tap 16) is the same loop, only longer;
* the ``JINCRESIZE_DEEP_FUSED_MIN_PIXELS`` output-size gate
  (``jincresize_tpu/apply_conv.py``), which exists because a Mosaic compile
  takes minutes -- a deep-tap plan takes this kernel at every output size.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..operator import PlaneOperator
from ..phase import PhasePlan, build_conv_kernels

from . import _build

# Per-block shared memory an H100 kernel may opt into (227 KB).
MAX_SMEM_BYTES = 232448
# fs**2 above which a plan has deep taps: the envelope of the TPU's seg and
# gather kernels (the Mosaic VMEM budget), which no kernel of the port keeps
# (each is bounded by its shared memory); the tests name deep-tap plans by it.
FS2_MAX = 1200
# The kernel's shapes (compile-time constants of csrc/fused_interior.cu):
# (threads a block, R anchors a thread along x, C*G accumulator rows a
# thread). A thread of a G-phase group holds C = CG // G anchor rows, so
# R*CG accumulators whatever the phase count. Every main-path plan runs the
# default; the narrow block stages rows a quarter as long, for the plans
# with a large step q whose default window row does not fit (``fit_shape``).
DEFAULT_SHAPE = (128, 4, 8)
NARROW_SHAPE = (32, 4, 8)
SHAPES = (DEFAULT_SHAPE, NARROW_SHAPE)
CHUNK = 8  # taps of a register window (csrc/fused_interior.cu kChunk)
# The kernel's precision modes: 'fp32' the exact FMA kernel, 'bf16' the
# tensor-core kernel on bfloat16-rounded operands, 'wsplit3' the tensor-core
# kernel on three bfloat16 parts of the weights (exact products for u8
# sources). The appliers map their precisions onto these.
PRECISIONS = ("fp32", "bf16", "wsplit3")
# bfloat16 parts of the weights a tensor-core mode multiplies.
TC_PARTS = {"bf16": 1, "wsplit3": 3}
# The fused and seg interiors' kernel mode for each applier precision: the
# JAX package's mapping (jincresize_tpu/apply_conv.py:656-660,
# jincresize_tpu/apply_conv_seg.py:72-76), read by both appliers and the
# sharded engine. u8 planes ('fp32_u8src', bf16-exact sources) take the
# three-pass weight split on the tensor cores, exact products at a third of
# an fp32 dot's passes. On an H100 80GB HBM3 at 700 W (chip_smoke.py phase
# 4, 8-frame u8 luma batches): the fused kernel 0.460 ms/frame at 4K->8K
# tap 8 against its fp32 FMA form's 0.670; the seg kernel 0.184 at
# 1440p->4K tap 8 against 0.239, and at 1440p->1080p tap 16 (fs 44, one
# frame a block beside the float32 blocks) 0.558 against 0.436, slower.
KERNEL_PRECISION = {"fp32": "fp32", "bf16": "bf16", "fp32_u8src": "wsplit3"}
# The appliers' precision each kernel mode reports as ``effective_precision``
# (KERNEL_PRECISION the other way).
APPLIER_PRECISION = {"fp32": "fp32", "bf16": "bf16", "wsplit3": "fp32_u8src"}
# Shared memory a block aims to stay under: a window that does not fit
# whole streams through the ring in stages of a few rows, so that one
# stage's copies overlap the last one's FMAs (faster on the card than one
# stage of the whole window); a plan whose weights alone pass it streams
# one row a stage.
SMEM_TARGET = 40 * 1024


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to the nearest bfloat16, ties to even, kept float32:
    the operand rounding of ``precision='bf16'`` (the kernels' own, on the
    card, is ``__float2bfloat16_rn``)."""
    return x.to(torch.bfloat16).to(torch.float32)


def split_bf16x3(K: np.ndarray) -> np.ndarray:
    """The three bfloat16 parts of float32 ``K``, stacked (3, ...) as
    float32: ``c0 = round_bf16(K)``, ``c1 = round_bf16(K - c0)``, ``c2 = K -
    c0 - c1``, the JAX package's split (``pallas_fused.py:387-393``).
    ``c0 + c1 + c2 == K`` exactly; ``c2`` is bfloat16-exact for every K
    whose lowest significand bit is at least 2**-133, the least bfloat16
    step (each part holds 8 of K's 24 bits): ``check_split`` says so of a
    given K."""
    K = np.ascontiguousarray(K, np.float32)
    c0 = round_bf16(torch.from_numpy(K)).numpy()
    r1 = K - c0
    c1 = round_bf16(torch.from_numpy(r1)).numpy()
    return np.stack([c0, c1, r1 - c1])


def check_split(K: np.ndarray, parts: np.ndarray) -> None:
    """Raise ValueError unless every one of ``parts`` (3, ...) is
    bfloat16-exact and ``parts[0] + parts[1] + parts[2] == K`` bit for bit."""
    K = np.asarray(K, np.float32)
    exact = all(np.array_equal(round_bf16(torch.from_numpy(p)).numpy(), p) for p in parts)
    total = (parts[0] + parts[1]) + parts[2]
    if not exact or not np.array_equal(total.view(np.uint32), K.view(np.uint32)):
        raise ValueError("split_bf16x3: the weights do not split into three bfloat16 parts")


F32_U = 2.0**-24  # unit roundoff of float32
BF16_U = 2.0**-8  # unit roundoff of bfloat16 (8 significand bits)
BF16_SUM_TOL = 2e-6  # the fp32 summation limit of the kernels' fp32 modes


def k_slots(n: int) -> int:
    """K slots of a tap row of ``n`` taps in the bf16 kernels: k16 chunks,
    the last one a k8 chunk where at most 8 taps are left."""
    r = n % 16
    return n - r + (0 if r == 0 else 8 if r <= 8 else 16)


def tap_of_k(k):
    """Tap (within its chunk) of logical k of an m16n8k16 chunk in the bf16
    kernels' packing: k = 2t + h -> 4t + h, k = 8 + 2t + h -> 4t + 2 + h, so
    that lane t's taps 4t .. 4t + 3 are a0 | a2 of an A row and b0 | b1 of
    its B column (csrc/common.cuh). A k8 chunk keeps k = tap."""
    k = np.asarray(k)
    hi, r = k >= 8, k % 8
    return 4 * (r // 2) + r % 2 + 2 * hi


def mma_maps(k: int = 16) -> dict[str, np.ndarray]:
    """The fragment maps of ``mma.sync.m16n8k16`` (``k = 16``) or
    ``m16n8k8`` (``k = 8``) with bf16 operands and fp32 sums, from the PTX
    ISA (csrc/common.cuh): for each lane (groupID g = lane >> 2,
    threadID_in_group t = lane & 3), the (row, column) of every value it
    holds. ``'a'`` (32, k // 4, 2, 2): A (16 x k), register r, half h
    (lower k first); ``'b'`` (32, k // 8, 2, 2): B (k x 8) as (k, n);
    ``'d'`` (32, 4, 2): C and D (16 x 8)."""
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    h = np.arange(2)

    def pairs(rows, cols):  # (32, 2 halves, 2): a register's two values
        return np.stack(np.broadcast_arrays(rows, cols), -1)

    a_rows = [g, g + 8, g, g + 8][: k // 4]
    a_cols = [2 * t, 2 * t, 2 * t + 8, 2 * t + 8][: k // 4]
    a = np.stack([pairs(r[:, None], c[:, None] + h) for r, c in zip(a_rows, a_cols)], 1)
    b = np.stack([pairs(2 * t[:, None] + 8 * i + h, g[:, None]) for i in range(k // 8)], 1)
    d = np.stack([np.stack([g + 8 * (i >> 1), 2 * t + (i & 1)], -1) for i in range(4)], 1)
    return {"a": a, "b": b, "d": d}


def tc_sum_bound(n: int, wsum: float, max_src: float) -> float:
    """The bound of the bf16 kernels against their plain forms:
    (gamma_n(2u) + 2u) * sum|w| * max|src|, u = 2**-24, gamma_n(v) = n*v /
    (1 - n*v), over the ``n`` taps a pixel sums.

    Both sides multiply the same bfloat16-rounded operands, and a product
    of two bfloat16 values (8 significand bits each) is exact in fp32, so
    only the sums differ. The plain form adds the products in fp32 FMA
    order. The tensor core adds them in fp32 in its own order, and its
    adder may not round to nearest: it aligns the addends to the largest
    exponent and may truncate, so each of the n additions is allowed one
    ulp of its result (2u relative) and the sum is within gamma_n(2u) *
    sum|products| of the exact one, sum|products| <= sum|w| * max|src|.
    The last 2u covers one rounding of the exact sum to fp32. The plain
    form's own error (at most gamma_n(u) of the same, far less in
    practice) is not added: both the readings on the card (chip_smoke.py
    prints reading / bound) and the CPU emulation
    (tests/test_torch_bf16_tc.py) sit far below the bound. It is never
    below ``f32_sum_bound``, the fp32 modes' bound of the same sum."""
    v = 2 * F32_U
    gamma = n * v / (1 - n * v)
    return (gamma + v) * wsum * max_src


def wsplit3_bound(n: int, wsum: float, max_src: float) -> float:
    """The bound of the wsplit3 kernels against their plain forms (the fp32
    modes' ``fused_interior_plain`` and ``seg_interior_plain``) on sources
    that are bfloat16-exact, such as u8 planes: ``tc_sum_bound(3n, ...)``
    plus ``f32_sum_bound(n, ...)``, over the ``n`` taps a pixel sums.

    A source value and a bfloat16 part have 8 significant bits each, so
    every product c_k * s is exact in fp32, and c0 + c1 + c2 == w makes
    their exact sum the exact sum of the w * s. The kernel adds the 3n
    products (three parts a tap) on the tensor cores in their own order,
    each addition allowed one ulp of its result (``tc_sum_bound``), over
    sum|products| <= (1 + 2**-6) sum|w| * max|src|: |w - c0| <= 2**-8 |w|,
    so |c0| + |c1| + |c2| <= (1 + 2**-7 + 2**-15) |w|. So it is within
    ``tc_sum_bound(3n, (1 + 2**-6) sum|w|)`` of the exact sum. The plain
    form's fp32 FMA chain is within ``f32_sum_bound(n)`` of the same exact
    sum. The two add."""
    return tc_sum_bound(3 * n, (1 + 2.0**-6) * wsum, max_src) + f32_sum_bound(n, wsum, max_src)


def f32_sum_bound(n: int, wsum: float, max_src: float) -> float:
    """The rounding of any float32 multiply-add chain over ``n`` taps
    against its exact value rounded once to float32: (gamma_n + u) * sum|w|
    * max|src|, with u = 2**-24 and gamma_n = n*u / (1 - n*u). A bound of
    the arithmetic, whatever the order of the sum."""
    gamma = n * F32_U / (1 - n * F32_U)
    return (gamma + F32_U) * wsum * max_src


def bf16_bound(op, max_src: float = 1.0) -> float:
    """The analytic bound of a bf16 interior against its fp32 mode on the
    plane of ``op``: each product w*s becomes w*s*(1 + d1)*(1 + d2) with
    |d| <= u, so a pixel moves by at most (2u + u**2) * sum|w| * max|src|,
    sum|w| over the plane's largest class-pair block; plus the fp32
    summation limit."""
    s = float(np.abs(op.pair_blocks).sum((2, 3)).max())
    return (2 * BF16_U + BF16_U**2) * s * max_src + BF16_SUM_TOL


def bf16_lsb(op, peak: float) -> int:
    """``bf16_bound`` at ``max|src| = 1`` in LSB of an integer format of
    ``peak``: floor(bound * peak) + 1."""
    return int(bf16_bound(op) * peak) + 1


def shape_name(shape) -> str:
    return "{}t r{} cg{}".format(*shape)


def _skew(x: int) -> int:
    """Physical offset of window column ``x`` in a staged row: 4 floats of
    padding after every 32, so lanes ``qx*R`` columns apart hit distinct
    banks with 16-byte loads."""
    return x + 4 * (x >> 5)


@dataclass(frozen=True)
class Layout:
    """How the kernel tiles one plan (mirrors ``csrc/fused_interior.cu``)."""

    tx: int  # threads a block
    r: int  # anchors a thread along x
    c: int  # anchor rows a thread (and a block)
    g: int  # phases a thread (a block's phase group)
    ngroups: int  # phase groups: gridDim.z = frames * ngroups
    kh: int  # kernel rows: fs + max(offs_y)
    kw: int  # kernel columns: fs + max(offs_x)
    kwp: int  # weight row stride, kw rounded up to 4
    qx_mode: int  # compile-time qx of the register window (1, 2), else 0
    nr: int  # source rows of a block's window: qy*(c - 1) + kh
    sw: int  # source columns staged: qx*(tx*r - 1) + kw
    swp: int  # floats a staged row takes (padded, skewed)
    ch: int  # rows a ring stage
    slots: int  # staged rows held at once
    smem_bytes: int

    @property
    def bj(self) -> int:
        """Anchor columns of a block."""
        return self.tx * self.r


def layout(
    py: int, px: int, qy: int, qx: int, kh: int, kw: int, shape=DEFAULT_SHAPE, g: int | None = None
) -> Layout:
    """The kernel's tiling of a plan with ``(Kh, Kw)`` kernels under
    ``shape``, ``g`` phases a block (default 4 where the phases split so)."""
    tx, r, cg = shape
    nph = py * px
    if g is None:
        g = 4 if nph % 4 == 0 else 1
    c = cg // g
    kwp = -(-kw // 4) * 4
    nr = qy * (c - 1) + kh
    sw = qx * (tx * r - 1) + kw
    # Window loads of a chunk reach qx*(r - 1) + CHUNK columns past a
    # thread's first, rounded up to 16-byte loads.
    swa = -(-(sw + 4) // 4) * 4
    swp = _skew(swa) + 4
    wfloats = kh * kwp * g
    bjp = tx * r + (tx * r) // 32 + 1
    tile = c * g * bjp
    row_bytes = swp * 4
    room = SMEM_TARGET - wfloats * 4
    if nr * row_bytes <= room:
        ch, slots = nr, nr
    else:
        ch = max(1, room // (2 * row_bytes))
        ch = min(ch, nr)
        slots = nr if ch >= nr else 2 * ch
    smem = (wfloats + max(slots * swp, tile)) * 4
    return Layout(
        tx=tx, r=r, c=c, g=g, ngroups=nph // g, kh=kh, kw=kw, kwp=kwp,
        qx_mode=qx if qx in (1, 2) else 0, nr=nr, sw=sw, swp=swp, ch=ch, slots=slots,
        smem_bytes=smem,
    )  # fmt: skip


def plan_layout(op: PlaneOperator, plan: PhasePlan, shape=DEFAULT_SHAPE) -> Layout:
    fs = op.filter_size
    kh = fs + int(plan.y.offsets.max())
    kw = fs + int(plan.x.offsets.max())
    return layout(plan.y.p, plan.x.p, plan.y.q, plan.x.q, kh, kw, shape)


def block_origin(lay: Layout, qy: int, qx: int, base_y: int, base_x: int, by: int, bx: int):
    """Source (row, column) of block (by, bx)'s staged window, and its first
    anchor (row, column): anchors ``i0 + c``, ``j0 + t*R + r``."""
    i0, j0 = by * lay.c, bx * lay.bj
    return base_y + qy * i0, base_x + qx * j0, i0, j0


def thread_window(lay: Layout, qx: int, t: int, b0: int, taps: int = CHUNK) -> range:
    """Window columns (relative to the block's staged window) that thread
    ``t`` loads for the chunk of ``taps`` taps from ``b0``: with a
    compile-time qx (``qx_mode``) one run of 16-byte loads from
    ``qx*R*t + b0``, else ``qx*r + b`` for each anchor."""
    x0 = qx * lay.r * t + b0
    if lay.qx_mode and taps == CHUNK:
        return range(x0, x0 + -(-(qx * (lay.r - 1) + CHUNK) // 4) * 4)
    return range(x0, x0 + qx * (lay.r - 1) + taps)


# The bf16 kernel: a warp holds TC_MW m-tiles of 16 anchor columns by
# TC_NT n-tiles of 8 (anchor row, phase) pairs (csrc/fused_interior.cu
# kTcMW, kTcNT); TC_LAND stages of f32 source rows land at once (kTcLand).
# A stage takes a third of the window's rows, fewer where the stages and
# the weights would pass TC_SMEM_TARGET (four 128-thread blocks an SM).
TC_MW, TC_NT, TC_LAND = 2, 4, 3
TC_SMEM_TARGET = 56 * 1024


@dataclass(frozen=True)
class TcLayout:
    """How the bf16 tensor-core kernel tiles one plan (mirrors ``fused_tc_kernel``)."""

    warps: int  # warps a block: SHAPES' threads / 32
    c: int  # anchor rows a block: TC_NT * 8 / g
    g: int  # phases a block
    ngroups: int  # phase groups: gridDim.z = frames * ngroups
    kh: int
    kw: int
    kwk: int  # k-slots of a weight row: k_slots(kw)
    ws: int  # words of a weight row (a, e): >= kwk / 2, even
    wn: int  # words of a phase group's weights: >= kh * g * ws, a multiple of 4
    nr: int  # source rows of a block's window: qy*(c - 1) + kh
    nw: int  # words of a copy row that A reads: ceil((qx*(bj - 1) + kwk) / 2)
    cw: int  # words of a staged copy row: >= nw, 16 mod 32
    ch: int  # rows a stage
    swf: int  # floats of a landing row: 2*nw + 4 rounded up to a multiple of 4
    smem_bytes: int

    @property
    def bj(self) -> int:
        """Anchor columns of a block."""
        return self.warps * TC_MW * 16


def weight_stride(kwk: int, qy: int, g: int) -> int:
    """Words of a weight row (a, e) of the bf16 kernel: the least even
    count >= kwk / 2 that puts the 8-word B reads of lanes g = 0..3 (one
    half warp of an 8-byte load) on 4 distinct 8-bank groups -- rows e
    apart (4 phases a block) or qy*g apart (one phase) -- if one within 32
    words does, else kwk / 2 rounded up to even."""
    lo = kwk // 2 + (kwk // 2) % 2
    for ws in range(lo, lo + 32, 2):
        d = ws if g == 4 else qy * ws
        offs = sorted((i * d) % 32 for i in range(4))
        gaps = [b - a for a, b in zip(offs, offs[1:])] + [offs[0] + 32 - offs[-1]]
        if min(gaps) >= 8:
            return ws
    return lo


def copy_rows(qx: int, bj: int, kslots: int) -> tuple[int, int, int]:
    """(nw, cw, swf) of a staged source row of a block ``bj`` anchors wide
    whose A fragments read ``kslots`` taps from each anchor: the words of a
    bf16 copy row that A reads, the words a copy row takes (16 mod 32, so
    that copy 1 falls on the other half of the banks) and the floats of an
    f32 landing row (2*nw + 1 floats from up to 3 past an aligned start)."""
    nw = -(-(qx * (bj - 1) + kslots) // 2)
    return nw, nw + (16 - nw) % 32, -(-(2 * nw + 4) // 4) * 4


def tc_layout(
    py: int, px: int, qy: int, qx: int, kh: int, kw: int, shape=DEFAULT_SHAPE, g: int | None = None
) -> TcLayout:
    """The bf16 tensor-core kernel's tiling of a plan with ``(Kh, Kw)``
    kernels: ``shape``'s threads in warps, ``g`` phases a block (default 4
    where the phases split so). Shared memory: one phase group's weights
    (``wn`` words), then TC_LAND stages of ``ch`` f32 rows and the current
    stage's ``ch`` bf16 rows (two copies of ``cw`` words), or the output
    tile where larger."""
    warps = shape[0] // 32
    nph = py * px
    if g is None:
        g = 4 if nph % 4 == 0 else 1
    c = TC_NT * 8 // g
    kwk = k_slots(kw)
    ws = weight_stride(kwk, qy, g)
    wn = -(-(kh * g * ws) // 4) * 4
    nr = qy * (c - 1) + kh
    bj = warps * TC_MW * 16
    nw, cw, swf = copy_rows(qx, bj, kwk)
    # Stages as the default shape's, whatever the shape: the packed one-tap
    # tail sums 8 rows of a stage at its end, so every shape adds alike.
    _, dcw, dswf = copy_rows(qx, DEFAULT_SHAPE[0] // 32 * TC_MW * 16, kwk)
    ch = max(1, min(-(-nr // 3), (TC_SMEM_TARGET // 4 - wn) // (TC_LAND * dswf + 2 * dcw)))
    tile = c * g * (bj + bj // 32 + 1)
    smem = 4 * (wn + max(ch * (TC_LAND * swf + 2 * cw), tile))
    return TcLayout(
        warps=warps, c=c, g=g, ngroups=nph // g, kh=kh, kw=kw, kwk=kwk, ws=ws, wn=wn, nr=nr,
        nw=nw, cw=cw, ch=ch, swf=swf, smem_bytes=smem,
    )  # fmt: skip


def tc_weights(K: np.ndarray, lay: TcLayout) -> np.ndarray:
    """The bf16 kernel's weights from bfloat16-exact kernels ``K`` (nph,
    Kh, Kw): (ngroups, 2 * wn) bfloat16 values as float32, phase
    group*g + e's row a at bf16 offset 2 * (a*g + e) * ws, zeros beyond kw
    and in the padding."""
    nph, kh, kw = K.shape
    w = np.zeros((lay.ngroups, kh, lay.g, 2 * lay.ws), np.float32)
    w[..., :kw] = K.reshape(lay.ngroups, lay.g, kh, kw).transpose(0, 2, 1, 3)
    out = np.zeros((lay.ngroups, 2 * lay.wn), np.float32)
    out[:, : kh * lay.g * 2 * lay.ws] = w.reshape(lay.ngroups, -1)
    return out


# The wsplit3 kernel (fused_ws3_kernel): SHAPES' warps of WS3_MW m-tiles
# each; the window lands in WS3_LAND f32 stages and is rounded into a ring
# of WS3_NS bf16 stages (two copies of each row) of ``ch`` rows: the first
# of WS3_CH whose layout fits WS3_SMEM_TARGET (two blocks an SM), else the
# first that fits at all (8 where the packed one-tap tail sums a stage's 8
# rows; with fewer a plan runs its last tap as a k8 chunk). The 4-warp
# shape of 4 phases a block pads the weight rows (``Ws3Layout.lp``) for
# ``wgmma`` where that fits, preferred at each number of rows a stage. A
# block walks ``ws3_frames`` frames, so that a launch has at least
# WS3_MIN_BLOCKS blocks. csrc/fused_interior.cu kWs*.
WS3_MW, WS3_NS, WS3_LAND = 2, 2, 2
WS3_CH = (8, 4, 2, 1)
WS3_PARTS = 3
WS3_SMEM_TARGET = MAX_SMEM_BYTES // 2 - 1024
WS3_MIN_BLOCKS = 2048


@dataclass(frozen=True)
class Ws3Layout:
    """How the wsplit3 kernel tiles one plan (mirrors ``fused_ws3_kernel``).

    The weights of a phase group are three parts (bfloat16, ``wn`` words
    each) of ``rows`` weight rows of 16 bytes (8 taps) a chunk: weight row
    ``R`` of chunk ``k`` at word ``4 * (k * rows + R)``, then, where one tap
    is left past the k16 chunks (``last1``), a column of that tap, weight
    row ``R`` at bfloat16 ``2 * nk8 * rows * 4 + R``. Row ``R(a, e)`` of
    kernel row ``a`` and phase ``e`` (``weight_row``) puts the (anchor row,
    phase) columns of an n-tile that read one staged row on consecutive
    rows, so that a B fragment is one ``ldmatrix`` read of contiguous
    bytes; the last row is zeros, the row of every column whose kernel row
    falls outside ``[0, kh)``. With ``lp`` > 0, ``lp`` zero slots of kernel
    rows pad each residue's rows on both sides, so that such a column of a
    live n-tile (``live_tiles``: one of its ``cpt`` anchor rows reads the
    row, so the others are at most ``cpt - 1`` slots from a kernel row)
    reads a zero row at ``R0(s) + col`` too: every column of an n-tile reads
    one stride from one address, the ``wgmma`` descriptor's core matrix
    (8 rows of 16 bytes), and the kernel's 4-warp shape takes the B of a
    warpgroup's products from there."""

    warps: int  # warps a block: SHAPES' threads / 32
    c: int  # anchor rows a block: 32 / g
    g: int  # phases a block
    ngroups: int  # phase groups: gridDim.z = frames * ngroups
    kh: int
    kw: int
    nq16: int  # k16 chunks of a row: kw // 16, one more where 9 or more taps are left
    k8: bool  # one k8 chunk past them (1 to 8 taps left; 1 where the tail is not packed)
    last1: bool  # one tap past them: the packed tail (the last tap of 8 rows in one k8 mma)
    nk8: int  # 8-tap chunks of a weight row: 2 * nq16 + k8
    lq: int  # kernel rows of one residue mod qy: ceil(kh / qy)
    lp: int  # zero kernel-row slots padding each residue: cpt - 1 (wgmma) or 0
    rows: int  # weight rows of a chunk: (qy * (lq + lp) + lp) * g, then the zero row
    wn: int  # words of one part: 4 * nk8 * rows, the last-tap column, a multiple of 4
    nr: int  # source rows of a block's window: qy*(c - 1) + kh
    ch: int  # rows a stage (WS3_CH)
    nst: int  # stages of ch rows a frame
    nw: int  # words of a copy row that A reads
    cw: int  # words of a staged copy row: >= nw, 16 mod 32
    swf: int  # floats of a landing row
    smem_bytes: int

    @property
    def bj(self) -> int:
        """Anchor columns of a block."""
        return self.warps * WS3_MW * 16

    @property
    def cpt(self) -> int:
        """Anchor rows of an n-tile."""
        return 8 // self.g

    @property
    def wgmma(self) -> bool:
        """The staged rows that reach all 4 n-tiles run their products as
        ``wgmma`` m64n32k16, one warpgroup (4 warps) a block, B from the
        padded weight rows; the others, and every row where this is False,
        as ``mma.sync``, B from ``ldmatrix``."""
        return self.warps == 4 and self.lp > 0


def ws3_layout(
    py: int,
    px: int,
    qy: int,
    qx: int,
    kh: int,
    kw: int,
    shape=DEFAULT_SHAPE,
    g: int | None = None,
    ch: int | None = None,
    last1: bool | None = None,
    pad: bool | None = None,
) -> Ws3Layout:
    """The wsplit3 kernel's tiling of a plan with ``(Kh, Kw)`` kernels:
    ``shape``'s threads in warps, ``g`` phases a block (default 4
    where the phases split so), stages of ``ch`` rows (default: see
    WS3_CH). ``last1`` and ``pad`` fix the weights' layout where they are
    given, as a launch at another shape than the build's must
    (``FusedInterior.ws3``): the tail (the packed one-tap tail, which takes
    stages of 8 rows, or a k8 chunk) and the zero rows for ``wgmma``
    (``Ws3Layout.lp``). By default the 4-warp shape with 4 phases a block
    pads where that fits (the first fitting layout, stages of the most rows
    first, padded before unpadded), and a one-tap tail is packed where the
    stages are 8 rows. Shared memory: one phase group's three weight
    parts, two tables of the window rows (``nr + 1`` words each, to a
    multiple of 4: each row's ``weight_row(s, 0)`` and its
    ``live_tiles``), WS3_LAND stages of f32 landing rows, then WS3_NS
    stages of bf16 rows (two copies of ``cw`` words)."""
    n16, rem = divmod(kw, 16)
    if last1 and rem != 1:
        raise ValueError(f"ws3_layout: no one-tap tail at kw {kw}")
    nph = py * px
    if g is None:
        g = 4 if nph % 4 == 0 else 1
    if ch is None:
        chs = (8,) if last1 else WS3_CH
        wg = shape[0] == 128 and g == 4  # wgmma measured faster with 4 phases a block only
        pads = (pad,) if pad is not None else (True, False) if wg else (False,)
        lays = [ws3_layout(py, px, qy, qx, kh, kw, shape, g, c, last1, p)
                for c in chs for p in pads]  # fmt: skip
        for limit in (WS3_SMEM_TARGET, MAX_SMEM_BYTES):
            for lay in lays:
                if lay.smem_bytes <= limit:
                    return lay
        return lays[-1]
    if last1 is None:
        last1 = rem == 1 and ch == 8
    elif last1 and ch != 8:
        raise ValueError("ws3_layout: the packed one-tap tail takes stages of 8 rows")
    warps = shape[0] // 32
    c = TC_NT * 8 // g
    nq16 = n16 + (rem > 8)
    k8 = 1 <= rem <= 8 and not last1
    nk8 = 2 * nq16 + k8
    lq = -(-kh // qy)
    lp = 8 // g - 1 if pad else 0  # an n-tile's other anchor rows: cpt - 1
    rows = (qy * (lq + lp) + lp) * g + 1
    wn = -(-(4 * nk8 * rows + (rows + 1) // 2 * last1) // 4) * 4
    nr = qy * (c - 1) + kh
    bj = warps * WS3_MW * 16
    nw, cw, swf = copy_rows(qx, bj, 16 * nq16 + 8 * (k8 or last1))
    smem = 4 * (WS3_PARTS * wn + 2 * ((nr + 4) // 4 * 4) + ch * (WS3_LAND * swf + WS3_NS * 2 * cw))
    return Ws3Layout(
        warps=warps, c=c, g=g, ngroups=nph // g, kh=kh, kw=kw, nq16=nq16, k8=k8, last1=last1,
        nk8=nk8, lq=lq, lp=lp, rows=rows, wn=wn, nr=nr, ch=ch, nst=-(-nr // ch), nw=nw, cw=cw,
        swf=swf, smem_bytes=smem,
    )  # fmt: skip


def ws3_frames(lay: Ws3Layout, nyb: int, nxb: int, frames: int) -> int:
    """Frames a block of the wsplit3 kernel walks, one after another: as
    many as leave a launch over ``frames`` frames WS3_MIN_BLOCKS blocks or
    more (weights, tables and the ring's start paid once for them all)."""
    per_frame = -(-nxb // lay.bj) * -(-nyb // lay.c) * lay.ngroups
    return max(1, min(frames, frames * per_frame // WS3_MIN_BLOCKS))


def weight_row(lay: Ws3Layout, qy: int, a, e):
    """Weight row ``R`` of kernel row ``a`` (in ``[0, kh)``) and phase
    ``e``: ``a`` by residue mod ``qy`` (``lq + lp`` slots a residue, after
    ``lp`` zero slots), then descending ``a // qy``, phases innermost; so
    ``R(s - qy*c, e) = R0(s) + c*g + e`` for staged row ``s`` and every
    anchor row ``c`` whose kernel row ``s - qy*c`` lies in ``[0, kh)``,
    where ``R0(s) = weight_row(s, 0)``; with ``lp = cpt - 1`` that row is
    a zero row for the other anchor rows of a live n-tile."""
    a = np.asarray(a)
    lq, lp = lay.lq, lay.lp
    return ((a % qy) * (lq + lp) + lp + lq - 1 - a // qy) * lay.g + np.asarray(e)


def b_row(lay: Ws3Layout, qy: int, s, col):
    """The weight row that column ``col`` (anchor row ``col // g``, phase
    ``col % g``) of an n-tile reads for staged row ``s``: ``R0(s) + col``,
    or the zero row where its kernel row is outside ``[0, kh)``."""
    a = np.asarray(s) - qy * (np.asarray(col) // lay.g)
    ok = (a >= 0) & (a < lay.kh)
    return np.where(ok, weight_row(lay, qy, s, 0) + col, lay.rows - 1)


def live_tiles(lay: Ws3Layout, qy: int, s: int) -> tuple[int, int] | None:
    """(first, last) n-tile with an anchor row that reads staged row ``s``
    (kernel row ``s - qy*c`` in ``[0, kh)``), or None: the kernel runs
    those n-tiles alone on the row."""
    cmin = 0 if s - lay.kh + 1 <= 0 else (s - lay.kh + qy) // qy
    cmax = min(lay.c - 1, s // qy)
    if cmin > cmax:
        return None
    return cmin // lay.cpt, cmax // lay.cpt


def ws3_weights(parts: np.ndarray, lay: Ws3Layout, qy: int) -> np.ndarray:
    """The wsplit3 kernel's weights from the (3, nph, Kh, Kw) parts of
    ``split_bf16x3``: (ngroups, 3 * 2 * wn) bfloat16 values as float32, in
    the layout of ``Ws3Layout`` (zeros beyond kw, past the kernel rows and
    in the padding)."""
    _, nph, kh, kw = parts.shape
    w = np.zeros((lay.ngroups, WS3_PARTS, 2 * lay.wn), np.float32)
    a, e = np.meshgrid(np.arange(kh), np.arange(lay.g), indexing="ij")
    R = weight_row(lay, qy, a, e)  # (kh, g)
    K = parts.reshape(WS3_PARTS, lay.ngroups, lay.g, kh, kw).transpose(1, 0, 3, 2, 4)
    taps = 8 * lay.nk8
    Kc = np.zeros(K.shape[:-1] + (taps,), np.float32)
    n = min(kw, 16 * lay.nq16 + 8 * lay.k8)  # the taps the chunks hold (the last tap apart)
    Kc[..., :n] = K[..., :n]
    for k in range(lay.nk8):
        idx = 8 * (k * lay.rows + R)[..., None] + np.arange(8)  # (kh, g, 8) bf16 offsets
        w[:, :, idx] = Kc[..., 8 * k : 8 * k + 8]
    if lay.last1:
        w[:, :, 8 * lay.nk8 * lay.rows + R] = K[..., kw - 1]
    return w.reshape(lay.ngroups, -1)


def fit_shape(py: int, px: int, qy: int, qx: int, kh: int, kw: int):
    """(shape, g) a plan runs: the default shape with 4 phases a block where
    the phases split so, else the narrow one (shorter staged rows), then
    both with one phase a block (a quarter of the weights), whichever first
    fits the shared memory; None if none fits."""
    for g in dict.fromkeys((4 if py * px % 4 == 0 else 1, 1)):
        for shape in SHAPES:
            if layout(py, px, qy, qx, kh, kw, shape, g).smem_bytes <= MAX_SMEM_BYTES:
                return shape, g
    return None


def smem_bytes(op: PlaneOperator, plan: PhasePlan, shape=DEFAULT_SHAPE) -> int:
    """Shared memory a block of the kernel takes on ``plan``: one phase
    group's weights and the larger of the source ring and the output tile."""
    return plan_layout(op, plan, shape).smem_bytes


def is_supported(op: PlaneOperator, plan: PhasePlan) -> bool:
    """Envelope: one block of some shape fits the shared memory.

    ``phase.plan_phases`` caps ``py*px*fs**2`` at 32768; shared memory holds
    one phase group's weights (at most 4 phases) and a ring of source rows,
    so every plan it returns is admitted, deep taps included; the check
    keeps the kernel honest if that cap ever moves.
    """
    lay = plan_layout(op, plan)
    return fit_shape(plan.y.p, plan.x.p, plan.y.q, plan.x.q, lay.kh, lay.kw) is not None


@dataclass(frozen=True)
class FusedInterior:
    """Device operator of the fused interior for one phase plan."""

    w: torch.Tensor  # (ngroups, Kh, kwp, G) f32: phase g*G + e's kernel at [g, :, :Kw, e]
    kernels: torch.Tensor  # (py*px, Kh, Kw) f32: phase.build_conv_kernels (plain form)
    py: int
    px: int
    qy: int
    qx: int
    base_y: int
    base_x: int
    nyb: int
    nxb: int
    fs: int
    shape: tuple  # the kernel shape engines launch (fit_shape; wsplit3: ws3_shape)
    g: int  # phases a block (fit_shape; the layout of w)
    # the mode that runs (PRECISIONS): 'bf16' rounds w and kernels; 'bf16' and
    # 'wsplit3' launch the tensor-core kernel; 'wsplit3' keeps w and kernels
    # unrounded (its plain form is the fp32 mode's)
    precision: str
    # the tensor-core modes only (the same for every shape): bf16 (ngroups,
    # 2 * wn) of tc_weights; wsplit3 (ngroups, 3 * 2 * wn) of ws3_weights
    wtc: torch.Tensor | None = None
    # wsplit3: the build's layout (ws3_layout at ws3_shape); a launch at
    # another shape keeps its weight layout (its tail and zero rows)
    ws3: Ws3Layout | None = None

    @property
    def bf16(self) -> bool:
        return self.precision == "bf16"

    @property
    def parts(self) -> int:
        """bfloat16 parts of the weights the launch multiplies (0: the FMA kernel)."""
        return TC_PARTS.get(self.precision, 0)

    @property
    def out_shape(self) -> tuple[int, int]:
        return self.py * self.nyb, self.px * self.nxb

    def layout(self, shape=None) -> Layout | TcLayout | Ws3Layout:
        """The launch's layout: ``layout``, ``tc_layout`` in the bf16 mode,
        ``ws3_layout`` in the wsplit3 mode."""
        _, kh, kw = self.kernels.shape
        args = (self.py, self.px, self.qy, self.qx, kh, kw, shape or self.shape, self.g)
        if self.precision == "wsplit3":
            return ws3_layout(*args, last1=self.ws3.last1, pad=self.ws3.lp > 0)
        return {"fp32": layout, "bf16": tc_layout}[self.precision](*args)


def ws3_shape(py: int, px: int, qy: int, qx: int, kh: int, kw: int, g: int):
    """The first of ``SHAPES`` whose wsplit3 layout with ``g`` phases a
    block fits the shared memory (the narrow one stages rows a quarter as
    long), or None."""
    for shape in SHAPES:
        if ws3_layout(py, px, qy, qx, kh, kw, shape, g).smem_bytes <= MAX_SMEM_BYTES:
            return shape
    return None


def kernel_precision(op: PlaneOperator, plan: PhasePlan, precision: str) -> str:
    """The mode ``make_fused_interior`` builds for ``precision`` on ``plan``:
    ``'wsplit3'`` only where its three weight parts and stages fit
    ``MAX_SMEM_BYTES`` at some shape (``ws3_shape``), else the exact
    ``'fp32'`` kernel (an envelope decision taken at the build, as the JAX
    package's envelopes are; nothing falls back at run time)."""
    if precision != "wsplit3":
        return precision
    lay = plan_layout(op, plan)
    geo = (plan.y.p, plan.x.p, plan.y.q, plan.x.q, lay.kh, lay.kw)
    fit = fit_shape(*geo)
    if fit is not None and ws3_shape(*geo, fit[1]) is None:
        return "fp32"
    return precision


def make_fused_interior(
    op: PlaneOperator,
    plan: PhasePlan,
    device: torch.device | str = "cpu",
    precision: str = "fp32",
) -> FusedInterior:
    """Host build of the fused interior's weights for ``plan`` on ``device``
    in the kernel mode ``precision`` (``PRECISIONS``), once per geometry:
    ``'bf16'`` rounds them to bfloat16, ``'wsplit3'`` splits them into three
    bfloat16 parts (``split_bf16x3``, checked bit for bit) or, where those
    do not fit (``kernel_precision``), builds the fp32 mode; the result's
    ``precision`` says which."""
    if precision not in PRECISIONS:
        raise ValueError(f"make_fused_interior: unknown precision {precision!r}")
    K = build_conv_kernels(op, plan)[:, 0]
    nph, kh, kw = K.shape
    geo = (plan.y.p, plan.x.p, plan.y.q, plan.x.q, kh, kw)
    fit = fit_shape(*geo)
    if fit is None:
        raise ValueError("make_fused_interior: plan outside the kernel envelope")
    shape, g = fit
    precision = kernel_precision(op, plan, precision)
    if precision == "bf16":
        K = round_bf16(torch.from_numpy(K)).numpy()
    lay = layout(*geo, shape, g)
    w = np.zeros((lay.ngroups, g, kh, lay.kwp), dtype=np.float32)
    w[..., :kw] = K.reshape(lay.ngroups, g, kh, kw)
    wtc = ws3 = None
    if precision == "wsplit3":
        shape = ws3_shape(*geo, g)
    if precision in TC_PARTS:
        tl = (tc_layout if precision == "bf16" else ws3_layout)(*geo, shape, g)
        if tl.smem_bytes > MAX_SMEM_BYTES:
            raise ValueError("make_fused_interior: plan outside the tensor-core kernel's envelope")
        if precision == "bf16":
            wtc = tc_weights(K, tl)
        else:
            parts = split_bf16x3(K)
            check_split(K, parts)
            wtc = ws3_weights(parts, tl, plan.y.q)
            ws3 = tl
        wtc = torch.from_numpy(wtc).to(torch.bfloat16).to(device)
    return FusedInterior(
        w=torch.from_numpy(np.ascontiguousarray(w.transpose(0, 2, 3, 1))).to(device),
        kernels=torch.from_numpy(K).to(device),
        py=plan.y.p,
        px=plan.x.p,
        qy=plan.y.q,
        qx=plan.x.q,
        base_y=plan.y.base,
        base_x=plan.x.base,
        nyb=plan.y.nblocks,
        nxb=plan.x.nblocks,
        fs=op.filter_size,
        shape=shape,
        g=g,
        precision=precision,
        wtc=wtc,
        ws3=ws3,
    )


def fused_interior_plain(fi: FusedInterior, src_f: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch form: shift-sum over the conv kernels + phase interleave.

    ``src_f`` (F, H, W) float32 -> (F, py*nyb, px*nxb) float32. Reads past the
    plane are zeros (padding), as in the kernel. Under ``fi.bf16`` the
    source is rounded to bfloat16 first (the kernels come rounded); under
    ``'wsplit3'`` this is the fp32 mode's form, unrounded kernels and
    source, whose products are exact for u8 sources. Calls
    are counted in ``fused_interior_plain.calls``, so that a run on the card
    can show that no engine took the plain form.
    """
    fused_interior_plain.calls += 1
    if fi.bf16:
        src_f = round_bf16(src_f)
    F, H, W = src_f.shape
    K = fi.kernels
    nph, Kh, Kw = K.shape
    qy, qx, nyb, nxb = fi.qy, fi.qx, fi.nyb, fi.nxb
    eh = (nyb - 1) * qy + Kh
    ew = (nxb - 1) * qx + Kw
    pad_h = max(0, fi.base_y + eh - H)
    pad_w = max(0, fi.base_x + ew - W)
    lhs = torch.nn.functional.pad(src_f, (0, pad_w, 0, pad_h))
    lhs = lhs[:, fi.base_y : fi.base_y + eh, fi.base_x : fi.base_x + ew]
    conv = torch.zeros((F, nph, nyb, nxb), dtype=torch.float32, device=src_f.device)
    for a in range(Kh):
        for b in range(Kw):
            win = lhs[:, a : a + (nyb - 1) * qy + 1 : qy, b : b + (nxb - 1) * qx + 1 : qx]
            conv.addcmul_(K[:, a, b].view(1, nph, 1, 1), win.unsqueeze(1))
    return (
        conv.view(F, fi.py, fi.px, nyb, nxb)
        .permute(0, 3, 1, 4, 2)
        .reshape(F, fi.py * nyb, fi.px * nxb)
    )


fused_interior_plain.calls = 0


def fused_interior(fi: FusedInterior, src_f: torch.Tensor, shape=None) -> torch.Tensor:
    """Fused interior of ``src_f`` (F, H, W) float32 in destination layout.

    On a CPU tensor this is ``fused_interior_plain``. On a CUDA tensor it
    launches ``csrc/fused_interior.cu`` (counted in ``fused_interior.launches``
    and, by ``fi.precision``, in ``fused_interior.mode_launches``; the bf16
    and wsplit3 modes launch its tensor-core kernel) or raises; it never
    falls back. ``shape`` is the kernel's (threads, R, C*G), one of
    ``SHAPES`` (default ``fi.shape``); every shape gives the same result
    (the tensor-core kernels take its threads as warps; wsplit3 stages its
    rows to the weights' layout, ``FusedInterior.ws3``) or raises where
    its layout does not fit.
    """
    shape = tuple(shape or fi.shape)
    if shape not in SHAPES:
        raise ValueError(f"fused_interior: shape {shape} is not one of {SHAPES}")
    if src_f.device.type == "cpu":
        return fused_interior_plain(fi, src_f)
    if src_f.device.type != "cuda":
        raise RuntimeError(f"fused_interior: unsupported device {src_f.device}")
    if src_f.dtype != torch.float32 or src_f.dim() != 3 or not src_f.is_contiguous():
        raise ValueError("fused_interior: src must be a contiguous (F, H, W) float32 tensor")
    if fi.w.device != src_f.device:
        raise ValueError("fused_interior: operator and source on different devices")
    lay = fi.layout(shape)
    if lay.smem_bytes > MAX_SMEM_BYTES:
        raise ValueError(f"fused_interior: shape {shape} needs {lay.smem_bytes} B of shared memory")
    if fi.parts == WS3_PARTS and fi.wtc.shape[-1] != WS3_PARTS * 2 * lay.wn:
        raise ValueError(f"fused_interior: shape {shape}'s weight layout is not the build's")
    F, H, W = src_f.shape
    hout, wout = fi.out_shape
    out = torch.empty((F, hout, wout), dtype=torch.float32, device=src_f.device)
    if F == 0:
        return out
    if F * lay.ngroups > 65535 or -(-fi.nyb // lay.c) > 65535:
        raise ValueError("fused_interior: grid too large (frames x phase groups or anchor rows)")
    geo = (F, H, W, fi.py, fi.px, fi.qy, fi.qx, fi.base_y, fi.base_x, fi.nyb, fi.nxb)
    with torch.cuda.device(src_f.device):
        if fi.bf16:
            rc = _build.library().jt_fused_interior_bf16(
                src_f.data_ptr(), fi.wtc.data_ptr(), out.data_ptr(), *geo,
                lay.kh, lay.kw, lay.kwk, lay.g, lay.ngroups, lay.ws, lay.wn, lay.cw, lay.ch,
                lay.swf, lay.warps, _build.stream_of(src_f),
            )  # fmt: skip
        elif fi.parts:
            rc = _build.library().jt_fused_interior_wsplit3(
                src_f.data_ptr(), fi.wtc.data_ptr(), out.data_ptr(), *geo,
                lay.kh, lay.kw, lay.g, lay.ngroups, lay.nq16, int(lay.k8), int(lay.last1),
                lay.lq, lay.lp, lay.rows, lay.wn, lay.cw, lay.swf, lay.ch,
                ws3_frames(lay, fi.nyb, fi.nxb, F), lay.warps,
                _build.stream_of(src_f),
            )  # fmt: skip
        else:
            rc = _build.library().jt_fused_interior(
                src_f.data_ptr(), fi.w.data_ptr(), out.data_ptr(), *geo,
                lay.kh, lay.kw, lay.kwp, lay.g, lay.ngroups, lay.ch, lay.slots, lay.swp,
                *shape, _build.stream_of(src_f),
            )  # fmt: skip
    _build.check(rc, "jt_fused_interior")
    fused_interior.launches += 1
    fused_interior.mode_launches[fi.precision] += 1
    return out


fused_interior.launches = 0
fused_interior.mode_launches = dict.fromkeys(PRECISIONS, 0)
