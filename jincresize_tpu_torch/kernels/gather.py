"""General-geometry gather interior: hand-written CUDA kernels and plain form.

``gather_interior`` replaces ``jincresize_tpu/kernels/pallas_gather.py``
``make_gather_interior``/``_gather_kernel`` (:137, ``pallas_call`` :455).
It computes the interior rectangle ``[y_lo, y_hi) x [x_lo, x_hi)`` of any
geometry, periodic or not, at any filter size:

    out[f, m, x] = sum_{ly, lx < fs} src[f, sy[m] + ly, sx[x] + lx]
                                     * pair_blocks[cy[m], cx[x], ly, lx]

with the operator's own window starts ``sy``/``sx`` and dictionary classes
``cy``/``cx``. Borders and the canvas are the caller's (``apply_gather``).

Two CUDA kernels in ``csrc/gather_interior.cu`` compute it; the wrapper
picks one from the tables and the launch, with no setting. What bounds
both on an H100 is feeding the FMAs, not their count: every pixel may own a
different (fs, fs) block, while the source is small and shared by
neighbouring windows.

The tile kernel (the tile body of ``csrc/gather_tile.cuh``, shared with the
band kernel) streams a tile's source window (32 columns by 16 rows of
output) through a double-buffered ``cp.async`` ring of source rows in
shared memory, frames side by side; a thread owns one column, 2 rows and up
to 8 frames (``FRAMES``, chosen from F by ``choose_ring``), loads each
staged row's source values once for both of its rows, and reads each row's
weights as one linear stream of 16-byte loads through its block, two
chunks ahead: one load serves 4 taps times its frames. At one frame a
launch that stream is the whole cost: 33,856 bytes a pixel at fs 92, 48.8
GB a frame at 3840x2160 -> 1366x768 tap 16 (23.8 ms on an H100).

The class-grouped kernel (``gather_interior_grouped``) reads each weight
for several rows: a block depends only on (row class, column class), and a
row class recurs every few rows (46 luma and 22 chroma rows a class at
that geometry). ``row_groups`` cuts the interior rows, in class order, into
groups of at most K rows of one class (``group_size`` takes K in
``GROUP_ROWS`` from the rows a class has); a block takes one group and
``GROUP_COLS`` columns, stages tap row ly of its K rows at a time, and a
thread's 16-byte weight load feeds 4 taps of all K rows. On an H100 at one
frame it takes 2.98 ms on that luma plane (K 16) and 1.08 on each chroma
plane (K 8), against 16.19 and 3.77 for the tile kernel; what bounds it
now is the SM's load/store pipe (two-way bank conflicts of the scalar
source reads at that downscale, and 32 lines a warp's weight load
touches). ``gather_interior`` takes it where ``takes_grouped``: the
tables have row groups (some class has 2 rows or more) and 2 F <= K. With
more frames the tile kernel's weight loads serve enough of them, and its
source reads, each serving 2 rows, make it the faster one. Tried on the
card and dropped: 128-column blocks, a double-buffered stage, and a branch
that skips a group's idle row slots (``csrc/gather_interior.cu`` gives
the times).

Per pixel and frame both kernels sum an ``fmaf`` chain along each tap row,
the row sums added in ly order (more accurate than one running sum over
fs**2 taps); the plain form sums alike, so the kernels and the plain form
agree bit for bit.

Weights: the kernel reads the compact dictionary as ``padded_blocks``,
``[cy, cx, ly, lx]`` with each tap row padded to a multiple of 4 floats
(16-byte loads): 89 MB at 256x256 classes and fs 17 (75.8 MB unpadded),
138.7 MB at fs 92. A thread's tap row is contiguous, so the 32 lanes of a
warp read 16 bytes each of their own sectors, the other half of which the
next 4 taps read. The earlier class-minor ``[cy, ly, lx, cx]`` order read
one scattered word per lane and tap (32 sectors for 128 useful bytes); the
expanded ``[cy, ly*fs + lx, x]`` layout would cost n_ux-fold memory (1.16
GB on 1080p -> 3740x2104) and was measured and rejected.

The envelope: a non-empty dictionary, a non-empty interior and one staged
source row of a tile (its window columns times one frame, two ring stages)
within the 227 KB of shared memory -- any filter size. Row groups are kept
only where one grouped stage (K window rows of ``GROUP_COLS`` columns)
fits too (``group_fits``), with a smaller K or none otherwise.

TPU workarounds of the Pallas kernel that this one drops:

* the host and device x-expansion of the dictionary into class planes
  ``Wx[n_uy, fs2p, nxi_pad]`` (``expand_weight_planes``, 1.16 GB at 256x256
  classes) -- a thread indexes the compact dictionary directly;
* the XLA horizontal im2col ``P[f, h, lx, x]`` built outside the kernel --
  a block stages its source window in shared memory;
* ``_choose_tiles`` against the 12 MB VMEM budget, the band origins and
  band-local starts (``syloc``/``y0``) and the padding of rows and columns
  to the tile grid -- a thread block covers a 32 x 16 pixel tile and masks
  the ragged edge itself;
* the ``JINCRESIZE_GATHER_TN``/``JINCRESIZE_GATHER_TM`` tile overrides;
* the envelope ``fs**2 <= 1200`` (``pallas_gather.is_supported``), the VMEM
  budget of a deep-tap tile: the window streams through the ring, so
  aperiodic deep-tap downscales (4K -> 1366x768 tap 16, fs 92) run here.

``gather_band`` replaces ``pallas_gather.py`` ``make_gather_band``/
``band_kernel`` (:306, ``pallas_call`` :333): the same sum over one row
shard of the sharded engine (``sharding.make_sharded_apply_gather``), read
from the shard's band (its own source rows plus the halos) at band-local
window starts ``syl``, for every destination row of the shard (border rows
too; the caller patches them), and stored straight into the shard's
``(F, td, dst_w)`` canvas at column ``x_lo``. Its kernel is
``csrc/gather_band.cu``, the same tile body with the canvas row stride.
TPU workarounds of ``make_gather_band`` that it drops besides the ones
above: the x-expanded class planes passed as a jit argument (the remote
compile's HTTP 413 limit), the XLA im2col ``P = band[:, colsT]``,
``choose_band_tiles`` against the 12 MB VMEM budget, the per-band origins
``y0`` with ``syloc`` relative to them, the padding of rows and columns to
``tm``/``tn`` and of the band to ``hp_need``, the ``dynamic_update_slice``
of the interior into the canvas, and the ``interpret=not backend_tpu``
switch (the wrapper chooses by the tensor's device).

Weights and state: the operator is the shared NumPy ``PlaneOperator`` that
the JAX package builds too, so the device tables are made from the same
object and no carry-over function is needed.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import metrics
from ..operator import PlaneOperator

from . import _build
from .fused import MAX_SMEM_BYTES

# The kernel's tiling (csrc/gather_tile.cuh): output columns and rows of a
# block (kTX, kTY), and the frames a thread may carry (its instances).
TILE = (32, 16)
FRAMES = (1, 2, 4, 8)
# The ring: at most this many source rows a stage, two stages, and about
# this many bytes, so that several blocks share an SM.
MAX_STAGE_ROWS = 8
RING_BYTES = 48 * 1024
# The class-grouped kernel (csrc/gather_interior.cu gather_class_kernel):
# columns of a block (kGCols), the rows a group may hold (its instances, K),
# and the most rows times frames a thread carries.
GROUP_COLS = 64
GROUP_ROWS = (4, 8, 16)
MAX_ROW_FRAMES = 32
GROUP_SMEM_BYTES = MAX_SMEM_BYTES - 1024  # room for its static arrays
# What a group's weight loads cost beside its FMAs, in rows of FMAs: a
# group of K rows takes about as long as K + WEIGHT_ROWS rows would without
# them (fitted to the fs-92 luma plane of 3840x2160 -> 1366x768 on an H100
# at one frame: 4.11, 3.41 and 3.00 ms at K = 4, 8 and 16).
WEIGHT_ROWS = 2


@dataclass(frozen=True)
class Ring:
    """Shared-memory ring of one launch (the kernel's ``swp``, ``ch``)."""

    frames: int  # frames a thread: one of FRAMES
    swp: int  # columns of a staged row, padded to 4 (16-byte rows)
    ch: int  # source rows a stage; two stages
    smem_bytes: int


def tile_span(starts: np.ndarray, tile: int, fs: int) -> int:
    """Widest window of a tile: max over tiles of ``tile`` consecutive
    starts of (max start - min start) + fs; the kernel's tile window."""
    s = np.asarray(starts, dtype=np.int64)
    n = -(-len(s) // tile) * tile
    s = np.concatenate([s, np.full(n - len(s), s[-1])]).reshape(-1, tile)
    return int((s.max(axis=1) - s.min(axis=1)).max()) + fs


def ring_layout(span_w: int, frames: int) -> Ring:
    """The ring for tiles at most ``span_w`` source columns wide carrying
    ``frames`` frames a thread."""
    swp = -(-span_w // 4) * 4
    row_bytes = 4 * swp * frames
    ch = max(1, min(MAX_STAGE_ROWS, RING_BYTES // (2 * row_bytes)))
    return Ring(frames, swp, ch, 2 * ch * row_bytes)


def frames_per_thread(n_frames: int) -> int:
    """The fewest of ``FRAMES`` that cover ``n_frames`` (8 beyond it)."""
    return next((f for f in FRAMES if f >= n_frames), FRAMES[-1])


def choose_ring(span_w: int, n_frames: int) -> Ring:
    """The ring of a launch over ``n_frames``: ``frames_per_thread``,
    halved until one staged row fits the shared memory. Raises when even
    one frame's row does not (``is_supported`` declines such operators)."""
    frames = frames_per_thread(n_frames)
    while True:
        ring = ring_layout(span_w, frames)
        if ring.smem_bytes <= MAX_SMEM_BYTES:
            return ring
        if frames == 1:
            raise ValueError(
                f"gather ring: a window row of {span_w} columns does not fit "
                f"{MAX_SMEM_BYTES} bytes of shared memory"
            )
        frames //= 2


def class_rows(cy: np.ndarray) -> int:
    """The most interior rows that one row class holds (0 without rows)."""
    return int(np.bincount(np.asarray(cy)).max()) if len(cy) else 0


def group_size(cy: np.ndarray) -> int:
    """K, the rows a group of the class-grouped kernel holds: 1 (the tile
    kernel) where no row class has 2 rows, else the one of ``GROUP_ROWS``
    whose groups take the least time: every class cut into ceil(n / K)
    groups of K slots (``row_groups``; a slot past a group's rows is summed
    too), each slot costing 1 + ``WEIGHT_ROWS`` / K rows."""
    if class_rows(cy) < 2:
        return 1
    n = np.bincount(np.asarray(cy))
    n = n[n > 0]
    return min(GROUP_ROWS, key=lambda k: (-(-n // k) * k).sum() * (k + WEIGHT_ROWS) / k)


def row_groups(cy: np.ndarray, k: int) -> np.ndarray:
    """The interior rows in class order, each class cut as evenly as it goes
    into groups of at most ``k`` rows: (n_groups, k) int32 row indices, each
    group's rows ascending and packed first, -1 after them. Groups run in
    class order, so one class's weights serve its groups back to back."""
    cy = np.asarray(cy)
    order = np.argsort(cy, kind="stable")
    bounds = np.cumsum(np.bincount(cy))
    groups = []
    for rows in np.split(order, bounds[:-1]):
        for part in np.array_split(rows, -(-len(rows) // k)) if len(rows) else ():
            groups.append(np.pad(part, (0, k - len(part)), constant_values=-1))
    return np.asarray(groups, dtype=np.int32).reshape(-1, k)


def group_ring(span_w: int, k: int, n_frames: int) -> Ring:
    """The shared memory of a grouped launch over ``n_frames`` for windows
    at most ``span_w`` columns wide: one stage of one tap row of ``k``
    source rows (``ch`` = k), at most ``MAX_ROW_FRAMES // k`` frames a
    thread, halved until it fits ``GROUP_SMEM_BYTES`` or down to 1."""
    swp = -(-span_w // 4) * 4
    frames = min(frames_per_thread(n_frames), MAX_ROW_FRAMES // k)
    while frames > 1 and k * swp * frames * 4 > GROUP_SMEM_BYTES:
        frames //= 2
    return Ring(frames, swp, k, k * swp * frames * 4)


def group_fits(span_w: int, k: int) -> bool:
    """One frame's grouped stage fits the shared memory."""
    return group_ring(span_w, k, 1).smem_bytes <= GROUP_SMEM_BYTES


def fsp_of(fs: int) -> int:
    """Floats of a padded tap row of the device dictionary."""
    return -(-fs // 4) * 4


def padded_blocks(pair_blocks: np.ndarray, device) -> torch.Tensor:
    """The dictionary as ``[cy, cx, ly, lx]`` on ``device``, each tap row
    padded with zeros to ``fsp_of(fs)`` floats: (n_uy, n_ux, fs, fsp)."""
    n_uy, n_ux, fs, _ = pair_blocks.shape
    out = np.zeros((n_uy, n_ux, fs, fsp_of(fs)), dtype=np.float32)
    out[..., :fs] = pair_blocks
    return torch.from_numpy(out).to(device)


def class_minor_view(blocks: torch.Tensor) -> torch.Tensor:
    """``padded_blocks`` seen as ``[cy, ly, lx, cx]`` (a view, no copy)."""
    return blocks[..., : blocks.shape[2]].permute(0, 2, 3, 1)


@dataclass(frozen=True)
class GatherInterior:
    """Device tables of the gather interior for one operator."""

    blocks: torch.Tensor  # (n_uy, n_ux, fs, fsp) f32, padded_blocks
    start_y: torch.Tensor  # (nyi,) int32 window starts of rows [y_lo, y_hi)
    cy_idx: torch.Tensor  # (nyi,) int32 row classes
    start_x: torch.Tensor  # (nxi,) int32 window starts of columns [x_lo, x_hi)
    cx_idx: torch.Tensor  # (nxi,) int32 column classes
    src_height: int
    src_width: int
    fs: int
    span_w: int  # widest tile window (tile_span of start_x)
    group_rows: int = 1  # K of the grouped kernel; 1: the tile kernel
    groups: torch.Tensor | None = None  # (n_groups, K) int32 row_groups
    group_span: int = 0  # widest window of GROUP_COLS columns

    @property
    def out_shape(self) -> tuple[int, int]:
        return self.start_y.shape[0], self.start_x.shape[0]


def interior_span(op: PlaneOperator) -> int:
    """``tile_span`` of the interior columns' window starts."""
    return tile_span(op.start_x[op.x_lo : op.x_hi], TILE[0], op.filter_size)


def is_supported(op: PlaneOperator) -> bool:
    """Envelope: a non-empty dictionary, an interior, and one frame's staged
    window row within the shared memory (``choose_ring``). Any filter size."""
    return (
        op.pair_blocks.size > 0
        and op.y_hi > op.y_lo
        and op.x_hi > op.x_lo
        and ring_layout(interior_span(op), 1).smem_bytes <= MAX_SMEM_BYTES
    )


def check_window_starts(starts: np.ndarray, size: int, fs: int, what: str) -> None:
    """Every window ``[start, start + fs)`` lies inside the source axis.

    The operator builder clamps interior window begins to
    ``0 <= start <= size - fs``; the kernels rely on that instead of an edge
    rule (the JAX kernels clamp columns and zero-pad rows, ``common.cuh``
    skips reads past the plane), so it is checked here on the host.
    """
    if len(starts) and (int(starts.min()) < 0 or int(starts.max()) + fs > size):
        raise ValueError(
            f"{what}: window starts in [{int(starts.min())}, {int(starts.max())}] "
            f"leave the source axis of {size} with filter_size {fs}"
        )


def make_gather_interior(
    op: PlaneOperator, device: torch.device | str = "cpu"
) -> GatherInterior:
    """Host tables of the interior rectangle plus the device dictionary."""
    if not is_supported(op):
        raise ValueError("make_gather_interior: geometry outside the kernel envelope")
    fs = op.filter_size
    sy = op.start_y[op.y_lo : op.y_hi]
    sx = op.start_x[op.x_lo : op.x_hi]
    check_window_starts(sy, op.src_height, fs, "make_gather_interior rows")
    check_window_starts(sx, op.src_width, fs, "make_gather_interior columns")

    cy = op.cy_idx[op.y_lo : op.y_hi]
    k, span = group_size(cy), tile_span(sx, GROUP_COLS, fs)
    while k > 1 and not group_fits(span, k):
        k = max([g for g in GROUP_ROWS if g < k], default=1)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(device)

    return GatherInterior(
        blocks=padded_blocks(op.pair_blocks, device),
        start_y=t(sy),
        cy_idx=t(cy),
        start_x=t(sx),
        cx_idx=t(op.cx_idx[op.x_lo : op.x_hi]),
        src_height=op.src_height,
        src_width=op.src_width,
        fs=fs,
        span_w=interior_span(op),
        group_rows=k,
        groups=t(row_groups(cy, k)) if k > 1 else None,
        group_span=span if k > 1 else 0,
    )


def window_sum_plain(src_f, sy, cy, sx, cx, pair_blocks_t) -> torch.Tensor:
    """Plain PyTorch per-pixel window sum: (F, H, W) -> (F, len(sy), len(sx)).

    ``out[f, m, x] = sum src[f, sy[m] + ly, sx[x] + lx] *
    pair_blocks_t[cy[m], ly, lx, cx[x]]``, summed as the kernels sum: along
    each tap row, then the row sums in ly order. Per tap an (F, ny, nx)
    source gather and an (ny, nx) weight gather, never the (F, ny, nx, fs,
    fs) product. Elementwise fp32 only (no matmul, so no TF32 path on CUDA
    tensors).
    """
    fs = pair_blocks_t.shape[1]
    sy, cy, sx, cx = (a.long() for a in (sy, cy, sx, cx))
    acc = torch.zeros(
        (src_f.shape[0], sy.shape[0], sx.shape[0]), dtype=torch.float32, device=src_f.device
    )
    for ly in range(fs):
        rows = (sy + ly)[:, None]
        row = torch.zeros_like(acc)
        for lx in range(fs):
            w = pair_blocks_t[:, ly, lx][cy][:, cx]  # (ny, nx)
            row.addcmul_(src_f[:, rows, (sx + lx)[None, :]], w)
        acc += row
    return acc


def gather_interior_plain(gi: GatherInterior, src_f: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch form of the gather interior: (F, H, W) -> (F, nyi, nxi)."""
    return window_sum_plain(
        src_f, gi.start_y, gi.cy_idx, gi.start_x, gi.cx_idx, class_minor_view(gi.blocks)
    )


def _output(gi: GatherInterior, src_f: torch.Tensor, name: str) -> torch.Tensor:
    """The (F, nyi, nxi) output of a launch on CUDA ``src_f``, after checking
    the source against the tables."""
    if src_f.device.type != "cuda":
        raise RuntimeError(f"{name}: unsupported device {src_f.device}")
    if src_f.dtype != torch.float32 or src_f.dim() != 3 or not src_f.is_contiguous():
        raise ValueError(f"{name}: src must be a contiguous (F, H, W) float32 tensor")
    F, H, W = src_f.shape
    if (H, W) != (gi.src_height, gi.src_width):
        raise ValueError(f"{name}: source {W}x{H} does not match the operator")
    if gi.blocks.device != src_f.device:
        raise ValueError(f"{name}: operator and source on different devices")
    return torch.empty((F,) + gi.out_shape, dtype=torch.float32, device=src_f.device)


def takes_grouped(gi: GatherInterior, n_frames: int) -> bool:
    """Whether a launch over ``n_frames`` runs the class-grouped kernel:
    where the tables have row groups and a weight load of the grouped kernel
    serves at least twice as many rows as one of the tile kernel serves
    frames (2 F <= K). The grouped kernel reads a staged source value for
    each of its rows (rows of one class share no source row), the tile
    kernel one for its 2 adjacent rows, so it wins only while the weight
    stream it saves outweighs those reads. On an H100 at F = 1..8 the
    faster kernel is the one this picks on the chroma plane of 3840x2160 ->
    1366x768 tap 16 (K 8) and the tap-8 1080p -> 3740x2104 luma plane
    (K 8); on the fs-92 luma plane (K 16) the tile kernel is 12% faster at
    F = 7 and 8 (``chip_smoke.py``'s gather row prints both)."""
    return gi.groups is not None and 2 * n_frames <= gi.group_rows


def gather_interior(gi: GatherInterior, src_f: torch.Tensor) -> torch.Tensor:
    """Gather interior of ``src_f`` (F, H, W) float32: (F, nyi, nxi).

    On a CPU tensor this is ``gather_interior_plain``. On a CUDA tensor it
    is ``gather_interior_grouped`` where ``takes_grouped``, else
    ``gather_interior_tile``; it never falls back.
    """
    if src_f.device.type == "cpu":
        return gather_interior_plain(gi, src_f)
    if src_f.dim() == 3 and takes_grouped(gi, src_f.shape[0]):
        return gather_interior_grouped(gi, src_f)
    return gather_interior_tile(gi, src_f)


def gather_interior_tile(gi: GatherInterior, src_f: torch.Tensor) -> torch.Tensor:
    """The tile kernel on any tables and frames: ``gather_interior``'s
    result, bit for bit. On a CPU tensor this is ``gather_interior_plain``.
    A launch counts in ``gather_interior_tile.launches`` and the counter
    ``gather_launches``, after it."""
    if src_f.device.type == "cpu":
        return gather_interior_plain(gi, src_f)
    out = _output(gi, src_f, "gather_interior_tile")
    F, H, W = src_f.shape
    if F == 0:
        return out
    ring = choose_ring(gi.span_w, F)
    with torch.cuda.device(src_f.device):
        rc = _build.library().jt_gather_interior(
            src_f.data_ptr(), gi.blocks.data_ptr(), gi.start_y.data_ptr(), gi.cy_idx.data_ptr(),
            gi.start_x.data_ptr(), gi.cx_idx.data_ptr(), out.data_ptr(), F, H, W, *gi.out_shape,
            gi.blocks.shape[1], gi.fs, gi.blocks.shape[3], ring.frames, ring.swp, ring.ch,
            _build.stream_of(src_f),
        )  # fmt: skip
    _build.check(rc, "jt_gather_interior")
    gather_interior_tile.launches += 1
    metrics.count("gather_launches")
    return out


gather_interior_tile.launches = 0


def gather_interior_grouped(gi: GatherInterior, src_f: torch.Tensor) -> torch.Tensor:
    """The class-grouped kernel on any number of frames, for tables with row
    groups: ``gather_interior``'s result, bit for bit. On a CPU tensor this
    is ``gather_interior_plain``. A launch counts in
    ``gather_interior_grouped.launches`` and in the counters
    ``gather_launches`` and ``gather_grouped_launches``, after it."""
    if gi.groups is None:
        raise ValueError("gather_interior_grouped: the tables have no row groups")
    if src_f.device.type == "cpu":
        return gather_interior_plain(gi, src_f)
    out = _output(gi, src_f, "gather_interior_grouped")
    F, H, W = src_f.shape
    if F == 0:
        return out
    ring = group_ring(gi.group_span, gi.group_rows, F)
    with torch.cuda.device(src_f.device):
        rc = _build.library().jt_gather_interior_grouped(
            src_f.data_ptr(), gi.blocks.data_ptr(), gi.groups.data_ptr(), gi.start_y.data_ptr(),
            gi.cy_idx.data_ptr(), gi.start_x.data_ptr(), gi.cx_idx.data_ptr(), out.data_ptr(),
            F, H, W, *gi.out_shape, gi.groups.shape[0], gi.blocks.shape[1], gi.fs,
            gi.blocks.shape[3], gi.group_rows, ring.frames, ring.swp, _build.stream_of(src_f),
        )  # fmt: skip
    _build.check(rc, "jt_gather_interior_grouped")
    gather_interior_grouped.launches += 1
    metrics.count("gather_launches")
    metrics.count("gather_grouped_launches")
    return out


gather_interior_grouped.launches = 0


@dataclass(frozen=True)
class GatherBand:
    """Device tables of one row shard's band interior."""

    blocks: torch.Tensor  # (n_uy, n_ux, fs, fsp) f32, padded_blocks
    syl: torch.Tensor  # (td,) int32 band-local window starts of the shard's rows
    cy: torch.Tensor  # (td,) int32 row classes (border rows clipped into range)
    start_x: torch.Tensor  # (nxi,) int32 window starts of columns [x_lo, x_hi)
    cx_idx: torch.Tensor  # (nxi,) int32 column classes
    band_h: int
    src_width: int
    dst_width: int
    x_lo: int
    fs: int
    span_w: int  # widest tile window (tile_span of start_x)

    @property
    def rows(self) -> int:
        return self.syl.shape[0]


def make_gather_band(
    op: PlaneOperator,
    syl: np.ndarray,
    cy: np.ndarray,
    band_h: int,
    blocks: torch.Tensor,
) -> GatherBand:
    """Tables of one row shard on the device of ``blocks``
    (``padded_blocks(op.pair_blocks, device)``, shared by the shards of a
    device).

    ``syl``/``cy`` are the band-local window starts and the classes of the
    shard's destination rows; every window must lie inside the band.
    """
    if not is_supported(op):
        raise ValueError("make_gather_band: geometry outside the kernel envelope")
    fs = op.filter_size
    n_uy = op.pair_blocks.shape[0]
    sx = op.start_x[op.x_lo : op.x_hi]
    check_window_starts(syl, band_h, fs, "make_gather_band rows")
    check_window_starts(sx, op.src_width, fs, "make_gather_band columns")
    if len(cy) != len(syl) or (len(cy) and (int(cy.min()) < 0 or int(cy.max()) >= n_uy)):
        raise ValueError(f"make_gather_band: row classes must be {len(syl)} values in [0, {n_uy})")
    device = blocks.device

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(device)

    return GatherBand(
        blocks=blocks,
        syl=t(syl),
        cy=t(cy),
        start_x=t(sx),
        cx_idx=t(op.cx_idx[op.x_lo : op.x_hi]),
        band_h=band_h,
        src_width=op.src_width,
        dst_width=op.dst_width,
        x_lo=op.x_lo,
        fs=fs,
        span_w=interior_span(op),
    )


def gather_band_plain(gb: GatherBand, band: torch.Tensor, canvas: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch form: ``window_sum_plain`` of the band, written into
    ``canvas[:, :, x_lo:x_hi]`` (in place); returns ``canvas``."""
    nxi = gb.start_x.shape[0]
    canvas[:, :, gb.x_lo : gb.x_lo + nxi] = window_sum_plain(
        band, gb.syl, gb.cy, gb.start_x, gb.cx_idx, class_minor_view(gb.blocks)
    )
    return canvas


def gather_band(gb: GatherBand, band: torch.Tensor, canvas: torch.Tensor) -> torch.Tensor:
    """Interior columns of one row shard, stored into ``canvas`` in place.

    ``band`` (F, band_h, W) and ``canvas`` (F, td, dst_w) are float32. On a
    CPU tensor this is ``gather_band_plain``. On a CUDA tensor it launches
    ``csrc/gather_band.cu`` (counted in ``gather_band.launches``) or raises;
    it never falls back. Returns ``canvas``.
    """
    if band.device.type == "cpu":
        return gather_band_plain(gb, band, canvas)
    if band.device.type != "cuda":
        raise RuntimeError(f"gather_band: unsupported device {band.device}")
    if band.dtype != torch.float32 or band.dim() != 3 or not band.is_contiguous():
        raise ValueError("gather_band: band must be a contiguous (F, band_h, W) float32 tensor")
    F, H, W = band.shape
    if (H, W) != (gb.band_h, gb.src_width):
        raise ValueError(f"gather_band: band {W}x{H} does not match the tables")
    if (
        canvas.dtype != torch.float32
        or tuple(canvas.shape) != (F, gb.rows, gb.dst_width)
        or not canvas.is_contiguous()
    ):
        raise ValueError(
            f"gather_band: canvas must be a contiguous ({F}, {gb.rows}, {gb.dst_width}) "
            "float32 tensor"
        )
    if gb.blocks.device != band.device or canvas.device != band.device:
        raise ValueError("gather_band: tables, band and canvas on different devices")
    if F == 0:
        return canvas
    ring = choose_ring(gb.span_w, F)
    with torch.cuda.device(band.device):
        rc = _build.library().jt_gather_band(
            band.data_ptr(), gb.blocks.data_ptr(), gb.syl.data_ptr(), gb.cy.data_ptr(),
            gb.start_x.data_ptr(), gb.cx_idx.data_ptr(), canvas.data_ptr(), F, H, W, gb.rows,
            gb.start_x.shape[0], gb.blocks.shape[1], gb.fs, gb.blocks.shape[3], gb.dst_width,
            gb.x_lo, ring.frames, ring.swp, ring.ch, _build.stream_of(band),
        )  # fmt: skip
    _build.check(rc, "jt_gather_band")
    gather_band.launches += 1
    return canvas


gather_band.launches = 0
