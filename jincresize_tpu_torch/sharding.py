"""Row-sharded multi-device apply: halo collection and per-shard interiors.

Port of ``jincresize_tpu/sharding.py``. Destination rows split evenly over
the ``rows`` axis of a device mesh; each shard owns a contiguous band of
source rows and collects the halo rows its windows reach from its
neighbours; frames split over the ``data`` axis. The JAX package runs one
``shard_map`` over a ``jax.sharding.Mesh``. Here one Python process drives a
``RowMesh``, a grid of ``torch.device``s in which devices may repeat: four
row shards on one card (``make_mesh(n_rows=4, devices=[torch.device("cuda",
0)] * 4)``) run one after another and their halo exchange is a copy on that
card; shards on distinct cards get their halos by device-to-device copies.
Halo rows that would come from beyond the mesh are zeros (the JAX
``ppermute`` chains wrap around; no window reads those rows in either
package).

Per shard, after its halo is collected:

* ``conv-fused`` -- the fused phase-conv kernel (``kernels/fused.py``) on the
  shard's segment, with the plan shifted so that block 0 starts at row 0,
  deep taps included;
* ``seg`` -- the segment-periodic kernel (``kernels/seg.py``) on the shard's
  blocks of the plan, made relative to its band;
* ``gather`` -- the band kernel (``kernels/gather.py`` ``gather_band``),
  stored straight into the shard's canvas;
* ``gather-scan`` -- the JAX package's ``fs**2``-step uniform gather-MAC in
  plain torch, only where the band kernel's envelope declines (no
  dictionary or interior, or windows outside the band; unlike the JAX
  package's band kernel, it takes deep taps).

Border rows and columns and the plan's exception rows and columns are then
patched from the uniform operator (``build_uniform``), and each shard is
finalized (clamp, round half to even, cast) on its device before the shards
are concatenated on ``mesh.devices[0][0]``. As in the JAX package, the halo
is exchanged first and computed on after, with no overlap of the two.

A mesh may span processes (``distributed.global_mesh``): its ``ranks`` grid
says which ``torch.distributed`` rank owns each entry. Each rank builds and
runs only its own shards and uploads only their source rows; the halo rows
of another rank's shards arrive by ``torch.distributed.batch_isend_irecv``,
one batch a call, every rank walking the same global (data row, shard, hop)
order so that the messages between two ranks pair up (the JAX package's
``ppermute`` chains); a replicated source is assembled with one
``all_gather``. Under gloo the halos of CUDA shards go through host buffers,
under NCCL card to card. The call returns this rank's rows as
``LocalShard``s (``.index``, ``.data``), the twin of
``jax.Array.addressable_shards``: nothing is concatenated across ranks.

Weights and state: the operator is the port's NumPy ``PlaneOperator`` (a
copy of the JAX package's, bit-identical).
``build_uniform``, ``ShardPlan`` and ``plan_row_shard`` are copies of the JAX
module's pure NumPy functions (that module imports jax), which the tests hold
equal to the originals, so the block table and the partition are the same on
both sides and no carry-over function is needed.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from collections.abc import Callable
from dataclasses import dataclass

import numpy as np
import torch

from .operator import PlaneOperator
from .phase import (
    AxisPhasePlan,
    PhasePlan,
    SegAxisPlan,
    SegPhasePlan,
    plan_phases,
    plan_phases_seg,
)

from .apply_xla import finalize, source_f32
from .kernels import fused as fused_k
from .kernels import gather as gather_k
from .kernels import seg as seg_k

f32 = torch.float32


def build_uniform(op: PlaneOperator) -> tuple[np.ndarray, np.ndarray]:
    """Flatten the operator to (blocks_all[NB, fs, fs], bid[dst_h, dst_w]).

    Interior pixels index the pair dictionary; border pixels index their
    per-pixel strip blocks appended after it.
    """
    fs = op.filter_size
    n_uy, n_ux = op.pair_blocks.shape[:2]
    parts = [op.pair_blocks.reshape(-1, fs, fs)]
    bid = np.zeros((op.dst_height, op.dst_width), dtype=np.int32)
    if n_uy and n_ux:
        inter = (
            op.cy_idx[op.y_lo : op.y_hi][:, None] * n_ux
            + op.cx_idx[op.x_lo : op.x_hi][None, :]
        )
        bid[op.y_lo : op.y_hi, op.x_lo : op.x_hi] = inter
    offset = n_uy * n_ux
    for s in op.strips:
        ny, nx = s.blocks.shape[:2]
        bid[s.y0 : s.y1, s.x0 : s.x1] = offset + np.arange(ny * nx).reshape(ny, nx)
        parts.append(s.blocks.reshape(-1, fs, fs))
        offset += ny * nx
    blocks_all = (
        np.concatenate(parts, axis=0)
        if parts
        else np.zeros((1, fs, fs), dtype=np.float32)
    )
    if blocks_all.shape[0] == 0:
        blocks_all = np.zeros((1, fs, fs), dtype=np.float32)
    return blocks_all.astype(np.float32), bid


@dataclass(frozen=True)
class ShardPlan:
    """Host-computed static partitioning of one plane geometry over N devices."""

    n_devices: int
    dst_rows_per: int  # padded destination rows per device
    src_rows_per: int  # padded source rows per device
    halo_up: int  # rows received from the previous device
    halo_dn: int  # rows received from the next device
    replicate_src: bool  # fallback: halo hops would cover the whole mesh
    dst_pad: int
    src_pad: int
    # Hops needed to collect each halo; consistent with halo_up/halo_dn (0
    # when the halo is 0), so no defaults are provided.
    hops_up: int
    hops_dn: int


def plan_row_shard(op: PlaneOperator, n_devices: int) -> ShardPlan:
    """Compute halo sizes for an even row partition of dst and src."""
    dst_h, src_h = op.dst_height, op.src_height
    fs = op.filter_size
    td = -(-dst_h // n_devices)
    ts = -(-src_h // n_devices)
    dst_pad = td * n_devices - dst_h
    src_pad = ts * n_devices - src_h
    halo_up = 0
    halo_dn = 0
    start_y = op.start_y
    for d in range(n_devices):
        r0, r1 = d * td, min((d + 1) * td, dst_h)
        if r0 >= r1:
            continue
        lo = int(start_y[r0:r1].min())
        hi = int(start_y[r0:r1].max()) + fs
        halo_up = max(halo_up, d * ts - lo)
        halo_dn = max(halo_dn, hi - (d + 1) * ts)
    halo_up = max(halo_up, 0)
    halo_dn = max(halo_dn, 0)
    # Deep downscales need halos spanning several neighbour bands, collected
    # hop by hop. Replicate on a byte break-even: the hops ship
    # halo_up + halo_dn rows per device, replication the other devices'
    # (n - 1) * ts rows.
    hops_up = -(-halo_up // ts) if halo_up else 0
    hops_dn = -(-halo_dn // ts) if halo_dn else 0
    replicate = halo_up + halo_dn >= (n_devices - 1) * ts
    return ShardPlan(
        n_devices=n_devices,
        dst_rows_per=td,
        src_rows_per=ts,
        halo_up=halo_up,
        halo_dn=halo_dn,
        replicate_src=replicate,
        dst_pad=dst_pad,
        src_pad=src_pad,
        hops_up=hops_up,
        hops_dn=hops_dn,
    )


# ---------------------------------------------------------------------------
# The mesh.
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class RowMesh:
    """A ('data', 'rows') grid of torch devices, ``devices[j][d]``; devices
    may repeat (several shards on one card run one after another).

    ``ranks[j][d]`` is the ``torch.distributed`` rank that owns entry (j, d);
    None means that every entry belongs to this process."""

    devices: tuple[tuple[torch.device, ...], ...]
    ranks: tuple[tuple[int, ...], ...] | None = None

    def __post_init__(self):
        if not self.devices or not self.devices[0] or len({len(r) for r in self.devices}) != 1:
            raise ValueError("RowMesh: devices must be a non-empty (n_data, n_rows) grid")
        if self.ranks is not None and [len(r) for r in self.ranks] != [
            len(r) for r in self.devices
        ]:
            raise ValueError("RowMesh: ranks must be a grid of the devices' shape")

    @property
    def spans_ranks(self) -> bool:
        """Whether the entries belong to more than one process."""
        return self.ranks is not None and len({r for row in self.ranks for r in row}) > 1

    def is_local(self, j: int, d: int) -> bool:
        """Whether this process owns entry (j, d)."""
        return self.ranks is None or self.ranks[j][d] == torch.distributed.get_rank()

    @property
    def n_data(self) -> int:
        return len(self.devices)

    @property
    def n_rows(self) -> int:
        return len(self.devices[0])


def make_mesh(
    n_rows: int | None = None, n_data: int = 1, devices=None, device_type: str = "cuda"
) -> RowMesh:
    """A ('data', 'rows') mesh over ``devices`` (default: every visible
    device of ``device_type``; the CPU counts as one), filled row by row."""
    if devices is None:
        if device_type == "cuda":
            devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
            if not devices:
                raise RuntimeError("make_mesh: no CUDA device is visible")
        elif device_type == "cpu":
            devices = [torch.device("cpu")]
        else:
            raise ValueError(f"make_mesh: unsupported device type {device_type!r}")
    devices = [torch.device(d) for d in devices]
    if n_rows is None:
        n_rows = len(devices) // n_data
    if n_rows < 1 or n_data < 1 or n_data * n_rows > len(devices):
        raise ValueError(
            f"make_mesh: {n_data} x {n_rows} shards need that many devices, got {len(devices)}"
        )
    return RowMesh(
        tuple(tuple(devices[j * n_rows : (j + 1) * n_rows]) for j in range(n_data))
    )


# ---------------------------------------------------------------------------
# Halo collection and the per-shard pieces.
# ---------------------------------------------------------------------------


def halo_hops(d: int, ts: int, halo_up: int, halo_dn: int) -> list[tuple[int, int]]:
    """Shard ``d``'s halo hops in band order, each (i, rows): ``rows`` rows
    from shard d + i, i < 0 above (the last rows of that shard), i > 0 below
    (its first rows). Hop i ships ``ts`` rows, the farthest hop only the
    rows it contributes."""
    hops_up = -(-halo_up // ts)
    hops_dn = -(-halo_dn // ts)
    above = [(-i, halo_up - (i - 1) * ts if i == hops_up else ts) for i in range(hops_up, 0, -1)]
    below = [(i, halo_dn - (i - 1) * ts if i == hops_dn else ts) for i in range(1, hops_dn + 1)]
    return above + below


def hop_rows(part: torch.Tensor, i: int, rows: int) -> torch.Tensor:
    """The rows that hop ``i`` takes from its shard's (F, ts, W) part."""
    return part[:, part.shape[1] - rows :] if i < 0 else part[:, :rows]


def collect_band(
    parts: list[torch.Tensor | None],
    d: int,
    halo_up: int,
    halo_dn: int,
    replicate: bool,
    received: dict[int, torch.Tensor] | None = None,
) -> torch.Tensor:
    """Shard ``d``'s band (F, band_h, W) on its device.

    ``parts[e]`` is shard e's (F, ts, W) source rows on shard e's device. The
    band is every shard's rows when ``replicate``, else the last ``halo_up``
    rows above shard d (hop i from shard d - i, the farthest hop shipping only
    the rows it contributes), its own rows, and the first ``halo_dn`` rows
    below it; rows from beyond the mesh are zeros. ``received[i]`` is hop
    i's rows where another process owns shard d + i (``parts`` holds None
    there).
    """
    dev = parts[d].device
    if replicate:
        return torch.cat([p.to(dev) for p in parts], dim=1)
    n = len(parts)
    F, ts, W = parts[d].shape
    received = received or {}

    def hop(i: int, rows: int) -> torch.Tensor:
        e = d + i
        if not 0 <= e < n:
            return torch.zeros((F, rows, W), dtype=f32, device=dev)
        if i in received:
            return received[i].to(dev)
        return hop_rows(parts[e], i, rows).to(dev)

    hops = halo_hops(d, ts, halo_up, halo_dn)
    above = [hop(i, rows) for i, rows in hops if i < 0]
    below = [hop(i, rows) for i, rows in hops if i > 0]
    return torch.cat([*above, parts[d], *below], dim=1)


# Window floats one patch_values step gathers (128 MB): bounds its memory at
# 8K widths, where one frame's border-row windows take ~26 M floats.
PATCH_STEP_FLOATS = 1 << 25


def patch_values(
    band: torch.Tensor, sy: torch.Tensor, sx: torch.Tensor, bid: torch.Tensor, blocks: torch.Tensor
) -> torch.Tensor:
    """(F, len(sy), len(sx)) window sums against per-pixel uniform blocks:

    ``out[f, i, j] = sum_{a, l} band[f, sy[i] + a, sx[j] + l] * blocks[bid[i, j], a, l]``.

    The port of both ``_patch_rows_sliced`` (``sy`` the patch rows, ``sx``
    every column) and ``_patch_cols_sliced`` (``sy`` every row, ``sx`` the
    patch columns): one row gather and one column gather of all the windows
    in place of ``vmap(dynamic_slice)``, and elementwise products summed over
    the taps (no matmul, so no TF32 on CUDA tensors). Frames go in steps of
    at most ``PATCH_STEP_FLOATS`` window floats; a few large operations,
    since many small ones cost more in launches than in work.
    """
    k, m, fs = sy.shape[0], sx.shape[0], blocks.shape[1]
    taps = torch.arange(fs, device=band.device)
    rows = (sy[:, None] + taps).reshape(-1)
    cols = (sx[:, None] + taps).reshape(-1)
    w = blocks[bid].permute(0, 2, 1, 3)  # (k, a, m, l)
    step = max(1, PATCH_STEP_FLOATS // max(1, k * m * fs * fs))
    out = [
        (band[f : f + step, rows][:, :, cols].view(-1, k, fs, m, fs) * w).sum((2, 4))
        for f in range(0, band.shape[0], step)
    ]
    return torch.cat(out) if len(out) > 1 else out[0]


def scan_values(
    band: torch.Tensor,
    sy: torch.Tensor,
    sx: torch.Tensor,
    bid: torch.Tensor,
    blocks: torch.Tensor,
    last_row: int,
) -> torch.Tensor:
    """The JAX package's ``_local_apply``: the ``fs**2``-step uniform
    gather-MAC over (F, len(sy), len(sx)) pixels, the products of each tap
    row formed at once and added one tap after another in (ly, lx) order.

    Window columns are clipped to the plane and window rows to band row
    ``last_row``, the last real source row: rows of the band below it are
    the zero padding of an uneven split, and the golden clamps to the last
    source row. (The JAX package clips to the band's last row, padding
    included, which is off where the filter is taller than the source.)
    """
    F, band_h, W = band.shape
    fs = blocks.shape[1]
    last_row = min(last_row, band_h - 1)
    cols = torch.clamp(sx[:, None] + torch.arange(fs, device=band.device), 0, W - 1)
    acc = torch.zeros((F, sy.shape[0], sx.shape[0]), dtype=f32, device=band.device)
    for ly in range(fs):
        rows = band[:, torch.clamp(sy + ly, 0, last_row)]  # (F, k, W)
        prod = rows[:, :, cols] * blocks[:, ly][bid]  # (F, k, m, fs)
        for lx in range(fs):
            acc += prod[..., lx]
    return acc


@dataclass(frozen=True)
class Patches:
    """A shard's border and exception rows and columns, from the uniform
    operator, on the shard's device."""

    blocks: torch.Tensor  # (NB, fs, fs) float32, build_uniform's blocks_all
    start_x: torch.Tensor  # (dst_w,) window starts of every column
    rows: torch.Tensor  # (k,) canvas rows to patch
    sy_rows: torch.Tensor  # (k,) their band-local window starts
    bid_rows: torch.Tensor  # (k, dst_w)
    cols: torch.Tensor  # (C,) columns to patch
    sx_cols: torch.Tensor  # (C,) their window starts
    sy_all: torch.Tensor  # (r1 - r0,) band-local window starts of every row
    bid_cols: torch.Tensor  # (r1 - r0, C)

    def apply(self, band: torch.Tensor, canvas: torch.Tensor) -> None:
        """Overwrite the patched rows, then columns, of ``canvas`` in place."""
        if self.rows.shape[0]:
            canvas[:, self.rows] = patch_values(
                band, self.sy_rows, self.start_x, self.bid_rows, self.blocks
            )
        if self.cols.shape[0]:
            canvas[:, :, self.cols] = patch_values(
                band, self.sy_all, self.sx_cols, self.bid_cols, self.blocks
            )


def _long(a, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int64)).to(device)


def make_patches(
    op: PlaneOperator,
    uniform: tuple[np.ndarray, torch.Tensor],
    r0: int,
    r1: int,
    base: int,
    band_h: int,
    rows: list[int],
    cols: np.ndarray,
) -> Patches:
    """Patch tables of the shard that owns rows [r0, r1), whose band starts
    at source row ``base``: ``rows`` (global) and ``cols`` are patched.
    ``uniform`` is (bid, blocks_all on the shard's device)."""
    bid, blocks = uniform
    dev = blocks.device
    fs = op.filter_size
    sy_all = op.start_y[r0:r1].astype(np.int64) - base
    gather_k.check_window_starts(sy_all, band_h, fs, "sharded patch rows")
    gather_k.check_window_starts(op.start_x, op.src_width, fs, "sharded patch columns")
    rows = np.asarray(rows, dtype=np.int64)
    return Patches(
        blocks=blocks,
        start_x=_long(op.start_x, dev),
        rows=_long(rows - r0, dev),
        sy_rows=_long(sy_all[rows - r0], dev),
        bid_rows=_long(bid[rows], dev),
        cols=_long(cols, dev),
        sx_cols=_long(op.start_x[cols], dev),
        sy_all=_long(sy_all, dev),
        bid_cols=_long(bid[r0:r1][:, cols], dev),
    )


@dataclass(frozen=True)
class Shard:
    """Destination rows [r0, r1) of one row shard, computed on its device
    from its band."""

    r0: int
    r1: int
    dst_width: int
    interior: Callable[[torch.Tensor, torch.Tensor], None]  # (band, canvas): fills the canvas
    patches: Patches | None
    tables: object  # the interior's device tables (GatherBand, FusedInterior, SegInterior)

    def __call__(self, band: torch.Tensor) -> torch.Tensor:
        canvas = torch.zeros(
            (band.shape[0], self.r1 - self.r0, self.dst_width), dtype=f32, device=band.device
        )
        self.interior(band, canvas)
        if self.patches is not None:
            self.patches.apply(band, canvas)
        return canvas


def _paste(canvas: torch.Tensor, block: torch.Tensor, row: int, col: int) -> None:
    """``canvas[:, row:, col:] = block``, cut to the canvas rows (``row`` may
    be negative: the block starts above the shard)."""
    a = max(0, -row)
    b = min(block.shape[1], canvas.shape[1] - row)
    if b > a:
        canvas[:, row + a : row + b, col : col + block.shape[2]] = block[:, a:b]


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


@dataclass(frozen=True)
class RemoteShard:
    """Destination rows [r0, r1) of a row shard that another process owns."""

    r0: int
    r1: int
    rank: int


@dataclass(frozen=True)
class LocalShard:
    """Rows of a sharded result that this process holds: ``data`` is
    ``result[index]``, finalized on the shard's device (the twin of a
    ``jax.Array``'s addressable shard)."""

    index: tuple[slice, ...]
    data: torch.Tensor


def _drop_frame_axis(out):
    """The result of a 2-D source from that of its one-frame batch."""
    if isinstance(out, list):
        return [LocalShard(s.index[1:], s.data[0]) for s in out]
    return out[0]


class ShardedApply:
    """A built sharded apply: ``fn(src, out_dtype=..., peak=...,
    float_clamp_min=...)`` maps (H, W) or (F, H, W) sources to the finalized
    (F?, dst_h, dst_w) result on ``mesh.devices[0][0]``; on a mesh that spans
    processes, to the list of this process's ``LocalShard``s.

    With ``data_axis='data'`` the frames split evenly over the mesh's data
    rows, else every frame runs on data row 0. ``info`` records the interior,
    under the JAX package's keys; ``shards[j][d]`` is row shard d of data row
    j (None where the shard owns no destination rows, a ``RemoteShard``
    where another process owns it). ``exchange`` holds the last call's
    cross-process traffic: the bytes this process sent and received and the
    host seconds spent exchanging (under gloo the staging copies wait for
    the card; under NCCL the seconds count only the host's part).
    """

    def __init__(
        self,
        op: PlaneOperator,
        mesh: RowMesh,
        data_axis: str | None,
        ts: int,
        halo: tuple[int, int],
        replicate: bool,
        make_shard: Callable[[int, torch.device, int, int], Shard],
        info: dict,
    ):
        if data_axis not in (None, "data"):
            raise ValueError(f"sharded apply: unknown data axis {data_axis!r}")
        self.op = op
        self.mesh = mesh
        self.ts = ts
        self.halo = halo
        self.replicate = replicate
        self.info = info
        self.exchange = {"bytes_sent": 0, "bytes_received": 0, "seconds": 0.0}
        td = -(-op.dst_height // mesh.n_rows)

        def shard(j, d, dev):
            r0, r1 = d * td, min((d + 1) * td, op.dst_height)
            if r0 >= r1:
                return None
            if not mesh.is_local(j, d):
                return RemoteShard(r0, r1, mesh.ranks[j][d])
            return make_shard(d, dev, r0, r1)

        groups = mesh.devices if data_axis else mesh.devices[:1]
        self.shards = [[shard(j, d, dev) for d, dev in enumerate(row)] for j, row in enumerate(groups)]

    def _part(self, src_f: torch.Tensor, d: int, dev: torch.device) -> torch.Tensor:
        """Shard d's (F, ts, W) source rows on ``dev``, zero rows past the source."""
        ts = self.ts
        a, b = min(d * ts, src_f.shape[1]), min((d + 1) * ts, src_f.shape[1])
        part = src_f[:, a:b].to(dev)
        if b - a < ts:
            part = torch.nn.functional.pad(part, (0, 0, 0, ts - (b - a)))
        return part

    def bands(self, src_f: torch.Tensor, j: int = 0) -> list[torch.Tensor | None]:
        """This process's shards' bands of data row ``j`` from float32
        frames (F, src_h, src_w); None for the other entries. Only this
        process's shards' rows of ``src_f`` are read."""
        mesh = self.mesh
        local = [isinstance(s, Shard) for s in self.shards[j]]
        parts = [
            self._part(src_f, d, dev) if mesh.is_local(j, d) else None
            for d, dev in enumerate(mesh.devices[j])
        ]
        received = {}
        if mesh.spans_ranks and len(set(mesh.ranks[j])) > 1:
            shape = (src_f.shape[0], self.ts, src_f.shape[2])
            if self.replicate:
                parts = self._gather_parts(parts, j, shape)
            else:
                received = self._exchange_halos(parts, j, shape)
        return [
            collect_band(parts, d, *self.halo, self.replicate, received.get(d))
            if local[d]
            else None
            for d in range(mesh.n_rows)
        ]

    @staticmethod
    def _staging(dev: torch.device | None) -> torch.device:
        """Where rows on ``dev`` (None: this process holds none) cross
        processes: gloo sends host tensors, so CUDA rows go through host
        buffers; NCCL sends them from the card."""
        if torch.distributed.get_backend() != "nccl":
            return torch.device("cpu")
        return dev if dev is not None else torch.device("cuda", torch.cuda.current_device())

    def _gather_parts(self, parts, j: int, shape) -> list[torch.Tensor]:
        """Every shard's part of data row ``j``: this process's own, the
        others' from one ``all_gather`` of the processes' stacked parts
        (zero-padded to the largest count)."""
        dist = torch.distributed
        ranks = self.mesh.ranks[j]
        me, world = dist.get_rank(), dist.get_world_size()
        mine = [p for p in parts if p is not None]
        t0 = time.perf_counter()
        send = torch.zeros(
            (max(map(ranks.count, range(world))), *shape),
            dtype=f32,
            device=self._staging(mine[0].device if mine else None),
        )
        for i, p in enumerate(mine):
            send[i] = p
        recv = [torch.empty_like(send) for _ in range(world)]
        dist.all_gather(recv, send)
        out, seen = [], [0] * world
        for d, r in enumerate(ranks):
            out.append(parts[d] if r == me else recv[r][seen[r]])
            seen[r] += 1
        nbytes = _nbytes([send]) * (world - 1)
        self._count(time.perf_counter() - t0, nbytes, nbytes)
        return out

    def _count(self, seconds: float, sent: int, received: int) -> None:
        self.exchange["seconds"] += seconds
        self.exchange["bytes_sent"] += sent
        self.exchange["bytes_received"] += received

    def _exchange_halos(self, parts, j: int, shape) -> dict[int, dict[int, torch.Tensor]]:
        """The halo rows of data row ``j`` that cross processes, by one
        ``batch_isend_irecv``: {d: {i: hop i's rows}} for this process's
        shards d. Every process walks the same (shard, hop) order, and each
        message's tag is its place in it."""
        dist = torch.distributed
        ranks, n, me = self.mesh.ranks[j], self.mesh.n_rows, dist.get_rank()
        F, ts, W = shape
        ops, sent, received = [], [], {}
        tag = 0
        t0 = time.perf_counter()
        for d in range(n):
            if self.shards[j][d] is None:
                continue
            for i, rows in halo_hops(d, ts, *self.halo):
                e = d + i
                if not 0 <= e < n or ranks[e] == ranks[d]:
                    continue
                tag += 1
                if ranks[e] == me:
                    buf = hop_rows(parts[e], i, rows)
                    buf = buf.to(self._staging(buf.device)).contiguous()
                    ops.append(dist.P2POp(dist.isend, buf, ranks[d], tag=tag))
                    sent.append(buf)
                elif ranks[d] == me:
                    dev = self._staging(parts[d].device)
                    buf = torch.empty((F, rows, W), dtype=f32, device=dev)
                    ops.append(dist.P2POp(dist.irecv, buf, ranks[e], tag=tag))
                    received.setdefault(d, {})[i] = buf
        if ops:
            for w in dist.batch_isend_irecv(ops):
                w.wait()
        self._count(
            time.perf_counter() - t0,
            _nbytes(sent),
            _nbytes(b for hops in received.values() for b in hops.values()),
        )
        return received

    def __call__(self, src, out_dtype=f32, peak=None, float_clamp_min=None):
        if src.dim() == 2:
            return _drop_frame_axis(self(src[None], out_dtype, peak, float_clamp_min))
        groups = len(self.shards)
        if src.shape[0] % groups:
            raise ValueError(
                f"sharded apply: {src.shape[0]} frames do not split over {groups} data rows"
            )
        self.exchange = {"bytes_sent": 0, "bytes_received": 0, "seconds": 0.0}
        src_f = source_f32(src, float_clamp_min)
        dev0 = self.mesh.devices[0][0]
        fg = src.shape[0] // groups
        out, local = [], []
        for j, chunk in enumerate(torch.tensor_split(src_f, groups)):
            pairs = [(s, b) for s, b in zip(self.shards[j], self.bands(chunk, j)) if b is not None]
            if self.mesh.spans_ranks:
                local += [
                    LocalShard(
                        (slice(j * fg, (j + 1) * fg), slice(s.r0, s.r1), slice(0, self.op.dst_width)),
                        finalize(s(band), out_dtype, peak),
                    )
                    for s, band in pairs
                ]
                continue
            rows = [finalize(s(band), out_dtype, peak).to(dev0) for s, band in pairs]
            out.append(torch.cat(rows, dim=1))
        return local if self.mesh.spans_ranks else torch.cat(out, dim=0)


# ---------------------------------------------------------------------------
# The interiors.
# ---------------------------------------------------------------------------


def _uniform_on(op: PlaneOperator):
    """(bid, device -> blocks_all on it), the blocks uploaded once per device."""
    blocks_all, bid = build_uniform(op)
    return bid, functools.cache(lambda dev: torch.from_numpy(blocks_all).to(dev))


def _rows_in_source(op: PlaneOperator) -> bool:
    """Every destination row's window ``[start_y, start_y + fs)`` lies in the
    real source rows. The band kernel, the conv-fused and seg interiors and
    the patches read the band without a row clamp, and the band of an uneven
    split ends in zero padding, so they take only such operators; the
    scan-gather clamps to the last source row and takes the rest. The
    builder's windows end at the last source row or start at row 0
    (``geometry.build_axis_geometry``), so this fails only where the filter
    is taller than the source, and then no row is interior either."""
    sy = op.start_y.astype(np.int64)
    return not len(sy) or (int(sy.min()) >= 0 and int(sy.max()) + op.filter_size <= op.src_height)


def _border_cols(op: PlaneOperator, lo: int, hi: int, exceptions=()) -> np.ndarray:
    cols = set(range(0, lo)) | set(range(hi, op.dst_width)) | {int(v) for v in exceptions}
    return np.asarray(sorted(cols), dtype=np.int64)


def make_sharded_apply_gather(
    op: PlaneOperator, mesh: RowMesh, data_axis: str | None = None
) -> tuple[ShardedApply, ShardPlan] | None:
    """Row-sharded apply with the band kernel per shard; None when its
    envelope declines (the caller falls back to the scan-gather).

    Every shard runs ``gather_band`` over all its rows (border rows with
    their classes clipped into the dictionary) into its canvas; border rows
    and columns are patched. The band kernel takes any filter size (its
    window streams through a ring of source rows), so deep-tap aperiodic
    downscales run here; the JAX package's band kernel declines fs**2 >
    1200 and takes the scan-gather there.
    """
    if not gather_k.is_supported(op) or not _rows_in_source(op):
        return None
    n = mesh.n_rows
    plan = plan_row_shard(op, n)
    fs = op.filter_size
    td, ts = plan.dst_rows_per, plan.src_rows_per
    dst_h = op.dst_height
    hu, hd = plan.halo_up, plan.halo_dn
    rows_glob = np.minimum(np.arange(n * td), dst_h - 1)
    sy_glob = op.start_y.astype(np.int64)[rows_glob]
    cy_glob = np.clip(op.cy_idx[rows_glob].astype(np.int64), 0, op.pair_blocks.shape[0] - 1)
    if plan.replicate_src:
        band_h = ts * n
        base = np.zeros(n, dtype=np.int64)
    else:
        band_h = ts + hu + hd
        base = np.arange(n, dtype=np.int64) * ts - hu
    sy_loc = sy_glob.reshape(n, td) - base[:, None]
    if sy_loc.min() < 0 or int((sy_loc + fs).max()) > band_h:
        return None  # the JAX package's rule (padded rows included)
    bid, blocks_on = _uniform_on(op)
    blocks_on_dev = functools.cache(lambda dev: gather_k.padded_blocks(op.pair_blocks, dev))
    cols = _border_cols(op, op.x_lo, op.x_hi)

    def make_shard(d, dev, r0, r1):
        gb = gather_k.make_gather_band(
            op, sy_loc[d, : r1 - r0], cy_glob[r0:r1], band_h, blocks_on_dev(dev)
        )
        rows = [r for r in range(r0, r1) if r < op.y_lo or r >= op.y_hi]
        patches = make_patches(
            op, (bid, blocks_on(dev)), r0, r1, int(base[d]), band_h, rows, cols
        )
        def interior(band, canvas):
            gather_k.gather_band(gb, band, canvas)

        return Shard(r0, r1, op.dst_width, interior, patches, gb)

    info = {
        "interior": "gather",
        "tiles": {"block": gather_k.TILE, "frames_per_thread": gather_k.FRAMES},
        "replicate_src": plan.replicate_src,
        "hops": (plan.hops_up, plan.hops_dn),
    }
    apply_fn = ShardedApply(op, mesh, data_axis, ts, (hu, hd), plan.replicate_src, make_shard, info)
    return apply_fn, plan


def make_sharded_apply_scan(
    op: PlaneOperator, mesh: RowMesh, data_axis: str | None = None
) -> tuple[ShardedApply, ShardPlan]:
    """The scan-gather: ``scan_values`` over each shard's rows, border pixels
    included; taken only where the band kernel declines (no dictionary, no
    interior, a window outside its shard's band, or one past the source
    rows; any filter size is taken by the band kernel)."""
    n = mesh.n_rows
    plan = plan_row_shard(op, n)
    ts = plan.src_rows_per
    bid, blocks_on = _uniform_on(op)

    def make_shard(d, dev, r0, r1):
        base = 0 if plan.replicate_src else d * ts - plan.halo_up
        sy = _long(op.start_y[r0:r1].astype(np.int64) - base, dev)
        sx, bid_d, blocks = _long(op.start_x, dev), _long(bid[r0:r1], dev), blocks_on(dev)

        last_row = op.src_height - 1 - base

        def interior(band, canvas):
            canvas[:] = scan_values(band, sy, sx, bid_d, blocks, last_row)

        return Shard(r0, r1, op.dst_width, interior, None, None)

    info = {
        "interior": "gather-scan",
        "replicate_src": plan.replicate_src,
        "hops": (plan.hops_up, plan.hops_dn),
    }
    halo = (plan.halo_up, plan.halo_dn)
    return ShardedApply(op, mesh, data_axis, ts, halo, plan.replicate_src, make_shard, info), plan


def make_sharded_apply_conv(
    op: PlaneOperator, mesh: RowMesh, data_axis: str | None = None, precision: str = "fp32"
) -> tuple[ShardedApply, ShardPlan] | None:
    """Phase-conv sharded apply; None if the geometry does not qualify.

    Per shard: the segment of its band from the first (possibly straddling)
    phase block it touches, the fused interior on it with the plan shifted so
    that block 0 starts at segment row 0, the block pasted at the shard's
    rows, then border rows and columns and the plan's exception rows and
    columns patched. The guards and halos are the JAX package's.
    """
    pplan = plan_phases(op)
    if pplan is None or not _rows_in_source(op):
        return None
    n = mesh.n_rows
    splan = plan_row_shard(op, n)
    if splan.replicate_src:
        return None
    fs = op.filter_size
    py, px, qy = pplan.y.p, pplan.x.p, pplan.y.q
    nyb, nxb = pplan.y.nblocks, pplan.x.nblocks
    spread_y = int(pplan.y.offsets.max())
    base_y = pplan.y.base
    ylo, xlo = pplan.y.lo, pplan.x.lo
    yhi, xhi = ylo + py * nyb, xlo + px * nxb
    td, ts = splan.dst_rows_per, splan.src_rows_per
    # Device 0 owns the whole top border; the interior is tall enough for
    # the straddling block.
    if td < max(ylo, py, fs) or nyb < 3:
        return None
    # Halo margin so that the straddling block's window start is in the band.
    hu = splan.halo_up + spread_y + qy
    hd = splan.halo_dn + spread_y + qy
    if hu > ts or hd > ts:
        return None
    nyb_l = td // py + 2  # blocks per shard (covers the straddlers)
    seg_h = qy * (nyb_l - 1) + spread_y + fs
    y = pplan.y
    y_local = AxisPhasePlan(
        lo=0,
        hi=py * nyb_l,
        p=y.p,
        q=y.q,
        anchor_start=y.anchor_start - y.base,
        anchor_cls=y.anchor_cls,
        exceptions=np.zeros(0, dtype=np.int64),
        nblocks=nyb_l,
    )
    plan_local = PhasePlan(x=pplan.x, y=y_local)
    if not fused_k.is_supported(op, plan_local):
        return None
    tables_on = functools.cache(
        lambda dev: fused_k.make_fused_interior(op, plan_local, dev, precision)
    )
    bid, blocks_on = _uniform_on(op)
    exc_y = {int(v) for v in pplan.y.exceptions}
    cols = _border_cols(op, xlo, xhi, pplan.x.exceptions)

    def make_shard(d, dev, r0, r1):
        bi0 = max(0, (r0 - ylo) // py)
        band_start = d * ts - hu
        seg_off = base_y + qy * bi0 - band_start
        if seg_off < 0:
            raise ValueError(f"make_sharded_apply_conv: shard {d} segment starts above its band")
        fi = tables_on(dev)

        def interior(band, canvas):
            seg = band[:, seg_off : seg_off + seg_h].contiguous()
            _paste(canvas, fused_k.fused_interior(fi, seg), ylo + py * bi0 - r0, xlo)

        rows = [r for r in range(r0, r1) if r < ylo or r >= yhi or r in exc_y]
        patches = make_patches(
            op, (bid, blocks_on(dev)), r0, r1, band_start, ts + hu + hd, rows, cols
        )
        return Shard(r0, r1, op.dst_width, interior, patches, fi)

    info = {
        "interior": "conv-fused",
        "precision": precision,
        "replicate_src": False,
        "hops": (1 if hu > 0 else 0, 1 if hd > 0 else 0),
    }
    return ShardedApply(op, mesh, data_axis, ts, (hu, hd), False, make_shard, info), splan


def make_sharded_apply_seg(
    op: PlaneOperator, mesh: RowMesh, data_axis: str | None = None, precision: str = "fp32"
) -> tuple[ShardedApply, ShardPlan] | None:
    """Row-sharded apply with the segment-periodic kernel per shard.

    Each shard runs ``seg_interior`` over the plan's blocks that hold its
    interior rows, with a band-local plan (the blocks' ``roff``/``cls``,
    ``base`` relative to the band start) and the band as the source; border
    and exception rows and columns are patched. Returns None when the
    geometry has no segment-periodic plan, a shard's plan is outside the
    kernel's envelope, or a halo exceeds one neighbour's rows (the caller
    falls through to the gather paths).
    """
    plan = plan_phases_seg(op)
    if plan is None or not seg_k.is_supported(op, plan) or not _rows_in_source(op):
        return None
    n = mesh.n_rows
    fs = op.filter_size
    y = plan.y
    py, qy = y.p, y.q
    ylo, yhi = y.lo, y.hi
    xlo, xhi = plan.x.lo, plan.x.hi
    dst_h, src_h = op.dst_height, op.src_height
    td, ts = -(-dst_h // n), -(-src_h // n)
    sy_plan = y.base + qy * (np.arange(yhi - ylo) // py) + y.roff.astype(np.int64)

    # Blocks of each shard, and the halos that its interior and patch
    # windows reach.
    shard_blocks, halo_up, halo_dn = {}, 0, 0
    for d in range(n):
        r0, r1 = d * td, min((d + 1) * td, dst_h)
        if r0 >= r1:
            continue
        lo = int(op.start_y[r0:r1].min())
        hi = int(op.start_y[r0:r1].max()) + fs
        i0, i1 = max(r0, ylo), min(r1, yhi)
        if i0 < i1:
            b0, b1 = (i0 - ylo) // py, -(-(i1 - ylo) // py)
            shard_blocks[d] = (b0, b1)
            lo = min(lo, int(sy_plan[py * b0 : py * b1].min()))
            hi = max(hi, int(sy_plan[py * b0 : py * b1].max()) + fs)
        halo_up = max(halo_up, d * ts - lo)
        halo_dn = max(halo_dn, hi - (d + 1) * ts)
    hu, hd = max(halo_up, 0), max(halo_dn, 0)
    if hu > ts or hd > ts:
        return None
    band_h = hu + ts + hd
    op_band = dataclasses.replace(op, src_height=band_h)  # the band is the local plan's source

    def local_plan(d):
        b0, b1 = shard_blocks[d]
        return SegPhasePlan(
            x=plan.x,
            y=SegAxisPlan(
                lo=0,
                hi=py * (b1 - b0),
                p=py,
                q=qy,
                nblocks=b1 - b0,
                base=y.base + qy * b0 - (d * ts - hu),
                roff=y.roff[py * b0 : py * b1],
                cls=y.cls[py * b0 : py * b1],
                exceptions=np.zeros(0, dtype=np.int64),
            ),
        )

    if not all(seg_k.is_supported(op_band, local_plan(d)) for d in shard_blocks):
        return None
    bid, blocks_on = _uniform_on(op)
    exc_y = {int(v) for v in y.exceptions}
    cols = _border_cols(op, xlo, xhi, plan.x.exceptions)

    def make_shard(d, dev, r0, r1):
        si = None
        if d in shard_blocks:
            si = seg_k.make_seg_interior(op_band, local_plan(d), dev, precision)
        row0 = ylo + py * shard_blocks.get(d, (0, 0))[0] - r0

        def interior(band, canvas):
            if si is not None:
                _paste(canvas, seg_k.seg_interior(si, band), row0, xlo)

        rows = [r for r in range(r0, r1) if r < ylo or r >= yhi or r in exc_y]
        patches = make_patches(
            op, (bid, blocks_on(dev)), r0, r1, d * ts - hu, band_h, rows, cols
        )
        return Shard(r0, r1, op.dst_width, interior, patches, si)

    info = {
        "interior": "seg",
        "precision": precision,
        "tiles": {"block": (seg_k.TILE_X, seg_k.TILE_Y)},
        "replicate_src": False,
        "hops": (1 if hu > 0 else 0, 1 if hd > 0 else 0),
    }
    splan = plan_row_shard(op, n)
    return ShardedApply(op, mesh, data_axis, ts, (hu, hd), False, make_shard, info), splan


def make_sharded_apply(
    op: PlaneOperator,
    mesh: RowMesh,
    data_axis: str | None = None,
    impl: str = "auto",
    precision: str = "fp32",
) -> tuple[ShardedApply, ShardPlan]:
    """Build the sharded apply of ``op`` over ``mesh``: (apply_fn, plan).

    ``impl='auto'`` tries the interiors conv -> seg -> gather -> the
    scan-gather; ``'conv'`` and ``'seg'`` run theirs or raise; ``'gather'``
    runs the band kernel, or the scan-gather where its envelope declines, as
    in the JAX package. ``precision`` is the fused and seg interiors'
    (``'fp32'`` or ``'fp32_u8src'``, the same exact kernels, or ``'bf16'``,
    the kernels on bfloat16-rounded operands, reported in
    ``info['precision']``); the gather interiors and every patch are fp32.
    ``apply_fn.info['interior']`` records which interior was built.
    """
    if impl not in ("auto", "conv", "seg", "gather"):
        raise ValueError(f"make_sharded_apply: unknown impl {impl!r}")
    if impl in ("auto", "conv"):
        r = make_sharded_apply_conv(op, mesh, data_axis, precision)
        if r is not None:
            return r
        if impl == "conv":
            raise ValueError("sharded conv path: geometry not eligible")
    if impl in ("auto", "seg"):
        r = make_sharded_apply_seg(op, mesh, data_axis, precision)
        if r is not None:
            return r
        if impl == "seg":
            raise ValueError("sharded seg path: geometry not eligible")
    r = make_sharded_apply_gather(op, mesh, data_axis)
    if r is not None:
        return r
    return make_sharded_apply_scan(op, mesh, data_axis)


class ShardedApplier:
    """Mesh applier, interface-compatible with ``ConvApplier`` and
    ``GatherApplier``, so that ``JincResizer`` routes planes through a mesh
    (``impl='sharded'`` or ``mesh=``): call with (H, W) or (F, H, W)
    sources and the output dtype, peak and clamp. Frame batches split over
    the mesh's data rows, padded with copies of the last frame up to a
    multiple of their number; rows split over its row shards.

    ``interior`` reports the interior built ('conv-fused', 'seg', 'gather'
    or 'gather-scan').
    """

    def __init__(
        self, op: PlaneOperator, mesh: RowMesh, precision: str = "fp32", impl: str = "auto"
    ):
        self.op = op
        self.mesh = mesh
        self._fn, self.plan = make_sharded_apply(
            op, mesh, data_axis="data", impl=impl, precision=precision
        )
        self.info = dict(self._fn.info)
        self.interior = self.info["interior"]
        self.effective_precision = self.info.get("precision", "fp32")

    def __call__(self, src, out_dtype=f32, peak=None, float_clamp_min=None):
        """The (F?, dst_h, dst_w) result; on a mesh that spans processes,
        this process's ``LocalShard``s of it (the padded frames cut)."""
        if src.dim() == 2:
            return _drop_frame_axis(self(src[None], out_dtype, peak, float_clamp_min))
        F = src.shape[0]
        pad = -F % self.mesh.n_data
        if pad:
            src = torch.cat([src, src[-1:].expand(pad, *src.shape[1:])])
        out = self._fn(src, out_dtype, peak, float_clamp_min)
        if not isinstance(out, list):
            return out[:F]
        cut = []
        for s in out:
            f0, f1 = s.index[0].start, min(s.index[0].stop, F)
            if f1 > f0:
                cut.append(LocalShard((slice(f0, f1), *s.index[1:]), s.data[: f1 - f0]))
        return cut
