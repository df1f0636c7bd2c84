"""Border strips of the gather and fused-seg engines: hand-written CUDA kernel
and plain form.

Every border pixel of a plane has its own (fs, fs) block of weights (the
operator's ``strips``), applied to the fs x fs window of the source at its
window starts:

    out[f, y, x] = sum_{ly, lx < fs} blocks[y - y0, x - x0, ly, lx]
                                     * src[f, start_y[y] + ly, start_x[x] + lx]

``make_band_strips`` builds a plane's spec once, at applier construction:
the strip pixels grouped by their window start ``(start_y, start_x)``, at
most ``GROUP_MEMBERS`` a group, beside the blocks, which stay where
``apply_xla.to_device`` put them. Along a clamped axis the pixels share a
window: a top or bottom strip's column shares ``start_y``, a left or right
strip's row ``start_x`` wherever the clamp holds it. The groups come from
the starts alone, so an unclamped or odd pixel is a group of its own.
``band_strips`` then computes every strip of the plane for all frames: one
launch of ``csrc/band_strips.cu`` on a CUDA tensor, ``band_strips_plain`` on
a CPU one.

The kernel replaces no TPU kernel: the JAX package computes these strips
with XLA ops (its ``apply_strips_fast``), which the port ran as about 27
torch ops a plane, casting the static blocks to float64 every call. What
bounds the kernel is the blocks' bytes, read once a call (2.28 GB for the
luma plane of 3840x2160 -> 1366x768 tap 16, 0.68 ms at 3.35 TB/s); its
float64 multiply-adds are a twentieth of that time. So a block of the
kernel stages one group's window in shared memory once, as float64, and
streams each member's contiguous block once for up to 8 frames, in 16-byte
loads with neighbouring threads on neighbouring addresses.

Both forms take each product of two float32 values exactly in float64, sum
in float64 and round once to float32; they sum in different orders, so they
agree within one float32 ulp.

``GROUP_MEMBERS`` is 16: at tap 16 a clamped row or column of a strip has 16
pixels (the strips are 16 deep at every tap-16 downscale the benchmark
runs), and the kernel's 8 warps take two members each.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import metrics
from ..apply_xla import DevicePlaneOperator
from ..operator import PlaneOperator
from . import _build
from .fused import MAX_SMEM_BYTES
from .gather import check_window_starts

GROUP_MEMBERS = 16  # = the kernel's kWarps * kSlots
MAX_STRIPS = 4  # the kernel's kMaxStrips: top, bottom, left, right
PASS_FRAMES = (1, 2, 4, 8)  # the kernel's instances: frames a pass
PLAIN_CHUNK = 1 << 19  # float64 block elements a product of the plain form takes: cache-sized


@dataclass(frozen=True)
class BandStrips:
    """A plane's strip pixels grouped by window start, and their blocks.

    Members ``members[m0:m1]`` of group ``(start_y, start_x, m0, m1)`` share
    its window. A member is ``(strip, block, out, 0)``: pixel ``block`` of
    strip ``strip`` in row-major order, so its destination is ``(y0 + block
    // nx, x0 + block % nx)`` of that strip's rect and its weights start at
    float ``block * fs**2`` of ``blocks[strip]``; ``out`` is its column of
    the (F, ``n_out``) output, the strips' pixels one after another."""

    groups: torch.Tensor  # (n_groups, 4) int32
    members: torch.Tensor  # (n_pixels, 4) int32
    blocks: tuple[torch.Tensor, ...]  # each strip's (ny, nx, fs, fs) float32, shared with the dop
    rects: tuple[tuple[int, int, int, int], ...]  # each strip's (y0, y1, x0, x1)
    src_height: int
    src_width: int
    fs: int

    @property
    def n_out(self) -> int:
        return int(self.members.shape[0])


def make_band_strips(op: PlaneOperator, dop: DevicePlaneOperator) -> BandStrips:
    """The spec of ``op``'s strips on ``dop``'s device (``dop`` =
    ``to_device(op)``, whose strip blocks it shares). Raises ValueError when
    the source is smaller than the filter or a window leaves the source."""
    fs, H, W = op.filter_size, op.src_height, op.src_width
    if H < fs or W < fs:
        raise ValueError(
            f"make_band_strips: source {W}x{H} smaller than filter_size {fs} -- "
            f"window slices would be out of bounds"
        )
    if len(op.strips) > MAX_STRIPS:
        raise ValueError(f"make_band_strips: {len(op.strips)} strips, at most {MAX_STRIPS}")
    strip, block, sy, sx = [], [], [], []
    for i, s in enumerate(op.strips):
        ys, xs = np.meshgrid(np.arange(s.y0, s.y1), np.arange(s.x0, s.x1), indexing="ij")
        strip.append(np.full(ys.size, i, dtype=np.int64))
        block.append(np.arange(ys.size, dtype=np.int64))
        sy.append(np.asarray(op.start_y, dtype=np.int64)[ys.ravel()])
        sx.append(np.asarray(op.start_x, dtype=np.int64)[xs.ravel()])
    strip, block, sy, sx = (np.concatenate(a) if a else np.zeros(0, np.int64)
                            for a in (strip, block, sy, sx))  # fmt: skip
    check_window_starts(sy, H, fs, "make_band_strips (rows)")
    check_window_starts(sx, W, fs, "make_band_strips (columns)")
    out = block + np.cumsum([0] + [s.npixels for s in op.strips])[strip]
    order = np.lexsort((block, strip, sx, sy))  # by window start, then strip and pixel
    strip, block, sy, sx, out = strip[order], block[order], sy[order], sx[order], out[order]
    # A run of one window start, cut into groups of at most GROUP_MEMBERS.
    new = np.ones(sy.size, dtype=bool)
    new[1:] = (sy[1:] != sy[:-1]) | (sx[1:] != sx[:-1])
    run_start = np.maximum.accumulate(np.where(new, np.arange(sy.size), 0))
    new |= (np.arange(sy.size) - run_start) % GROUP_MEMBERS == 0
    m0 = np.flatnonzero(new)
    m1 = np.append(m0[1:], sy.size)
    groups = np.stack([sy[m0], sx[m0], m0, m1], axis=1).astype(np.int32).reshape(-1, 4)
    members = np.stack([strip, block, out, np.zeros_like(out)], axis=1).astype(np.int32)
    device = dop.start_x.device
    return BandStrips(
        groups=torch.from_numpy(groups).to(device),
        members=torch.from_numpy(members.reshape(-1, 4)).to(device),
        blocks=tuple(s.blocks for s in dop.strips),
        rects=tuple((s.y0, s.y1, s.x0, s.x1) for s in op.strips),
        src_height=H,
        src_width=W,
        fs=fs,
    )


def pixels(spec: BandStrips) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(strip, y, x) int64 of every member, in the members' order."""
    m = spec.members.cpu().numpy().astype(np.int64)
    rects = np.asarray(spec.rects, dtype=np.int64).reshape(-1, 4)[m[:, 0]]
    nx = rects[:, 3] - rects[:, 2]
    return m[:, 0], rects[:, 0] + m[:, 1] // nx, rects[:, 2] + m[:, 1] % nx


def pass_layout(fs: int, F: int) -> tuple[int, int, int]:
    """(frames a pass, tap rows a stage, shared bytes) of a launch: the
    fewest of ``PASS_FRAMES`` that hold min(F, 8) frames, and the fewest
    bands of equal rows whose float64 stage of those frames fits the shared
    memory."""
    frames = next(n for n in PASS_FRAMES if n >= min(F, PASS_FRAMES[-1]))
    for bands in range(1, fs + 1):
        rows = -(-fs // bands)
        nbytes = smem_bytes(fs, rows, frames)
        if nbytes <= MAX_SMEM_BYTES:
            return frames, rows, nbytes
    raise ValueError(f"band_strips: no stage of {frames} frames at fs {fs} fits the shared memory")


def smem_bytes(fs: int, rows: int, frames: int) -> int:
    """The kernel's stage: ``frames`` x 4 residues x (ceil(rows * fs / 4) + 2)
    doubles."""
    return frames * 4 * ((rows * fs + 3) // 4 + 2) * 8


def _views(spec: BandStrips, out: torch.Tensor) -> dict:
    """{rect: (F, ny, nx) view of ``out``} in the members' ``out`` order."""
    views, at = {}, 0
    for y0, y1, x0, x1 in spec.rects:
        n = (y1 - y0) * (x1 - x0)
        views[(y0, y1, x0, x1)] = out[:, at : at + n].view(-1, y1 - y0, x1 - x0)
        at += n
    return views


def band_strips_plain(spec: BandStrips, src_f: torch.Tensor) -> dict:
    """Plain PyTorch form on any device: each group's window gathered once,
    its members' blocks against it in one float64 product, rounded once to
    float32. Returns ``band_strips``'s dict."""
    F, fs = src_f.shape[0], spec.fs
    dev = src_f.device
    out = torch.empty((F, spec.n_out), dtype=torch.float32, device=dev)
    groups, members = spec.groups.to(dev).long(), spec.members.to(dev).long()
    sizes = groups[:, 3] - groups[:, 2]
    owner = torch.repeat_interleave(torch.arange(groups.shape[0], device=dev), sizes)
    strip = members[groups[:, 2], 0]  # a group's first member's strip
    mixed = torch.zeros_like(sizes).index_add_(0, owner, (members[:, 0] != strip[owner]).long())
    strip[mixed > 0] = MAX_STRIPS  # members from several strips
    flat = [b.to(dev).reshape(-1, fs * fs) for b in spec.blocks]
    taps = torch.arange(fs, device=dev)
    src64 = src_f.double()
    # Groups of one size and one strip: one batched product, blocks picked
    # by index_select.
    for size, si in torch.stack([sizes, strip], 1).unique(dim=0).tolist():
        step = max(1, PLAIN_CHUNK // (size * fs * fs))
        for part in torch.nonzero((sizes == size) & (strip == si))[:, 0].split(step):
            g = groups[part]
            mem = members[g[:, 2, None] + torch.arange(size, device=dev)]  # (n, size, 4)
            if si < MAX_STRIPS:
                w = flat[si].index_select(0, mem[..., 1].flatten()).double().view(*mem.shape[:2], -1)
            else:
                w = torch.empty((*mem.shape[:2], fs * fs), dtype=torch.float64, device=dev)
                for i, blocks in enumerate(flat):
                    at = mem[..., 0] == i
                    w[at] = blocks[mem[..., 1][at]].double()
            rows = (g[:, 0, None] + taps)[:, :, None]
            cols = (g[:, 1, None] + taps)[:, None, :]
            win = src64[:, rows, cols].reshape(F, -1, fs * fs).permute(1, 2, 0)  # (n, fs*fs, F)
            out[:, mem[..., 2]] = torch.bmm(w, win).permute(2, 0, 1).float()
    return _views(spec, out)


def band_strips(spec: BandStrips, src_f: torch.Tensor) -> dict:
    """{(y0, y1, x0, x1): (F, ny, nx) float32} of every strip of the spec's
    plane, from ``src_f`` (F, H, W) float32 contiguous.

    On a CPU tensor this is ``band_strips_plain``. On a CUDA tensor it
    launches ``csrc/band_strips.cu`` (counted in ``band_strips.launches`` and
    in the counter ``strips_band_launches``, after the launch) or raises; it
    never falls back."""
    if src_f.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"band_strips: unsupported device {src_f.device}")
    if src_f.dtype != torch.float32 or src_f.dim() != 3 or not src_f.is_contiguous():
        raise ValueError("band_strips: src must be a contiguous (F, H, W) float32 tensor")
    F, H, W = src_f.shape
    if (H, W) != (spec.src_height, spec.src_width):
        raise ValueError(
            f"band_strips: a {W}x{H} source for a spec of {spec.src_width}x{spec.src_height}"
        )
    if src_f.device.type == "cpu":
        return band_strips_plain(spec, src_f)
    if not all(t.device == src_f.device for t in (spec.groups, spec.members, *spec.blocks)):
        raise ValueError("band_strips: spec and source on different devices")
    out = torch.empty((F, spec.n_out), dtype=torch.float32, device=src_f.device)
    if F == 0 or spec.n_out == 0:
        return _views(spec, out)
    if any(b.data_ptr() % 16 for b in spec.blocks):
        raise ValueError("band_strips: strip blocks must be 16-byte aligned")
    frames, rows, _ = pass_layout(spec.fs, F)
    pad = MAX_STRIPS - len(spec.blocks)
    ptrs = [b.data_ptr() for b in spec.blocks] + [None] * pad
    counts = [b.shape[0] * b.shape[1] for b in spec.blocks] + [0] * pad
    with torch.cuda.device(src_f.device):
        rc = _build.library().jt_band_strips(
            src_f.data_ptr(), spec.groups.data_ptr(), spec.members.data_ptr(), out.data_ptr(),
            *ptrs, *counts, F, H, W, spec.fs, spec.groups.shape[0], spec.n_out, frames, rows,
            _build.stream_of(src_f),
        )  # fmt: skip
    _build.check(rc, "jt_band_strips")
    band_strips.launches += 1
    metrics.count("strips_band_launches")
    return _views(spec, out)


band_strips.launches = 0
