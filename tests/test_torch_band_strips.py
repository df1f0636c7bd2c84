"""The border strips of the gather and fused-seg engines
(``kernels/band_strips.py``) on the CPU.

The plain form is held to the per-pixel strips of ``apply_strips_fast``
(``_strip_values``, float32 sums) within 2e-6 absolute on fp32 sources in
[0, 1), and to a numpy float64 sum of block x window within one float32 ulp
of each value (it rounds a float64 sum once). The planes: the drifted 1.5x
tap-8 plane of ``tests/test_torch_seg.py`` and the CPU stand-in of the
benchmark's gather deployment (3840x2160 -> 1366x768 tap 16 cut to 384x216
-> 137x77: fs 92 on luma, 93 on chroma). The CUDA kernel runs only on the
card (``chip_smoke.py`` holds it to the plain form); here a NumPy emulation
of its staging and streaming index arithmetic (bands, passes, the residue
split, the alignment of each block) is held to the plain form, with every
unstaged entry NaN.
"""

import copy

import numpy as np
import pytest
import torch

from jincresize_tpu_torch import metrics
from jincresize_tpu_torch.api import JincConfig, JincResizer
from jincresize_tpu_torch.apply_conv_seg import SegConvApplier
from jincresize_tpu_torch.apply_gather import GatherApplier
from jincresize_tpu_torch.apply_strips_fast import _strip_values
from jincresize_tpu_torch.apply_xla import to_device
from jincresize_tpu_torch.clip import yuv420p
from jincresize_tpu_torch.kernels import _build
from jincresize_tpu_torch.kernels import band_strips as band_k
from jincresize_tpu_torch.kernels.fused import MAX_SMEM_BYTES
from jincresize_tpu_torch.operator import build_plane_operator, radius_for_tap


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
PLANES = ("seg-1.5x-tap8", "gather-luma", "gather-chroma")


@pytest.fixture(scope="module")
def planes():
    """{name: (host operator, device operator on the CPU)}."""
    seg_op = build_plane_operator(640, 360, 960, 540, radius_for_tap(8))
    cfg = JincConfig(target_width=137, target_height=77, tap=16, impl="gather",
                     operator_cache=False)  # fmt: skip
    r = JincResizer(yuv420p(8), 384, 216, cfg, device="cpu")
    assert r.engines == {"luma": "gather", "chroma": "gather"}
    out = {"seg-1.5x-tap8": (seg_op, to_device(seg_op, "cpu"))}
    for name, app in (("gather-luma", r._applier_luma), ("gather-chroma", r._applier_chroma)):
        out[name] = (app.op, app._dop)
    assert out["gather-luma"][0].filter_size == 92 and out["gather-chroma"][0].filter_size == 93
    return out


def _src(op, frames, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.random((frames, op.src_height, op.src_width), dtype=np.float32))


@pytest.mark.parametrize("frames", [1, 3])
@pytest.mark.parametrize("name", PLANES)
def test_plain_form_equals_strip_values(name, frames, planes):
    """Every strip: the plain form equals the float32 per-pixel strips; the
    seg plane has both the constant-row strips (top, bottom) and rows of
    their own starts (left, right)."""
    op, dop = planes[name]
    spec = band_k.make_band_strips(op, dop)
    src = _src(op, frames, seed=30 + frames)
    got = band_k.band_strips(spec, src)
    assert list(got) == [(s.y0, s.y1, s.x0, s.x1) for s in dop.strips]
    const_rows = set()
    for s in dop.strips:
        want = _strip_values(dop, src, s)
        vals = got[(s.y0, s.y1, s.x0, s.x1)]
        assert vals.shape == want.shape == (frames, s.y1 - s.y0, s.x1 - s.x0)
        assert float((vals - want).abs().max()) <= F32_TOL
        const_rows.add(bool((op.start_y[s.y0 : s.y1] == op.start_y[s.y0]).all()))
    assert const_rows == {True, False}


def _float64_strips(op, src):
    """{rect: (F, ny, nx) float64}: each pixel's block times its window, a
    numpy float64 sum."""
    fs, taps = op.filter_size, np.arange(op.filter_size)
    x = src.numpy().astype(np.float64)
    out = {}
    for s in op.strips:
        rows = op.start_y[s.y0 : s.y1][:, None] + taps  # (ny, fs)
        cols = op.start_x[s.x0 : s.x1][:, None] + taps  # (nx, fs)
        win = x[:, rows[:, None, :, None], cols[None, :, None, :]]  # (F, ny, nx, fs, fs)
        out[(s.y0, s.y1, s.x0, s.x1)] = np.einsum("fyxkl,yxkl->fyx", win,
                                                  s.blocks.astype(np.float64))  # fmt: skip
        assert win.shape[-2:] == (fs, fs)
    return out


@pytest.mark.parametrize("name", PLANES)
def test_plain_form_within_an_ulp_of_float64_sums(name, planes):
    op, dop = planes[name]
    src = _src(op, 1, seed=41)
    got = band_k.band_strips(band_k.make_band_strips(op, dop), src)
    for rect, want in _float64_strips(op, src).items():
        ulp = np.spacing(np.abs(want).astype(np.float32))
        assert (np.abs(got[rect].numpy().astype(np.float64) - want) <= ulp).all(), rect


@pytest.mark.parametrize("name", PLANES)
def test_groups_cover_every_strip_pixel_once(name, planes):
    """Each strip pixel is one member; a group's members share its window
    start, which lies inside the source; no group passes GROUP_MEMBERS; the
    output columns are the strips' pixels one after another."""
    op, dop = planes[name]
    spec = band_k.make_band_strips(op, dop)
    groups = spec.groups.numpy()
    strip, ys, xs = band_k.pixels(spec)
    want = sorted((i, y, x) for i, s in enumerate(op.strips)
                  for y in range(s.y0, s.y1) for x in range(s.x0, s.x1))  # fmt: skip
    assert sorted(zip(strip.tolist(), ys.tolist(), xs.tolist(), strict=True)) == want
    sizes = groups[:, 3] - groups[:, 2]
    assert (groups[1:, 2] == groups[:-1, 3]).all() and groups[0, 2] == 0
    assert groups[-1, 3] == spec.n_out and (sizes >= 1).all()
    assert sizes.max() <= band_k.GROUP_MEMBERS
    owner = np.repeat(np.arange(len(groups)), sizes)
    assert (op.start_y[ys] == groups[owner, 0]).all() and (op.start_x[xs] == groups[owner, 1]).all()
    assert groups[:, :2].min() >= 0 and groups[:, 0].max() + op.filter_size <= op.src_height
    assert groups[:, 1].max() + op.filter_size <= op.src_width
    first = np.cumsum([0] + [s.npixels for s in op.strips])
    m = spec.members.numpy()
    assert sorted(m[:, 2].tolist()) == list(range(spec.n_out))
    assert (m[:, 2] == first[m[:, 0]] + m[:, 1]).all() and (m[:, 3] == 0).all()
    # At tap 16 every group but the corners' is a whole clamped row or column
    # of a strip: 16 pixels.
    if name.startswith("gather"):
        assert np.median(sizes) == band_k.GROUP_MEMBERS
    # The blocks are the device operator's own tensors: no copy is held.
    assert all(a is b.blocks for a, b in zip(spec.blocks, dop.strips, strict=True))


def test_wrapper_raises_off_cpu_and_cuda_and_counts_nothing_on_the_cpu(planes):
    op, dop = planes["seg-1.5x-tap8"]
    spec = band_k.make_band_strips(op, dop)
    with pytest.raises(RuntimeError, match="unsupported device"):
        band_k.band_strips(spec, torch.empty((1, op.src_height, op.src_width), device="meta"))
    with pytest.raises(ValueError, match="float32"):
        band_k.band_strips(spec, _src(op, 1, seed=5).double())
    with pytest.raises(ValueError, match="source"):
        band_k.band_strips(spec, _src(op, 1, seed=5)[:, 1:])
    before, launches = metrics.counters()["strips_band_launches"], band_k.band_strips.launches
    band_k.band_strips(spec, _src(op, 2, seed=5))
    assert metrics.counters()["strips_band_launches"] == before
    assert band_k.band_strips.launches == launches


def test_make_band_strips_refuses_a_source_below_the_filter():
    tiny = build_plane_operator(6, 6, 12, 12, radius_for_tap(8))
    with pytest.raises(ValueError, match="smaller than filter_size"):
        band_k.make_band_strips(tiny, to_device(tiny, "cpu"))


def test_kernel_is_bound_with_the_wrappers_arguments():
    """Eight pointers (source, groups, members, output, four strips' blocks),
    twelve sizes (four strips' blocks, F, H, W, fs, the groups, the output's
    columns, the frames a pass, the rows a stage) and the stream."""
    P, I = _build._P, _build._I
    assert _build._SIGNATURES["jt_band_strips"] == [P] * 8 + [I] * 12 + [P]


@pytest.mark.parametrize("fs", [3, 7, 17, 44, 92, 93, 150, 300])
def test_pass_layout_fits_the_shared_memory(fs):
    """A pass holds min(F, 8) frames in the fewest instance frames; its bands
    of equal rows cover the window and fit the shared memory; at one frame
    up to fs 93 the whole window is one band."""
    for F in range(1, 18):
        frames, rows, nbytes = band_k.pass_layout(fs, F)
        assert frames in band_k.PASS_FRAMES and frames >= min(F, 8)
        assert frames // 2 < min(F, 8) or frames == 1
        assert 1 <= rows <= fs and nbytes == band_k.smem_bytes(fs, rows, frames)
        assert nbytes <= MAX_SMEM_BYTES
        bands = -(-fs // rows)
        assert rows == -(-fs // bands)  # equal bands: one more would not be needed
        if bands > 1:
            assert band_k.smem_bytes(fs, -(-fs // (bands - 1)), frames) > MAX_SMEM_BYTES
    assert band_k.pass_layout(92, 1)[1] == 92 and band_k.pass_layout(93, 1)[1] == 93


def emulate_kernel(spec, src, frames, band_rows):
    """``csrc/band_strips.cu`` in NumPy: each group's window staged a band of
    tap rows at a time, split by tap index mod 4 with its zero pads, NaN
    wherever the kernel writes nothing; each member's band read as the
    float4 chunks its lanes load (past the strip's last float: zeros), each
    element met with the staged tap the kernel reads; float64 sums, one
    rounding. Returns the (F, n_out) output."""
    fs, n = spec.fs, spec.fs * spec.fs
    x = src.numpy().astype(np.float64)
    F = x.shape[0]
    qp = (band_rows * fs + 3) // 4 + 2
    flat = [b.numpy().reshape(-1) for b in spec.blocks]
    members = spec.members.numpy().astype(np.int64)
    out = np.full((F, spec.n_out), np.nan, dtype=np.float32)
    for sy, sx, m0, m1 in spec.groups.numpy().astype(np.int64):
        for f0 in range(0, F, frames):
            acc = np.zeros((m1 - m0, frames))
            for k0 in range(0, fs, band_rows):
                rows = min(band_rows, fs - k0)
                nb = rows * fs
                win = np.full((frames, 4, qp), np.nan)
                p = np.arange(nb)
                for f in range(frames):
                    vals = (x[f0 + f, sy + k0 : sy + k0 + rows, sx : sx + fs].ravel()
                            if f0 + f < F else np.zeros(nb))  # fmt: skip
                    win[f, p & 3, (p >> 2) + 1] = vals
                win[:, :, 0] = 0.0
                pad = nb + np.arange(3)
                win[:, pad & 3, (pad >> 2) + 1] = 0.0
                for i, (strip, block, _, _) in enumerate(members[m0:m1]):
                    o = block * n + k0 * fs
                    a0 = o & ~3
                    s = o - a0
                    c = np.arange((s + nb + 3) >> 2)
                    at = a0 + 4 * c[:, None] + np.arange(4)
                    total = flat[strip].size
                    e = np.where(at < total, flat[strip][np.minimum(at, total - 1)], 0.0)
                    for j in range(4):
                        w = win[:, (j - s) & 3, c + ((j - s) >> 2) + 1]  # (frames, chunks)
                        acc[i] += w @ e[:, j].astype(np.float64)
            nf = min(frames, F - f0)
            out[f0 : f0 + nf, members[m0:m1, 2]] = acc[:, :nf].T.astype(np.float32)
    return out


@pytest.mark.parametrize("frames,band_rows", [(1, None), (2, 3), (4, 2)])
def test_kernel_index_math_matches_the_plain_form(frames, band_rows):
    """The emulated kernel reads no unstaged tap and gives the plain form's
    values within one float32 ulp: one band and one pass, bands of 3 rows
    (the last one short) over two passes with a zero frame, and bands of 2.
    The plane (tap 2, fs 7: fs**2 is odd, so blocks start at every
    alignment mod 4, and the strips end off a 16-byte boundary; a window at
    a corner is shared by pixels of two strips) keeps the loops short."""
    op = build_plane_operator(120, 80, 77, 53, radius_for_tap(2))
    assert op.filter_size % 2 == 1 and len(op.strips) == 4
    spec = band_k.make_band_strips(op, to_device(op, "cpu"))
    strip = spec.members[:, 0].numpy()
    assert any(len(set(strip[m0:m1])) > 1 for _, _, m0, m1 in spec.groups.numpy())
    src = _src(op, 3, seed=61)
    got = emulate_kernel(spec, src, frames, band_rows or op.filter_size)
    assert not np.isnan(got).any()
    want = band_k.band_strips_plain(spec, src)
    at = 0
    for rect, vals in want.items():
        n = vals.shape[1] * vals.shape[2]
        v = vals.reshape(3, n).numpy()
        assert (np.abs(got[:, at : at + n] - v) <= np.spacing(np.abs(v))).all(), rect
        at += n


@pytest.mark.parametrize("kind", ["gather", "seg"])
def test_appliers_planes_are_unchanged(kind, planes):
    """A whole plane through ``GatherApplier`` (the gather stand-in's luma,
    fs 92) and ``SegConvApplier`` (the drifted 1.5x tap-8 plane): the same
    values, within 2e-6, as the same applier with the float32 per-pixel
    strips, and the same 8-bit samples."""
    op = planes["gather-luma" if kind == "gather" else "seg-1.5x-tap8"][0]
    app = (GatherApplier if kind == "gather" else SegConvApplier)(op, device="cpu")
    src = _src(op, 2, seed=71)
    got = app(src)
    ref = copy.copy(app)
    ref._strips = lambda s: {(d.y0, d.y1, d.x0, d.x1): _strip_values(app._dop, s, d)
                             for d in app._dop.strips}  # fmt: skip
    want = ref(src)
    assert got.shape == want.shape == (2, op.dst_height, op.dst_width)
    assert float((got - want).abs().max()) <= F32_TOL
    u8 = (src * 255).round().to(torch.uint8)
    a, b = app(u8, out_dtype=np.uint8, peak=255.0), ref(u8, out_dtype=np.uint8, peak=255.0)
    assert int((a.int() - b.int()).abs().max()) <= 1
