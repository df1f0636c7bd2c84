"""Port's segment-periodic engine (plain forms on the CPU) against the JAX one.

The JAX side runs ``make_seg_interior`` and ``SegConvApplier`` in Pallas
interpret mode, as ``tests/test_apply_conv_seg.py`` does; the port's
wrappers take their plain PyTorch forms because the tensors lie on the CPU.
The CUDA kernel is held to the same plain form on the card by
``chip_smoke.py``; the tile-window test below checks, on the host, the index
arithmetic that kernel stages its shared-memory window with.

Tolerances: 2e-6 absolute for the interior on fp32 sources in [0, 1) (exact
fp32 products, only the summation order differs); for the applier,
``tests/test_apply_conv_seg.py``'s fp32 bound (2e-5 absolute) and <= 1 LSB
for u8/u16 after ``finalize``. On the deep-tap plane (fs 44, fs**2 > 1200):
the JAX deep-tap bound 4e-6 against the JAX package, and 1e-5 against the
float32 host golden, whose own chain over thousands of taps drifts by a few
1e-6 from a float64 sum (``tests/test_torch_gather.py`` ``golden64``).
"""

import numpy as np
import pytest
import torch

from jincresize_tpu import operator as joperator
from jincresize_tpu import phase as jphase
from jincresize_tpu_torch.golden import apply_plane_numpy
from jincresize_tpu_torch.operator import build_plane_operator, radius_for_tap
from jincresize_tpu_torch.phase import plan_phases, plan_phases_seg
from jincresize_tpu_torch.apply_strips_fast import _strip_values
from jincresize_tpu_torch.apply_conv_seg import SegConvApplier
from jincresize_tpu_torch.apply_xla import to_device
from jincresize_tpu_torch.kernels import band_strips, fused, gather, seg


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread for this module's tests: pytest-xdist runs
    several workers on one machine, and each worker's default pool (a
    thread a core) oversubscribes the cores, so the plain forms' thousands
    of small ops wait on contended threads. The old count is back after the
    module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


F32_TOL = 2e-6
DEEP_TOL = 4e-6  # fs**2 > 1200: the JAX package's deep-tap bound
DEEP_GOLDEN_TOL = 1e-5  # the float32 golden's own drift at thousands of taps
APPLIER_F32_TOL = 2e-5  # test_apply_conv_seg.py::test_seg_parity_float_output

# tests/test_apply_conv_seg.py: the drifted 1.5x tap-8 plane, the exactly
# periodic 1.5x tap-3 plane, and the 2.5x tap-2 plane with exception columns.
GEOMS = {
    "1.5x-tap8": (640, 360, 960, 540, 8),
    "1.5x-tap3-periodic": (64, 48, 96, 72, 3),
    "2.5x-exceptions": (1920, 80, 4800, 200, 2),
}
# 2560x1440 -> 1920x1080 tap 16 at a quarter of its size: drifted under f32
# positions, fs 44 (4 x 5 classes), no periodic plan.
DEEP = (640, 360, 480, 270, 16)


def _op(name):
    sw, sh, dw, dh, tap = GEOMS[name]
    return build_plane_operator(sw, sh, dw, dh, radius_for_tap(tap))


def _jop(name):
    """The JAX package's operator of the same geometry, from its own host layer."""
    sw, sh, dw, dh, tap = GEOMS[name]
    return joperator.build_plane_operator(sw, sh, dw, dh, joperator.radius_for_tap(tap))


def _src(op, dtype, seed, frames=2):
    rng = np.random.default_rng(seed)
    shape = (frames, op.src_height, op.src_width)
    if dtype == np.float32:
        return rng.random(shape, dtype=np.float32)
    return rng.integers(0, 256, shape).astype(dtype)


def _maxdiff(a, b):
    return float(np.abs(a.astype(np.float64) - b.astype(np.float64)).max())


@pytest.fixture(scope="module")
def ops():
    return {name: _op(name) for name in GEOMS}


@pytest.fixture(scope="module")
def jax_interiors(ops):
    """JAX Pallas seg interiors (interpret mode) on one fp32 frame each."""
    import jax.numpy as jnp

    from jincresize_tpu.kernels.pallas_fused_seg import make_seg_interior

    out = {}
    for name in ("1.5x-tap8", "1.5x-tap3-periodic"):
        op = _jop(name)
        fn = make_seg_interior(op, jphase.plan_phases_seg(op), interpret=True)
        src = _src(op, np.float32, seed=4, frames=1)[0]
        out[name] = (src, np.asarray(fn(jnp.asarray(src), fn.params)))
    return out


@pytest.mark.parametrize("name", ["1.5x-tap8", "1.5x-tap3-periodic"])
def test_seg_plain_matches_pallas_interpret(name, ops, jax_interiors):
    op = ops[name]
    plan = plan_phases_seg(op)
    assert seg.is_supported(op, plan)
    src, want = jax_interiors[name]
    si = seg.make_seg_interior(op, plan)
    got = seg.seg_interior(si, torch.from_numpy(src)[None])[0].numpy()
    assert got.shape == want.shape == si.out_shape
    assert si.out_shape == (plan.y.hi - plan.y.lo, plan.x.hi - plan.x.lo)
    assert np.abs(got - want).max() <= F32_TOL


@pytest.fixture(scope="module")
def jax_applier_outputs(ops):
    """JAX SegConvApplier (interpret) outputs on the drifted 1.5x tap-8 plane."""
    import jax.numpy as jnp

    from jincresize_tpu.apply_conv_seg import SegConvApplier as JaxSegConvApplier

    op = ops["1.5x-tap8"]
    jap = JaxSegConvApplier(_jop("1.5x-tap8"), interpret=True)
    out = {"concat": jap._concat}
    for dtype, peak in ((np.float32, None), (np.uint8, 255.0)):
        src = _src(op, dtype, seed=2)
        out[np.dtype(dtype).name] = (
            src,
            np.asarray(jap(jnp.asarray(src), out_dtype=dtype, peak=peak)),
        )
    return out


@pytest.mark.parametrize("dtype,peak", [(np.float32, None), (np.uint8, 255.0)], ids=["f32", "u8"])
def test_seg_applier_matches_jax_and_golden(dtype, peak, ops, jax_applier_outputs):
    op = ops["1.5x-tap8"]
    src, want = jax_applier_outputs[np.dtype(dtype).name]
    ap = SegConvApplier(op, device="cpu")
    assert ap.interior == "fused-seg"
    assert ap.canvas.concat == jax_applier_outputs["concat"]
    got = ap(torch.from_numpy(src), out_dtype=dtype, peak=peak).numpy()
    golden = np.stack([apply_plane_numpy(op, s, out_dtype=dtype, peak=peak) for s in src])
    assert got.dtype == np.dtype(dtype)
    tol = APPLIER_F32_TOL if dtype == np.float32 else 1
    assert _maxdiff(got, golden) <= tol
    assert _maxdiff(got, want) <= tol


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16], ids=["u8", "u16"])
def test_seg_exception_case_matches_golden(dtype, ops):
    """2.5x wide plane: exception columns take the paste assembly with the
    column fixup (the JAX interpret run of this case takes ~19 s, so only
    the golden is the reference here)."""
    op = ops["2.5x-exceptions"]
    plan = plan_phases_seg(op)
    assert len(plan.x.exceptions) > 0
    ap = SegConvApplier(op, plan=plan, device="cpu")
    assert not ap.canvas.concat
    peak = 255.0 if dtype == np.uint8 else 1023.0
    src = _src(op, dtype, seed=3)
    got = ap(torch.from_numpy(src), out_dtype=dtype, peak=peak).numpy()
    golden = np.stack([apply_plane_numpy(op, s, out_dtype=dtype, peak=peak) for s in src])
    assert _maxdiff(got, golden) <= 1


def test_seg_batch_matches_per_frame(ops):
    op = ops["1.5x-tap3-periodic"]
    ap = SegConvApplier(op, device="cpu")
    src = torch.from_numpy(_src(op, np.float32, seed=6, frames=5))
    batch = ap(src)
    si = ap.si
    whole = seg.seg_interior(si, src)
    for f in range(5):
        # The einsum may block the frames differently: summation order only.
        assert float((batch[f] - ap(src[f])).abs().max()) <= F32_TOL
        one = seg.seg_interior(si, src[f : f + 1])[0]
        assert float((whole[f] - one).abs().max()) <= F32_TOL


@pytest.mark.parametrize("name", list(GEOMS))
def test_tile_windows_cover_every_read(name, ops):
    """The CUDA kernel stages, per 32 x 32 output tile, source windows
    between the tile's least start and its greatest start plus fs: their
    extent is at most ``win_h x win_w`` (a staged row spans ``win_w``), they
    lie inside the source plane, and the largest tile's pair blocks beside
    the warps' rings of ``frames_per_block`` frames fit the shared memory."""
    op = ops[name]
    si = seg.make_seg_interior(op, plan_phases_seg(op))
    for tile, start, win, size in (
        (seg.TILE_Y, si.start_y.numpy(), si.win_h, op.src_height),
        (seg.TILE_X, si.start_x.numpy(), si.win_w, op.src_width),
    ):
        for k0 in range(0, len(start), tile):
            part = start[k0 : k0 + tile]
            assert part.min() >= 0 and part.max() + si.fs <= size
            assert part.max() - part.min() + si.fs <= win
    nbytes = seg.smem_bytes(si.pairs, si.fs, si.win_w, si.frames_per_block)
    assert nbytes <= fused.MAX_SMEM_BYTES


def test_strip_values_banded_equals_strip_values(ops):
    """Every strip of a seg geometry: the band-strips plain form (the seg
    engine's strips) equals the full-height per-pixel one."""
    op = ops["1.5x-tap8"]
    dop = to_device(op, "cpu")
    spec = band_strips.make_band_strips(op, dop)
    src = torch.from_numpy(_src(op, np.float32, seed=9))
    vals = band_strips.band_strips_plain(spec, src)
    kinds = set()
    for s in dop.strips:
        kinds.add(bool((op.start_y[s.y0 : s.y1] == op.start_y[s.y0]).all()))
        got = vals[(s.y0, s.y1, s.x0, s.x1)]
        want = _strip_values(dop, src, s)
        assert got.shape == want.shape == (2, s.y1 - s.y0, s.x1 - s.x0)
        assert float((got - want).abs().max()) <= F32_TOL
    assert kinds == {True, False}  # both the constant-row and the per-row strips


def test_strip_row_bands_equal_jax(ops):
    """The band-strips spec's windows against the JAX package's row bands
    (``apply_conv.strip_row_bands`` of the same geometry): every strip
    pixel's window starts where the JAX operator starts it, its rows lie in
    the strip's JAX band, and a strip is constant-row in the JAX sense
    exactly when all its pixels share one start row; a source below the
    filter is refused."""
    from jincresize_tpu import apply_conv as japply

    for name, op in ops.items():
        jop = _jop(name)
        bands = japply.strip_row_bands(jop)
        spec = band_strips.make_band_strips(op, to_device(op, "cpu"))
        groups = spec.groups.numpy()
        owner = np.repeat(np.arange(len(groups)), groups[:, 3] - groups[:, 2])
        strip, ys, xs = band_strips.pixels(spec)
        sy = groups[owner, 0]
        assert (sy == np.asarray(jop.start_y)[ys]).all()
        assert (groups[owner, 1] == np.asarray(jop.start_x)[xs]).all()
        assert len(ys) == sum(s.npixels for s in jop.strips)
        for i, rect in enumerate(spec.rects):
            y_min, band_h, const_sy = bands[rect]
            rows = sy[strip == i]
            assert rows.min() == y_min and rows.max() + op.filter_size == y_min + band_h
            assert bool((rows == rows[0]).all()) == const_sy
    tiny = build_plane_operator(6, 6, 12, 12, radius_for_tap(8))
    with pytest.raises(ValueError, match="smaller than filter_size"):
        band_strips.make_band_strips(tiny, to_device(tiny, "cpu"))


def test_is_supported_declines_deep_tap(monkeypatch):
    """A deep-tap drifted plan (fs**2 > 1200, which the TPU envelope
    declines) is declined only where its largest tile's pair blocks and
    one-frame rings do not fit the shared memory: here with that memory one
    byte short of the need. Declined, a plan with no periodic plan takes the
    gather kernel under auto on a CUDA device (the appliers are stand-ins:
    no card here)."""
    from jincresize_tpu_torch import api

    op = build_plane_operator(720, 405, 240, 135, radius_for_tap(16))
    plan = plan_phases_seg(op)
    assert plan is not None and op.filter_size**2 > fused.FS2_MAX
    si = seg.make_seg_interior(op, plan)
    need = seg.smem_bytes(si.pairs, si.fs, si.win_w, 1)
    monkeypatch.setattr(seg, "MAX_SMEM_BYTES", need - 1)
    assert not seg.is_supported(op, plan)
    with pytest.raises(ValueError, match="envelope"):
        seg.make_seg_interior(op, plan)
    with pytest.raises(ValueError, match="envelope"):
        SegConvApplier(op, plan=plan, device="cpu")
    monkeypatch.setattr(seg, "MAX_SMEM_BYTES", need)
    assert seg.is_supported(op, plan)

    for name in ("SegConvApplier", "GatherApplier"):
        monkeypatch.setattr(api, name, lambda op, *a, _n=name, **kw: _n)
    deep = build_plane_operator(*DEEP[:4], radius_for_tap(DEEP[4]))
    deep_plan, cuda = plan_phases_seg(deep), torch.device("cuda")
    monkeypatch.setattr(seg, "MAX_SMEM_BYTES", fused.MAX_SMEM_BYTES)
    dsi = seg.make_seg_interior(deep, deep_plan)
    assert api._select_engine(deep, "auto", "fp32", cuda) == ("SegConvApplier", "fused-seg")
    monkeypatch.setattr(seg, "MAX_SMEM_BYTES", seg.smem_bytes(dsi.pairs, dsi.fs, dsi.win_w, 1) - 1)
    assert api._select_engine(deep, "auto", "fp32", cuda) == ("GatherApplier", "gather")


def test_applier_declines_aperiodic_geometry():
    op = build_plane_operator(400, 220, 601, 331, radius_for_tap(3))
    assert plan_phases(op) is None and plan_phases_seg(op) is None
    with pytest.raises(ValueError, match="segment-periodic"):
        SegConvApplier(op, device="cpu")


def test_precision_modes(ops):
    op = ops["1.5x-tap3-periodic"]
    src = torch.from_numpy(_src(op, np.uint8, seed=8, frames=1))
    a, b = (
        SegConvApplier(op, precision=prec, device="cpu")(src, out_dtype=np.uint8, peak=255.0)
        for prec in ("fp32", "fp32_u8src")
    )
    # The u8-source mode's wsplit3 interior runs the fp32 plain form on the CPU.
    assert torch.equal(a, b)
    # bf16 (tests/test_torch_bf16.py): u8 sources are bf16-exact, only the
    # weights round, so the output stays within 2 LSB here.
    ap = SegConvApplier(op, precision="bf16", device="cpu")
    assert ap.si.bf16 and ap.effective_precision == "bf16"
    c = ap(src, out_dtype=np.uint8, peak=255.0)
    assert (c.int() - a.int()).abs().max() <= 2
    with pytest.raises(ValueError, match="unknown precision"):
        SegConvApplier(op, precision="fp16", device="cpu")


def test_wrapper_never_falls_back_off_cpu(ops):
    op = ops["1.5x-tap3-periodic"]
    si = seg.make_seg_interior(op, plan_phases_seg(op))
    src = torch.empty((1, op.src_height, op.src_width), device="meta")
    with pytest.raises(RuntimeError, match="unsupported device"):
        seg.seg_interior(si, src)
    assert seg.seg_interior.launches == 0


@pytest.mark.parametrize("name", [*GEOMS, "deep-fs44"])
def test_tile_tables_recount_the_plan(name):
    """The kernel's host tables against a direct recount from the plan:
    each tile's distinct classes and every coordinate's index into them,
    the pair blocks of the largest tile, the tallest and widest tile
    windows, and the frames a thread that fit beside the pair blocks."""
    sw, sh, dw, dh, tap = DEEP if name == "deep-fs44" else GEOMS[name]
    op = build_plane_operator(sw, sh, dw, dh, radius_for_tap(tap))
    plan = plan_phases_seg(op)
    si = seg.make_seg_interior(op, plan)
    fs = op.filter_size
    most = {}
    for axis, tile, start, ids, count, local, win in (
        ("y", seg.TILE_Y, si.start_y, si.tcy, si.ncy, si.lcy, si.win_h),
        ("x", seg.TILE_X, si.start_x, si.tcx, si.ncx, si.lcx, si.win_w),
    ):
        cls = getattr(plan, axis).cls
        ids, count, local, start = (a.numpy() for a in (ids, count, local, start))
        tiles = range(0, len(cls), tile)
        assert ids.shape[0] == count.shape[0] == len(tiles) and local.shape == cls.shape
        widest = 0
        for i, k0 in enumerate(tiles):
            part = cls[k0 : k0 + tile]
            want = sorted(set(part.tolist()))
            assert count[i] == len(want) and ids[i, : len(want)].tolist() == want
            assert (ids[i, len(want) :] == want[-1]).all()
            assert (ids[i][local[k0 : k0 + tile]] == part).all()
            widest = max(widest, int(start[k0 : k0 + tile].max() - start[k0 : k0 + tile].min()))
        most[axis] = int(count.max())
        assert ids.shape[1] == most[axis] and win == widest + fs
    assert si.pairs == most["y"] * most["x"]
    fits = [
        f for f in gather.FRAMES if seg.smem_bytes(si.pairs, fs, si.win_w, f) <= fused.MAX_SMEM_BYTES
    ]
    assert si.frames_per_block == max(fits)
    for n_frames in (1, 2, 3, 4, 8):
        frames = seg.frames_of(si, n_frames)
        assert frames == min(gather.frames_per_thread(n_frames), si.frames_per_block)
        assert seg.smem_bytes(si.pairs, fs, si.win_w, frames) <= fused.MAX_SMEM_BYTES
    swp = seg.row_floats(si.win_w, 1)
    assert swp >= si.win_w and swp % 4 == 0 and swp - si.win_w < 4
    if name == "deep-fs44":
        assert fs == 44 and op.pair_blocks.shape[:2] == (4, 5) and plan_phases(op) is None


@pytest.mark.parametrize("fs", [3, 5, 7, 17, 22, 44, 92])
def test_block_stride_spreads_column_classes_over_banks(fs):
    """Pair blocks lie ``block_stride`` floats apart: room for a padded
    block, 16-byte aligned, and 4 mod 32, so the same tap of 8 consecutive
    column classes falls in 8 distinct groups of 4 banks."""
    b = seg.block_stride(fs)
    assert b >= fs * gather.fsp_of(fs) and b % 32 == 4
    assert len({(j * b) % 32 for j in range(8)}) == 8


@pytest.fixture(scope="module")
def deep_outputs():
    """The JAX package's jinc_resize (auto; its seg envelope declines fs 44)
    on one-frame gray fp32 and u8 clips of the deep plane."""
    from jincresize_tpu import api as japi
    from jincresize_tpu.clip import Clip as JClip
    from jincresize_tpu.clip import Frame as JFrame
    from jincresize_tpu.clip import gray as jgray

    sw, sh, dw, dh, tap = DEEP
    out = {}
    for dtype in (np.float32, np.uint8):
        src = _src(build_plane_operator(sw, sh, dw, dh, radius_for_tap(tap)), dtype, seed=44, frames=1)
        bits = 32 if dtype == np.float32 else 8
        fmt = jgray(bits)
        clip = JClip.from_frames([JFrame(fmt, {"Y": src[0]}, {})])
        jr = japi.JincResizer(fmt, sw, sh, japi.JincConfig(dw, dh, tap=tap))
        out[np.dtype(dtype).name] = (src, jr(clip).frames[0].planes["Y"], jr.engines)
    return out


@pytest.mark.parametrize("dtype,peak", [(np.float32, None), (np.uint8, 255.0)], ids=["f32", "u8"])
def test_deep_tap_applier_matches_jax_and_golden(dtype, peak, deep_outputs):
    """The fs-44 drifted plane through the port's SegConvApplier (plain
    forms on the CPU) against the JAX package's jinc_resize and the host
    golden: fp32 within the deep-tap bounds, u8 within 1 LSB."""
    sw, sh, dw, dh, tap = DEEP
    op = build_plane_operator(sw, sh, dw, dh, radius_for_tap(tap))
    src, want, _ = deep_outputs[np.dtype(dtype).name]
    ap = SegConvApplier(op, device="cpu")
    assert ap.interior == "fused-seg" and op.filter_size == 44
    got = ap(torch.from_numpy(src), out_dtype=dtype, peak=peak).numpy()[0]
    golden = apply_plane_numpy(op, src[0], out_dtype=dtype, peak=peak)
    assert got.dtype == want.dtype == np.dtype(dtype)
    deep = dtype == np.float32
    assert _maxdiff(got, want) <= (DEEP_TOL if deep else 1)
    assert _maxdiff(got, golden) <= (DEEP_GOLDEN_TOL if deep else 1)
    assert _maxdiff(want, golden) <= (DEEP_GOLDEN_TOL if deep else 1)


def test_deep_tap_plan_routes_apart_from_jax(deep_outputs):
    """Pinned difference: the port's seg kernel takes the fs-44 plan (auto
    on a CUDA device runs fused-seg: tests/test_torch_api.py AUTO_CUDA),
    where the JAX package's seg envelope (fs**2 <= 1200) declines it and its
    auto takes xla."""
    from jincresize_tpu.kernels import pallas_fused_seg

    sw, sh, dw, dh, tap = DEEP
    op = build_plane_operator(sw, sh, dw, dh, radius_for_tap(tap))
    assert seg.is_supported(op, plan_phases_seg(op))
    jop = joperator.build_plane_operator(sw, sh, dw, dh, joperator.radius_for_tap(tap))
    assert not pallas_fused_seg.is_supported(jop, jphase.plan_phases_seg(jop))
    assert deep_outputs["float32"][2] == {"luma": "xla"}

