"""Port's gather engine (plain forms on the CPU) against the JAX gather engine.

The JAX side runs ``make_gather_interior`` and ``GatherApplier`` in Pallas
interpret mode, as ``tests/test_apply_gather.py`` does; the port's wrappers
take their plain PyTorch forms because the tensors lie on the CPU. The CUDA
kernel is held to the same plain form on the card by ``chip_smoke.py``.

Tolerances: 2e-6 absolute for the interior on fp32 sources in [0, 1) (exact
fp32 products, only the summation order differs), 4e-6 for deep taps (fs**2 >
1200, the JAX deep-tap bound); for the applier,
``tests/test_apply_gather.py``'s relative fp32 bound against the golden and
<= 1 LSB for u8/u16 after ``finalize``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from jincresize_tpu import operator as joperator
from jincresize_tpu_torch.golden import apply_plane_numpy, materialize_blocks
from jincresize_tpu_torch.operator import build_plane_operator, radius_for_tap
from jincresize_tpu_torch.phase import plan_phases, plan_phases_seg
from jincresize_tpu_torch.apply_gather import GatherApplier
from jincresize_tpu_torch.kernels import fused, gather


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
DEEP_TOL = 4e-6  # fs**2 > 1200: the JAX deep-tap bound

# tests/test_apply_gather.py: aperiodic upscale (>100 classes per axis) and
# the tap-2 downscale.
GEOMS = {"aperiodic-up": (96, 64, 167, 113, 3), "down-tap2": (120, 80, 77, 53, 2)}


def _op(name):
    sw, sh, dw, dh, tap = GEOMS[name]
    return build_plane_operator(sw, sh, dw, dh, radius_for_tap(tap))


def _jop(name):
    """The JAX package's operator of the same geometry, from its own host layer."""
    sw, sh, dw, dh, tap = GEOMS[name]
    return joperator.build_plane_operator(sw, sh, dw, dh, joperator.radius_for_tap(tap))


def _src(op, dtype, seed, frames=2, peak=255):
    rng = np.random.default_rng(seed)
    shape = (frames, op.src_height, op.src_width)
    if dtype == np.float32:
        return rng.random(shape, dtype=np.float32)
    return rng.integers(0, peak + 1, shape).astype(dtype)


def _maxdiff(a, b):
    return float(np.abs(a.astype(np.float64) - b.astype(np.float64)).max())


@pytest.fixture(scope="module")
def ops():
    return {name: _op(name) for name in GEOMS}


@pytest.fixture(scope="module")
def jax_interiors(ops):
    """JAX Pallas gather interiors (interpret mode) on 2-frame fp32 sources."""
    import jax.numpy as jnp

    from jincresize_tpu.kernels.pallas_gather import make_gather_interior

    out = {}
    for name, op in ops.items():
        src = _src(op, np.float32, seed=11)
        kfn = make_gather_interior(_jop(name), interpret=True)
        out[name] = (src, np.asarray(kfn(jnp.asarray(src))))
    return out


@pytest.mark.parametrize("name", list(GEOMS))
def test_gather_plain_matches_pallas_interpret(name, ops, jax_interiors):
    op = ops[name]
    assert plan_phases(op) is None and plan_phases_seg(op) is None
    src, want = jax_interiors[name]
    gi = gather.make_gather_interior(op)
    got = gather.gather_interior(gi, torch.from_numpy(src)).numpy()
    assert got.shape == want.shape == (2,) + gi.out_shape
    assert np.abs(got - want).max() <= F32_TOL


@pytest.fixture(scope="module")
def jax_applier_outputs(ops):
    """JAX GatherApplier (interpret) outputs: fp32 and u8 batches."""
    import jax.numpy as jnp

    from jincresize_tpu.apply_gather import GatherApplier as JaxGatherApplier

    op = ops["aperiodic-up"]
    jap = JaxGatherApplier(_jop("aperiodic-up"), interpret=True)
    out = {"concat": jap._concat}
    for dtype, peak in ((np.float32, None), (np.uint8, 255.0)):
        src = _src(op, dtype, seed=5)
        out[np.dtype(dtype).name] = (
            src,
            np.asarray(jap(jnp.asarray(src), out_dtype=dtype, peak=peak)),
        )
    return out


@pytest.mark.parametrize("dtype,peak", [(np.float32, None), (np.uint8, 255.0)], ids=["f32", "u8"])
def test_gather_applier_matches_jax_and_golden(dtype, peak, ops, jax_applier_outputs):
    op = ops["aperiodic-up"]
    src, want = jax_applier_outputs[np.dtype(dtype).name]
    ap = GatherApplier(op, device="cpu")
    assert ap.canvas.concat == jax_applier_outputs["concat"]
    got = ap(torch.from_numpy(src), out_dtype=dtype, peak=peak).numpy()
    golden = np.stack([apply_plane_numpy(op, s, out_dtype=dtype, peak=peak) for s in src])
    assert got.dtype == np.dtype(dtype)
    if dtype == np.float32:
        bound = 2e-6 * max(1.0, float(np.abs(golden).max()))  # test_apply_gather.py's bound
        assert _maxdiff(got, golden) <= bound
        assert _maxdiff(got, want) <= bound
    else:
        assert _maxdiff(got, golden) <= 1
        assert _maxdiff(got, want) <= 1


@pytest.mark.parametrize(
    "name,dtype,peak",
    [("down-tap2", np.float32, None), ("down-tap2", np.uint16, 1023.0)],
    ids=["down-f32", "down-u16"],
)
def test_gather_applier_matches_golden(name, dtype, peak, ops):
    op = ops[name]
    src = _src(op, dtype, seed=13, peak=int(peak or 1))
    got = GatherApplier(op, device="cpu")(torch.from_numpy(src), out_dtype=dtype, peak=peak).numpy()
    golden = np.stack([apply_plane_numpy(op, s, out_dtype=dtype, peak=peak) for s in src])
    tol = 2e-6 * max(1.0, float(np.abs(golden).max())) if dtype == np.float32 else 1
    assert _maxdiff(got, golden) <= tol


def test_gather_batch_matches_per_frame(ops):
    op = ops["aperiodic-up"]
    ap = GatherApplier(op, device="cpu")
    src = torch.from_numpy(_src(op, np.float32, seed=3, frames=3))
    batch = ap(src)
    gi = gather.make_gather_interior(op)
    whole = gather.gather_interior(gi, src)
    for f in range(3):
        # The einsum may block the frames differently: summation order only.
        assert float((batch[f] - ap(src[f])).abs().max()) <= F32_TOL
        one = gather.gather_interior(gi, src[f : f + 1])[0]
        assert float((whole[f] - one).abs().max()) <= F32_TOL


def test_gather_tables_follow_the_operator(ops):
    """State carries across: the device tables are the operator's own arrays.

    Since the Hopper redesign the dictionary is stored ``[cy, cx, ly, lx]``
    with each tap row padded to a multiple of 4 floats (a thread's 16-byte
    weight loads read its own block's tap row), no longer class-minor; the
    plain form reads it through ``class_minor_view``, the old order."""
    op = ops["aperiodic-up"]
    gi = gather.make_gather_interior(op)
    fs = op.filter_size
    np.testing.assert_array_equal(gi.start_y.numpy(), op.start_y[op.y_lo : op.y_hi])
    np.testing.assert_array_equal(gi.cy_idx.numpy(), op.cy_idx[op.y_lo : op.y_hi])
    np.testing.assert_array_equal(gi.start_x.numpy(), op.start_x[op.x_lo : op.x_hi])
    np.testing.assert_array_equal(gi.cx_idx.numpy(), op.cx_idx[op.x_lo : op.x_hi])
    assert gi.blocks.shape == op.pair_blocks.shape[:3] + (gather.fsp_of(fs),)
    np.testing.assert_array_equal(gi.blocks[..., :fs].numpy(), op.pair_blocks)
    assert not gi.blocks[..., fs:].any()
    np.testing.assert_array_equal(
        gather.class_minor_view(gi.blocks).numpy(), op.pair_blocks.transpose(0, 2, 3, 1)
    )
    assert gi.start_y.dtype == gi.cx_idx.dtype == torch.int32
    assert gi.span_w == gather.tile_span(op.start_x[op.x_lo : op.x_hi], gather.TILE[0], fs)


def test_is_supported_declines_an_empty_dictionary():
    border_only = build_plane_operator(8, 8, 16, 16, radius_for_tap(8))
    assert border_only.pair_blocks.size == 0
    assert not gather.is_supported(border_only)
    with pytest.raises(ValueError, match="envelope"):
        gather.make_gather_interior(border_only)
    with pytest.raises(ValueError, match="envelope"):
        GatherApplier(border_only, device="cpu")


def test_is_supported_takes_deep_taps_where_the_jax_envelope_declines():
    """fs**2 > 1200: the JAX gather kernel's VMEM envelope declines, the
    port's ring takes any filter size (the tables of the 373 MB tap-16
    dictionary of 481x271 -> 240x135 are not built here; the 33.6 MB one of
    ``DEEP`` is, below)."""
    from jincresize_tpu.kernels import pallas_gather

    deep = build_plane_operator(481, 271, 240, 135, radius_for_tap(16))
    assert deep.filter_size**2 > fused.FS2_MAX
    assert gather.is_supported(deep)
    jdeep = joperator.build_plane_operator(481, 271, 240, 135, joperator.radius_for_tap(16))
    assert not pallas_gather.is_supported(jdeep)


# A small aperiodic deep-tap plane: fs 92, 16 x 62 classes, a 33.6 MB
# dictionary and a 64 x 139 interior, with the 2.8125 row ratio of
# 3840x2160 -> 1366x768 tap 16.
DEEP = (480, 270, 171, 96, 16)


@pytest.fixture(scope="module")
def deep_op():
    sw, sh, dw, dh, tap = DEEP
    return build_plane_operator(sw, sh, dw, dh, radius_for_tap(tap))


def golden64(op, src):
    """The host golden's gather-MAC summed in float64: (F, dst_h, dst_w).

    At fs 92 the golden's own float32 chain over 8464 taps is 4.5e-6 off
    this sum, the port and the JAX package's engine 5e-7, so deep-tap fp32
    outputs are held to this form at the JAX deep-tap bound."""
    blocks = materialize_blocks(op).astype(np.float64)
    fs, (F, H, W) = op.filter_size, src.shape
    acc = np.zeros((F, op.dst_height, op.dst_width))
    for ly in range(fs):
        rows = src[:, np.clip(op.start_y + ly, 0, H - 1)]
        for lx in range(fs):
            acc += rows[:, :, np.clip(op.start_x + lx, 0, W - 1)] * blocks[:, :, ly, lx]
    return acc


def test_deep_tap_interior_matches_golden(deep_op):
    """The gather interior (plain form) of the fs-92 plane against the host
    golden's interior rectangle, summed in float64, at the JAX deep-tap
    bound."""
    op = deep_op
    assert op.filter_size == 92 and op.pair_blocks.shape[:2] == (16, 62)
    assert plan_phases(op) is None and gather.is_supported(op)
    src = _src(op, np.float32, seed=19)
    gi = gather.make_gather_interior(op)
    got = gather.gather_interior(gi, torch.from_numpy(src)).numpy()
    want = golden64(op, src)[:, op.y_lo : op.y_hi, op.x_lo : op.x_hi]
    assert got.shape == want.shape == (2, 64, 139)
    assert _maxdiff(got, want) <= DEEP_TOL


def test_tile_span_is_the_widest_tile_window():
    rng = np.random.default_rng(4)
    for n, tile, fs in ((70, 32, 17), (32, 32, 92), (5, 32, 3), (100, 16, 7)):
        starts = np.sort(rng.integers(0, 500, n))
        want = max(int(starts[i : i + tile].max() - starts[i : i + tile].min()) for i in range(0, n, tile))
        assert gather.tile_span(starts, tile, fs) == want + fs


@pytest.mark.parametrize(
    "n_frames,frames", [(1, 1), (2, 2), (3, 4), (4, 4), (5, 8), (8, 8), (12, 8)]
)
def test_frames_per_thread(n_frames, frames):
    assert gather.frames_per_thread(n_frames) == frames


@pytest.mark.parametrize(
    "span_w,n_frames,want",
    [
        # 1080p -> 3740x2104 tap 8 (fs 17): 33 window columns a tile.
        (33, 8, gather.Ring(8, 36, 8, 18432)),
        (33, 4, gather.Ring(4, 36, 8, 9216)),
        # 3840x2160 -> 1366x768 tap 16 (fs 92): 180 columns; 8 frames halve the stage.
        (180, 8, gather.Ring(8, 180, 4, 46080)),
        (180, 2, gather.Ring(2, 180, 8, 23040)),
        # Wide rows: one row a stage, then fewer frames until it fits 227 KB.
        (5000, 8, gather.Ring(4, 5000, 1, 160000)),
        (29000, 1, gather.Ring(1, 29000, 1, 232000)),
    ],
)
def test_choose_ring(span_w, n_frames, want):
    ring = gather.choose_ring(span_w, n_frames)
    assert ring == want
    assert ring.smem_bytes == 2 * ring.ch * ring.swp * ring.frames * 4 <= fused.MAX_SMEM_BYTES
    assert ring.swp % 4 == 0 and ring.swp >= span_w


def test_choose_ring_refuses_a_row_that_does_not_fit():
    with pytest.raises(ValueError, match="does not fit"):
        gather.choose_ring(29100, 1)
    # An operator whose tile window would span 31000 columns is declined.
    op = build_plane_operator(96, 64, 167, 113, radius_for_tap(3))
    assert gather.is_supported(op)
    wide = dataclasses.replace(op, start_x=np.arange(op.dst_width, dtype=np.int32) * 1000)
    assert gather.interior_span(wide) > 29056 and not gather.is_supported(wide)


def test_make_checks_window_starts_on_the_host(ops):
    op = ops["aperiodic-up"]
    sy = op.start_y.copy()
    sy[op.y_lo] = op.src_height - op.filter_size + 1
    with pytest.raises(ValueError, match="leave the source axis"):
        gather.make_gather_interior(dataclasses.replace(op, start_y=sy))
    sx = op.start_x.copy()
    sx[op.x_hi - 1] = -1
    with pytest.raises(ValueError, match="columns"):
        gather.make_gather_interior(dataclasses.replace(op, start_x=sx))


def test_wrapper_never_falls_back_off_cpu(ops):
    op = ops["aperiodic-up"]
    gi = gather.make_gather_interior(op)
    src = torch.empty((1, op.src_height, op.src_width), device="meta")
    before = gather.gather_interior_tile.launches, gather.gather_interior_grouped.launches
    with pytest.raises(RuntimeError, match="unsupported device"):
        gather.gather_interior(gi, src)
    with pytest.raises(RuntimeError, match="unsupported device"):
        gather.gather_interior_tile(gi, src)
    assert (gather.gather_interior_tile.launches,
            gather.gather_interior_grouped.launches) == before == (0, 0)  # fmt: skip


# ---- The class-grouped kernel's row groups (csrc/gather_interior.cu
# gather_class_kernel): full-size interiors from the axis geometry alone
# (no dictionary is built), and the stand-in of the benchmark's gather cell.
FULL_PLANES = {
    # 3840x2160 -> 1366x768 tap 16, MPEG2 chroma: 16 row classes, 46 luma
    # and 22 chroma rows each (the benchmark's gather cell).
    "uhd-768p-luma": ((3840, 2160, 1366, 768, 16), False),
    "uhd-768p-chroma": ((3840, 2160, 1366, 768, 16), True),
    # 1920x1080 -> 3740x2104 tap 8: 256 row classes of 7 to 9 rows.
    "1080p-3740-luma": ((1920, 1080, 3740, 2104, 8), False),
    "1080p-3740-chroma": ((1920, 1080, 3740, 2104, 8), True),
}
STANDIN_PLANES = {
    # The gather cell's CPU stand-in, 384x216 -> 137x77: one row a class.
    "standin-luma": ((384, 216, 137, 77, 16), False),
    "standin-chroma": ((384, 216, 137, 77, 16), True),
}


def interior_rows(geo, chroma):
    """(start_y, cy_idx, start_x, fs) of a plane's interior rectangle, as
    ``build_plane_operator`` makes them, from its axis geometry."""
    from jincresize_tpu_torch.geometry import build_plane_geometry, chroma_crop
    from jincresize_tpu_torch.operator import _contiguous_border

    sw, sh, dw, dh, tap = geo
    crop = (0.0, 0.0, float(sw), float(sh))
    if chroma:
        crop = chroma_crop("mpeg2", sw, sh, dw, dh, *crop, 1, 1)
        sw, sh, dw, dh = sw >> 1, sh >> 1, dw >> 1, dh >> 1
    g = build_plane_geometry(sw, sh, dw, dh, radius_for_tap(tap), *crop, 256, 256, dists=False)
    y_lo, y_hi = _contiguous_border(g.y.border)
    x_lo, x_hi = _contiguous_border(g.x.border)
    cy = np.unique(g.y.qclass[y_lo:y_hi], return_inverse=True)[1].astype(np.int32)
    return g.y.start[y_lo:y_hi], cy, g.x.start[x_lo:x_hi], g.filter_size


@pytest.mark.parametrize("name", list(FULL_PLANES))
def test_row_groups_cover_the_interior_once_by_class(name):
    sy, cy, sx, fs = interior_rows(*FULL_PLANES[name])
    k = gather.group_size(cy)
    groups = gather.row_groups(cy, k)
    assert groups.dtype == np.int32 and groups.shape[1] == k
    rows = groups[groups >= 0]
    np.testing.assert_array_equal(np.sort(rows), np.arange(len(cy)))  # every row once
    sizes = (groups >= 0).sum(axis=1)
    assert sizes.min() >= 1 and sizes.max() <= k
    for g, n in zip(groups, sizes, strict=True):
        assert (g[:n] >= 0).all() and (g[n:] == -1).all()  # packed first
        assert len(set(cy[g[:n]].tolist())) == 1  # one class
        assert (np.diff(g[:n]) > 0).all()
    classes = cy[groups[:, 0]]
    assert (np.diff(classes) >= 0).all()  # class order
    for c in np.unique(classes):  # each class cut as evenly as it goes
        s = sizes[classes == c]
        assert s.max() - s.min() <= 1 and s.sum() == (cy == c).sum()
    assert gather.group_fits(gather.tile_span(sx, gather.GROUP_COLS, fs), k)


@pytest.mark.parametrize(
    "name,rows_a_class,k",
    [("uhd-768p-luma", 46, 16), ("uhd-768p-chroma", 22, 8), ("1080p-3740-luma", 9, 8),
     ("1080p-3740-chroma", 5, 4), ("standin-luma", 1, 1), ("standin-chroma", 1, 1)],
)  # fmt: skip
def test_group_size_follows_the_rows_a_class(name, rows_a_class, k):
    """K from the operator: 1 (the tile kernel) where no row class has two
    rows, as at the gather cell's stand-in; above 1 at full size, where the
    fewest slots weighed by their weight loads choose it: 46 luma rows a
    class fill three groups of 16 (two slots idle), 22 chroma rows three of
    8 rather than two of 16 (ten idle)."""
    _, cy, _, _ = interior_rows(*{**FULL_PLANES, **STANDIN_PLANES}[name])
    assert gather.class_rows(cy) == rows_a_class
    assert gather.group_size(cy) == k
    assert k == 1 or gather.row_groups(cy, k).shape[0] < len(cy)


@pytest.mark.parametrize(
    "rows,k,want",
    [([0] * 46, 8, [8, 8, 8, 8, 7, 7]), ([0] * 22, 8, [8, 7, 7]), ([0] * 3, 4, [3]),
     ([1, 0, 1, 0, 2], 4, [2, 2, 1])],
)  # fmt: skip
def test_row_groups_cut_each_class_evenly(rows, k, want):
    groups = gather.row_groups(np.asarray(rows, dtype=np.int32), k)
    assert (groups >= 0).sum(axis=1).tolist() == want


@pytest.mark.parametrize(
    "span_w,k,n_frames,want",
    [
        # The gather cell: 270 window columns a 64-column block.
        (270, 16, 1, gather.Ring(1, 272, 16, 17408)),
        (270, 16, 8, gather.Ring(2, 272, 16, 34816)),  # K x frames <= 32
        (270, 8, 8, gather.Ring(4, 272, 8, 34816)),
        (50, 4, 8, gather.Ring(8, 52, 4, 6656)),
        # Wide windows: fewer frames until the stage fits.
        (3000, 8, 8, gather.Ring(2, 3000, 8, 192000)),
        (3000, 16, 8, gather.Ring(1, 3000, 16, 192000)),
    ],
)
def test_group_ring(span_w, k, n_frames, want):
    ring = gather.group_ring(span_w, k, n_frames)
    assert ring == want and ring.smem_bytes <= gather.GROUP_SMEM_BYTES < fused.MAX_SMEM_BYTES
    assert gather.group_fits(span_w, k)
    assert not gather.group_fits(3700, 16) and gather.group_fits(3600, 16)


def test_make_takes_smaller_groups_where_the_ring_does_not_fit(deep_op):
    """A window too wide for K rows a stage takes a smaller K, down to the
    tile kernel."""
    gi = gather.make_gather_interior(deep_op)
    assert gi.group_rows == 4 and gi.groups.shape == (16, 4)
    wide = dataclasses.replace(deep_op, start_x=np.arange(deep_op.dst_width, dtype=np.int32) * 300)
    wide = dataclasses.replace(wide, src_width=int(wide.start_x.max()) + deep_op.filter_size)
    assert not gather.group_fits(gather.tile_span(wide.start_x[wide.x_lo : wide.x_hi],
                                                  gather.GROUP_COLS, wide.filter_size), 4)  # fmt: skip
    assert gather.make_gather_interior(wide).groups is None


def test_grouped_interior_on_the_cpu_is_the_plain_form(deep_op):
    """With row groups (K 4 at the fs-92 plane) the CPU wrapper still returns
    ``window_sum_plain`` bit for bit and launches nothing: neither launch
    count nor counter moves."""
    from jincresize_tpu_torch import metrics

    gi = gather.make_gather_interior(deep_op)
    assert gi.groups is not None
    src = torch.from_numpy(_src(deep_op, np.float32, seed=23, frames=3))
    launches = gather.gather_interior_tile.launches, gather.gather_interior_grouped.launches
    before = metrics.counters()
    got = gather.gather_interior(gi, src)
    after = metrics.counters()
    want = gather.window_sum_plain(src, gi.start_y, gi.cy_idx, gi.start_x, gi.cx_idx,
                                   gather.class_minor_view(gi.blocks))  # fmt: skip
    assert torch.equal(got, want)
    assert torch.equal(gather.gather_interior_tile(gi, src), want)
    assert torch.equal(gather.gather_interior_grouped(gi, src), want)
    assert after["gather_grouped_launches"] == before["gather_grouped_launches"]
    assert after["gather_launches"] == before["gather_launches"]
    assert (gather.gather_interior_tile.launches,
            gather.gather_interior_grouped.launches) == launches == (0, 0)  # fmt: skip
    with pytest.raises(ValueError, match="no row groups"):
        gather.gather_interior_grouped(dataclasses.replace(gi, groups=None), src)


@pytest.mark.parametrize(
    "k,grouped_frames", [(1, 0), (4, 2), (8, 4), (16, 8)]
)  # fmt: skip
def test_takes_grouped_while_twice_the_frames_are_at_most_k(deep_op, k, grouped_frames):
    """The grouped kernel takes launches of 2 F <= K frames and the tile
    kernel the rest; tables without row groups (K 1) always the tile one."""
    gi = gather.make_gather_interior(deep_op)
    if k == 1:
        gi = dataclasses.replace(gi, group_rows=1, groups=None, group_span=0)
    else:
        gi = dataclasses.replace(gi, group_rows=k)
    picks = [gather.takes_grouped(gi, f) for f in range(1, 17)]
    assert picks == [True] * grouped_frames + [False] * (16 - grouped_frames)


def test_resizer_logs_its_row_groups(caplog):
    """The ``resizer built:`` line gives each gather plane's rows a group
    and the rows a class that chose them."""
    import logging

    from jincresize_tpu_torch.api import JincConfig, JincResizer
    from jincresize_tpu_torch.clip import yuv420p

    cfg = JincConfig(target_width=171, target_height=96, tap=3, impl="gather", operator_cache=False)
    with caplog.at_level(logging.INFO, logger="jincresize_tpu_torch"):
        r = JincResizer(yuv420p(8), 480, 270, cfg, device="cpu")
    (luma, n_luma), (chroma, n_chroma) = (
        (a.gi, gather.class_rows(a.op.cy_idx[a.op.y_lo : a.op.y_hi]))
        for a in (r._applier_luma, r._applier_chroma)
    )
    assert luma.group_rows > 1 and chroma.group_rows > 1
    line = [m for m in caplog.messages if m.startswith("resizer built:")][-1]
    assert line.endswith(
        f"builds, gather luma {luma.group_rows} rows a group ({n_luma} a class), "
        f"gather chroma {chroma.group_rows} rows a group ({n_chroma} a class)"
    )


def test_grouped_kernel_is_built_and_bound():
    """The class-grouped kernel's C entry point is bound with eight pointers
    (the row groups after the dictionary), twelve sizes (the groups, K, the
    frames a thread and the staged row width among them) and the stream, the
    arguments ``gather_interior_grouped`` passes."""
    from jincresize_tpu_torch.kernels import _build

    assert _build._SIGNATURES["jt_gather_interior_grouped"] == (
        [_build._P] * 8 + [_build._I] * 12 + [_build._P]
    )
