"""Port's sharded engine on a CPU device list against ``jincresize_tpu.sharding``.

The JAX side runs on the 8 virtual CPU devices of ``tests/conftest.py``, its
Pallas kernels in interpret mode, as ``tests/test_sharding.py`` runs it; the
port's meshes are lists of ``torch.device('cpu')`` (devices may repeat), so
its kernel wrappers take their plain forms. Each side builds its operators
and clips with its own package's host layer. JAX outputs are shared through
module-scoped fixtures.

Tolerances: 2e-6 absolute port against JAX on fp32 sources in [0, 1) (exact
fp32 products on both sides, only the summation order differs); against the
golden, ``tests/test_sharding.py``'s own bounds: 1e-6 for the conv
interiors, 2e-5 for gather and seg, 4e-6 for the deep-tap conv (4225 taps a
pixel); <= 1 LSB for u8/u16 after ``finalize``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from jincresize_tpu import clip as jclip
from jincresize_tpu import operator as joperator
from jincresize_tpu_torch import api, sharding
from jincresize_tpu_torch.clip import Clip, random_frame, yuv420p
from jincresize_tpu_torch.golden import apply_plane_numpy
from jincresize_tpu_torch.kernels import gather
from jincresize_tpu_torch.operator import build_plane_operator, radius_for_tap


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
CPU = torch.device("cpu")

# tests/test_sharding.py's geometries (src_w, src_h, dst_w, dst_h, tap).
GEOMS = {
    "up-160x120": (96, 72, 160, 120, 3),
    "multihop-24": (128, 128, 24, 24, 4),
    "replicated-8": (256, 256, 8, 8, 4),
    "deep-multihop-16": (256, 256, 16, 16, 4),
    "two-row-192x144": (96, 72, 192, 144, 3),
    "tap16-80x56": (240, 168, 80, 56, 16),
    "conv-2x-tap8": (128, 96, 256, 192, 8),
    "seg-960x540": (640, 360, 960, 540, 8),
    "seg-exceptions": (1920, 80, 4800, 200, 2),
    "deep-tap-conv": (480, 270, 240, 135, 16),
    # Not in tests/test_sharding.py: a small aperiodic deep-tap plane (fs 92,
    # 16 x 62 classes), the 2.8125 row ratio of 3840x2160 -> 1366x768 tap 16.
    "deep-gather-171x96": (480, 270, 171, 96, 16),
    # Nor this: a border-only operator (no dictionary, no interior), which
    # both packages run on the scan-gather.
    "border-only-16x16": (8, 8, 16, 16, 8),
}

# (case, geometry, impl, n_rows, interior): one case per interior, on the
# meshes of tests/test_sharding.py.
CASES = [
    ("gather", "up-160x120", "gather", 8, "gather"),
    ("gather-scan", "border-only-16x16", "gather", 8, "gather-scan"),
    ("gather-deep", "tap16-80x56", "gather", 8, "gather"),
    ("conv", "conv-2x-tap8", "conv", 8, "conv-fused"),
    ("seg", "seg-960x540", "seg", 4, "seg"),
    ("seg-exceptions", "seg-exceptions", "seg", 2, "seg"),
]
CASE_IDS = [c[0] for c in CASES]
# Golden bounds of tests/test_sharding.py, by interior.
GOLDEN_TOL = {"conv-fused": 1e-6, "seg": 2e-5, "gather": 2e-5, "gather-scan": 2e-5}
DEEP_TOL = 4e-6

# Where the port's routing differs from the JAX package's (ROADMAP queue 3):
# (geometry, impl, n_rows) -> (JAX interior, port interior). Deep taps route
# as in the JAX package: both run the fused kernel on the shards.
ROUTING_DIFFERS = {
    # The Pallas fused envelope declines the shifted local plan, the CUDA
    # kernel's (shared memory of the weights) takes it.
    ("up-160x120", "auto", 2): ("conv-shift", "conv-fused"),
    ("up-160x120", "conv", 2): ("conv-shift", "conv-fused"),
    # The JAX seg interior needs each device to hold a whole TPU row tile
    # (td >= tmo) and its Mosaic layout; the port's needs a one-neighbour
    # halo and its shared-memory window only.
    ("up-160x120", "auto", 4): ("gather", "seg"),
    ("up-160x120", "auto", 8): ("gather", "seg"),
    ("up-160x120", "seg", 4): (None, "seg"),
    ("up-160x120", "seg", 8): (None, "seg"),
    ("two-row-192x144", "seg", 8): (None, "seg"),
    ("seg-exceptions", "auto", 8): ("gather", "seg"),
    ("seg-exceptions", "seg", 8): (None, "seg"),
    ("conv-2x-tap8", "auto", 1): ("gather", "seg"),
    ("conv-2x-tap8", "seg", 1): (None, "seg"),
    ("conv-2x-tap8", "seg", 2): (None, "seg"),
    ("conv-2x-tap8", "seg", 4): (None, "seg"),
    ("conv-2x-tap8", "seg", 8): (None, "seg"),
}
# The port's band kernel takes any filter size (its window streams through
# a ring of source rows); the JAX package's declines fs**2 > 1200 and takes
# the scan-gather. On 2 rows the 2x tap-16 downscale runs the fused kernel
# on both sides.
ROUTING_DIFFERS.update(
    {
        (geom, impl, n): ("gather-scan", "gather")
        for geom in ("multihop-24", "deep-multihop-16", "tap16-80x56", "deep-tap-conv",
                     "deep-gather-171x96")
        for impl in ("auto", "gather")
        for n in (1, 2, 4, 8)
        if (geom, impl, n) != ("deep-tap-conv", "auto", 2)
    }
)

# The port's seg kernel takes any filter size whose largest tile's pair
# blocks fit the shared memory; the JAX package's declines fs**2 > 1200. So
# deep-tap plans whose shards the fused kernel declines take seg where JAX
# takes the scan-gather (auto) or raises (seg).
ROUTING_DIFFERS.update(
    {
        (geom, impl, n): ({"auto": "gather-scan", "seg": None}[impl], "seg")
        for geom, impl, rows in (
            ("deep-multihop-16", "auto", (1, 2)),
            ("deep-multihop-16", "seg", (1, 2)),
            ("tap16-80x56", "auto", (1, 2)),
            ("tap16-80x56", "seg", (1, 2)),
            ("deep-tap-conv", "auto", (1, 4, 8)),
            ("deep-tap-conv", "seg", (1, 2, 4, 8)),
        )
        for n in rows
    }
)


def _op(name):
    sw, sh, dw, dh, tap = GEOMS[name]
    return build_plane_operator(sw, sh, dw, dh, radius_for_tap(tap))


def _jop(name):
    """The JAX package's operator of the same geometry, from its own host layer."""
    sw, sh, dw, dh, tap = GEOMS[name]
    return joperator.build_plane_operator(sw, sh, dw, dh, joperator.radius_for_tap(tap))


def _jclip(clip):
    """The port's ``clip`` as a JAX package Clip over the same arrays."""
    fmt = jclip.VideoFormat(**dataclasses.asdict(clip.format))
    return jclip.Clip.from_frames(
        [jclip.Frame(fmt, dict(f.planes), dict(f.props)) for f in clip.frames]
    )


def _src(op, seed, frames=None):
    shape = (op.src_height, op.src_width)
    if frames is not None:
        shape = (frames,) + shape
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


def _mesh(n_rows, n_data=1):
    return sharding.make_mesh(n_rows=n_rows, n_data=n_data, devices=[CPU] * (n_rows * n_data))


def _jax_mesh(n_rows, n_data=1):
    from jincresize_tpu.sharding import make_mesh

    return make_mesh(n_rows=n_rows, n_data=n_data)


@pytest.fixture(scope="module")
def ops():
    return {name: _op(name) for name in GEOMS}


@pytest.fixture(scope="module")
def jops():
    return {name: _jop(name) for name in GEOMS}


@pytest.fixture(scope="module")
def jax_outputs(jops):
    """JAX ``make_sharded_apply`` on every case: (interior, fp32 output)."""
    from jincresize_tpu.sharding import make_sharded_apply

    out = {}
    for case, geom, impl, n, _ in CASES:
        op = jops[geom]
        fn, _ = make_sharded_apply(op, _jax_mesh(n), impl=impl)
        out[case] = (fn.info["interior"], np.asarray(fn(_src(op, 11))))
    return out


# ---------------------------------------------------------------- host copies


@pytest.mark.parametrize("name", list(GEOMS)[:5])
def test_plan_copies_equal_jax(ops, jops, name):
    from jincresize_tpu import sharding as jsh

    op, jop = ops[name], jops[name]
    for n in (1, 2, 4, 8):
        got, want = sharding.plan_row_shard(op, n), jsh.plan_row_shard(jop, n)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), n
    blocks, bid = sharding.build_uniform(op)
    jblocks, jbid = jsh.build_uniform(jop)
    np.testing.assert_array_equal(blocks, jblocks)
    np.testing.assert_array_equal(bid, jbid)
    assert blocks.dtype == jblocks.dtype and bid.dtype == jbid.dtype


def test_shard_plan_fields_equal_jax():
    from jincresize_tpu import sharding as jsh

    assert [f.name for f in dataclasses.fields(sharding.ShardPlan)] == [
        f.name for f in dataclasses.fields(jsh.ShardPlan)
    ]


# ---------------------------------------------------------------- mesh, halos


def test_make_mesh_grid_and_errors():
    m = _mesh(4, 2)
    assert (m.n_data, m.n_rows) == (2, 4)
    assert all(d == CPU for row in m.devices for d in row)
    assert sharding.make_mesh(device_type="cpu").devices == ((CPU,),)
    with pytest.raises(ValueError, match="need that many devices"):
        sharding.make_mesh(n_rows=4, devices=[CPU] * 3)
    with pytest.raises(ValueError, match="grid"):
        sharding.RowMesh(((CPU, CPU), (CPU,)))


def test_default_cuda_mesh_needs_a_card(monkeypatch):
    """No CPU mesh in place of a missing card."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sharding.make_mesh()
    clip = Clip.from_frames([random_frame(yuv420p(8), 32, 24, seed=1)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.jinc_resize(clip, 64, 48, impl="sharded", device="cuda")


@pytest.mark.parametrize("halo", [(3, 5), (9, 0), (20, 13)], ids=["one-hop", "up-only", "multi-hop"])
def test_collect_band_slices_the_padded_source(halo):
    """A band is the padded source rows [d*ts - hu, (d+1)*ts + hd), zeros
    beyond the mesh, whatever the number of hops."""
    hu, hd = halo
    n, ts, W = 5, 8, 6
    src = torch.arange(2 * n * ts * W, dtype=torch.float32).reshape(2, n * ts, W) + 1
    parts = [src[:, d * ts : (d + 1) * ts] for d in range(n)]
    padded = torch.nn.functional.pad(src, (0, 0, hu, hd))
    for d in range(n):
        band = sharding.collect_band(parts, d, hu, hd, replicate=False)
        assert torch.equal(band, padded[:, d * ts : (d + 1) * ts + hu + hd])
    assert torch.equal(sharding.collect_band(parts, 2, hu, hd, replicate=True), src)


# ---------------------------------------------------------------- band kernel


@pytest.mark.parametrize("d", [0, 7])
def test_gather_band_plain_matches_pallas_interpret(ops, jops, d):
    """One device's band of 96x72 -> 160x120 tap 3 on 8 rows: the port's
    plain form against ``pallas_gather.make_gather_band(interpret=True)`` with
    the tables ``sharding.make_sharded_apply_gather`` gives it."""
    import jax.numpy as jnp

    from jincresize_tpu.kernels import pallas_gather

    op = ops["up-160x120"]
    n = 8
    plan = sharding.plan_row_shard(op, n)
    fs, td, ts = op.filter_size, plan.dst_rows_per, plan.src_rows_per
    hu, hd = plan.halo_up, plan.halo_dn
    rows = np.minimum(np.arange(n * td), op.dst_height - 1)
    sy_loc = op.start_y.astype(np.int64)[rows].reshape(n, td) - (
        np.arange(n)[:, None] * ts - hu
    )
    cy = np.clip(op.cy_idx[rows].astype(np.int64), 0, op.pair_blocks.shape[0] - 1).reshape(n, td)
    band_h = ts + hu + hd
    src = np.pad(_src(op, 5, frames=1), ((0, 0), (hu, n * ts - op.src_height + hd), (0, 0)))
    band = src[:, d * ts : d * ts + band_h]

    jop = jops["up-160x120"]
    kfn, meta = pallas_gather.make_gather_band(jop, sy_loc, band_h, interpret=True)
    tm, nb = meta["tm"], meta["nb"]
    pad = meta["n_rows_pad"] - td
    syl_p = np.concatenate([sy_loc[d], np.repeat(sy_loc[d, -1:], pad)])
    cy_p = np.concatenate([cy[d], np.repeat(cy[d, -1:], pad)])
    y0 = np.array([syl_p[b * tm : (b + 1) * tm].min() for b in range(nb)])
    expand, wt, _, _ = pallas_gather.expand_weight_planes(jop)
    want = np.asarray(
        kfn(
            jnp.asarray(band[0]),
            jnp.asarray((syl_p - np.repeat(y0, tm)).astype(np.int32)),
            jnp.asarray(cy_p.astype(np.int32)),
            jnp.asarray(y0.astype(np.int32)),
            expand(wt),
        )
    )[:td, : meta["nxi"]]

    r0, r1 = d * td, min((d + 1) * td, op.dst_height)
    gb = gather.make_gather_band(
        op, sy_loc[d, : r1 - r0], cy[d, : r1 - r0], band_h, gather.padded_blocks(op.pair_blocks, CPU)
    )
    canvas = torch.full((1, r1 - r0, op.dst_width), 7.0)
    got = gather.gather_band(gb, torch.from_numpy(band), canvas)
    assert got is canvas
    interior = got[0, :, op.x_lo : op.x_hi].numpy()
    assert interior.shape == want[: r1 - r0].shape
    assert np.abs(interior - want[: r1 - r0]).max() <= F32_TOL
    outside = torch.cat([got[0, :, : op.x_lo], got[0, :, op.x_hi :]], dim=1)
    assert torch.all(outside == 7.0)  # only the interior columns are written


def test_make_gather_band_checks_windows(ops):
    op = ops["up-160x120"]
    pbt = gather.padded_blocks(op.pair_blocks, CPU)
    syl = np.array([0, 3, 4])
    with pytest.raises(ValueError, match="leave the source axis"):
        gather.make_gather_band(op, syl, np.zeros(3, np.int64), 4 + op.filter_size - 1, pbt)
    with pytest.raises(ValueError, match="row classes"):
        gather.make_gather_band(op, syl, np.full(3, 99), 64, pbt)


def test_gather_band_never_falls_back_off_cpu(ops):
    op = ops["up-160x120"]
    gb = gather.make_gather_band(
        op, np.zeros(2, np.int64), np.zeros(2, np.int64), 16, gather.padded_blocks(op.pair_blocks, CPU)
    )
    band = torch.zeros((1, 16, op.src_width), device="meta")
    with pytest.raises(RuntimeError, match="unsupported device"):
        gather.gather_band(gb, band, torch.zeros((1, 2, op.dst_width), device="meta"))


# ---------------------------------------------------------------- sharded apply


@pytest.fixture(scope="module")
def goldens(ops):
    """Host golden of each case's geometry on two frames of ``_src(op, 3)``."""
    out = {}
    for _, geom, _, _, _ in CASES:
        src = _src(ops[geom], 3, frames=2)
        out[geom] = (src, np.stack([apply_plane_numpy(ops[geom], s) for s in src]))
    return out


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_sharded_apply_matches_jax(ops, jax_outputs, case):
    name, geom, impl, n, interior = case
    op = ops[geom]
    fn, plan = sharding.make_sharded_apply(op, _mesh(n), impl=impl)
    jax_interior, want = jax_outputs[name]
    assert fn.info["interior"] == interior
    assert ROUTING_DIFFERS.get((geom, impl, n), (interior,))[0] == jax_interior
    got = fn(torch.from_numpy(_src(op, 11))).numpy()
    assert got.shape == want.shape == (op.dst_height, op.dst_width)
    assert np.abs(got - want).max() <= (DEEP_TOL if op.filter_size**2 > 1200 else F32_TOL)


@pytest.mark.parametrize("n", [1, 2, 4, 8, "2x4"])
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_sharded_apply_matches_golden(ops, goldens, case, n):
    """Every interior on 1, 2, 4 and 8 row shards and a 2 x 4 data x rows
    mesh (frames over the data rows) against the host golden. Meshes where
    an interior declines take the interior that ``auto`` would."""
    _, geom, impl, _, _ = case
    op = ops[geom]
    frames = 2 if n == "2x4" else 1
    mesh = _mesh(4, 2) if n == "2x4" else _mesh(n)
    try:
        fn, _ = sharding.make_sharded_apply(op, mesh, data_axis="data", impl=impl)
    except ValueError as e:
        assert "not eligible" in str(e)
        fn, _ = sharding.make_sharded_apply(op, mesh, data_axis="data")
    src, ref = goldens[geom]
    got = fn(torch.from_numpy(src[:frames])).numpy()
    tol = GOLDEN_TOL[fn.info["interior"]]
    assert np.abs(got - ref[:frames]).max() <= tol, fn.info["interior"]


def test_deep_tap_conv_shift_matches_golden(ops):
    """Deep taps (fs**2 > 1200) run the fused kernel on every shard
    (``conv-fused``; there is no ``conv-shift`` interior): tap-16 2x (fs 65)
    and 2/3 (fs 49) downscales on 2 rows against the golden, and at twice
    the size (each shard holds fs rows) on 4 rows against the single-device
    fused applier, at the JAX deep-tap bound."""
    from jincresize_tpu_torch.apply_conv import ConvApplier

    for op in (ops["deep-tap-conv"], build_plane_operator(480, 270, 320, 180, radius_for_tap(16))):
        ap = sharding.ShardedApplier(op, _mesh(2))
        assert ap.interior == "conv-fused" and ap.effective_precision == "fp32"
        src = _src(op, 5)
        out = ap(torch.from_numpy(src)).numpy()
        assert np.abs(out - apply_plane_numpy(op, src)).max() <= DEEP_TOL
    for dw, dh in ((480, 270), (640, 360)):
        op = build_plane_operator(960, 540, dw, dh, radius_for_tap(16))
        ap = sharding.ShardedApplier(op, _mesh(4), precision="fp32_u8src")
        assert ap.interior == "conv-fused" and ap.effective_precision == "fp32_u8src"
        src = torch.from_numpy(_src(op, 6))
        assert float((ap(src) - ConvApplier(op, device="cpu")(src)).abs().max()) <= DEEP_TOL


def test_sharded_seg_takes_deep_drifted_plans():
    """The drifted tap-16 downscale (fs 44; 1440p -> 1080p at a quarter
    size) runs the seg kernel on 2 and 4 row shards under auto, against the
    single-device seg applier at the deep-tap bound and the float32 golden
    at 1e-5 (its own drift over 1936 taps, tests/test_torch_seg.py)."""
    from jincresize_tpu_torch.apply_conv_seg import SegConvApplier

    op = build_plane_operator(640, 360, 480, 270, radius_for_tap(16))
    src = _src(op, 7, frames=1)
    single = SegConvApplier(op, device="cpu")(torch.from_numpy(src)).numpy()
    golden = apply_plane_numpy(op, src[0])
    for n in (2, 4):
        ap = sharding.ShardedApplier(op, _mesh(n))
        assert ap.interior == "seg", n
        out = ap(torch.from_numpy(src)).numpy()
        assert np.abs(out - single).max() <= DEEP_TOL, n
        assert np.abs(out[0] - golden).max() <= 1e-5, n


@pytest.mark.parametrize("name", list(GEOMS))
def test_routing_matches_jax(ops, jops, name):
    """``info['interior']`` equals the JAX package's for every impl on 1, 2,
    4 and 8 row shards, except where ROADMAP records a difference."""
    from jincresize_tpu.sharding import make_sharded_apply as jax_make

    op = ops[name]
    for n in (1, 2, 4, 8):
        for impl in ("auto", "conv", "seg", "gather"):
            try:
                want = jax_make(jops[name], _jax_mesh(n), impl=impl)[0].info["interior"]
            except ValueError:
                want = None
            try:
                got = sharding.make_sharded_apply(op, _mesh(n), impl=impl)[0].info["interior"]
            except ValueError:
                got = None
            assert ROUTING_DIFFERS.get((name, impl, n), (want, want)) == (want, got), (impl, n)


def test_replicated_and_multihop_plans(ops):
    """The replicated partition runs the scan-gather (its operator has no
    dictionary), which every shard computes from its collected band. The
    multi-hop deep-tap plan (fs 136) runs the scan-gather where it is asked
    for, and the band kernel under auto: the band kernel takes any filter
    size, where the JAX package's takes the scan-gather (``ROUTING_DIFFERS``)."""
    op = ops["replicated-8"]
    fn, plan = sharding.make_sharded_apply(op, _mesh(8))
    assert plan.replicate_src and fn.info == {
        "interior": "gather-scan",
        "replicate_src": True,
        "hops": (plan.hops_up, plan.hops_dn),
    }
    src = _src(op, 5)
    assert np.abs(fn(torch.from_numpy(src)).numpy() - apply_plane_numpy(op, src)).max() <= 1e-6
    op = ops["deep-multihop-16"]
    golden = apply_plane_numpy(op, src)
    fn, plan = sharding.make_sharded_apply_scan(op, _mesh(8))
    assert not plan.replicate_src and min(fn.info["hops"]) >= 2
    assert fn.info["interior"] == "gather-scan"
    assert np.abs(fn(torch.from_numpy(src)).numpy() - golden).max() <= 1e-6
    fn, plan = sharding.make_sharded_apply(op, _mesh(8))
    assert min(fn.info["hops"]) >= 2 and fn.info["interior"] == "gather"
    assert np.abs(fn(torch.from_numpy(src)).numpy() - golden).max() <= GOLDEN_TOL["gather"]


@pytest.fixture(scope="module")
def deep_gather_golden(ops):
    op = ops["deep-gather-171x96"]
    src = _src(op, 7)
    return src, apply_plane_numpy(op, src)


@pytest.mark.parametrize("n", [2, 4])
def test_deep_aperiodic_plane_takes_the_band_kernel(ops, jops, deep_gather_golden, n):
    """The fs-92 aperiodic plane on 2 and 4 row shards through
    ``sharded/gather`` (the band kernel's plain form here) against the host
    golden, where the JAX package takes the scan-gather."""
    from jincresize_tpu.sharding import make_sharded_apply as jax_make

    name = "deep-gather-171x96"
    op = ops[name]
    assert op.filter_size == 92 and gather.is_supported(op)
    fn, _ = sharding.make_sharded_apply(op, _mesh(n))
    assert fn.info["interior"] == "gather"
    jax_interior = jax_make(jops[name], _jax_mesh(n))[0].info["interior"]
    assert ROUTING_DIFFERS[name, "auto", n] == (jax_interior, "gather") == ("gather-scan", "gather")
    src, golden = deep_gather_golden
    got = fn(torch.from_numpy(src)).numpy()
    assert np.abs(got - golden).max() <= GOLDEN_TOL["gather"]


@pytest.mark.parametrize(
    "geom,hops,replicated",
    [((128, 96, 21, 16, 2), (2, 2), False), ((64, 48, 10, 8, 2), (4, 4), True)],
    ids=["multi-hop", "replicated"],
)
def test_band_engine_on_deep_halos(geom, hops, replicated):
    """The band kernel's engine on 8 rows where the halo spans two shards
    each way, and where every shard holds the whole source (the band cases
    ``chip_smoke.py`` runs on the card)."""
    sw, sh, dw, dh, tap = geom
    op = build_plane_operator(sw, sh, dw, dh, radius_for_tap(tap))
    fn, plan = sharding.make_sharded_apply(op, _mesh(8), impl="gather")
    assert fn.info["interior"] == "gather"
    assert (plan.hops_up, plan.hops_dn) == hops and plan.replicate_src == replicated
    src = _src(op, 9, frames=2)
    got = fn(torch.from_numpy(src)).numpy()
    for f in range(2):
        assert np.abs(got[f] - apply_plane_numpy(op, src[f])).max() <= 2e-5


def test_forced_interiors_raise_with_jax_messages(ops):
    op = ops["tap16-80x56"]
    with pytest.raises(ValueError, match="sharded conv path: geometry not eligible"):
        sharding.make_sharded_apply(op, _mesh(8), impl="conv")
    with pytest.raises(ValueError, match="sharded seg path: geometry not eligible"):
        sharding.make_sharded_apply(op, _mesh(8), impl="seg")
    with pytest.raises(ValueError, match="unknown impl"):
        sharding.make_sharded_apply(op, _mesh(8), impl="xla")
    # 'bf16' runs (it raised before it was ported; tests/test_torch_bf16.py
    # holds its numbers) and is reported.
    fn, _ = sharding.make_sharded_apply(
        ops["conv-2x-tap8"], _mesh(8), impl="conv", precision="bf16"
    )
    assert (fn.info["interior"], fn.info["precision"]) == ("conv-fused", "bf16")


# ---------------------------------------------------------------- applier, API


def test_sharded_applier_u8_u16_batched(ops):
    """u8 batch of 3 frames on a 2 x 4 mesh (padded to 4 on the data axis)
    and a u16 frame, <= 1 LSB against the golden."""
    op = ops["up-160x120"]
    ap = sharding.ShardedApplier(op, _mesh(4, 2))
    assert ap.interior == ap.info["interior"] == "seg"
    assert ap.effective_precision == "fp32"
    rng = np.random.default_rng(5)
    src8 = rng.integers(0, 256, (3, 72, 96)).astype(np.uint8)
    out8 = ap(torch.from_numpy(src8), out_dtype=np.uint8, peak=255.0)
    assert out8.dtype == torch.uint8 and tuple(out8.shape) == (3, 120, 160)
    for f in range(3):
        ref = apply_plane_numpy(op, src8[f], out_dtype=np.uint8, peak=255)
        assert np.abs(out8[f].numpy().astype(int) - ref.astype(int)).max() <= 1
    src16 = rng.integers(0, 65536, (72, 96)).astype(np.uint16)
    out16 = ap(torch.from_numpy(src16.astype(np.int32)), out_dtype=np.uint16, peak=65535.0)
    ref16 = apply_plane_numpy(op, src16, out_dtype=np.uint16, peak=65535)
    assert out16.dtype == torch.uint16
    assert np.abs(out16.numpy().astype(int) - ref16.astype(int)).max() <= 1


def test_sharded_applier_float_clamp(ops):
    op = ops["up-160x120"]
    ap = sharding.ShardedApplier(op, _mesh(8), impl="gather")
    src = (np.random.default_rng(6).random((72, 96), dtype=np.float32) - 0.5) * 2.0
    out = ap(torch.from_numpy(src), float_clamp_min=0.0).numpy()
    ref = apply_plane_numpy(op, src, float_clamp_min=0.0)
    assert np.abs(out - ref).max() <= 2e-5


@pytest.mark.parametrize("impl", ["sharded", "auto"])
def test_resizer_on_mesh_matches_jax(impl):
    """JincResizer on an 8-row CPU mesh against the JAX resizer on its 8
    virtual devices: the same engines, <= 1 LSB on yuv420p8."""
    from jincresize_tpu import api as japi

    clip = Clip.from_frames([random_frame(yuv420p(8), 96, 72, seed=s) for s in (1, 2)])
    cfg = api.JincConfig(target_width=192, target_height=144, impl=impl)
    r = api.JincResizer(clip.format, 96, 72, cfg, frame0=clip.frames[0], device="cpu", mesh=_mesh(8))
    jcfg = japi.JincConfig(target_width=192, target_height=144, impl=impl)
    jc = _jclip(clip)
    jr = japi.JincResizer(jc.format, 96, 72, jcfg, frame0=jc.frames[0], mesh=_jax_mesh(8))
    assert r.engines == jr.engines == {"luma": "sharded/conv-fused", "chroma": "sharded/gather"}
    got, want = r(clip), jr(jc)
    for fg, fw in zip(got.frames, want.frames):
        fg.validate()
        assert fg.props == fw.props
        for n in clip.format.plane_names:
            assert np.abs(fg.planes[n].astype(int) - fw.planes[n].astype(int)).max() <= 1, n
    one = api.jinc_resize(clip, 192, 144, device="cpu", mesh=_mesh(8), impl=impl)
    for fa, fb in zip(one.frames, got.frames):
        for n in clip.format.plane_names:
            np.testing.assert_array_equal(fa.planes[n], fb.planes[n])


def test_mesh_with_other_impl_raises():
    from jincresize_tpu import api as japi

    clip = Clip.from_frames([random_frame(yuv420p(8), 32, 24, seed=1)])
    with pytest.raises(japi.JincError) as je:
        japi.jinc_resize(_jclip(clip), 64, 48, impl="xla", mesh=_jax_mesh(2))
    with pytest.raises(api.JincError) as te:
        api.jinc_resize(clip, 64, 48, impl="xla", device="cpu", mesh=_mesh(2))
    assert str(te.value) == str(je.value)
