"""``precision='bf16'`` in the port (plain forms on the CPU).

On the TPU the JAX package's fused and seg interiors run their dots at
DEFAULT precision for ``precision='bf16'``: the MXU rounds both operands to
bfloat16, multiplies exactly and sums in fp32. Off the TPU the JAX package
runs the mode as fp32 math (its ``shift`` interior), so JAX on the CPU is no
oracle for the bf16 numbers. The oracle here is the JAX package's own Pallas
kernels in interpret mode at HIGHEST, fed ``dataclasses.replace(jop,
pair_blocks=<rounded>)`` and a rounded source: rounded with
``ml_dtypes.bfloat16`` on the JAX side and ``torch.bfloat16`` on the port's,
and the rounded arrays are asserted bitwise equal.

Tolerances:

* 2e-6 absolute against that oracle on sources in [0, 1) (both sides take
  exact products of the same rounded operands; only the summation order
  differs), 4e-6 for fs**2 > 1200, as the fp32 modes' tests;
* against the fp32 golden, the analytic bound of the rounding
  (``kernels.fused.bf16_bound`` / ``bf16_lsb``): per plane
  ``(2u + u**2) * max_px sum|w| * max|src| + 2e-6`` with ``u = 2**-8``, the
  unit roundoff of bfloat16 (8 significand bits), ``sum|w|`` over the
  largest class-pair block; for integer formats ``floor(bound * peak) + 1``
  LSB with the bound at ``max|src| = 1``;
* pixels that no bf16 interior writes (strips, exception rows and columns,
  sharded patches) equal the fp32 mode's bit for bit: they stay fp32.
"""

import dataclasses

import ml_dtypes
import numpy as np
import pytest
import torch

from jincresize_tpu import operator as joperator
from jincresize_tpu import phase as jphase
from jincresize_tpu_torch import api, bench, cli, sharding
from jincresize_tpu_torch.apply_conv import ConvApplier
from jincresize_tpu_torch.apply_conv_seg import SegConvApplier
from jincresize_tpu_torch.clip import Clip, random_frame, yuv420p
from jincresize_tpu_torch.kernels import fused, seg
from jincresize_tpu_torch.operator import build_plane_operator, radius_for_tap
from jincresize_tpu_torch.phase import plan_phases, plan_phases_seg


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
DEEP_TOL = 4e-6

# Periodic planes (the fused interior): tests/test_torch_kernels.py's 2x
# tap-8, tap-3 downscale and 2/3 tap-4 planes, and a 2x tap-16 downscale
# with fs**2 > 1200 (fs 65).
FUSED_GEOMS = {
    "2x-tap8": (64, 48, 128, 96, 8),
    "down-tap3": (96, 60, 64, 40, 3),
    "2/3-tap4": (90, 60, 60, 40, 4),
    "deep-fs65": (160, 120, 80, 60, 16),
}
# Segment-periodic planes (the seg interior): a 1.5x tap-3, a 3x tap-2 and a
# 1.5x tap-8 upscale.
SEG_GEOMS = {
    "1.5x-tap3": (64, 48, 96, 72, 3),
    "3x-tap2": (96, 64, 288, 192, 2),
    "1.5x-tap8": (96, 64, 144, 96, 8),
}


def _op(g):
    sw, sh, dw, dh, tap = g
    return build_plane_operator(sw, sh, dw, dh, radius_for_tap(tap))


def _jop(g):
    sw, sh, dw, dh, tap = g
    return joperator.build_plane_operator(sw, sh, dw, dh, joperator.radius_for_tap(tap))


def _r16(a):
    """``a`` rounded to bfloat16 by ml_dtypes (ties to even), as float32."""
    return np.asarray(a, np.float32).astype(ml_dtypes.bfloat16).astype(np.float32)


def _bits_equal(a, b):
    a, b = np.ascontiguousarray(a, np.float32), np.ascontiguousarray(b, np.float32)
    return a.shape == b.shape and np.array_equal(a.view(np.uint32), b.view(np.uint32))


def _tol(op):
    return DEEP_TOL if op.filter_size**2 > fused.FS2_MAX else F32_TOL


def _src(op, seed, frames=1):
    return np.random.default_rng(seed).random((frames, op.src_height, op.src_width), np.float32)


@pytest.fixture(scope="module")
def oracles():
    """The JAX Pallas interiors (interpret, HIGHEST) on rounded operands:
    {name: (src, rounded src, rounded JAX pair blocks, interior)}."""
    import jax.numpy as jnp

    from jincresize_tpu.kernels.pallas_fused import make_fused_interior
    from jincresize_tpu.kernels.pallas_fused_seg import make_seg_interior

    out = {}
    for name, g in FUSED_GEOMS.items():
        jop = _jop(g)
        jr = dataclasses.replace(jop, pair_blocks=_r16(jop.pair_blocks))
        src = _src(jop, seed=11)
        want = make_fused_interior(jr, jphase.plan_phases(jop), interpret=True)(
            jnp.asarray(_r16(src[0]))
        )
        out[name] = (src, _r16(src), jr.pair_blocks, np.asarray(want)[None])
    for name, g in SEG_GEOMS.items():
        jop = _jop(g)
        jr = dataclasses.replace(jop, pair_blocks=_r16(jop.pair_blocks))
        src = _src(jop, seed=12)
        fn = make_seg_interior(jr, jphase.plan_phases_seg(jop), interpret=True)
        want = fn(jnp.asarray(_r16(src[0])), fn.params)
        out[name] = (src, _r16(src), jr.pair_blocks, np.asarray(want)[None])
    return out


def test_rounding_is_ml_dtypes_rounding():
    """torch.bfloat16 and ml_dtypes.bfloat16 round alike, ties to even:
    halfway cases, both signs, subnormals and the largest finite floats."""
    rng = np.random.default_rng(0)
    ties = np.array([1 + 2**-8, 1 + 3 * 2**-8, -(1 + 2**-8), 2**-130 * (1 + 2**-8),
                     np.finfo(np.float32).max, 0.0, -0.0], np.float32)  # fmt: skip
    x = np.concatenate([rng.standard_normal(4096).astype(np.float32), ties,
                        rng.random(512, np.float32) * 1e-38])  # fmt: skip
    got = fused.round_bf16(torch.from_numpy(x)).numpy()
    assert _bits_equal(got, _r16(x))
    assert got[4096] == 1.0 and got[4097] == 1 + 2**-6  # ties go to the even neighbour


@pytest.mark.parametrize("name", list(FUSED_GEOMS))
def test_fused_bf16_plain_matches_pallas_on_rounded_operands(name, oracles):
    g = FUSED_GEOMS[name]
    src, src16, jblocks, want = oracles[name]
    op = _op(g)
    plan = plan_phases(op)
    fi = fused.make_fused_interior(op, plan, precision="bf16")
    assert fi.bf16 and not fused.make_fused_interior(op, plan).bf16
    # The same rounded operands on both sides, bit for bit.
    assert _bits_equal(fi.kernels.numpy(), jphase.build_conv_kernels(
        dataclasses.replace(_jop(g), pair_blocks=jblocks), jphase.plan_phases(_jop(g)))[:, 0])
    assert _bits_equal(fused.round_bf16(torch.from_numpy(src)).numpy(), src16)
    got = fused.fused_interior(fi, torch.from_numpy(src)).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= _tol(op)
    # The mode rounds: it differs from fp32, within the analytic bound.
    f32 = fused.fused_interior(fused.make_fused_interior(op, plan), torch.from_numpy(src)).numpy()
    assert 0 < np.abs(got - f32).max() <= fused.bf16_bound(op)


@pytest.mark.parametrize("name", list(SEG_GEOMS))
def test_seg_bf16_plain_matches_pallas_on_rounded_operands(name, oracles):
    g = SEG_GEOMS[name]
    src, src16, jblocks, want = oracles[name]
    op = _op(g)
    plan = plan_phases_seg(op)
    si = seg.make_seg_interior(op, plan, precision="bf16")
    assert si.bf16 and si.blocks.shape[3] % 4 == 0
    assert _bits_equal(si.blocks[..., : op.filter_size].numpy(), jblocks)
    got = seg.seg_interior(si, torch.from_numpy(src)).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= F32_TOL
    f32 = seg.seg_interior(seg.make_seg_interior(op, plan), torch.from_numpy(src)).numpy()
    assert 0 < np.abs(got - f32).max() <= fused.bf16_bound(op)
    # The staged layout does not change with the mode.
    si32 = seg.make_seg_interior(op, plan)
    assert (si.pairs, si.win_h, si.win_w, si.frames_per_block) == (
        si32.pairs, si32.win_h, si32.win_w, si32.frames_per_block)


def _interior_mask(op, rect, exc_y, exc_x):
    """The pixels a bf16 interior owns: its rectangle, less the exception
    rows and columns and every border strip."""
    m = np.zeros((op.dst_height, op.dst_width), bool)
    y0, y1, x0, x1 = rect
    m[y0:y1, x0:x1] = True
    m[np.asarray(exc_y, np.int64)] = False
    m[:, np.asarray(exc_x, np.int64)] = False
    for s in op.strips:
        m[s.y0 : s.y1, s.x0 : s.x1] = False
    return m, (y0, x0)


def _conv_mask(op):
    plan = plan_phases(op)
    y, x = plan.y, plan.x
    rect = (y.lo, y.lo + y.p * y.nblocks, x.lo, x.lo + x.p * x.nblocks)
    return _interior_mask(op, rect, y.exceptions, x.exceptions)


def _seg_mask(op):
    plan = plan_phases_seg(op)
    rect = (plan.y.lo, plan.y.hi, plan.x.lo, plan.x.hi)
    return _interior_mask(op, rect, plan.y.exceptions, plan.x.exceptions)


def _check_plane(got, f32, want, mask, origin, tol):
    """Interior pixels within ``tol`` of the oracle, every other pixel the
    fp32 mode's bit for bit."""
    ys, xs = np.nonzero(mask)
    y0, x0 = origin
    assert len(ys) > 0
    assert np.abs(got[:, ys, xs] - want[:, ys - y0, xs - x0]).max() <= tol
    assert _bits_equal(got[:, ~mask], f32[:, ~mask])


@pytest.mark.parametrize("name", list(FUSED_GEOMS))
def test_conv_applier_bf16_matches_the_oracle(name, oracles):
    src, _, _, want = oracles[name]
    op = _op(FUSED_GEOMS[name])
    ap = ConvApplier(op, precision="bf16", device="cpu")
    assert ap.precision == ap.effective_precision == "bf16" and ap.fi.bf16
    got = ap(torch.from_numpy(src)).numpy()
    f32 = ConvApplier(op, device="cpu")(torch.from_numpy(src)).numpy()
    _check_plane(got, f32, want, *_conv_mask(op), _tol(op))


@pytest.mark.parametrize("name", list(SEG_GEOMS))
def test_seg_applier_bf16_matches_the_oracle(name, oracles):
    src, _, _, want = oracles[name]
    op = _op(SEG_GEOMS[name])
    ap = SegConvApplier(op, precision="bf16", device="cpu")
    assert ap.precision == ap.effective_precision == "bf16" and ap.si.bf16
    got = ap(torch.from_numpy(src)).numpy()
    f32 = SegConvApplier(op, device="cpu")(torch.from_numpy(src)).numpy()
    _check_plane(got, f32, want, *_seg_mask(op), F32_TOL)


SHARDED = [("conv", "2x-tap8", 2), ("conv", "2x-tap8", 3), ("conv", "down-tap3", 2),
           ("seg", "3x-tap2", 2), ("seg", "3x-tap2", 5), ("seg", "1.5x-tap8", 4)]  # fmt: skip


@pytest.mark.parametrize("impl,name,n", SHARDED, ids=[f"{i}-{g}-{n}" for i, g, n in SHARDED])
def test_sharded_bf16_interiors_match_the_oracle(impl, name, n, oracles):
    src, _, _, want = oracles[name]
    op = _op((FUSED_GEOMS if impl == "conv" else SEG_GEOMS)[name])
    mesh = sharding.make_mesh(n_rows=n, devices=["cpu"] * n)
    fn, _ = sharding.make_sharded_apply(op, mesh, impl=impl, precision="bf16")
    assert fn.info["interior"] == {"conv": "conv-fused", "seg": "seg"}[impl]
    assert fn.info["precision"] == "bf16"
    got = fn(torch.from_numpy(src)).numpy()
    f32_fn, _ = sharding.make_sharded_apply(op, mesh, impl=impl)
    assert f32_fn.info["precision"] == "fp32"
    f32 = f32_fn(torch.from_numpy(src)).numpy()
    mask = _conv_mask(op) if impl == "conv" else _seg_mask(op)
    _check_plane(got, f32, want, *mask, _tol(op))


def test_sharded_gather_interiors_stay_fp32():
    """The gather interiors have no precision mode: under 'bf16' they run,
    and report, fp32 (as in the JAX package)."""
    op = _op((96, 64, 167, 113, 3))  # aperiodic: the band kernel
    mesh = sharding.make_mesh(n_rows=2, devices=["cpu"] * 2)
    ap = sharding.ShardedApplier(op, mesh, precision="bf16")
    assert ap.interior == "gather" and ap.effective_precision == "fp32"
    src = torch.from_numpy(_src(op, seed=3))
    assert torch.equal(ap(src), sharding.ShardedApplier(op, mesh)(src))


# (impl, geometry): auto and conv take the fused engine, seg the fused-seg
# engine, sharded conv-fused (periodic) and seg (3x) on 3 CPU row shards.
API_CASES = [("auto", (64, 48, 128, 96, 4)), ("conv", (64, 48, 128, 96, 4)),
             ("seg", (96, 64, 288, 192, 2)), ("sharded", (64, 48, 128, 96, 4)),
             ("sharded", (96, 64, 288, 192, 2))]  # fmt: skip
ENGINES = {"auto": "fused", "conv": "fused", "seg": "fused-seg"}


@pytest.mark.parametrize("bits", [8, 10, 32], ids=["yuv420p8", "yuv420p10", "yuv420ps"])
@pytest.mark.parametrize("impl,g", API_CASES, ids=[f"{i}-{g[2]}x{g[3]}" for i, g in API_CASES])
def test_api_bf16_within_the_bound_of_the_golden(impl, g, bits):
    sw, sh, dw, dh, tap = g
    fmt = yuv420p(bits)
    clip = Clip.from_frames([random_frame(fmt, sw, sh, seed=5 + i) for i in range(2)])
    cfg = api.JincConfig(target_width=dw, target_height=dh, tap=tap, impl=impl, precision="bf16")
    mesh = sharding.make_mesh(n_rows=3, devices=["cpu"] * 3) if impl == "sharded" else None
    r = api.JincResizer(fmt, sw, sh, cfg, device="cpu", mesh=mesh)
    if impl == "sharded":
        want_engine = "sharded/" + ("seg" if dw == 3 * sw else "conv-fused")
    else:
        want_engine = ENGINES[impl]
    assert r.engines == {"luma": want_engine, "chroma": want_engine}
    # bf16 stays bf16 at every bit depth (u8 planes under fp32 take fp32_u8src).
    assert r._applier_luma.effective_precision == r._applier_chroma.effective_precision == "bf16"
    out = r(clip)
    gold = api.jinc_resize(clip, dw, dh, tap=tap, impl="numpy", device="cpu")
    f32 = api.JincResizer(fmt, sw, sh, dataclasses.replace(cfg, precision="fp32"),
                          device="cpu", mesh=mesh)(clip)  # fmt: skip
    peak = (1 << bits) - 1
    moved = 0.0
    for fo, fg, ff, fs in zip(out.frames, gold.frames, f32.frames, clip.frames):
        fo.validate()
        for n in fmt.plane_names:
            op = r.op_chroma if n in ("U", "V") else r.op_luma
            d = np.abs(fo.planes[n].astype(np.float64) - fg.planes[n].astype(np.float64)).max()
            if bits == 32:
                bound = fused.bf16_bound(op, float(np.abs(fs.planes[n]).max()))
            else:
                bound = fused.bf16_lsb(op, peak)
            assert d <= bound, (n, d, bound)
            moved = max(moved, np.abs(fo.planes[n].astype(np.float64) - ff.planes[n]).max())
    assert moved > 0  # the mode rounds: it is not the fp32 run


def test_effective_precision_differs_from_jax_on_the_cpu():
    """Pinned difference: off the TPU the JAX package runs bf16 as fp32
    math (its ``shift`` interior, ``effective_precision='fp32'``), the port
    runs its fused interior on rounded operands (``'bf16'``). Its seg
    applier reports 'bf16' in both packages."""
    from jincresize_tpu.apply_conv import ConvApplier as JaxConvApplier
    from jincresize_tpu.apply_conv_seg import SegConvApplier as JaxSegConvApplier

    g = FUSED_GEOMS["down-tap3"]
    jap = JaxConvApplier(_jop(g), precision="bf16")
    assert (jap.interior, jap.effective_precision) == ("shift", "fp32")
    assert ConvApplier(_op(g), precision="bf16", device="cpu").effective_precision == "bf16"
    g = SEG_GEOMS["1.5x-tap3"]
    jseg = JaxSegConvApplier(_jop(g), precision="bf16", interpret=True)
    assert jseg.effective_precision == "bf16"
    assert SegConvApplier(_op(g), precision="bf16", device="cpu").effective_precision == "bf16"


def test_bench_and_cli_run_bf16(tmp_path, capsys):
    """``--precision bf16`` runs in the bench twin (its JSON carries the
    precision asked for and the engine's) and in the CLI."""
    res = bench.main(["--precision", "bf16", "--device", "cpu", "--frames", "2", "--iters", "1"],
                     size=(48, 32, 96, 64))  # fmt: skip
    assert (res["engine"], res["precision"]) == ("fused", "bf16")
    assert res["effective_precision"] == "bf16"
    res = bench.main(["--precision", "bf16", "--impl", "xla", "--device", "cpu", "--frames", "1",
                      "--iters", "1"], size=(48, 32, 96, 64))  # fmt: skip
    assert (res["engine"], res["effective_precision"]) == ("xla", "fp32")
    capsys.readouterr()
    src = np.random.default_rng(4).integers(0, 256, (40, 48), dtype=np.uint8)
    np.save(tmp_path / "in.npy", src)
    flags = ["--width", "96", "--height", "80", "--no-cache", "--device", "cpu"]
    assert cli.main([str(tmp_path / "in.npy"), str(tmp_path / "bf16.npy"), *flags,
                     "--precision", "bf16"]) == 0  # fmt: skip
    assert cli.main([str(tmp_path / "in.npy"), str(tmp_path / "fp32.npy"), *flags]) == 0
    got, f32 = np.load(tmp_path / "bf16.npy"), np.load(tmp_path / "fp32.npy")
    op = build_plane_operator(48, 40, 96, 80, radius_for_tap(3))
    assert got.shape == f32.shape == (80, 96)
    assert np.abs(got.astype(int) - f32.astype(int)).max() <= fused.bf16_lsb(op, 255)
