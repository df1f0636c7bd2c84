"""u8 planes on the weight-split modes, held to the JAX package without a card.

Both packages run an 8-bit plane under ``precision='fp32'`` as
``'fp32_u8src'``, and map it onto their fused and seg kernels' three-pass
weight split: the JAX package's ``wsplit3`` (``pallas_fused.py:383-393``)
and ``wsplit3_vmem`` (``pallas_fused_seg.py:371-389``), the port's
``'wsplit3'`` modes (``kernels/fused.py``, ``kernels/seg.py``). Each
weight w splits into three bfloat16 parts, ``w == c0 + c1 + c2`` exactly,
and a u8 source value has 8 significant bits, so every product is exact
in fp32 and only the order of the sums differs.

This module holds

* the port's split (``fused.split_bf16x3``) to the JAX package's, bit for
  bit, on random weights (values whose first part rounds up, negative
  values, tiny values near 2**-126) run through the JAX package's own
  kernel build, and on the kernels of the test plans;
* both wsplit3 kernels, emulated in NumPy (the fused one in
  ``tests/test_torch_wsplit3_tc.py``, the seg one in
  ``tests/test_torch_bf16_tc.py``), on u8-integer sources
  against the JAX Pallas kernels in interpret mode and against the port's
  fp32 plain forms, within ``fused.wsplit3_bound``: every product is exact
  on every side, and each side's fp32 sums are within ``tc_sum_bound(3n)``
  of the exact sum (the JAX kernel's and the emulation's round to
  nearest, within gamma_3n(u) each, which ``tc_sum_bound``'s
  gamma_3n(2u) covers for both);
* the routing: ``kernels.fused.KERNEL_PRECISION`` beside the kernel mode
  the JAX appliers ask for, the modes the port's appliers and its sharded
  applier build on the CPU, and the envelope past which a plan runs the
  fp32 kernel;
* the slice: yuv420p8 through the port's ``JincResizer`` and the JAX
  package's on the CPU, <= 1 LSB, on a periodic (fused), a drifted (seg)
  and a 4-row sharded clip.
"""

import dataclasses

import ml_dtypes
import numpy as np
import pytest
import torch

from jincresize_tpu import api as japi
from jincresize_tpu import clip as jclip
from jincresize_tpu import operator as joperator
from jincresize_tpu import phase as jphase
from jincresize_tpu_torch import api, sharding
from jincresize_tpu_torch.apply_conv import ConvApplier
from jincresize_tpu_torch.apply_conv_seg import SegConvApplier
from jincresize_tpu_torch.clip import Clip, random_frame, yuv420p
from jincresize_tpu_torch.kernels import fused, seg
from jincresize_tpu_torch.operator import build_plane_operator, radius_for_tap
from jincresize_tpu_torch.phase import plan_phases, plan_phases_seg

from test_torch_bf16_tc import emulate_seg
from test_torch_wsplit3_tc import emulate_fused_ws3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread for this module's tests (the workers of
    pytest-xdist share the machine's cores); the old count is back after
    the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# Fused planes: 2x up (4 phases a block, kw 7: a k8 tail), 2x down tap 4
# (one phase, qx 2, kw 17: the one-tap tail packed over 8 rows) and the 2/3
# plan (qx 3, kw 15). Seg planes: 1.5x up tap 3 over two frames (fs 7),
# 4/3 down tap 4 (fs 12) and 2x down tap 4 on its seg plan (fs 17).
FUSED_GEOMS = {
    "2x-tap3": (48, 36, 96, 72, 3),
    "2x-down-tap4": (96, 72, 48, 36, 4),
    "2/3-tap4": (90, 60, 60, 40, 4),
}
FUSED_CASES = [(n, fused.DEFAULT_SHAPE) for n in FUSED_GEOMS] + [("2x-tap3", fused.NARROW_SHAPE)]
SEG_GEOMS = {
    "1.5x-tap3": ((64, 48, 96, 72, 3), 2),
    "4/3-down-tap4": ((96, 72, 72, 54, 4), 1),
    "2x-down-tap4": ((96, 72, 48, 36, 4), 1),
}
# The JAX kernels' precision names, in the port's kernel modes.
JAX_KERNEL_MODES = {"highest": "fp32", "default": "bf16", "wsplit3": "wsplit3",
                    "wsplit3_vmem": "wsplit3"}  # fmt: skip


def _op(g):
    sw, sh, dw, dh, tap = g
    return build_plane_operator(sw, sh, dw, dh, radius_for_tap(tap))


def _jop(g):
    sw, sh, dw, dh, tap = g
    return joperator.build_plane_operator(sw, sh, dw, dh, joperator.radius_for_tap(tap))


def _u8(op, seed, frames):
    shape = (frames, op.src_height, op.src_width)
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.float32)


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def _jax_split(g, values=None):
    """The parts (3, ...) that the JAX package's fused kernel build makes of
    its weights on the plane ``g`` (its pair blocks replaced by ``values``,
    repeated to their size, where given): ``pallas_fused.make_fused_interior
    (..., precision='wsplit3')``, its weight tensor read from the built
    function. Returns (the values its weights hold, their three parts)."""
    from jincresize_tpu.kernels.pallas_fused import make_fused_interior

    jop = _jop(g)
    if values is not None:
        vals = np.resize(np.asarray(values, np.float32).ravel(), jop.pair_blocks.size)
        jop = dataclasses.replace(jop, pair_blocks=vals.reshape(jop.pair_blocks.shape))
    fn = make_fused_interior(jop, jphase.plan_phases(jop), precision="wsplit3", interpret=True)
    cells = dict(zip(fn.__code__.co_freevars, fn.__closure__))
    parts = np.asarray(cells["w_dev"].cell_contents).reshape(3, -1)
    return (parts[0] + parts[1]) + parts[2], parts


def _weights():
    """Random fp32 weights: normal values, values just past a bfloat16
    midpoint (their first part rounds up), negative ones, and tiny ones
    near 2**-126, half with no significand bit below 2**-133 (the least
    bfloat16 step) and half with bits down to 2**-149. Returns (weights,
    the count of those before the last tiny ones)."""
    rng = np.random.default_rng(13)
    normal = rng.normal(0, 0.05, 512).astype(np.float32)
    mid = _r16(rng.uniform(0.01, 1, 256)).astype(np.float64)
    ulp = 2.0 ** (np.floor(np.log2(mid)) - 7)  # a bfloat16 step at mid
    up = (mid + ulp * rng.uniform(0.51, 0.99, 256)).astype(np.float32)
    tiny_ok = (rng.integers(2**7, 2**24, 128) * 2.0**-133).astype(np.float32)
    tiny = (rng.integers(2**23, 2**24, 128) * 2.0**-149).astype(np.float32)
    vals = np.concatenate([normal, up, tiny_ok, tiny])
    signs = np.where(rng.random(vals.size) < 0.5, -1, 1).astype(np.float32)
    return vals * signs, len(vals) - len(tiny)


def _r16(a):
    return np.asarray(a, np.float32).astype(ml_dtypes.bfloat16).astype(np.float32)


# ---- the split


def test_split_is_exact_and_equals_the_jax_split():
    """``split_bf16x3`` on random weights: the parts sum to each weight bit
    for bit; every part is bfloat16-exact where the weight has no
    significand bit below 2**-133, and ``check_split`` raises on the tiny
    weights that do; the parts equal, bit for bit, those the JAX package's
    fused kernel build makes of the same values."""
    K, n_ok = _weights()
    parts = fused.split_bf16x3(K)
    assert parts.shape == (3, K.size) and parts.dtype == np.float32
    assert np.array_equal(_bits((parts[0] + parts[1]) + parts[2]), _bits(K))
    for p in parts:
        assert np.array_equal(_r16(p[:n_ok]), p[:n_ok])
    assert (np.abs(parts[0]) > np.abs(K))[512:768].all()  # the first parts rounded up
    assert not np.array_equal(_r16(parts[2][n_ok:]), parts[2][n_ok:])
    fused.check_split(K[:n_ok], parts[:, :n_ok])
    with pytest.raises(ValueError, match="three bfloat16 parts"):
        fused.check_split(K, parts)  # the tiny weights' last parts are not bfloat16
    for lo in range(0, K.size, 196):  # the 2x tap-3 plane holds 4 blocks of 7 x 7
        w, jparts = _jax_split(FUSED_GEOMS["2x-tap3"], K[lo : lo + 196])
        assert np.isin(_bits(K[lo : lo + 196]), _bits(w)).all()  # each went through the build
        assert np.array_equal(_bits(fused.split_bf16x3(w)), _bits(jparts))


@pytest.mark.parametrize("name", list(FUSED_GEOMS))
def test_kernel_weight_planes_hold_the_jax_split(name):
    """``make_fused_interior(..., 'wsplit3')``: ``wtc`` holds three parts of
    weight rows (``ws3_weights``), whose values sum to the unrounded
    kernels' weight rows bit for bit and are the JAX package's split of
    them; ``kernels`` and ``w`` stay unrounded (the plain form is the fp32
    mode's)."""
    op = _op(FUSED_GEOMS[name])
    plan = plan_phases(op)
    fi = fused.make_fused_interior(op, plan, precision="wsplit3")
    f32 = fused.make_fused_interior(op, plan)
    assert fi.precision == "wsplit3" and fi.parts == 3 and not fi.bf16
    assert torch.equal(fi.kernels, f32.kernels) and torch.equal(fi.w, f32.w)
    lay = fi.layout()
    assert isinstance(lay, fused.Ws3Layout) and fi.wtc.dtype == torch.bfloat16
    w = fi.wtc.float().numpy().reshape(lay.ngroups, 3, 2 * lay.wn)
    K = f32.kernels.numpy()
    want = fused.split_bf16x3(K)
    fused.check_split(K, want)
    assert np.array_equal(w.reshape(lay.ngroups, -1), fused.ws3_weights(want, lay, fi.qy))
    whole = fused.ws3_weights(np.stack([K, 0 * K, 0 * K]), lay, fi.qy).reshape(w.shape)
    assert np.array_equal((w[:, 0] + w[:, 1]) + w[:, 2], whole[:, 0])
    # The JAX build's weights of the same plane: the same values, the same parts.
    jw, jparts = _jax_split(FUSED_GEOMS[name])
    assert np.isin(_bits(K[K != 0]), _bits(jw)).all()
    assert np.array_equal(_bits(fused.split_bf16x3(jw)), _bits(jparts))


# ---- the emulated three-pass kernels against the JAX Pallas kernels


@pytest.fixture(scope="module")
def oracles():
    """{name: (u8 source, JAX Pallas interior)}: interpret mode, the JAX
    package's ``wsplit3`` (fused) and ``wsplit3_vmem`` (seg) modes on the
    unrounded pair blocks, one call a frame."""
    import jax.numpy as jnp

    from jincresize_tpu.kernels.pallas_fused import make_fused_interior
    from jincresize_tpu.kernels.pallas_fused_seg import make_seg_interior

    out = {}
    for name, g in FUSED_GEOMS.items():
        jop = _jop(g)
        src = _u8(jop, 31, 1)
        fn = make_fused_interior(jop, jphase.plan_phases(jop), precision="wsplit3", interpret=True)
        out["fused", name] = (src, np.asarray(fn(jnp.asarray(src[0])))[None])
    for name, (g, frames) in SEG_GEOMS.items():
        jop = _jop(g)
        src = _u8(jop, 32, frames)
        fn = make_seg_interior(jop, jphase.plan_phases_seg(jop), precision="wsplit3_vmem",
                               interpret=True)  # fmt: skip
        out["seg", name] = (src, np.stack([np.asarray(fn(jnp.asarray(s), fn.params)) for s in src]))
    return out


def _bound(n, blocks, src):
    wsum = float(np.abs(blocks).sum(axis=(-2, -1)).max())
    return fused.wsplit3_bound(n, wsum, float(np.abs(src).max()))


def _case_id(v):
    return v if isinstance(v, str) else fused.shape_name(v)


@pytest.mark.parametrize("name,shape", FUSED_CASES, ids=_case_id)
def test_fused_wsplit3_emulation_matches_pallas(name, shape, oracles):
    """The fused kernel's three-pass decomposition, emulated on a u8
    source, within ``wsplit3_bound`` (n = Kh*Kw) of the JAX ``wsplit3``
    Pallas kernel and of the port's plain form, every interior pixel
    written; the readings are not 0 (the sums leave the FMA order) and far
    under the bound."""
    src, want = oracles["fused", name]
    op = _op(FUSED_GEOMS[name])
    fi = fused.make_fused_interior(op, plan_phases(op), precision="wsplit3")
    got = emulate_fused_ws3(fi, src, shape)
    nph, kh, kw = fi.kernels.shape
    bound = _bound(kh * kw, fi.kernels.numpy(), src)
    plain = fused.fused_interior_plain(fi, torch.from_numpy(src)).numpy()
    assert got.shape == want.shape == plain.shape and np.isfinite(got).all()
    assert np.abs(got - want).max() <= bound
    assert np.abs(got - plain).max() <= bound
    assert np.abs(want - plain).max() <= bound


@pytest.mark.parametrize("name", list(SEG_GEOMS))
def test_seg_wsplit3_emulation_matches_pallas(name, oracles):
    """The seg kernel's three-pass decomposition (the fp32 mode's float32
    blocks, at their fsp-float rows, split at each B load), emulated on a
    u8 source at the frames a block the wrapper picks, within
    ``wsplit3_bound`` (n = fs**2) of the JAX ``wsplit3_vmem`` Pallas kernel
    and of the port's plain form, every pixel written."""
    src, want = oracles["seg", name]
    op = _op(SEG_GEOMS[name][0])
    si = seg.make_seg_interior(op, plan_phases_seg(op), precision="wsplit3")
    assert si.precision == "wsplit3" and si.tc_blocks is None
    nf = seg.frames_of(si, src.shape[0])
    assert nf == src.shape[0]
    got = emulate_seg(si, src, nf)
    bound = _bound(si.fs**2, si.blocks.numpy(), src)
    plain = seg.seg_interior_plain(si, torch.from_numpy(src)).numpy()
    assert got.shape == want.shape == plain.shape and np.isfinite(got).all()
    assert np.abs(got - want).max() <= bound
    assert np.abs(got - plain).max() <= bound


@pytest.mark.parametrize("n", [9, 289, 1936, 4225])
def test_wsplit3_bound_covers_three_tensor_core_sums_and_the_plain_chain(n):
    """``wsplit3_bound``: the tensor cores' bound over 3n terms (their
    weight parts' sums, 1 + 2**-6 of sum|w|) plus the fp32 chain's over
    n; above both, growing with n."""
    b = fused.wsplit3_bound(n, 3.0, 255.0)
    assert b == pytest.approx(fused.tc_sum_bound(3 * n, 3.0 * (1 + 2.0**-6), 255.0)
                              + fused.f32_sum_bound(n, 3.0, 255.0))  # fmt: skip
    assert b > fused.tc_sum_bound(3 * n, 3.0, 255.0) > fused.tc_sum_bound(n, 3.0, 255.0)
    assert fused.wsplit3_bound(n + 1, 3.0, 255.0) > b


# ---- the routing


def test_kernel_precision_mirrors_the_jax_mapping(monkeypatch):
    """``kernels.fused.KERNEL_PRECISION``, which the fused and seg appliers
    read, beside the kernel precision the JAX package's ``ConvApplier`` and
    ``SegConvApplier`` ask their Pallas builds for (recorded, the build
    then stopped): the same mode for every applier precision."""
    from jincresize_tpu import apply_conv as japply_conv
    from jincresize_tpu import apply_conv_seg as japply_seg
    from jincresize_tpu.kernels import pallas_fused, pallas_fused_seg

    class Asked(Exception):
        pass

    def record(op, plan, precision, **kw):
        raise Asked(precision)

    monkeypatch.setattr(pallas_fused, "make_fused_interior", record)
    monkeypatch.setattr(pallas_fused_seg, "make_seg_interior", record)
    monkeypatch.delenv("JINCRESIZE_FUSED_PRECISION", raising=False)
    monkeypatch.delenv("JINCRESIZE_SEG_DOT", raising=False)
    jop = _jop(SEG_GEOMS["1.5x-tap3"][0])
    for prec in fused.KERNEL_PRECISION:
        for make in (
            lambda: japply_conv.ConvApplier(jop, interior="fused", precision=prec),
            lambda: japply_seg.SegConvApplier(jop, precision=prec, interpret=True),
        ):
            with pytest.raises(Asked) as asked:
                make()
            assert JAX_KERNEL_MODES[asked.value.args[0]] == fused.KERNEL_PRECISION[prec], prec
    assert fused.KERNEL_PRECISION["fp32_u8src"] == "wsplit3"


@pytest.mark.parametrize("prec,mode", [("fp32", "fp32"), ("fp32_u8src", "wsplit3"), ("bf16", "bf16")])
def test_appliers_build_the_mapped_mode(prec, mode):
    """On the CPU the appliers build the kernel mode of the mapping and
    report the applier precision that runs; ``wsplit3`` runs the fp32 plain
    forms there, so a u8 plane's output equals the fp32 mode's."""
    g = SEG_GEOMS["1.5x-tap3"][0]
    op = _op(g)
    src = torch.from_numpy(_u8(op, 3, 1))
    for App, kmode, tables in (
        (ConvApplier, mode, "fi"),
        (SegConvApplier, fused.KERNEL_PRECISION[prec], "si"),
    ):
        ap = App(op, precision=prec, device="cpu")
        assert getattr(ap, tables).precision == kmode
        assert ap.precision == prec and ap.effective_precision == fused.APPLIER_PRECISION[kmode]
        if prec != "bf16":
            out = ap(src, out_dtype=np.uint8, peak=255.0)
            ref = App(op, precision="fp32", device="cpu")(src, out_dtype=np.uint8, peak=255.0)
            assert torch.equal(out, ref)


@pytest.mark.parametrize("geo,interior", [((48, 36, 96, 72, 3), "conv-fused"),
                                          ((64, 48, 96, 72, 3), "seg")])  # fmt: skip
def test_sharded_applier_maps_u8_planes(geo, interior):
    """``ShardedApplier`` on 4 CPU row shards under ``fp32_u8src``: every
    shard's interior in the ``wsplit3`` mode, ``effective_precision``
    ``'fp32_u8src'``; under ``fp32`` the fp32 mode, and both give the same
    u8 output on the CPU."""
    op = _op(geo)
    mesh = sharding.make_mesh(n_rows=4, devices=["cpu"] * 4)
    impl = "conv" if interior == "conv-fused" else "seg"
    src = torch.from_numpy(_u8(op, 4, 2))
    outs = {}
    for prec, mode in (("fp32_u8src", "wsplit3"), ("fp32", "fp32")):
        ap = sharding.ShardedApplier(op, mesh, precision=prec, impl=impl)
        assert ap.interior == interior and ap.effective_precision == prec
        tables = [s.tables for s in ap._fn.shards[0] if s is not None and s.tables is not None]
        assert tables and all(t.precision == mode for t in tables)
        outs[prec] = ap(src, out_dtype=np.uint8, peak=255.0)
    assert torch.equal(outs["fp32_u8src"], outs["fp32"])


def test_plans_past_the_u8_envelope_run_the_fp32_kernel():
    """Pinned envelope. The tap-16 2/5 plan (four (84, 84) kernels), past
    the earlier wsplit3 form's 227 KB (three planes of the bf16 mode's
    weight rows), now fits the wsplit3 kernel's three parts (16-byte
    weight rows, stages of 4 rows): under ``fp32_u8src`` it builds
    ``'wsplit3'``. Past the new boundary: a one-phase plan of (191, 191)
    kernels at step 11 (fs 181, the deepest ``plan_phases`` admits) fits
    the bf16 kernel but no wsplit3 shape, so ``kernel_precision`` builds
    it fp32; a plan there is read from the layouts, as the sweep of
    tests/test_torch_wsplit3_tc.py does. Likewise a wide-support drifted
    4/3 plan (fs 55): the seg kernel's float32 pair blocks beside one
    frame's window do not fit, its bf16 blocks do."""
    op = _op((300, 200, 120, 80, 16))
    plan = plan_phases(op)
    kh, kw = fused.plan_layout(op, plan).kh, fused.plan_layout(op, plan).kw
    geo = (plan.y.p, plan.x.p, plan.y.q, plan.x.q, kh, kw)
    fit = fused.fit_shape(*geo)
    assert (kh, kw) == (84, 84) and fused.tc_layout(*geo, *fit).smem_bytes <= fused.MAX_SMEM_BYTES
    lay = fused.ws3_layout(*geo, *fit)
    assert lay.smem_bytes <= fused.MAX_SMEM_BYTES and lay.ch == 4 and not lay.last1
    assert fused.kernel_precision(op, plan, "wsplit3") == "wsplit3"
    ap = ConvApplier(op, plan=plan, precision="fp32_u8src", device="cpu")
    assert ap.fi.precision == "wsplit3" and ap.effective_precision == "fp32_u8src"
    assert ConvApplier(op, plan=plan, precision="bf16", device="cpu").effective_precision == "bf16"
    deep = (1, 1, 11, 11, 191, 191)
    assert fused.fit_shape(*deep) == (fused.DEFAULT_SHAPE, 1)
    assert fused.tc_layout(*deep, fused.DEFAULT_SHAPE, 1).smem_bytes <= fused.MAX_SMEM_BYTES
    assert fused.ws3_shape(*deep, 1) is None

    op = build_plane_operator(400, 300, 300, 225, radius_for_tap(16) * 1.25)
    splan = plan_phases_seg(op)
    assert op.filter_size == 55 and seg.is_supported(op, splan)
    assert seg.kernel_precision(op, splan, "wsplit3") == "fp32"
    sap = SegConvApplier(op, plan=splan, precision="fp32_u8src", device="cpu")
    assert sap.si.precision == "fp32" and sap.si.tc_blocks is None
    assert sap.effective_precision == "fp32"
    bsi = seg.make_seg_interior(op, splan, precision="bf16")
    assert bsi.precision == "bf16" and bsi.tc_frames >= 1


# ---- the slice


def _jclip(clip):
    """The port's ``clip`` as a JAX package Clip over the same arrays."""
    def jfmt(fmt):
        return jclip.VideoFormat(**dataclasses.asdict(fmt))

    return jclip.Clip.from_frames(
        [jclip.Frame(jfmt(f.format), dict(f.planes), dict(f.props)) for f in clip.frames]
    )


@pytest.mark.parametrize(
    "geo,impl,engine",
    [
        ((48, 36, 96, 72), "auto", "fused"),
        ((64, 48, 96, 72), "seg", "fused-seg"),
        ((64, 48, 160, 120), "sharded", "sharded/seg"),
    ],
    ids=["periodic-fused", "drifted-seg", "sharded-seg-4-rows"],
)
def test_yuv420p8_resizer_matches_jax(geo, impl, engine):
    """A 2-frame yuv420p8 clip through the port's ``JincResizer`` on the
    CPU (every plane's interior in the ``wsplit3`` mode, reported as
    ``'fp32_u8src'``) and through the JAX package's on the CPU: <= 1 LSB
    on every plane."""
    sw, sh, dw, dh = geo
    fmt = yuv420p(8)
    clip = Clip.from_frames([random_frame(fmt, sw, sh, seed=60 + i) for i in range(2)])
    cfg = api.JincConfig(target_width=dw, target_height=dh, tap=3, impl=impl,
                         operator_cache=False)  # fmt: skip
    mesh = sharding.make_mesh(n_rows=4, devices=["cpu"] * 4) if impl == "sharded" else None
    r = api.JincResizer(fmt, sw, sh, cfg, device="cpu", mesh=mesh)
    assert r.engines == {"luma": engine, "chroma": engine}
    for ap in (r._applier_luma, r._applier_chroma):
        assert ap.effective_precision == "fp32_u8src"
    got = r(clip)
    want = japi.jinc_resize(_jclip(clip), dw, dh, tap=3)
    assert len(got.frames) == len(want.frames)
    for fa, fb in zip(got.frames, want.frames):
        fa.validate()
        for n in fa.planes:
            d = np.abs(fa.planes[n].astype(np.int64) - fb.planes[n].astype(np.int64)).max()
            assert d <= 1, (n, d)
