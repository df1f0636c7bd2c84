"""Port kernels (plain forms on the CPU) against the JAX Pallas kernels.

The JAX side runs ``make_fused_interior`` / ``make_strips_interior`` in
Pallas interpret mode, as its own tests do. The port's wrappers take their
plain PyTorch forms because the tensors lie on the CPU; the CUDA kernels
themselves are checked against the same plain forms on the card by
``chip_smoke.py``.

Each side builds its operator and plan with its own package's host layer.

Tolerance: 2e-6 absolute on fp32 sources in [0, 1) -- both sides multiply in
exact fp32 and differ only in summation order; 4e-6 for deep taps (fs**2 >
1200: 4225 products a pixel at fs = 65), the JAX package's deep-tap bound.
"""

import dataclasses

import numpy as np
import pytest
import torch

from jincresize_tpu import operator as joperator
from jincresize_tpu import phase as jphase
from jincresize_tpu_torch.kernels import fused, strips
from jincresize_tpu_torch.operator import build_plane_operator, radius_for_tap
from jincresize_tpu_torch.phase import plan_phases


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

# test_pallas_fused.py's five geometries plus its subpixel crop.
GEOMS = [
    ((64, 48, 128, 96, 8), {}),
    ((96, 60, 64, 40, 3), {}),
    ((90, 60, 60, 40, 4), {}),
    ((64, 64, 256, 256, 3), {}),
    ((40, 30, 200, 150, 3), {}),
    ((64, 48, 128, 96, 4), {"crop_left": 0.25, "crop_top": -0.5}),
]
IDS = ["2x-tap8", "down-tap3", "2/3-tap4", "4x-tap3", "5x-tap3", "subpixel-crop"]


def _op(g, kw):
    sw, sh, dw, dh, tap = g
    return build_plane_operator(sw, sh, dw, dh, radius_for_tap(tap), **kw)


def _jop(g, kw):
    """The JAX package's operator and plan of the same geometry."""
    sw, sh, dw, dh, tap = g
    op = joperator.build_plane_operator(sw, sh, dw, dh, joperator.radius_for_tap(tap), **kw)
    return op, jphase.plan_phases(op)


def _src(op, seed, frames=None):
    shape = (op.src_height, op.src_width)
    if frames is not None:
        shape = (frames,) + shape
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


@pytest.mark.parametrize("g,kw", GEOMS, ids=IDS)
def test_fused_plain_matches_pallas_interpret(g, kw):
    import jax.numpy as jnp

    from jincresize_tpu.kernels.pallas_fused import make_fused_interior

    op = _op(g, kw)
    plan = plan_phases(op)
    assert fused.is_supported(op, plan)
    src = _src(op, 11)
    jop, jplan = _jop(g, kw)
    want = np.asarray(make_fused_interior(jop, jplan, interpret=True)(jnp.asarray(src)))
    fi = fused.make_fused_interior(op, plan)
    got = fused.fused_interior(fi, torch.from_numpy(src)[None])[0].numpy()
    assert got.shape == want.shape == fi.out_shape
    assert np.abs(got - want).max() <= F32_TOL


def test_fused_batch_matches_per_frame():
    op = _op(*GEOMS[0])
    plan = plan_phases(op)
    fi = fused.make_fused_interior(op, plan)
    src = torch.from_numpy(_src(op, 3, frames=3))
    batch = fused.fused_interior(fi, src)
    for f in range(3):
        one = fused.fused_interior(fi, src[f : f + 1])[0]
        assert torch.equal(batch[f], one)


def _full_width_strips(op):
    return [s for s in op.strips if s.x0 == 0 and s.x1 == op.dst_width and s.y1 > s.y0]


STRIP_GEOMS = [GEOMS[0], GEOMS[1], GEOMS[2], GEOMS[3]]


@pytest.mark.parametrize("g,kw", STRIP_GEOMS, ids=IDS[:4])
def test_strips_plain_matches_pallas_interpret(g, kw):
    import jax.numpy as jnp

    from jincresize_tpu.kernels.pallas_strips import make_strips_interior

    op = _op(g, kw)
    plan = plan_phases(op)
    jr = make_strips_interior(*_jop(g, kw), interpret=True)
    assert jr is not None
    jfn, jpatches, jmeta = jr
    st, patches, meta = strips.make_strips(op, plan)
    assert meta["strips"] == jmeta["strips"]
    assert (meta["xlo"], meta["width"]) == (jmeta["xlo"], jmeta["width"])
    # Corner + exception columns the caller patches: exactly the same.
    assert len(patches) == len(jpatches)
    for (s, cols), (js, jcols) in zip(patches, jpatches):
        assert (s.y0, s.y1, s.x0, s.x1) == (js.y0, js.y1, js.x0, js.x1)
        np.testing.assert_array_equal(cols, jcols)
    src = _src(op, 5)
    want = np.asarray(jfn(jnp.asarray(src)))
    got = strips.strips(st, torch.from_numpy(src)[None])[0].numpy()
    ny_p = jmeta["ny_p"]
    for si, (y0, y1) in enumerate(meta["strips"]):
        w = want[si * ny_p : si * ny_p + (y1 - y0)]
        assert np.abs(got[si, : y1 - y0] - w).max() <= F32_TOL
        assert not got[si, y1 - y0 :].any()  # unused rows of a shorter strip


@pytest.mark.parametrize("g,kw", STRIP_GEOMS, ids=IDS[:4])
def test_strips_chain_matches_pallas_interpret(g, kw):
    """``strips_chain`` (the strip kernel's float32 multiply-add chain, the
    reference ``chip_smoke.py`` holds the kernel to at 0) computes the same
    strips as the JAX kernel and the float64 ``strips_plain``, on 2 frames."""
    import jax.numpy as jnp

    from jincresize_tpu.kernels.pallas_strips import make_strips_interior

    op = _op(g, kw)
    st, _, meta = strips.make_strips(op, plan_phases(op))
    jfn, _, jmeta = make_strips_interior(*_jop(g, kw), interpret=True)
    src = _src(op, 9, frames=2)
    got = strips.strips_chain(st, torch.from_numpy(src)).numpy()
    assert got.shape == strips.strips_plain(st, torch.from_numpy(src)).shape
    assert np.abs(got - strips.strips_plain(st, torch.from_numpy(src)).numpy()).max() <= F32_TOL
    ny_p = jmeta["ny_p"]
    for f in range(2):
        want = np.asarray(jfn(jnp.asarray(src[f])))
        for si, (y0, y1) in enumerate(meta["strips"]):
            w = want[si * ny_p : si * ny_p + (y1 - y0)]
            assert np.abs(got[f, si, : y1 - y0] - w).max() <= F32_TOL
            assert not got[f, si, y1 - y0 :].any()


@pytest.mark.parametrize(
    "g,kw",
    GEOMS + [((160, 120, 400, 300, 3), {}), ((320, 180, 480, 270, 3), {})],
    ids=IDS + ["5/2-exceptions", "3/2-drift"],
)
def test_anchor_blocks_copy_equals_original(g, kw):
    """The copied host check gives the same anchors and exception columns."""
    from jincresize_tpu.kernels import pallas_strips

    op = _op(g, kw)
    plan = plan_phases(op)
    jop, jplan = _jop(g, kw)
    for s, js in zip(_full_width_strips(op), _full_width_strips(jop), strict=True):
        a = strips._anchor_blocks(s, plan.x, op.filter_size)
        b = pallas_strips._anchor_blocks(js, jplan.x, jop.filter_size)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a[0], b[0])
            np.testing.assert_array_equal(a[1], b[1])


@pytest.mark.parametrize(
    "g,kw",
    GEOMS + [((160, 120, 400, 300, 3), {}), ((320, 180, 480, 270, 3), {})],
    ids=IDS + ["5/2-exceptions", "3/2-drift"],
)
def test_plan_strips_copy_equals_original(g, kw):
    from jincresize_tpu import apply_strips_fast as jsf
    from jincresize_tpu_torch import apply_strips_fast as tsf

    op = _op(g, kw)
    plan = plan_phases(op)
    a = tsf.plan_strips(op, plan)
    b = jsf.plan_strips(*_jop(g, kw))
    assert (a is None) == (b is None)
    for pa, pb in zip(a or [], b or []):
        for f in ("kind", "const_start", "lo", "p", "q", "anchor_start", "nblocks", "rect"):
            assert getattr(pa, f) == getattr(pb, f), f
        np.testing.assert_array_equal(pa.exc, pb.exc)


ENVELOPE_GEOMS = [
    (64, 48, 128, 96, 8),
    (96, 60, 64, 40, 3),
    (90, 60, 60, 40, 4),
    (64, 64, 256, 256, 3),
    (40, 30, 200, 150, 3),
    (160, 120, 400, 300, 3),
    (320, 180, 480, 270, 3),
    (192, 128, 96, 64, 8),
    (200, 120, 100, 60, 10),
    (256, 144, 128, 72, 6),
    (48, 32, 384, 256, 3),
    (120, 90, 80, 60, 4),
    (128, 96, 64, 48, 6),
]


@pytest.mark.parametrize("g", ENVELOPE_GEOMS, ids=lambda g: "x".join(map(str, g)))
def test_is_supported_covers_pallas_envelope(g):
    """Every plan the Pallas kernel admits (deep taps included) is admitted."""
    from jincresize_tpu.kernels import pallas_fused

    op = _op(g, {})
    plan = plan_phases(op)
    assert plan is not None
    if pallas_fused.is_supported(*_jop(g, {})):
        assert fused.is_supported(op, plan)
    assert fused.smem_bytes(op, plan) <= fused.MAX_SMEM_BYTES


DEEP_GEOMS = [(480, 270, 240, 135, 16), (480, 270, 320, 180, 16)]


def test_deep_tap_outside_envelope():
    """Deep taps (fs**2 > 1200) are inside the fused envelope now: the
    tap-16 2x (p=1, fs=65) and 2/3 (p=(2,2), fs=49) downscales build, and
    the plain form matches the JAX kernel in interpret mode at 4e-6."""
    import jax.numpy as jnp

    from jincresize_tpu.kernels.pallas_fused import make_fused_interior

    for g, fs, p in zip(DEEP_GEOMS, (65, 49), (1, 2), strict=True):
        op = _op(g, {})
        plan = plan_phases(op)
        assert op.filter_size == fs and op.filter_size**2 > fused.FS2_MAX
        assert (plan.y.p, plan.x.p) == (p, p)
        assert fused.is_supported(op, plan)
        fi = fused.make_fused_interior(op, plan)
        assert fi.fs == fs and fused.smem_bytes(op, plan) <= fused.MAX_SMEM_BYTES
        src = _src(op, 13)
        got = fused.fused_interior(fi, torch.from_numpy(src)[None])[0].numpy()
        want = np.asarray(make_fused_interior(*_jop(g, {}), interpret=True)(jnp.asarray(src)))
        assert got.shape == want.shape == fi.out_shape
        assert np.abs(got - want).max() <= DEEP_TOL


@pytest.mark.parametrize("g", DEEP_GEOMS, ids=["2x-fs65", "2/3-fs49"])
def test_deep_tap_strips_match_pallas_interpret(g):
    """The strip kernel's plain form serves fs = 65 and 49 (anchors of
    px * fs**2 floats) and matches the JAX strip kernel in interpret mode."""
    import jax.numpy as jnp

    from jincresize_tpu.kernels.pallas_strips import make_strips_interior

    op = _op(g, {})
    st, patches, meta = strips.make_strips(op, plan_phases(op))
    jfn, jpatches, jmeta = make_strips_interior(*_jop(g, {}), interpret=True)
    assert meta["strips"] == jmeta["strips"] and len(patches) == len(jpatches)
    src = _src(op, 7)
    want = np.asarray(jfn(jnp.asarray(src)))
    got = strips.strips(st, torch.from_numpy(src)[None])[0].numpy()
    for si, (y0, y1) in enumerate(meta["strips"]):
        w = want[si * jmeta["ny_p"] : si * jmeta["ny_p"] + (y1 - y0)]
        assert np.abs(got[si, : y1 - y0] - w).max() <= DEEP_TOL


# The composed operators of tests/test_torch_chain.py's "4x periodic" and
# "large dedup" pairs: the bottom strip's window start steps from row to row
# (42 -> 43 and 261 -> 262 -> 263), and its last windows leave the source
# (43 + 7 > 48, 263 + 10 > 270) with zero weight on the rows past it.
COMPOSED = {
    "4x periodic": ((64, 48, 128, 96, 2), (128, 96, 256, 192, 2)),
    "large dedup": ((480, 270, 960, 540, 3), (960, 540, 1920, 1080, 3)),
}


@pytest.fixture(scope="module")
def composed():
    """{name: (port operator, JAX operator)}, each composed by its own package."""
    from jincresize_tpu import compose as jcompose
    from jincresize_tpu_torch.compose import compose

    return {
        name: (
            compose(*[_op(g, {}) for g in pair]),
            jcompose.compose(*[_jop(g, {})[0] for g in pair]),
        )
        for name, pair in COMPOSED.items()
    }


def _bottom_strip(op):
    return max(_full_width_strips(op), key=lambda s: s.y0)


@pytest.mark.parametrize("name", list(COMPOSED))
def test_composed_strips_run_the_kernel_path(name, composed):
    """A composed chain operator's strips take the strip kernel (its plain
    form on the CPU), per-row window starts included, and the port's
    ``ConvApplier`` matches the JAX package's applier (whose strip kernel
    declines, so its strips take the value path) and the host golden."""
    import jax.numpy as jnp

    from jincresize_tpu.apply_conv import ConvApplier as JaxConvApplier
    from jincresize_tpu_torch.apply_conv import ConvApplier
    from jincresize_tpu_torch.golden import apply_plane_numpy

    op, jop = composed[name]
    plan = plan_phases(op)
    s = _bottom_strip(op)
    sy = op.start_y[s.y0 : s.y1]
    assert (sy != sy[0]).any() and int(sy.max()) + op.filter_size > op.src_height
    st, _, meta = strips.make_strips(op, plan)
    assert st.rows[-1] == (int(sy.min()), s.y1 - s.y0, int(sy.max() - sy.min()) + op.filter_size)
    ap = ConvApplier(op, plan=plan, device="cpu")
    assert ap.strips_spec is not None and meta["strips"][-1] == (s.y0, s.y1)
    src = _src(op, 17)
    got = ap(torch.from_numpy(src)).numpy()
    want = np.asarray(JaxConvApplier(jop, interior="fused")(jnp.asarray(src)))
    assert np.abs(got - want).max() <= F32_TOL
    assert np.abs(got - apply_plane_numpy(op, src)).max() <= F32_TOL


@pytest.mark.parametrize("name", list(COMPOSED))
def test_composed_strips_route_apart_from_jax(name, composed):
    """A routing difference, pinned: the JAX strip kernel declines strips
    whose rows do not share one window start; the port's takes them."""
    from jincresize_tpu.kernels.pallas_strips import make_strips_interior

    op, jop = composed[name]
    assert make_strips_interior(jop, jphase.plan_phases(jop), interpret=True) is None
    assert strips.make_strips(op, plan_phases(op)) is not None


@pytest.mark.parametrize("inside", [True, False], ids=["row-inside", "row-past-source"])
def test_weight_past_the_source_declines(inside, composed, monkeypatch):
    """One nonzero anchor weight on a window row past the source (the
    kernel reads zeros there, the reference the clamped row) declines the
    operator; the same weight on a row inside the source does not."""
    op, _ = composed["4x periodic"]
    plan = plan_phases(op)
    bottom = _bottom_strip(op)
    ly = 0 if inside else op.src_height - int(op.start_y[bottom.y0])
    assert 0 <= ly < op.filter_size
    original = strips._anchor_blocks

    def one_weight(s, plan_x, fs):
        anchors, exc = original(s, plan_x, fs)
        if s is bottom:
            anchors = anchors.copy()
            anchors[0, 0, ly, 0] = 1e-3
        return anchors, exc

    monkeypatch.setattr(strips, "_anchor_blocks", one_weight)
    assert (strips.make_strips(op, plan) is not None) == inside
    why = strips.verified_strips(op, plan)[1]
    assert why is None if inside else "outside the source" in why


def _taken_before(op, plan):
    """The previous kernel's envelope: one strip row's (px, fs, fs) anchors
    (odd stride) in shared memory, every full-width strip at one window
    start, and its anchor pattern verified."""
    fs = op.filter_size
    astride = fs * fs if fs % 2 else fs * fs + 1
    full = _full_width_strips(op)
    return (
        plan.x.p * astride * 4 <= fused.MAX_SMEM_BYTES
        and bool(full)
        and all(
            (op.start_y[s.y0 : s.y1] == op.start_y[s.y0]).all()
            and strips._anchor_blocks(s, plan.x, fs) is not None
            for s in full
        )
    )


# (src_w, src_h, dst_w, dst_h, radius): the fused envelope's geometries, the
# deep-tap ones, and a 1/8 downscale with one phase of (181, 181) anchors
# (181**2 <= 32768, the largest fs of a one-phase plan).
STRIP_ENVELOPE = [g[:4] + (radius_for_tap(g[4]),) for g in ENVELOPE_GEOMS + DEEP_GEOMS] + [
    (1600, 800, 200, 100, 11.3)
]


@pytest.mark.parametrize("g", STRIP_ENVELOPE, ids=lambda g: "{}x{}->{}x{}-r{:.4g}".format(*g))
def test_strips_envelope_keeps_every_plan(g):
    """Every plan the previous strip kernel took is still taken, px 1 at
    fs 181 included, within the shared memory a block may opt into."""
    op = build_plane_operator(*g)
    plan = plan_phases(op)
    r = strips.make_strips(op, plan)
    if g[-1] == 11.3:
        assert (plan.x.p, plan.x.q, op.filter_size) == (1, 8, 181) and _taken_before(op, plan)
    if _taken_before(op, plan):
        assert r is not None
    if r is not None:
        assert r[0].layout.smem_bytes <= fused.MAX_SMEM_BYTES


# Reduced planes whose strips have the (px, qx, fs) of the full-size ones:
# 3840x2160 -> 7680x4320 tap 8, -> 1920x1080 tap 16 and -> 2560x1440 tap 16
# (2/3), and the fs-181 1/8 downscale (a qx the kernel does not unroll).
STRIP_LAYOUT_PLANS = {
    "4k-8k": ((480, 270, 960, 540, radius_for_tap(8)), (2, 1, 17)),
    "4k-1080p-tap16": ((480, 270, 240, 135, radius_for_tap(16)), (1, 2, 65)),
    "4k-1440p-tap16": ((480, 270, 320, 180, radius_for_tap(16)), (2, 3, 49)),
    "1/8-fs181": ((1600, 800, 200, 100, 11.3), (1, 8, 181)),
}


@pytest.mark.parametrize("name", list(STRIP_LAYOUT_PLANS))
def test_strips_layout_covers_every_read(name):
    """The kernel's tiling (``strips.layout``): every tap of the 4 anchors
    a lane owns lies in the block's staged columns; each register-window
    load (qx 1-3) is a 16-byte-aligned load inside the staged row, and so
    is every scalar read; the ring's 2*ch slots and the output tile fit the
    block's shared memory."""
    g, (px, qx, fs) = STRIP_LAYOUT_PLANS[name]
    op = build_plane_operator(*g)
    st = strips.make_strips(op, plan_phases(op))[0]
    lay = st.layout
    assert (st.px, st.qx, st.fs) == (px, qx, fs)
    x0 = qx * strips.ANCHORS * np.arange(32)
    taps = x0[:, None, None] + qx * np.arange(strips.ANCHORS)[:, None] + np.arange(fs)
    assert taps.min() == 0 and taps.max() == lay.sw - 1
    skew = np.vectorize(strips._skew)
    assert skew(lay.sw - 1) < lay.swp and lay.swp % 4 == 0
    if qx <= 3:
        kwin = -(-(qx * (strips.ANCHORS - 1) + strips.CHUNK) // 4) * 4
        for b0 in range(0, fs - strips.CHUNK + 1, strips.CHUNK):
            starts = skew(x0[:, None] + b0 + 4 * np.arange(kwin // 4))
            assert (starts % 4 == 0).all() and (starts + 3 < lay.swp).all()
    assert lay.rbr % strips.ROWS == 0 and lay.rbr <= strips.ROWS * strips.MAX_WARPS
    assert lay.nrb * lay.rbr >= st.ny_max and 1 <= lay.ch <= st.nb_max
    ring = 2 * lay.ch * (fs * lay.rbr + lay.swp)
    assert lay.smem_bytes == 4 * max(ring, lay.rbr * strips.TILE) <= fused.MAX_SMEM_BYTES


def test_envelope_is_shared_memory_alone():
    """Every plan of ``plan_phases`` (cost cap py*px*fs**2 <= 32768) fits
    the 227 KB a block may opt into; a 2/5 tap-16 plan needs the opt-in above
    48 KB (one 4-phase group of (84, 84) kernels: 113 KB). No kernel of the
    port keeps the TPU's FS2_MAX envelope."""
    op = _op((300, 200, 120, 80, 16), {})
    plan = plan_phases(op)
    assert (plan.y.p, plan.x.p, op.filter_size) == (2, 2, 82)
    assert 48 * 1024 < fused.smem_bytes(op, plan) <= fused.MAX_SMEM_BYTES
    assert fused.is_supported(op, plan)
    # 181**2 <= 32768: one phase of (181, 181) at a 1/8 downscale.
    assert fused.layout(1, 1, 8, 8, 181, 181).smem_bytes <= fused.MAX_SMEM_BYTES
    # A window row of 512*127 floats (254 KB) even in the narrowest block.
    wide = dataclasses.replace(plan.x, q=512)
    assert not fused.is_supported(op, type(plan)(x=wide, y=plan.y))


def test_bf16_not_ported():
    """'bf16' is ported (it raised before): the weights come rounded to
    bfloat16, the layout is the fp32 mode's, the plain form rounds the
    source (tests/test_torch_bf16.py holds it to the JAX kernel); an unknown
    mode still raises."""
    op = _op(*GEOMS[0])
    plan = plan_phases(op)
    fi = fused.make_fused_interior(op, plan, precision="bf16")
    f32 = fused.make_fused_interior(op, plan)
    assert fi.bf16 and not f32.bf16 and (fi.shape, fi.g) == (f32.shape, f32.g)
    assert torch.equal(fi.kernels, fused.round_bf16(f32.kernels))
    assert torch.equal(fi.w, fused.round_bf16(f32.w))
    src = torch.from_numpy(_src(op, 5, frames=1))
    want = fused.fused_interior(f32, fused.round_bf16(src))
    # Rounded weights on a rounded source: what the bf16 plain form computes.
    f32_rounded = dataclasses.replace(f32, w=fi.w, kernels=fi.kernels)
    got = fused.fused_interior(fi, src)
    assert torch.equal(got, fused.fused_interior(f32_rounded, fused.round_bf16(src)))
    assert not torch.equal(got, want)
    with pytest.raises(ValueError, match="unknown precision"):
        fused.make_fused_interior(op, plan, precision="fp16")


def test_wrappers_never_fall_back_off_cpu():
    """A tensor that is neither on the CPU nor on a CUDA device is refused."""
    op = _op(*GEOMS[0])
    plan = plan_phases(op)
    fi = fused.make_fused_interior(op, plan)
    st, _, _ = strips.make_strips(op, plan)
    src = torch.empty((1, op.src_height, op.src_width), device="meta")
    with pytest.raises(RuntimeError, match="unsupported device"):
        fused.fused_interior(fi, src)
    with pytest.raises(RuntimeError, match="unsupported device"):
        strips.strips(st, src)
    assert fused.fused_interior.launches == 0 and strips.strips.launches == 0


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    from jincresize_tpu_torch.kernels import _build

    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


def test_build_dir_keyed_by_sources():
    from jincresize_tpu_torch.kernels import _build

    names = {p.name for p in _build._sources()}
    assert {
        "fused_interior.cu", "strips.cu", "gather_interior.cu", "seg_interior.cu", "common.cuh"
    } <= names
    assert _build.build_dir() == _build.build_dir()
    assert _build.build_dir().parent == _build.BUILD_ROOT


@pytest.mark.parametrize("fail", [None, "seg_interior.cu"], ids=["builds", "one-source-fails"])
def test_build_compiles_each_source_then_links(fail, monkeypatch, tmp_path):
    """One ``nvcc -c`` per source, then one ``-shared`` link; a failing source
    fails the build, names the source and leaves no objects behind."""
    from jincresize_tpu_torch.kernels import _build

    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        "#!/bin/sh\n"
        'out=""; prev=""\n'
        'for a in "$@"; do [ "$prev" = "-o" ] && out="$a"; prev="$a"; done\n'
        f'case "$*" in *{fail or "no-such-source"}*) echo "error: bad kernel" >&2; exit 2;; esac\n'
        'touch "$out"\n'
    )
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    sources = sorted(p.name for p in _build.CSRC.glob("*.cu"))
    if fail:
        with pytest.raises(RuntimeError, match=f"(?s){fail}.*bad kernel"):
            _build.build()
        assert not list(_build.build_dir().glob("*.o"))
        assert not (_build.build_dir() / "libjt_kernels.so").exists()
        return
    lib = _build.build()
    assert lib.exists() and lib == _build.build_dir() / "libjt_kernels.so"
    log = (lib.parent / "build.log").read_text().splitlines()
    compiles = [line for line in log if " -c " in line]
    assert sorted(line.split()[-1].rsplit("/", 1)[-1] for line in compiles) == sources
    assert sum(" -shared " in line for line in log) == 1
    assert not list(lib.parent.glob("*.o"))


def test_gather_band_kernel_is_built_and_bound():
    """The sharded engine's band kernel has its source and its C signature:
    seven pointers, thirteen sizes (nine, then the padded tap row, the
    frames a thread and the ring's row width and depth of the Hopper
    redesign), the stream; its tile body is shared with the interior."""
    from jincresize_tpu_torch.kernels import _build

    assert (_build.CSRC / "gather_band.cu").exists()
    assert "gather_band.cu" in {p.name for p in _build._sources()}
    sig = _build._SIGNATURES["jt_gather_band"]
    assert sig == [_build._P] * 7 + [_build._I] * 13 + [_build._P]
    for name in ("gather_band.cu", "gather_interior.cu"):
        assert '#include "gather_tile.cuh"' in (_build.CSRC / name).read_text()
    assert "jt_gather_band(" in (_build.CSRC / "gather_band.cu").read_text()


# Reduced planes whose plans have the (p, q, fs, offsets) of the full-size
# ones: 3840x2160 -> 7680x4320 tap 8, -> 1920x1080 tap 16 and -> 2560x1440
# tap 16 (2/3), and the 2/5 tap-16 plan of chip_smoke.py.
LAYOUT_PLANS = {
    "4k-8k": ((480, 270, 960, 540, 8), (2, 1, 17, (0, 0))),
    "4k-1080p-tap16": ((480, 270, 240, 135, 16), (1, 2, 65, (0,))),
    "4k-1440p-tap16": ((480, 270, 320, 180, 16), (2, 3, 49, (0, 2))),
    "2/5-tap16": ((300, 200, 120, 80, 16), (2, 5, 82, (0, 2))),
}


@pytest.mark.parametrize("shape", fused.SHAPES, ids=fused.shape_name)
@pytest.mark.parametrize("name", list(LAYOUT_PLANS))
def test_fused_layout_covers_every_read(name, shape):
    """The kernel's tiling (``fused.layout``): every tap of every output a
    thread owns comes from the block's staged window (inside the real
    columns, not its padding) and from the register window the thread
    loads for that tap's chunk; the staged rows keep distinct ring slots
    while two stages are resident; every skewed address stays inside its
    row and 16-byte loads stay aligned."""
    g, (p, q, fs, offs) = LAYOUT_PLANS[name]
    op = _op(g, {})
    plan = plan_phases(op)
    assert (plan.y.p, plan.x.p, plan.y.q, plan.x.q, op.filter_size) == (p, p, q, q, fs)
    assert tuple(plan.y.offsets) == tuple(plan.x.offsets) == offs
    fi = fused.make_fused_interior(op, plan)
    lay = fi.layout(shape)
    nph, kh, kw = fi.kernels.shape
    assert fi.shape == fused.DEFAULT_SHAPE and fi.g == (4 if nph % 4 == 0 else 1)
    assert (lay.kh, lay.kw, lay.g * lay.ngroups, lay.c * lay.g) == (kh, kw, nph, shape[2])
    assert tuple(fi.w.shape) == (lay.ngroups, kh, lay.kwp, lay.g)
    # Rows: anchor row c of a block reads window rows q*c + a, a < kh.
    rows = q * np.arange(lay.c)[:, None] + np.arange(kh)
    assert rows.min() == 0 and rows.max() == lay.nr - 1
    for k in range(-(-lay.nr // lay.ch)):  # stages k and k + 1 are resident together
        live = np.arange(k * lay.ch, min(lay.nr, (k + 2) * lay.ch))
        assert len(set(live % lay.slots)) == len(live)
    # Columns: thread t's anchor r reads window column q*(R*t + r) + b.
    full = kw // fused.CHUNK * fused.CHUNK
    for t in range(lay.tx):
        for b in range(kw):
            b0, taps = (b // fused.CHUNK * fused.CHUNK, fused.CHUNK) if b < full else (b, 1)
            win = fused.thread_window(lay, q, t, b0, taps)
            xs = q * (lay.r * t + np.arange(lay.r)) + b
            assert win.start <= xs.min() and xs.max() < win.stop, (t, b)
            assert xs.max() < lay.sw
            last = win.stop - 1
            assert fused._skew(last) < lay.swp
            if lay.qx_mode and taps == fused.CHUNK:
                assert win.start % 4 == 0 and fused._skew(win.start) % 4 == 0
    assert lay.swp % 4 == 0 and lay.kwp % 4 == 0
    # Blocks: the staged window of block (by, bx) starts at the reads of its
    # first anchor, and every anchor of the plan has one block.
    row0, col0, i0, j0 = fused.block_origin(lay, q, q, fi.base_y, fi.base_x, 3, 1)
    assert (row0, col0) == (fi.base_y + q * i0, fi.base_x + q * j0) == (
        fi.base_y + q * 3 * lay.c, fi.base_x + q * lay.bj)
    assert lay.smem_bytes <= fused.MAX_SMEM_BYTES


def test_fused_shared_memory_of_every_admitted_plan():
    """``plan_phases`` caps py*px*fs**2 at 32768; for every such (p, fs) with
    phase offsets up to q and steps q <= 32, a shape fits the 227 KB a block
    may opt into (the default, else the narrow one), and so do both
    shapes at the four plans of ``LAYOUT_PLANS``; the narrow shape serves
    only plans with a wide window row (a large step q)."""
    worst = 0
    for py in (1, 2, 3, 4, 5, 8):
        for px in (1, 2, 3, 4, 5, 8):
            fs_max = int((32768 // (py * px)) ** 0.5)
            for fs in sorted({3, 7, 17, fs_max // 2, fs_max}):
                for q in range(1, 33):
                    k = fs + min(q, fs) - 1
                    fit = fused.fit_shape(py, px, q, q, k, k)
                    assert fit is not None, (py, px, q, fs)
                    worst = max(worst, fused.layout(py, px, q, q, k, k, *fit).smem_bytes)
    assert 48 * 1024 < worst <= fused.MAX_SMEM_BYTES
    assert fused.fit_shape(1, 1, 32, 32, 145, 145) == (fused.NARROW_SHAPE, 1)
    for (p, q, fs, offs) in (v[1] for v in LAYOUT_PLANS.values()):
        for shape in fused.SHAPES:
            lay = fused.layout(p, p, q, q, fs + max(offs), fs + max(offs), shape)
            assert lay.smem_bytes <= fused.MAX_SMEM_BYTES
