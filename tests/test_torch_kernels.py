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
    op = _op(*GEOMS[0])
    with pytest.raises(NotImplementedError, match="bf16"):
        fused.make_fused_interior(op, plan_phases(op), precision="bf16")


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
