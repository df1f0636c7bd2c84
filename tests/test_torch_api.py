"""Port's public API (device='cpu') against ``jincresize_tpu.api``.

On the CPU the JAX package's automatic engine is its XLA shift-sum conv
interior; the port's is the fused engine with its kernels' plain forms. Each
package builds its own clips and operators from its own host layer (bit
for bit the same, ``tests/test_torch_host.py``): the port's clips are handed
to the JAX package as ``jincresize_tpu.clip`` objects over the same arrays.
Tolerances: <= 1 LSB for integer formats after ``finalize``, 2e-6 absolute
for 32-bit float (4e-6 for deep taps, fs**2 > 1200).
"""

import dataclasses

import numpy as np
import pytest
import torch

from jincresize_tpu import api as japi
from jincresize_tpu import clip as jclip
from jincresize_tpu_torch import api
from jincresize_tpu_torch.clip import Clip, gray, random_frame, rgbp, yuv420p, yuv422p, yuv444p


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


def _jfmt(fmt):
    """The JAX package's VideoFormat equal to the port's ``fmt``."""
    return jclip.VideoFormat(**dataclasses.asdict(fmt))


def _jclip(clip):
    """The port's ``clip`` as a JAX package Clip over the same arrays."""
    return jclip.Clip.from_frames(
        [jclip.Frame(_jfmt(f.format), dict(f.planes), dict(f.props)) for f in clip.frames]
    )


def _clip(fmt, w=32, h=24, n=1, seed=0, props=None):
    return Clip.from_frames(
        [random_frame(fmt, w, h, seed=seed + i, props=props) for i in range(n)]
    )


def _assert_clips_close(a, b, bits, f32_tol=F32_TOL):
    tol = f32_tol if bits == 32 else 1
    assert len(a.frames) == len(b.frames)
    assert (a.width, a.height) == (b.width, b.height)
    for fa, fb in zip(a.frames, b.frames):
        fa.validate()
        assert fa.props == fb.props
        for n in fa.planes:
            assert fa.planes[n].dtype == fb.planes[n].dtype
            d = np.abs(fa.planes[n].astype(np.float64) - fb.planes[n].astype(np.float64))
            assert float(d.max()) <= tol, n


FORMATS = [yuv420p(8), yuv444p(16), yuv444p(32), rgbp(8), rgbp(32)]


@pytest.mark.parametrize(
    "fmt", FORMATS, ids=lambda f: f"{f.family}{f.sub_w}{f.sub_h}-{f.bits}"
)
def test_jinc_resize_matches_jax(fmt):
    clip = _clip(fmt, n=2, seed=3)
    got = api.jinc_resize(clip, 64, 48, tap=3, device="cpu")
    want = japi.jinc_resize(_jclip(clip), 64, 48, tap=3)
    _assert_clips_close(got, want, fmt.bits)


@pytest.mark.parametrize("cplace", ["mpeg2", "mpeg1", "topleft"])
def test_cplace_matches_jax(cplace):
    clip = _clip(yuv420p(8), seed=5)
    got = api.jinc_resize(clip, 64, 48, cplace=cplace, device="cpu")
    want = japi.jinc_resize(_jclip(clip), 64, 48, cplace=cplace)
    _assert_clips_close(got, want, 8)
    loc = {"mpeg2": 0, "mpeg1": 1, "topleft": 2}[cplace]
    assert got.frames[0].props["_ChromaLocation"] == loc


@pytest.mark.parametrize("loc,cplace", [(0, "mpeg2"), (1, "mpeg1"), (2, "topleft")])
def test_chroma_location_prop_resolves_cplace(loc, cplace):
    clip = _clip(yuv420p(8), props={"_ChromaLocation": loc})
    cfg = api.JincConfig(target_width=48, target_height=36, impl="numpy")
    r = api.JincResizer(clip.format, 32, 24, cfg, frame0=clip.frames[0], device="cpu")
    assert r.cplace == cplace
    out = r(clip)
    assert out.frames[0].props["_ChromaLocation"] == loc
    _assert_clips_close(out, japi.jinc_resize(_jclip(clip), 48, 36, impl="numpy"), 8)


def test_no_chroma_location_prop_for_444():
    out = api.jinc_resize(_clip(yuv444p(8)), 48, 36, device="cpu")
    assert "_ChromaLocation" not in out.frames[0].props


@pytest.mark.parametrize(
    "geom,tap,want,want_jax",
    [
        ((32, 24, 64, 48), 3, "fused", "shift"),
        ((96, 64, 288, 192), 2, "xla", "xla"),
        ((480, 270, 240, 135), 16, "fused", "shift"),
    ],
    ids=["periodic", "aperiodic", "deep-tap"],
)
def test_engines_follow_the_auto_rule(geom, tap, want, want_jax):
    """auto: fused where the plan is periodic (deep taps and small outputs
    included), else the general engine. The JAX package's rule off the TPU
    is the same, with its shift-sum conv interior in the fused engine's
    place."""
    sw, sh, dw, dh = geom
    fmt = yuv444p(8)
    cfg = api.JincConfig(target_width=dw, target_height=dh, tap=tap)
    r = api.JincResizer(fmt, sw, sh, cfg, device="cpu")
    assert r.engines == {"luma": want}
    jcfg = japi.JincConfig(target_width=dw, target_height=dh, tap=tap)
    assert japi.JincResizer(_jfmt(fmt), sw, sh, jcfg).engines == {"luma": want_jax}


def test_deep_tap_auto_matches_jax():
    clip = _clip(gray(8), w=96, h=64, seed=2)
    got = api.jinc_resize(clip, 48, 32, tap=16, device="cpu")
    want = japi.jinc_resize(_jclip(clip), 48, 32, tap=16)
    _assert_clips_close(got, want, 8)


ERRORS = [
    (dict(tap=0), "JincResize: tap must be between 1..16."),
    (dict(tap=17), "JincResize: tap must be between 1..16."),
    (dict(quant_x=0), "JincResize: quant_x must be between 1..256."),
    (dict(quant_y=300), "JincResize: quant_y must be between 1..256."),
    (dict(opt=4), "JincResize: opt higher than 3 is not allowed."),
    (dict(threads=2), "JincResize: threads must be either 0 or 1."),
    (dict(initial_factor=0.5), "JincResize: initial_factor must be eqaul to or greater than 1.0."),
    (dict(initial_capacity=0), "JincResize: initial_capacity must be greater than 0."),
    (dict(cplace="center"), "JincResize: cplace must be MPEG2, MPEG1 or topleft."),
    (dict(impl="cuda"), "JincResize: unknown impl 'cuda'."),
    (dict(precision="fp16"), "JincResize: unknown precision 'fp16'."),
    (dict(pos_precision="f16"), "JincResize: unknown pos_precision 'f16'."),
]  # fmt: skip


@pytest.mark.parametrize("kw,msg", ERRORS, ids=[m.split(": ")[1][:24] for _, m in ERRORS])
def test_validation_messages_identical(kw, msg):
    clip = _clip(gray())
    kw = {"impl": "numpy", **kw}
    with pytest.raises(japi.JincError) as je:
        japi.jinc_resize(_jclip(clip), 48, 36, **kw)
    with pytest.raises(api.JincError) as te:
        api.jinc_resize(clip, 48, 36, device="cpu", **kw)
    assert str(te.value) == str(je.value) == msg


@pytest.mark.parametrize(
    "fmt,props,kw",
    [
        (yuv422p(8), None, dict(cplace="topleft")),
        (yuv420p(8), {"_ChromaLocation": 5}, {}),
    ],
    ids=["topleft-not-420", "bad-chroma-location"],
)
def test_cplace_errors_identical(fmt, props, kw):
    clip = _clip(fmt, props=props)
    with pytest.raises(japi.JincError) as je:
        japi.jinc_resize(_jclip(clip), 48, 36, impl="numpy", **kw)
    with pytest.raises(api.JincError) as te:
        api.jinc_resize(clip, 48, 36, device="cpu", **kw)
    assert str(te.value) == str(je.value)


# impl -> (geometry, engine) of the seg and gather engines.
PORTED_ENGINES = {
    "seg": ((96, 64, 288, 192, 2), "fused-seg"),
    "gather": ((96, 64, 167, 113, 3), "gather"),
}


@pytest.mark.parametrize("impl", ["seg", "gather", "sharded"])
def test_unported_engines_raise(impl):
    """No engine raises as unported any more: 'seg', 'gather' and 'sharded'
    (on the default mesh, the one CPU device) run their engines."""
    (sw, sh, dw, dh, tap), engine = PORTED_ENGINES.get(impl, PORTED_ENGINES["gather"])
    if impl == "sharded":
        engine = "sharded/gather"
    clip = _clip(gray(), w=sw, h=sh)
    cfg = api.JincConfig(target_width=dw, target_height=dh, tap=tap, impl=impl)
    r = api.JincResizer(clip.format, sw, sh, cfg, device="cpu")
    assert r.engines == {"luma": engine}
    _assert_clips_close(r(clip), japi.jinc_resize(_jclip(clip), dw, dh, tap=tap, impl="numpy"), 8)


def test_bf16_raises_and_conv_requires_periodic():
    """'bf16' runs (it raised before it was ported; tests/test_torch_bf16.py
    holds its numbers); impl='conv' still requires periodic geometry."""
    r = api.JincResizer(gray(), 32, 24, api.JincConfig(64, 48, precision="bf16"), device="cpu")
    assert r.engines == {"luma": "fused"} and r._applier_luma.effective_precision == "bf16"
    out = r(_clip(gray()))
    assert out.frames[0].planes["Y"].shape == (48, 64)
    with pytest.raises(api.JincError, match="unknown precision"):
        api.jinc_resize(_clip(gray()), 64, 48, precision="fp16", device="cpu")
    clip = _clip(gray(), w=96, h=64)
    with pytest.raises(api.JincError, match="impl='conv' requires periodic"):
        api.jinc_resize(clip, 288, 192, tap=2, impl="conv", device="cpu")
    # Outside the fused envelope, 'pallas' now runs the next hand-written
    # engine: this 3x plane is segment-periodic.
    cfg = api.JincConfig(target_width=288, target_height=192, tap=2, impl="pallas")
    assert api.JincResizer(clip.format, 96, 64, cfg, device="cpu").engines == {
        "luma": "fused-seg"
    }
    cfg = api.JincConfig(288, 192, tap=2, impl="seg", precision="bf16")
    r = api.JincResizer(clip.format, 96, 64, cfg, device="cpu")
    assert r.engines == {"luma": "fused-seg"} and r._applier_luma.effective_precision == "bf16"
    assert r(clip).frames[0].planes["Y"].shape == (192, 288)


@pytest.mark.parametrize("impl", ["conv", "pallas", "xla", "numpy"])
def test_forced_engines_match_golden(impl):
    clip = _clip(yuv420p(8), seed=9)
    got = api.jinc_resize(clip, 64, 48, impl=impl, device="cpu")
    want = japi.jinc_resize(_jclip(clip), 64, 48, impl="numpy")
    _assert_clips_close(got, want, 8)


def test_aliases_pin_tap():
    clip = _clip(gray())
    a = api.jinc36_resize(clip, 40, 30, device="cpu")
    b = api.jinc_resize(clip, 40, 30, tap=3, device="cpu")
    np.testing.assert_array_equal(a.frames[0].planes["Y"], b.frames[0].planes["Y"])
    c = api.jinc256_resize(clip, 40, 30, device="cpu")
    _assert_clips_close(c, japi.jinc256_resize(_jclip(clip), 40, 30), 8)
    assert [f.__name__ for f in (api.jinc36_resize, api.jinc64_resize, api.jinc144_resize, api.jinc256_resize)] == [
        "jinc36_resize", "jinc64_resize", "jinc144_resize", "jinc256_resize"
    ]  # fmt: skip


def test_config_copy_equals_original():
    ours = [(f.name, f.default) for f in dataclasses.fields(api.JincConfig)]
    theirs = [(f.name, f.default) for f in dataclasses.fields(japi.JincConfig)]
    assert ours == theirs


def test_batched_clip_matches_per_frame():
    clip = _clip(yuv420p(8), n=3, seed=4, props={"_ChromaLocation": 0})
    cfg = api.JincConfig(target_width=64, target_height=48)
    r = api.JincResizer(clip.format, 32, 24, cfg, frame0=clip.frames[0], device="cpu")
    batched = r(clip)
    for fb, f in zip(batched.frames, clip.frames):
        one = r.process_frame(f)
        for n in fb.planes:
            d = np.abs(fb.planes[n].astype(int) - one.planes[n].astype(int))
            assert d.max() <= 1, n


def test_cuda_device_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.jinc_resize(_clip(gray()), 64, 48)


def test_engine_records_match_jax():
    """impl='seg' and 'gather' record the JAX package's engine names and run
    end to end within 1 LSB of the host golden."""
    for impl, ((sw, sh, dw, dh, tap), engine) in PORTED_ENGINES.items():
        clip = _clip(gray(8), w=sw, h=sh, seed=7)
        cfg = api.JincConfig(target_width=dw, target_height=dh, tap=tap, impl=impl)
        r = api.JincResizer(clip.format, sw, sh, cfg, frame0=clip.frames[0], device="cpu")
        jcfg = japi.JincConfig(target_width=dw, target_height=dh, tap=tap, impl=impl)
        assert r.engines == japi.JincResizer(_jfmt(clip.format), sw, sh, jcfg).engines
        assert r.engines == {"luma": engine}
        assert r._applier_luma.interior == engine
        _assert_clips_close(r(clip), japi.jinc_resize(_jclip(clip), dw, dh, tap=tap, impl="numpy"), 8)


def test_impl_pallas_runs_hand_written_engines():
    """'pallas' runs a hand-written engine for every geometry it accepts:
    fused for periodic geometry, the gather kernel for aperiodic geometry."""
    clip = _clip(gray(8), w=64, h=48, seed=3)
    cfg = api.JincConfig(target_width=128, target_height=96, impl="pallas")
    assert api.JincResizer(clip.format, 64, 48, cfg, device="cpu").engines == {"luma": "fused"}
    clip2 = _clip(gray(8), w=96, h=64, seed=4)
    cfg2 = api.JincConfig(target_width=167, target_height=113, impl="pallas")
    r2 = api.JincResizer(clip2.format, 96, 64, cfg2, device="cpu")
    assert r2.engines == {"luma": "gather"}
    _assert_clips_close(r2(clip2), japi.jinc_resize(_jclip(clip2), 167, 113, impl="numpy"), 8)


# A small aperiodic deep-tap plane (fs 92, 16 x 62 classes, a 33.6 MB
# dictionary, a 64 x 139 interior) with the 2.8125 row ratio of
# 3840x2160 -> 1366x768 tap 16.
DEEP_GATHER = (480, 270, 171, 96)


# impl='gather' declines the border-only operator (no dictionary) in both
# packages; deep taps no longer decline it in the port (the JAX package's
# envelope ends at fs**2 = 1200: test_pallas_deep_tap_not_ported).
ENGINE_ERRORS = [
    ("seg", (400, 220, 601, 331, 3), "segment-periodic"),
    ("gather", (8, 8, 16, 16, 8), "gather kernel envelope"),
    ("pallas", (8, 8, 16, 16, 8), "outside all Pallas"),
    ("conv", (96, 64, 167, 113, 3), "requires periodic"),
]


@pytest.mark.parametrize(
    "impl,geom,msg", ENGINE_ERRORS, ids=[f"{e[0]}-{e[2].split()[0]}" for e in ENGINE_ERRORS]
)
def test_engine_errors_identical(impl, geom, msg):
    sw, sh, dw, dh, tap = geom
    with pytest.raises(japi.JincError, match=msg) as je:
        japi.JincResizer(_jfmt(gray(8)), sw, sh, japi.JincConfig(dw, dh, tap=tap, impl=impl))
    with pytest.raises(api.JincError) as te:
        api.JincResizer(gray(8), sw, sh, api.JincConfig(dw, dh, tap=tap, impl=impl), device="cpu")
    assert str(te.value) == str(je.value)


def test_pallas_deep_tap_not_ported():
    """impl='pallas' runs deep-tap periodic plans on the fused engine (the
    JAX package's 'pallas' runs its fused kernel there too). An aperiodic
    deep-tap plan, which the JAX package's 'pallas' and 'gather' decline
    (fs**2 > 1200), runs on the port's gather kernel, which takes any
    filter size."""
    cfg = api.JincConfig(target_width=240, target_height=135, tap=16, impl="pallas")
    r = api.JincResizer(gray(8), 480, 270, cfg, device="cpu")
    assert r.engines == {"luma": "fused"} and r._applier_luma.fi.fs == 65
    sw, sh, dw, dh = DEEP_GATHER
    for impl in ("pallas", "gather"):
        cfg = api.JincConfig(target_width=dw, target_height=dh, tap=16, impl=impl)
        r = api.JincResizer(gray(8), sw, sh, cfg, device="cpu")
        assert r.engines == {"luma": "gather"} and r.op_luma.filter_size == 92
        jcfg = japi.JincConfig(target_width=dw, target_height=dh, tap=16, impl=impl)
        with pytest.raises(japi.JincError, match="outside all Pallas|gather kernel envelope"):
            japi.JincResizer(_jfmt(gray(8)), sw, sh, jcfg)


DEEP = {"2x-fs65": (480, 270, 240, 135), "2/3-fs49": (480, 270, 320, 180)}


@pytest.fixture(scope="module")
def deep_jax_outputs():
    """The JAX package's automatic engine on the deep-tap clips (off the TPU
    its XLA shift-sum deep-tap forms), per geometry and bit depth."""
    out = {}
    for name, (sw, sh, dw, dh) in DEEP.items():
        for bits in (8, 16, 32):
            clip = _clip(gray(bits), w=sw, h=sh, seed=11)
            out[name, bits] = (clip, japi.jinc_resize(_jclip(clip), dw, dh, tap=16))
    return out


@pytest.mark.parametrize("bits", [8, 16, 32])
@pytest.mark.parametrize("name", list(DEEP))
def test_deep_tap_plans_take_fused_and_match_jax(name, bits, deep_jax_outputs):
    """480x270 -> 240x135 (p=1, fs=65) and -> 320x180 (p=(2,2), fs=49) at
    tap 16 take ``fused`` through 'auto', 'conv' and 'pallas' on the CPU, at
    <= 1 LSB (u8, u16) and 4e-6 (fp32) from the JAX package."""
    sw, sh, dw, dh = DEEP[name]
    clip, want = deep_jax_outputs[name, bits]
    for impl in ("auto", "conv", "pallas"):
        cfg = api.JincConfig(target_width=dw, target_height=dh, tap=16, impl=impl)
        r = api.JincResizer(clip.format, sw, sh, cfg, device="cpu")
        assert r.engines == {"luma": "fused"}, impl
    _assert_clips_close(r(clip), want, bits, f32_tol=DEEP_TOL)


@pytest.mark.parametrize(
    "geom", [(96, 64, 167, 113, 3), (96, 64, 288, 192, 2)], ids=["aperiodic", "segment-periodic"]
)
def test_auto_on_cpu_takes_xla_off_the_periodic_path(geom):
    """On the CPU, auto stays fused -> xla, as the JAX package's does off the TPU."""
    sw, sh, dw, dh, tap = geom
    r = api.JincResizer(gray(8), sw, sh, api.JincConfig(dw, dh, tap=tap), device="cpu")
    assert r.engines == {"luma": "xla"}
    assert japi.JincResizer(_jfmt(gray(8)), sw, sh, japi.JincConfig(dw, dh, tap=tap)).engines == {
        "luma": "xla"
    }


# The gather kernel takes any filter size, so the aperiodic tap-16 downscale
# (fs 66, where the JAX package's gather envelope declines and its auto takes
# xla) now takes gather; only the border-only operator, whose dictionary is
# empty, still reaches xla. The seg kernel takes any filter size whose tile
# pair blocks fit the shared memory, so the drifted tap-16 downscale (fs 44,
# 1440p -> 1080p at a quarter size; the JAX package: xla) takes fused-seg.
AUTO_CUDA = [
    ((32, 24, 64, 48, 3), "fused", "ConvApplier", "fused"),
    ((96, 64, 288, 192, 2), "fused-seg", "SegConvApplier", "fused-seg"),
    ((640, 360, 480, 270, 16), "fused-seg", "SegConvApplier", "fused-seg-deep"),
    ((96, 64, 167, 113, 3), "gather", "GatherApplier", "gather"),
    ((481, 271, 240, 135, 16), "gather", "GatherApplier", "gather-deep"),
    ((8, 8, 16, 16, 8), "xla", None, "xla"),
]


@pytest.mark.parametrize("geom,engine,cls", [e[:3] for e in AUTO_CUDA], ids=[e[3] for e in AUTO_CUDA])
def test_auto_on_cuda_selects_fused_seg_gather_xla(geom, engine, cls, monkeypatch):
    """auto on a CUDA device: fused -> fused-seg -> gather -> xla. The
    appliers are stand-ins here (no card): the order is what is checked."""
    from jincresize_tpu_torch.operator import build_plane_operator, radius_for_tap

    made = []
    for name in ("ConvApplier", "SegConvApplier", "GatherApplier"):
        monkeypatch.setattr(api, name, lambda op, *a, _n=name, **kw: made.append(_n) or _n)
    sw, sh, dw, dh, tap = geom
    op = build_plane_operator(sw, sh, dw, dh, radius_for_tap(tap))
    app, eng = api._select_engine(op, "auto", "fp32", torch.device("cuda"))
    assert (app, eng, made) == (cls, engine, [cls] if cls else [])


@pytest.fixture(scope="module")
def deep_gather_outputs():
    """The JAX package's jinc_resize (auto: xla, its gather envelope
    declines fs 92) and the port's golden on one-frame gray fp32 and u8 clips."""
    sw, sh, dw, dh = DEEP_GATHER
    out = {}
    for bits in (32, 8):
        clip = _clip(gray(bits), sw, sh, seed=40)
        jr = japi.JincResizer(_jfmt(gray(bits)), sw, sh, japi.JincConfig(dw, dh, tap=16))
        assert jr.engines == {"luma": "xla"}
        golden = api.jinc_resize(clip, dw, dh, tap=16, impl="numpy", device="cpu")
        out[bits] = (clip, jr(_jclip(clip)), golden)
    return out


@pytest.mark.parametrize("bits", [32, 8], ids=["f32", "u8"])
def test_gather_deep_tap_matches_jax_and_golden(bits, deep_gather_outputs):
    """fs**2 > 1200 through the port's GatherApplier (impl='gather', plain
    forms on the CPU) against the JAX package's output: fp32 within the
    deep-tap bound, u8 within 1 LSB; both against the host golden (u8 1
    LSB; fp32 at 1e-5, the golden's own float32 chain over 8464 taps being
    4.5e-6 off a float64 sum, the engines 5e-7, tests/test_torch_gather.py
    golden64)."""
    sw, sh, dw, dh = DEEP_GATHER
    clip, want, golden = deep_gather_outputs[bits]
    r = api.JincResizer(gray(bits), sw, sh, api.JincConfig(dw, dh, tap=16, impl="gather"), device="cpu")
    assert r.engines == {"luma": "gather"} and r.op_luma.filter_size == 92
    got = r(clip)
    _assert_clips_close(got, want, bits, f32_tol=DEEP_TOL)
    golden_tol = 1e-5 if bits == 32 else 1
    _assert_clips_close(got, golden, bits, f32_tol=golden_tol)
    _assert_clips_close(want, golden, bits, f32_tol=golden_tol)
