"""Port's public API (device='cpu') against ``jincresize_tpu.api``.

On the CPU the JAX package's automatic engine is its XLA shift-sum conv
interior; the port's is the fused engine with its kernels' plain forms. Both
build the same operators from the shared host layer. Tolerances: <= 1 LSB
for integer formats after ``finalize``, 2e-6 absolute for 32-bit float.
"""

import dataclasses

import numpy as np
import pytest
import torch

from jincresize_tpu import api as japi
from jincresize_tpu.clip import Clip, gray, random_frame, rgbp, yuv420p, yuv422p, yuv444p
from jincresize_tpu_torch import api

F32_TOL = 2e-6


def _clip(fmt, w=32, h=24, n=1, seed=0, props=None):
    return Clip.from_frames(
        [random_frame(fmt, w, h, seed=seed + i, props=props) for i in range(n)]
    )


def _assert_clips_close(a, b, bits):
    tol = F32_TOL if bits == 32 else 1
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
    want = japi.jinc_resize(clip, 64, 48, tap=3)
    _assert_clips_close(got, want, fmt.bits)


@pytest.mark.parametrize("cplace", ["mpeg2", "mpeg1", "topleft"])
def test_cplace_matches_jax(cplace):
    clip = _clip(yuv420p(8), seed=5)
    got = api.jinc_resize(clip, 64, 48, cplace=cplace, device="cpu")
    want = japi.jinc_resize(clip, 64, 48, cplace=cplace)
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
    _assert_clips_close(out, japi.jinc_resize(clip, 48, 36, impl="numpy"), 8)


def test_no_chroma_location_prop_for_444():
    out = api.jinc_resize(_clip(yuv444p(8)), 48, 36, device="cpu")
    assert "_ChromaLocation" not in out.frames[0].props


@pytest.mark.parametrize(
    "geom,tap,want,want_jax",
    [
        ((32, 24, 64, 48), 3, "fused", "shift"),
        ((96, 64, 288, 192), 2, "xla", "xla"),
        ((480, 270, 240, 135), 16, "xla", "shift"),
    ],
    ids=["periodic", "aperiodic", "deep-tap"],
)
def test_engines_follow_the_auto_rule(geom, tap, want, want_jax):
    """auto: fused where the plan is periodic and inside the kernel's
    envelope, else the general engine. The JAX package's rule off the TPU
    is the same, with its shift-sum conv interior in the fused engine's
    place (and for deep taps, which the port does not run fused yet)."""
    sw, sh, dw, dh = geom
    fmt = yuv444p(8)
    cfg = api.JincConfig(target_width=dw, target_height=dh, tap=tap)
    r = api.JincResizer(fmt, sw, sh, cfg, device="cpu")
    assert r.engines == {"luma": want}
    jcfg = japi.JincConfig(target_width=dw, target_height=dh, tap=tap)
    assert japi.JincResizer(fmt, sw, sh, jcfg).engines == {"luma": want_jax}


def test_deep_tap_auto_matches_jax():
    clip = _clip(gray(8), w=96, h=64, seed=2)
    got = api.jinc_resize(clip, 48, 32, tap=16, device="cpu")
    want = japi.jinc_resize(clip, 48, 32, tap=16)
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
        japi.jinc_resize(clip, 48, 36, **kw)
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
        japi.jinc_resize(clip, 48, 36, impl="numpy", **kw)
    with pytest.raises(api.JincError) as te:
        api.jinc_resize(clip, 48, 36, device="cpu", **kw)
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("impl", ["seg", "gather", "sharded"])
def test_unported_engines_raise(impl):
    with pytest.raises(NotImplementedError, match=f"impl='{impl}'.*ROADMAP"):
        api.jinc_resize(_clip(gray()), 64, 48, impl=impl, device="cpu")


def test_bf16_raises_and_conv_requires_periodic():
    with pytest.raises(NotImplementedError, match="bf16.*ROADMAP"):
        api.jinc_resize(_clip(gray()), 64, 48, precision="bf16", device="cpu")
    clip = _clip(gray(), w=96, h=64)
    with pytest.raises(api.JincError, match="impl='conv' requires periodic"):
        api.jinc_resize(clip, 288, 192, tap=2, impl="conv", device="cpu")
    with pytest.raises(NotImplementedError, match="envelope"):
        api.jinc_resize(clip, 288, 192, tap=2, impl="pallas", device="cpu")


@pytest.mark.parametrize("impl", ["conv", "pallas", "xla", "numpy"])
def test_forced_engines_match_golden(impl):
    clip = _clip(yuv420p(8), seed=9)
    got = api.jinc_resize(clip, 64, 48, impl=impl, device="cpu")
    want = japi.jinc_resize(clip, 64, 48, impl="numpy")
    _assert_clips_close(got, want, 8)


def test_aliases_pin_tap():
    clip = _clip(gray())
    a = api.jinc36_resize(clip, 40, 30, device="cpu")
    b = api.jinc_resize(clip, 40, 30, tap=3, device="cpu")
    np.testing.assert_array_equal(a.frames[0].planes["Y"], b.frames[0].planes["Y"])
    c = api.jinc256_resize(clip, 40, 30, device="cpu")
    _assert_clips_close(c, japi.jinc256_resize(clip, 40, 30), 8)
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
