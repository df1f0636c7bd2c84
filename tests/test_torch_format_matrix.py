"""Format matrix through the port and the JAX package, on the CPU.

Twin of ``tests/test_format_matrix.py``: its 15 ``CASES`` ({u8, u10, u16,
f32} x {Y, 420, 422, 444, 411, RGB, + alpha} x {up, down, sub-pixel crop +
blur} x cplace x quant) and its five quirk tests (the float source clamp,
the u16 overshoot clamp, the alpha float-clamp quirk, the u16 sub-peak
overshoot under SIMD and C dispatch, and alpha on the luma operator), each
through ``jincresize_tpu_torch.api.jinc_resize(..., device='cpu')`` and
``jincresize_tpu.api.jinc_resize`` on the same arrays. Tolerances: <= 1 LSB
for integer formats, 1e-6 for fp32 (the JAX file's own against its golden).
The u8 cases are the planes that run the fused and seg kernels' weight
split (``precision='fp32_u8src'``): their port resizers report it.
"""

import dataclasses

import numpy as np
import pytest
import torch

from jincresize_tpu import api as japi
from jincresize_tpu import clip as jclip
from jincresize_tpu_torch import api
from jincresize_tpu_torch.clip import (Clip, Frame, gray, random_frame, rgbp, yuv411p, yuv420p,
                                       yuv422p, yuv444p)  # fmt: skip


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread for this module's tests (the workers of
    pytest-xdist share the machine's cores); the old count is back after
    the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jclip(clip):
    """The port's ``clip`` as a JAX package Clip over the same arrays."""
    def jfmt(fmt):
        return jclip.VideoFormat(**dataclasses.asdict(fmt))

    return jclip.Clip.from_frames(
        [jclip.Frame(jfmt(f.format), dict(f.planes), dict(f.props)) for f in clip.frames]
    )


def _both(clip, dw, dh, **kw):
    """Frame 0 of ``clip`` resized by the port (on the CPU) and by the JAX
    package."""
    got = api.jinc_resize(clip, dw, dh, device="cpu", **kw).frames[0]
    want = japi.jinc_resize(_jclip(clip), dw, dh, **kw).frames[0]
    got.validate()
    return got, want


def _close(got, want, bits, names=None):
    for n in names or got.planes:
        a, b = got.planes[n], want.planes[n]
        assert a.shape == b.shape and a.dtype == b.dtype, n
        if bits == 32:
            assert np.abs(a - b).max() <= 1e-6, n
        else:
            assert np.abs(a.astype(int) - b.astype(int)).max() <= 1, n


# tests/test_format_matrix.py's CASES, with the port's formats.
CASES = [
    # (fmt, sw, sh, dw, dh, kwargs)
    (gray(8), 48, 36, 96, 72, {}),
    (yuv420p(8), 64, 48, 128, 96, {"cplace": "mpeg2"}),
    (yuv420p(16), 64, 48, 128, 96, {"cplace": "mpeg1"}),
    (yuv420p(8), 64, 48, 128, 96, {"cplace": "topleft"}),
    (yuv422p(10), 64, 48, 96, 72, {"tap": 4}),
    (yuv444p(32), 48, 36, 96, 72, {"tap": 4}),
    (yuv411p(8), 64, 48, 128, 96, {}),
    (rgbp(8), 48, 36, 96, 72, {}),
    (rgbp(32), 48, 36, 72, 54, {"tap": 4}),
    (yuv420p(8, alpha=True), 64, 48, 128, 96, {}),
    # downscale
    (yuv420p(8), 96, 64, 64, 48, {"tap": 3}),
    (gray(16), 96, 72, 48, 36, {"tap": 4}),
    # sub-pixel crop + blur
    (gray(8), 64, 48, 128, 96, {"src_left": 0.25, "src_top": -0.5, "blur": 0.98}),
    # quant extremes
    (gray(8), 64, 48, 96, 72, {"quant_x": 1, "quant_y": 1}),
    (yuv420p(8), 64, 48, 96, 72, {"quant_x": 256, "quant_y": 256}),
]


@pytest.mark.parametrize(
    "fmt,sw,sh,dw,dh,kw",
    CASES,
    ids=[
        f"{f.family}{f.sub_w}{f.sub_h}-{f.bits}{'a' if f.has_alpha else ''}"
        f"-{sw}x{sh}to{dw}x{dh}-" + "-".join(f"{k}={v}" for k, v in kw.items())
        for f, sw, sh, dw, dh, kw in CASES
    ],
)
def test_port_matches_jax(fmt, sw, sh, dw, dh, kw):
    """Each case through both packages: <= 1 LSB (integers), 1e-6 (fp32).
    On u8 formats every fused or seg plane of the port's resizer runs the
    weight split (``effective_precision='fp32_u8src'``), other depths fp32."""
    clip = Clip.from_frames([random_frame(fmt, sw, sh, seed=0)])
    got, want = _both(clip, dw, dh, **kw)
    _close(got, want, fmt.bits)
    r = api.JincResizer(fmt, sw, sh, api.JincConfig(target_width=dw, target_height=dh, **kw),
                        device="cpu")  # fmt: skip
    for plane in ("luma", "chroma"):
        ap = getattr(r, f"_applier_{plane}")
        if ap is not None and r.engines[plane] in ("fused", "fused-seg"):
            assert ap.effective_precision == ("fp32_u8src" if fmt.bits == 8 else "fp32")


def test_float_clamp_semantics():
    """The SIMD float-path source clamp (chroma at -0.5, luma at 0.0,
    unless opt == 0): both packages agree under both dispatch modes, and
    the clamp changes the port's output on negative inputs."""
    fmt = yuv444p(32)
    rng = np.random.default_rng(5)
    planes = {n: rng.random((24, 32), dtype=np.float32) * 2.0 - 1.0 for n in fmt.plane_names}
    clip = Clip.from_frames([Frame(format=fmt, planes=planes)])
    outs = {}
    for opt in (-1, 0):
        got, want = _both(clip, 64, 48, opt=opt)
        _close(got, want, 32)
        outs[opt] = got
    assert any(not np.array_equal(outs[-1].planes[n], outs[0].planes[n]) for n in fmt.plane_names)


def test_u16_overshoot_clamp():
    """A u16 step edge at tap 8 rings against [0, 65535]: both packages
    saturate alike (<= 1 LSB), and the port's output touches both ends."""
    img = np.zeros((32, 48), np.uint16)
    img[:, 24:] = 65535
    clip = Clip.from_frames([Frame(format=gray(16), planes={"Y": img})])
    got, want = _both(clip, 96, 64, tap=8)
    _close(got, want, 16)
    y = got.planes["Y"]
    assert (y == 0).any() and (y == 65535).any()


def test_alpha_float_clamp_quirk():
    """The alpha float-clamp quirk: a YUVA float alpha plane takes the
    chroma clamp (-0.5), so values in (-0.5, 0) pass; RGBA alpha takes 0.0
    and is zeroed. The port agrees with the JAX package on both."""
    rng = np.random.default_rng(6)
    alpha = (rng.random((24, 32), dtype=np.float32) * 0.4 - 0.45).astype(np.float32)
    pos = rng.random((24, 32), dtype=np.float32)
    yuva = Clip.from_frames([Frame(format=yuv444p(32, alpha=True),
                                   planes={"Y": pos, "U": pos, "V": pos, "A": alpha})])  # fmt: skip
    got, want = _both(yuva, 64, 48)
    _close(got, want, 32)
    assert got.planes["A"].min() < -0.05, "YUVA alpha was clamped at 0 (expected -0.5)"
    rgba = Clip.from_frames([Frame(format=rgbp(32, alpha=True),
                                   planes={"G": pos, "B": pos, "R": pos, "A": alpha})])  # fmt: skip
    got, want = _both(rgba, 64, 48)
    _close(got, want, 32)
    assert got.planes["A"].min() >= -1e-6 and got.planes["A"].max() <= 1e-6


def test_u16_subpeak_overshoot_simd_vs_c():
    """10-bit ringing overshoot: under the SIMD dispatch (opt != 0) the
    stores saturate at the type max, past peak 1023; under opt=0 at peak.
    Both packages agree under each, and the two dispatches agree away from
    the overshoot."""
    img = np.zeros((32, 48), np.uint16)
    img[:, 24:] = 1023
    clip = Clip.from_frames([Frame(format=gray(10), planes={"Y": img})])
    simd, jsimd = _both(clip, 96, 64, tap=8)
    c, jc = _both(clip, 96, 64, tap=8, opt=0)
    _close(simd, jsimd, 10)
    _close(c, jc, 10)
    s, cy = simd.planes["Y"], c.planes["Y"]
    assert int(s.max()) > 1023 and int(cy.max()) <= 1023
    inside = (s <= 1023) & (cy <= 1023)
    assert np.abs(s[inside].astype(int) - cy[inside].astype(int)).max() <= 1


def test_alpha_f32_uses_luma_operator():
    """Alpha planes resample with the luma operator in subsampled formats:
    the port's alpha plane has the luma size and matches the JAX package's."""
    fmt = yuv420p(32, alpha=True)
    clip = Clip.from_frames([random_frame(fmt, 32, 24, seed=9)])
    got, want = _both(clip, 64, 48)
    assert got.planes["A"].shape == (48, 64)
    _close(got, want, 32)
