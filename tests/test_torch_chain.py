"""The port's chains (``compose``, ``api.ChainResizer``,
``api.jinc_resize_chain``) against the JAX package's, on the CPU.

Each package builds its operators from its own host layer; composed
operators must be bit-identical, chain outputs within 1 LSB (integers) or
3e-5 of the plane's scale (fp32: the composed pass against the JAX
package's XLA shift-sum interior).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jincresize_tpu.compose as jcompose
from jincresize_tpu import api as japi
from jincresize_tpu import clip as jclip
from jincresize_tpu.operator import build_plane_operator as jbuild
from jincresize_tpu_torch import api
from jincresize_tpu_torch import compose as compose_mod
from jincresize_tpu_torch.clip import Clip, gray, random_frame, yuv420p
from jincresize_tpu_torch.golden import apply_plane_numpy
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


# (A, B) of tests/test_compose.py: each (src_w, src_h, dst_w, dst_h, tap).
PAIRS = {
    "up-up": ((40, 30, 60, 44, 2), (60, 44, 90, 66, 2)),
    "down-up": ((48, 36, 24, 18, 2), (24, 18, 36, 28, 2)),
    "4x periodic": ((64, 48, 128, 96, 2), (128, 96, 256, 192, 2)),
    "large dedup": ((480, 270, 960, 540, 3), (960, 540, 1920, 1080, 3)),
}


def _ops(pair, build):
    return [build(*g[:4], radius_for_tap(g[4])) for g in pair]


def _assert_operators_equal(a, b):
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if f.name == "strips":
            assert len(va) == len(vb)
            for sa, sb in zip(va, vb):
                assert (sa.y0, sa.y1, sa.x0, sa.x1) == (sb.y0, sb.y1, sb.x0, sb.x1)
                np.testing.assert_array_equal(sa.blocks, sb.blocks)
        elif isinstance(va, np.ndarray):
            assert va.dtype == vb.dtype
            np.testing.assert_array_equal(va, vb)
        else:
            assert va == vb, f.name


@pytest.mark.parametrize("name", list(PAIRS))
def test_compose_bit_identical_to_jax(name):
    got = compose_mod.compose(*_ops(PAIRS[name], build_plane_operator))
    want = jcompose.compose(*_ops(PAIRS[name], jbuild))
    _assert_operators_equal(got, want)


def test_compose_dim_mismatch_message():
    A = build_plane_operator(40, 30, 60, 44, radius_for_tap(2))
    B = build_plane_operator(61, 44, 90, 66, radius_for_tap(2))
    with pytest.raises(ValueError, match="source geometry must match"):
        compose_mod.compose(A, B)


def _jclip(clip):
    return jclip.Clip.from_frames([
        jclip.Frame(jclip.VideoFormat(**dataclasses.asdict(f.format)), dict(f.planes),
                    dict(f.props))
        for f in clip.frames
    ])  # fmt: skip


# (name, format, src (w, h), stages)
CHAINS = [
    ("gray32 up-up tap2", gray(32), (48, 40),
     [dict(target_width=72, target_height=60, tap=2, float_clamp=False),
      dict(target_width=96, target_height=80, tap=2, float_clamp=False)]),
    ("yuv420p8 4x tap3", yuv420p(8), (64, 48),
     [dict(target_width=128, target_height=96), dict(target_width=256, target_height=192)]),
    ("gray8 down-up tap4", gray(8), (96, 64),
     [dict(target_width=48, target_height=32, tap=4), dict(target_width=72, target_height=48, tap=4)]),
]  # fmt: skip


@pytest.mark.parametrize("case", CHAINS, ids=[c[0] for c in CHAINS])
def test_chain_matches_jax(case):
    _, fmt, (w, h), stages = case
    clip = Clip.from_frames([random_frame(fmt, w, h, seed=3 + i) for i in range(2)])
    cfgs = [dict(s, operator_cache=False) for s in stages]
    r = api.ChainResizer(fmt, w, h, [api.JincConfig(**c) for c in cfgs],
                         frame0=clip.frames[0], device="cpu")  # fmt: skip
    jr = japi.ChainResizer(jclip.VideoFormat(**dataclasses.asdict(fmt)), w, h,
                           [japi.JincConfig(**c) for c in cfgs], frame0=_jclip(clip).frames[0])  # fmt: skip
    _assert_operators_equal(r.op_luma, jr.op_luma)
    if fmt.is_subsampled:
        _assert_operators_equal(r.op_chroma, jr.op_chroma)
    assert r.engines == {k: v.replace("shift", "fused") for k, v in jr.engines.items()}
    out, jout = r(clip), jr(_jclip(clip))
    assert (out.width, out.height) == (stages[-1]["target_width"], stages[-1]["target_height"])
    for f, jf in zip(out.frames, jout.frames):
        f.validate()
        assert f.props == jf.props
        for n in fmt.plane_names:
            a, b = f.planes[n].astype(np.float64), np.asarray(jf.planes[n], np.float64)
            tol = 3e-5 * max(1.0, float(np.abs(b).max())) if fmt.bits == 32 else 1
            assert float(np.abs(a - b).max()) <= tol, n


def test_chain_of_the_chip_run_plans_fused():
    """The 2x-then-2x yuv420p8 tap-3 chain that ``chip_smoke.py`` runs at
    1920x1080 -> 3840x2160 -> 7680x4320, at 96x54: the composed 4x operator
    plans periodic on both planes, and the output is within 1 LSB of the
    composed operators' host golden."""
    clip = Clip.from_frames([random_frame(yuv420p(8), 96, 54, seed=i) for i in range(2)])
    stages = [dict(target_width=192, target_height=108, tap=3, operator_cache=False),
              dict(target_width=384, target_height=216, tap=3, operator_cache=False)]  # fmt: skip
    r = api.ChainResizer(clip.format, 96, 54, [api.JincConfig(**s) for s in stages],
                         frame0=clip.frames[0], device="cpu")  # fmt: skip
    assert r.engines == {"luma": "fused", "chroma": "fused"}
    out = api.jinc_resize_chain(clip, stages, device="cpu")
    for n, op in (("Y", r.op_luma), ("U", r.op_chroma), ("V", r.op_chroma)):
        want = apply_plane_numpy(op, clip.frames[1].planes[n], out_dtype=np.uint8, peak=255)
        d = np.abs(out.frames[1].planes[n].astype(int) - want.astype(int)).max()
        assert d <= 1, (n, d)


def test_chain_composed_cache(monkeypatch, tmp_path):
    """Warm construction loads the composed operators from the port's cache
    directory and composes nothing (the JAX ``test_chain_composed_cache``)."""
    monkeypatch.setenv("JINCRESIZE_TORCH_CACHE_DIR", str(tmp_path))
    clip = Clip.from_frames([random_frame(gray(8), 48, 40, seed=4)])
    cfgs = [
        api.JincConfig(target_width=72, target_height=60, tap=2),
        api.JincConfig(target_width=96, target_height=80, tap=2),
    ]
    r1 = api.ChainResizer(clip.format, 48, 40, cfgs, frame0=clip.frames[0], device="cpu")
    assert list(tmp_path.glob("chain_*.npz")), "composed cache entry missing"
    assert r1.stages, "cold chain should have built stage operators"

    def boom(a, b):
        raise AssertionError("compose called despite warm chain cache")

    monkeypatch.setattr(compose_mod, "compose", boom)
    r2 = api.ChainResizer(clip.format, 48, 40, cfgs, frame0=clip.frames[0], device="cpu")
    assert not r2.stages, "warm chain must skip stage builds"
    assert np.array_equal(r1.op_luma.start_x, r2.op_luma.start_x)
    assert np.array_equal(r1(clip).frames[0].planes["Y"], r2(clip).frames[0].planes["Y"])


def test_chain_errors(monkeypatch):
    clip = Clip.from_frames([random_frame(gray(8), 48, 40, seed=5)])
    with pytest.raises(api.JincError, match="at least one stage"):
        api.ChainResizer(clip.format, 48, 40, [], device="cpu")
    with pytest.raises(api.JincError, match="tap must be between"):
        api.jinc_resize_chain(clip, [dict(target_width=72, target_height=60, tap=17)], device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device is visible"):
        api.jinc_resize_chain(clip, [dict(target_width=72, target_height=60)])
