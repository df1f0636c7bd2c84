"""Repaired faults of the port, and a fuzz of its engines, against the golden.

* The sharded engine with a mesh that does not divide the source height:
  the scan-gather clamped window rows to the band's last row, the zero
  padding of the uneven split, where the golden clamps to the last source
  row (reached when the filter is taller than the source). The JAX package
  keeps that fault, so the golden is the oracle here, not the JAX sharded
  engine.
* fp32 borders under a caller's matmul precision: the glue einsums ran as
  matmuls under the process-wide setting (bf16 on the CPU under 'medium',
  TF32 on the card under 'high').
* A seeded fuzz of random small geometries through every engine the CPU
  runs (fused, seg, gather, xla and the sharded engine on 2-5 row shards),
  twin of ``tests/test_fuzz.py``, each held to the golden.

Tolerances: <= 1 LSB for u8 (one rounding step of the reference's output
conversion); 2e-6 absolute for fp32 sources in [0, 1) (exact fp32 products,
summation order only).
"""

import dataclasses

import numpy as np
import pytest
import torch

from jincresize_tpu_torch import sharding
from jincresize_tpu_torch.api import JincConfig, JincError, JincResizer
from jincresize_tpu_torch.apply_xla import einsum64
from jincresize_tpu_torch.clip import Clip, gray, random_frame, yuv420p
from jincresize_tpu_torch.golden import apply_plane_numpy
from jincresize_tpu_torch.operator import build_plane_operator, radius_for_tap
from jincresize_tpu_torch.sharding import make_mesh


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

# (src_w, src_h, dst_w, dst_h, tap): each has a plane whose filter is taller
# than the source, so the uneven split's padding was in reach.
F1_GEOMS = [(12, 16, 24, 32, 8), (48, 32, 96, 64, 8), (64, 40, 32, 20, 16)]


def _mesh(n):
    return make_mesh(n_rows=n, devices=["cpu"] * n, device_type="cpu")


def _lsb(a, b):
    return max(int(np.abs(a.planes[n].astype(int) - b.planes[n].astype(int)).max()) for n in a.planes)


@pytest.mark.parametrize("n_rows", [3, 5])
@pytest.mark.parametrize("geom", F1_GEOMS, ids=lambda g: "{}x{}-{}x{}-tap{}".format(*g))
def test_sharded_uneven_split_matches_golden(geom, n_rows):
    sw, sh, dw, dh, tap = geom
    fmt = yuv420p(8)
    clip = Clip.from_frames([random_frame(fmt, sw, sh, seed=1)])
    want = JincResizer(fmt, sw, sh, JincConfig(dw, dh, tap=tap, impl="numpy"), device="cpu")
    r = JincResizer(
        fmt, sw, sh, JincConfig(dw, dh, tap=tap, impl="sharded"), device="cpu", mesh=_mesh(n_rows)
    )
    assert all(e.startswith("sharded/") for e in r.engines.values()), r.engines
    assert _lsb(r(clip).frames[0], want(clip).frames[0]) <= 1


# (interior, impl, (src_w, src_h, dst_w, dst_h, tap), n_rows, tolerance):
# the interiors that read the band without a row clamp, each on a mesh that
# does not divide the source height, against the golden (tests/
# test_sharding.py's bounds: 1e-6 for conv, 2e-5 for seg and gather).
UNEVEN = [
    ("conv-fused", "conv", (128, 96, 256, 192, 8), 5, 1e-6),
    ("seg", "seg", (96, 72, 160, 120, 3), 5, 2e-5),
    ("gather", "gather", (96, 72, 160, 120, 3), 5, 2e-5),
]


@pytest.mark.parametrize("interior, impl, geom, n_rows, tol", UNEVEN, ids=[u[0] for u in UNEVEN])
def test_sharded_interiors_on_an_uneven_split_match_golden(interior, impl, geom, n_rows, tol):
    sw, sh, dw, dh, tap = geom
    assert sh % n_rows
    op = build_plane_operator(sw, sh, dw, dh, radius_for_tap(tap))
    assert sharding._rows_in_source(op)
    app = sharding.ShardedApplier(op, _mesh(n_rows), impl=impl)
    assert app.interior == interior
    src = np.random.default_rng(5).random((2, sh, sw), dtype=np.float32)
    got = app(torch.from_numpy(src)).numpy()
    want = np.stack([apply_plane_numpy(op, s) for s in src])
    assert got.shape == want.shape and float(np.abs(got - want).max()) <= tol


@pytest.mark.parametrize("interior, impl, geom, n_rows, tol", UNEVEN, ids=[u[0] for u in UNEVEN])
def test_sharded_interiors_decline_windows_past_the_source(interior, impl, geom, n_rows, tol):
    """An operator whose last row's window reaches one row past the source
    (what the padding of an uneven split would then feed) is declined by
    the interiors that read the band unclamped; the scan-gather takes it."""
    sw, sh, dw, dh, tap = geom
    op = build_plane_operator(sw, sh, dw, dh, radius_for_tap(tap))
    sy = op.start_y.copy()
    sy[-1] = op.src_height - op.filter_size + 1
    bad = dataclasses.replace(op, start_y=sy)
    assert not sharding._rows_in_source(bad)
    build = {
        "conv": sharding.make_sharded_apply_conv,
        "seg": sharding.make_sharded_apply_seg,
        "gather": sharding.make_sharded_apply_gather,
    }[impl]
    assert build(op, _mesh(n_rows)) is not None
    assert build(bad, _mesh(n_rows)) is None
    fn, _ = sharding.make_sharded_apply(bad, _mesh(n_rows), impl="gather")
    assert fn.info["interior"] == "gather-scan"


# (p, q): destination over source size of the rational scales drawn for
# the phase-conv engines.
SCALES = [(2, 1), (1, 2), (3, 2), (2, 3), (5, 2), (3, 1), (4, 3)]


def _random_geometry(rng, rational):
    """test_fuzz.py's ranges (small planes, taps 1-4, blur) at a rational
    scale (the fused and seg engines' plans), or at any sizes with a
    sub-pixel crop half the time (the gather engines')."""
    kw = dict(tap=int(rng.choice([1, 2, 3, 4])), blur=float(rng.choice([1.0, 0.98, 1.05])))
    if rational:
        p, q = SCALES[int(rng.integers(len(SCALES)))]
        sw, sh = q * int(rng.integers(24 // q, 48 // q + 1)), q * int(rng.integers(20 // q, 40 // q + 1))
        return sw, sh, sw * p // q, sh * p // q, kw
    sw, sh = int(rng.integers(10, 49)), int(rng.integers(10, 41))
    dw, dh = int(rng.integers(8, 73)), int(rng.integers(8, 65))
    if rng.random() < 0.5:
        kw.update(src_left=float(rng.uniform(0, 2)), src_top=float(rng.uniform(0, 2)))
    return sw, sh, dw, dh, kw


# 20 geometries, each through pallas (fused, else seg, else gather; auto
# where none admits the plane), seg where its plan exists, xla, and the
# sharded engine on 2-5 row shards.
@pytest.mark.parametrize("seed", range(20))
def test_fuzz_engines_match_golden(seed):
    rng = np.random.default_rng(6000 + seed)
    sw, sh, dw, dh, kw = _random_geometry(rng, rational=seed % 3 != 2)
    fmt = gray(8)
    clip = Clip.from_frames([random_frame(fmt, sw, sh, seed=seed)])
    want = JincResizer(fmt, sw, sh, JincConfig(dw, dh, impl="numpy", **kw), device="cpu")(clip)
    n_rows = int(rng.integers(2, 6))
    seen = {}
    for impl, mesh in (("pallas", None), ("seg", None), ("xla", None), ("sharded", _mesh(n_rows))):
        try:
            r = JincResizer(fmt, sw, sh, JincConfig(dw, dh, impl=impl, **kw), device="cpu", mesh=mesh)
        except JincError as exc:  # outside the kernel's envelope
            assert impl in ("pallas", "seg"), exc
            if impl == "seg":
                continue
            r = JincResizer(fmt, sw, sh, JincConfig(dw, dh, **kw), device="cpu")
        seen[impl] = r.engines["luma"]
        assert _lsb(r(clip).frames[0], want.frames[0]) <= 1, (impl, r.engines, (sw, sh, dw, dh, kw))
    assert seen["sharded"].startswith("sharded/") and seen["xla"] == "xla"


@pytest.mark.parametrize(
    "setting", ["medium", "high", "allow_tf32"], ids=["medium", "high", "allow_tf32"]
)
@pytest.mark.parametrize("impl", ["auto", "xla"])
def test_fp32_borders_ignore_the_callers_matmul_precision(impl, setting):
    """480x270 -> 960x540 tap 8 fp32 within 2e-6 of the golden whatever the
    caller set, and the caller's setting is the same after the call."""
    fmt = gray(32)
    clip = Clip.from_frames([random_frame(fmt, 480, 270, seed=1)])
    cfg = JincConfig(960, 540, tap=8, impl=impl)
    want = JincResizer(fmt, 480, 270, JincConfig(960, 540, tap=8, impl="numpy"), device="cpu")
    want = want(clip).frames[0].planes["Y"]
    before = torch.get_float32_matmul_precision()
    try:
        if setting == "allow_tf32":
            torch.backends.cuda.matmul.allow_tf32 = True
        else:
            torch.set_float32_matmul_precision(setting)
        caller = torch.get_float32_matmul_precision()
        r = JincResizer(fmt, 480, 270, cfg, device="cpu")
        got = r(clip).frames[0].planes["Y"]
        assert torch.get_float32_matmul_precision() == caller
    finally:
        torch.set_float32_matmul_precision(before)
    assert r.engines["luma"] == {"auto": "fused", "xla": "xla"}[impl]
    assert float(np.abs(got.astype(np.float64) - want).max()) <= F32_TOL


@pytest.mark.parametrize("setting", ["medium", "high"])
def test_einsum64_ignores_the_float32_matmul_setting(setting):
    """``einsum64`` of the glue's strip contraction equals its float64
    einsum rounded once, under a setting that runs float32 matmuls in bf16
    (CPU, 'medium') or TF32 ('high'), and leaves the setting as it was."""
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.random((2, 5, 30, 9), dtype=np.float32))
    b = torch.from_numpy(rng.random((7, 30, 5, 9), dtype=np.float32))
    want = np.einsum("fkxl,yxkl->fyx", a.double().numpy(), b.double().numpy()).astype(np.float32)
    before = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision(setting)
        got = einsum64("fkxl,yxkl->fyx", a, b)
        assert torch.get_float32_matmul_precision() == setting
    finally:
        torch.set_float32_matmul_precision(before)
    assert got.dtype == torch.float32 and got.shape == (2, 7, 30)
    assert float(np.abs(got.numpy() - want).max()) <= 1e-6
