"""F3: chains whose second stage's windows run past the intermediate plane.

Where stage B's filter is wider than the plane stage A writes (a steep
second downscale, a chroma plane narrower than B's filter), B's windows
cover coordinates past that plane's edge. The golden clamps them to the
edge, whose taps carry weight; the JAX ``compose`` indexes A's tables with
them and raises ``IndexError``. The port's ``compose`` clamps them, so its
composed operator is what the nested stages compute.

Every reference is the JAX package's, on the same inputs. Each chain runs
through the port's ``jinc_resize_chain`` on the CPU, on one device and on 2
and 5 row shards: fp32 clips against the nested JAX ``jinc_resize`` stages
(``float_clamp=False``) within the float32 rounding bound of both sides
(``kernels.fused.f32_sum_bound``: the composed pass sums fs**2 taps a
pixel, 9,216 on the steepest chain), u8 clips within 1 LSB of the JAX
golden applied stage by stage to the JAX stage operators. The port's
composition of the JAX stage operators, applied in float64, matches the
nested JAX operators applied in float64 within the float32 rounding of the
composed weights.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jincresize_tpu.compose as jcompose
from jincresize_tpu import api as japi
from jincresize_tpu import clip as jclip
from jincresize_tpu import golden as jgolden
from jincresize_tpu_torch import api
from jincresize_tpu_torch import compose as compose_mod
from jincresize_tpu_torch.clip import Clip, gray, random_frame, yuv420p
from jincresize_tpu_torch.kernels.fused import F32_U, f32_sum_bound
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


# (name, format family (bits set per test), src (w, h), stages, planes the
# JAX compose raises on)
CHAINS = [
    ("yuv420 92x24-58x15t5-38x10t8b1.2", yuv420p, (92, 24),
     [dict(target_width=58, target_height=15, tap=5),
      dict(target_width=38, target_height=10, tap=8, blur=1.2)], ("op_luma", "op_chroma")),
    ("gray steep 64x48-16x12t2-6x4t2", gray, (64, 48),
     [dict(target_width=16, target_height=12, tap=2),
      dict(target_width=6, target_height=4, tap=2)], ("op_luma",)),
    ("gray steep 96x64-24x16t3-6x4t4", gray, (96, 64),
     [dict(target_width=24, target_height=16, tap=3),
      dict(target_width=6, target_height=4, tap=4)], ("op_luma",)),
    ("yuv420 narrow chroma 64x48-48x24t3-64x32t8", yuv420p, (64, 48),
     [dict(target_width=48, target_height=24, tap=3),
      dict(target_width=64, target_height=32, tap=8)], ("op_chroma",)),
]  # fmt: skip
IDS = [c[0] for c in CHAINS]
MESHES = [None, 2, 5]


def _jfmt(fmt):
    return jclip.VideoFormat(**dataclasses.asdict(fmt))


def _jclip(clip):
    return jclip.Clip.from_frames([
        jclip.Frame(_jfmt(f.format), dict(f.planes), dict(f.props)) for f in clip.frames
    ])  # fmt: skip


def _jstage_ops(fmt, w, h, stages):
    """The JAX package's per-stage resizers (operators only)."""
    out = []
    for s in stages:
        cfg = japi.JincConfig(**dict(s, impl="numpy", operator_cache=False))
        out.append(japi.JincResizer(_jfmt(fmt), w, h, cfg))
        w, h = s["target_width"], s["target_height"]
    return out


def _plane_op(r, name):
    return r.op_chroma if name in ("U", "V") and r.op_chroma is not None else r.op_luma


def _wsum(op) -> float:
    """The largest sum|w| of a destination pixel's window (strips included)."""
    return float(np.abs(jgolden.materialize_blocks(op).astype(np.float64)).sum((2, 3)).max())


def _apply64(op, src) -> np.ndarray:
    """The golden's gather-MAC (edge-clamped windows) in float64."""
    fs = op.filter_size
    H, W = src.shape
    rows = np.clip(op.start_y[:, None] + np.arange(fs), 0, H - 1)
    cols = np.clip(op.start_x[:, None] + np.arange(fs), 0, W - 1)
    win = src.astype(np.float64)[rows[:, None, :, None], cols[None, :, None, :]]
    return np.einsum("yxij,yxij->yx", win, jgolden.materialize_blocks(op).astype(np.float64))


def _fp32_readings(fmt, clip, stages, r, out, want):
    """(plane, max |port chain - nested JAX stages|, bound) for each plane:
    the float32 rounding of the composed pass (fs**2 taps, and its weights
    rounded once to float32) and of each JAX stage (stage A's error carried
    through B's weights)."""
    js = _jstage_ops(fmt, clip.width, clip.height, stages)
    for n in fmt.plane_names:
        d = 0.0
        for f, g in zip(out.frames, want.frames):
            a, b = f.planes[n].astype(np.float64), np.asarray(g.planes[n], np.float64)
            assert np.isfinite(a).all(), n
            d = max(d, float(np.abs(a - b).max()))
        x = max(float(np.abs(src.planes[n]).max()) for src in clip.frames)
        op, A, B = _plane_op(r, n), _plane_op(js[0], n), _plane_op(js[1], n)
        sc, sa, sb = _wsum(op), _wsum(A), _wsum(B)
        ea = f32_sum_bound(A.filter_size**2, sa, x)
        tol = (
            f32_sum_bound(op.filter_size**2, sc, x) + F32_U * sc * x
            + sb * ea + f32_sum_bound(B.filter_size**2, sb, sa * x + ea)
        )  # fmt: skip
        yield n, d, tol


def _fp32_case(case, n_rows):
    """The port's fp32 chain and the nested JAX stages on one 2-frame clip."""
    _, family, (w, h), stages, _ = case
    fmt = family(32)
    clip = Clip.from_frames([random_frame(fmt, w, h, seed=11 + i) for i in range(2)])
    r, out = _chain(clip, stages, n_rows, float_clamp=False)
    want = _jclip(clip)
    for s in stages:
        want = japi.jinc_resize(want, float_clamp=False, operator_cache=False, **s)
    return fmt, clip, stages, r, out, want


def _chain(clip, stages, n_rows, float_clamp=None):
    stages = [dict(s, operator_cache=False, float_clamp=float_clamp) for s in stages]
    mesh = None if n_rows is None else make_mesh(n_rows=n_rows, devices=["cpu"] * n_rows)
    r = api.ChainResizer(clip.format, clip.width, clip.height,
                         [api.JincConfig(**s) for s in stages],
                         frame0=clip.frames[0], device="cpu", mesh=mesh)  # fmt: skip
    if n_rows is not None:
        assert all(e.startswith("sharded/") for e in r.engines.values()), r.engines
    return r, r(clip)


@pytest.mark.parametrize("case", CHAINS, ids=IDS)
def test_jax_compose_raises_where_the_port_clamps(case):
    """Pins the difference: the JAX package's compose raises on its own
    stage operators; the port's composes them."""
    _, family, (w, h), stages, raising = case
    rs = _jstage_ops(family(8), w, h, stages)
    for plane in ("op_luma", "op_chroma"):
        A, B = getattr(rs[0], plane), getattr(rs[1], plane)
        if A is None:
            continue
        if plane in raising:
            with pytest.raises(IndexError, match="out of bounds"):
                jcompose.compose(A, B)
            assert int(B.start_y.max()) + B.filter_size > A.dst_height or (
                int(B.start_x.max()) + B.filter_size > A.dst_width
            )
        op = compose_mod.compose(A, B)
        assert (op.dst_width, op.dst_height) == (B.dst_width, B.dst_height)
        assert np.isfinite(op.pair_blocks).all()


@pytest.mark.parametrize("n_rows", MESHES, ids=lambda n: "one-device" if n is None else f"{n}-rows")
@pytest.mark.parametrize("case", CHAINS, ids=IDS)
def test_fp32_chain_matches_nested_stages(case, n_rows):
    """The port's chain against the nested JAX stages, within the float32
    rounding bound of both: the composed pass (fs**2 taps, and its weights
    rounded once to float32) and each JAX stage (stage A's error carried
    through B's weights)."""
    fmt, clip, stages, r, out, want = _fp32_case(case, n_rows)
    assert (out.width, out.height) == (want.width, want.height)
    for n, d, tol in _fp32_readings(fmt, clip, stages, r, out, want):
        assert d <= tol, (n, d, tol)


@pytest.mark.parametrize("n_rows", MESHES, ids=lambda n: "one-device" if n is None else f"{n}-rows")
@pytest.mark.parametrize("case", CHAINS, ids=IDS)
def test_u8_chain_matches_composed_golden(case, n_rows):
    """The port's u8 chain within 1 LSB of the JAX golden run stage by
    stage on the JAX stage operators (float intermediate, as the composed
    pass skips the intermediate rounding)."""
    _, family, (w, h), stages, _ = case
    fmt = family(8)
    clip = Clip.from_frames([random_frame(fmt, w, h, seed=21 + i) for i in range(2)])
    _, out = _chain(clip, stages, n_rows)
    js = _jstage_ops(fmt, w, h, stages)
    for f, src in zip(out.frames, clip.frames):
        for n in fmt.plane_names:
            A, B = _plane_op(js[0], n), _plane_op(js[1], n)
            mid = jgolden.apply_plane_numpy(A, src.planes[n], out_dtype=np.float32)
            want = jgolden.apply_plane_numpy(B, mid, out_dtype=np.uint8, peak=255.0)
            d = int(np.abs(f.planes[n].astype(int) - want.astype(int)).max())
            assert d <= 1, (n, d)


def test_clamped_coordinates_add_their_weights():
    """A covered coordinate that the clamp repeats adds its B weights into
    the same composed taps: the port's composition of the JAX stage
    operators, applied in float64, equals the nested JAX operators applied
    in float64, within the rounding of the composed weights to float32
    (u * sum|w| * max|src|), on every raising plane of every chain."""
    rng = np.random.default_rng(5)
    for _, family, (w, h), stages, raising in CHAINS:
        rs = _jstage_ops(family(32), w, h, stages)
        for plane in raising:
            A, B = getattr(rs[0], plane), getattr(rs[1], plane)
            op = compose_mod.compose(A, B)
            src = rng.random((A.src_height, A.src_width), dtype=np.float32)
            want = _apply64(B, _apply64(A, src))
            got = _apply64(op, src)
            tol = F32_U * _wsum(op) * float(src.max()) + 1e-12
            assert float(np.abs(got - want).max()) <= tol, plane
            # The composed rows still sum to 1: no tap past the edge was dropped.
            ones = np.ones_like(src)
            np.testing.assert_allclose(_apply64(op, ones), 1.0, atol=64 * F32_U)


if __name__ == "__main__":
    # Each chain's fp32 reading on one device beside its bound and 2e-6.
    for case in CHAINS:
        for n, d, tol in _fp32_readings(*_fp32_case(case, None)):
            print(f"{case[0]} {n}: {d:.3g} (bound {tol:.3g}, 2e-6 {'held' if d <= 2e-6 else 'missed'})")
