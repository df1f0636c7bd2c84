"""Port's segment-periodic engine (plain forms on the CPU) against the JAX one.

The JAX side runs ``make_seg_interior`` and ``SegConvApplier`` in Pallas
interpret mode, as ``tests/test_apply_conv_seg.py`` does; the port's
wrappers take their plain PyTorch forms because the tensors lie on the CPU.
The CUDA kernel is held to the same plain form on the card by
``chip_smoke.py``; the tile-window test below checks, on the host, the index
arithmetic that kernel stages its shared-memory window with.

Tolerances: 2e-6 absolute for the interior on fp32 sources in [0, 1) (exact
fp32 products, only the summation order differs); for the applier,
``tests/test_apply_conv_seg.py``'s fp32 bound (2e-5 absolute) and <= 1 LSB
for u8/u16 after ``finalize``.
"""

import numpy as np
import pytest
import torch

from jincresize_tpu import operator as joperator
from jincresize_tpu import phase as jphase
from jincresize_tpu_torch.golden import apply_plane_numpy
from jincresize_tpu_torch.operator import build_plane_operator, radius_for_tap
from jincresize_tpu_torch.phase import plan_phases, plan_phases_seg
from jincresize_tpu_torch.apply_conv import _strip_values, _strip_values_banded, strip_row_bands
from jincresize_tpu_torch.apply_conv_seg import SegConvApplier
from jincresize_tpu_torch.apply_xla import to_device
from jincresize_tpu_torch.kernels import fused, seg

F32_TOL = 2e-6
APPLIER_F32_TOL = 2e-5  # test_apply_conv_seg.py::test_seg_parity_float_output

# tests/test_apply_conv_seg.py: the drifted 1.5x tap-8 plane, the exactly
# periodic 1.5x tap-3 plane, and the 2.5x tap-2 plane with exception columns.
GEOMS = {
    "1.5x-tap8": (640, 360, 960, 540, 8),
    "1.5x-tap3-periodic": (64, 48, 96, 72, 3),
    "2.5x-exceptions": (1920, 80, 4800, 200, 2),
}


def _op(name):
    sw, sh, dw, dh, tap = GEOMS[name]
    return build_plane_operator(sw, sh, dw, dh, radius_for_tap(tap))


def _jop(name):
    """The JAX package's operator of the same geometry, from its own host layer."""
    sw, sh, dw, dh, tap = GEOMS[name]
    return joperator.build_plane_operator(sw, sh, dw, dh, joperator.radius_for_tap(tap))


def _src(op, dtype, seed, frames=2):
    rng = np.random.default_rng(seed)
    shape = (frames, op.src_height, op.src_width)
    if dtype == np.float32:
        return rng.random(shape, dtype=np.float32)
    return rng.integers(0, 256, shape).astype(dtype)


def _maxdiff(a, b):
    return float(np.abs(a.astype(np.float64) - b.astype(np.float64)).max())


@pytest.fixture(scope="module")
def ops():
    return {name: _op(name) for name in GEOMS}


@pytest.fixture(scope="module")
def jax_interiors(ops):
    """JAX Pallas seg interiors (interpret mode) on one fp32 frame each."""
    import jax.numpy as jnp

    from jincresize_tpu.kernels.pallas_fused_seg import make_seg_interior

    out = {}
    for name in ("1.5x-tap8", "1.5x-tap3-periodic"):
        op = _jop(name)
        fn = make_seg_interior(op, jphase.plan_phases_seg(op), interpret=True)
        src = _src(op, np.float32, seed=4, frames=1)[0]
        out[name] = (src, np.asarray(fn(jnp.asarray(src), fn.params)))
    return out


@pytest.mark.parametrize("name", ["1.5x-tap8", "1.5x-tap3-periodic"])
def test_seg_plain_matches_pallas_interpret(name, ops, jax_interiors):
    op = ops[name]
    plan = plan_phases_seg(op)
    assert seg.is_supported(op, plan)
    src, want = jax_interiors[name]
    si = seg.make_seg_interior(op, plan)
    got = seg.seg_interior(si, torch.from_numpy(src)[None])[0].numpy()
    assert got.shape == want.shape == si.out_shape
    assert si.out_shape == (plan.y.hi - plan.y.lo, plan.x.hi - plan.x.lo)
    assert np.abs(got - want).max() <= F32_TOL


@pytest.fixture(scope="module")
def jax_applier_outputs(ops):
    """JAX SegConvApplier (interpret) outputs on the drifted 1.5x tap-8 plane."""
    import jax.numpy as jnp

    from jincresize_tpu.apply_conv_seg import SegConvApplier as JaxSegConvApplier

    op = ops["1.5x-tap8"]
    jap = JaxSegConvApplier(_jop("1.5x-tap8"), interpret=True)
    out = {"concat": jap._concat}
    for dtype, peak in ((np.float32, None), (np.uint8, 255.0)):
        src = _src(op, dtype, seed=2)
        out[np.dtype(dtype).name] = (
            src,
            np.asarray(jap(jnp.asarray(src), out_dtype=dtype, peak=peak)),
        )
    return out


@pytest.mark.parametrize("dtype,peak", [(np.float32, None), (np.uint8, 255.0)], ids=["f32", "u8"])
def test_seg_applier_matches_jax_and_golden(dtype, peak, ops, jax_applier_outputs):
    op = ops["1.5x-tap8"]
    src, want = jax_applier_outputs[np.dtype(dtype).name]
    ap = SegConvApplier(op, device="cpu")
    assert ap.interior == "fused-seg"
    assert ap._concat == jax_applier_outputs["concat"]
    got = ap(torch.from_numpy(src), out_dtype=dtype, peak=peak).numpy()
    golden = np.stack([apply_plane_numpy(op, s, out_dtype=dtype, peak=peak) for s in src])
    assert got.dtype == np.dtype(dtype)
    tol = APPLIER_F32_TOL if dtype == np.float32 else 1
    assert _maxdiff(got, golden) <= tol
    assert _maxdiff(got, want) <= tol


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16], ids=["u8", "u16"])
def test_seg_exception_case_matches_golden(dtype, ops):
    """2.5x wide plane: exception columns take the paste assembly with the
    column fixup (the JAX interpret run of this case takes ~19 s, so only
    the golden is the reference here)."""
    op = ops["2.5x-exceptions"]
    plan = plan_phases_seg(op)
    assert len(plan.x.exceptions) > 0
    ap = SegConvApplier(op, plan=plan, device="cpu")
    assert not ap._concat
    peak = 255.0 if dtype == np.uint8 else 1023.0
    src = _src(op, dtype, seed=3)
    got = ap(torch.from_numpy(src), out_dtype=dtype, peak=peak).numpy()
    golden = np.stack([apply_plane_numpy(op, s, out_dtype=dtype, peak=peak) for s in src])
    assert _maxdiff(got, golden) <= 1


def test_seg_batch_matches_per_frame(ops):
    op = ops["1.5x-tap3-periodic"]
    ap = SegConvApplier(op, device="cpu")
    src = torch.from_numpy(_src(op, np.float32, seed=6, frames=5))
    batch = ap(src)
    si = ap.si
    whole = seg.seg_interior(si, src)
    for f in range(5):
        # The einsum may block the frames differently: summation order only.
        assert float((batch[f] - ap(src[f])).abs().max()) <= F32_TOL
        one = seg.seg_interior(si, src[f : f + 1])[0]
        assert float((whole[f] - one).abs().max()) <= F32_TOL


@pytest.mark.parametrize("name", list(GEOMS))
def test_tile_windows_cover_every_read(name, ops):
    """The CUDA kernel stages, per 32 x 8 output tile, the window from
    ``base + q*(k0 // p)`` of ``win_h x win_w``: every pixel's fs x fs window
    must lie inside it and inside the source plane."""
    op = ops[name]
    si = seg.make_seg_interior(op, plan_phases_seg(op))
    for tile, p, q, base, roff, win, size in (
        (seg.TILE_Y, si.py, si.qy, si.base_y, si.roff_y, si.win_h, op.src_height),
        (seg.TILE_X, si.px, si.qx, si.base_x, si.roff_x, si.win_w, op.src_width),
    ):
        k = np.arange(roff.shape[0])
        local = q * (k // p) + roff.numpy() - q * ((k // tile * tile) // p)
        assert local.min() >= 0 and local.max() + si.fs <= win
        assert (base + q * (k // p) + roff.numpy()).max() + si.fs <= size
    assert si.frames_per_block * si.win_h * si.win_w * 4 <= fused.MAX_SMEM_BYTES


def test_strip_values_banded_equals_strip_values(ops):
    """Every strip of a seg geometry: the banded form equals the full-height one."""
    op = ops["1.5x-tap8"]
    dop = to_device(op, "cpu")
    bands = strip_row_bands(op)
    src = torch.from_numpy(_src(op, np.float32, seed=9))
    kinds = set()
    for s in dop.strips:
        b = bands[(s.y0, s.y1, s.x0, s.x1)]
        kinds.add(b[2])
        got = _strip_values_banded(dop, src, s, *b)
        want = _strip_values(dop, src, s)
        assert got.shape == want.shape == (2, s.y1 - s.y0, s.x1 - s.x0)
        assert float((got - want).abs().max()) <= F32_TOL
    assert kinds == {True, False}  # both the constant-row and the gathered branch


def test_strip_row_bands_equal_jax(ops):
    from jincresize_tpu import apply_conv as japply
    from jincresize_tpu_torch import apply_conv

    for name, op in ops.items():
        assert apply_conv.strip_row_bands(op) == japply.strip_row_bands(_jop(name))
    tiny = build_plane_operator(6, 6, 12, 12, radius_for_tap(8))
    with pytest.raises(ValueError, match="smaller than filter_size"):
        apply_conv.strip_row_bands(tiny)


def test_is_supported_declines_deep_tap():
    op = build_plane_operator(720, 405, 240, 135, radius_for_tap(16))
    plan = plan_phases_seg(op)
    assert plan is not None and op.filter_size**2 > fused.FS2_MAX
    assert not seg.is_supported(op, plan)
    with pytest.raises(ValueError, match="envelope"):
        seg.make_seg_interior(op, plan)
    with pytest.raises(ValueError, match="envelope"):
        SegConvApplier(op, plan=plan, device="cpu")


def test_applier_declines_aperiodic_geometry():
    op = build_plane_operator(400, 220, 601, 331, radius_for_tap(3))
    assert plan_phases(op) is None and plan_phases_seg(op) is None
    with pytest.raises(ValueError, match="segment-periodic"):
        SegConvApplier(op, device="cpu")


def test_precision_modes(ops):
    op = ops["1.5x-tap3-periodic"]
    src = torch.from_numpy(_src(op, np.uint8, seed=8, frames=1))
    a, b = (
        SegConvApplier(op, precision=prec, device="cpu")(src, out_dtype=np.uint8, peak=255.0)
        for prec in ("fp32", "fp32_u8src")
    )
    assert torch.equal(a, b)  # the u8-source mode runs the same exact kernel
    with pytest.raises(NotImplementedError, match="bf16"):
        SegConvApplier(op, precision="bf16", device="cpu")
    with pytest.raises(ValueError, match="unknown precision"):
        SegConvApplier(op, precision="fp16", device="cpu")


def test_wrapper_never_falls_back_off_cpu(ops):
    op = ops["1.5x-tap3-periodic"]
    si = seg.make_seg_interior(op, plan_phases_seg(op))
    src = torch.empty((1, op.src_height, op.src_width), device="meta")
    with pytest.raises(RuntimeError, match="unsupported device"):
        seg.seg_interior(si, src)
    assert seg.seg_interior.launches == 0
