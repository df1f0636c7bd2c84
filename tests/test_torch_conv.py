"""Port's fused-engine applier against JAX ``ConvApplier(interior='fused')``.

The JAX applier runs its Pallas kernels in interpret mode on the CPU; the
port's applier runs its kernels' plain forms (CPU tensors). Both are also
held to the host golden. Tolerances: 2e-6 absolute for fp32 (exact fp32
products, summation order differs), <= 1 LSB for u8/u16 after ``finalize``.
"""

import numpy as np
import pytest
import torch

from jincresize_tpu import operator as joperator
from jincresize_tpu_torch import apply_conv
from jincresize_tpu_torch.golden import apply_plane_numpy
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

CASES = [
    ("2x-tap8-f32", (64, 48, 128, 96, 8), np.float32, None),
    ("2x-tap8-u8", (64, 48, 128, 96, 8), np.uint8, 255.0),
    ("3/2-drift-f32", (320, 180, 480, 270, 3), np.float32, None),
    ("3/2-drift-u16", (320, 180, 480, 270, 3), np.uint16, 1023.0),
    ("5/2-exceptions-f32", (160, 120, 400, 300, 3), np.float32, None),
]


def _op(g):
    sw, sh, dw, dh, tap = g
    return build_plane_operator(sw, sh, dw, dh, radius_for_tap(tap))


def _jop(g):
    """The JAX package's operator of the same geometry, from its own host layer."""
    sw, sh, dw, dh, tap = g
    return joperator.build_plane_operator(sw, sh, dw, dh, joperator.radius_for_tap(tap))


def _src(op, dtype, peak, seed, frames=2):
    rng = np.random.default_rng(seed)
    shape = (frames, op.src_height, op.src_width)
    if dtype == np.float32:
        return rng.random(shape, dtype=np.float32)
    return rng.integers(0, int(peak) + 1, shape).astype(dtype)


def _maxdiff(a, b):
    return float(np.abs(a.astype(np.float64) - b.astype(np.float64)).max())


@pytest.mark.parametrize("name,g,dtype,peak", CASES, ids=[c[0] for c in CASES])
def test_conv_applier_matches_jax_fused_and_golden(name, g, dtype, peak):
    import jax.numpy as jnp

    from jincresize_tpu.apply_conv import ConvApplier as JaxConvApplier

    op = _op(g)
    src = _src(op, dtype, peak, seed=len(name))
    ap = apply_conv.ConvApplier(op, device="cpu")
    got = ap(torch.from_numpy(src), out_dtype=dtype, peak=peak).numpy()
    jap = JaxConvApplier(_jop(g), interior="fused")
    want = np.asarray(jap(jnp.asarray(src), out_dtype=dtype, peak=peak))
    golden = np.stack([apply_plane_numpy(op, s, out_dtype=dtype, peak=peak) for s in src])
    tol = F32_TOL if dtype == np.float32 else 1
    assert got.dtype == np.dtype(dtype)
    assert _maxdiff(got, want) <= tol
    assert _maxdiff(got, golden) <= tol
    # Same assembly route: one concatenate exactly when the JAX applier uses one.
    assert ap.canvas.concat == (jap._concat is not None)
    # Where the Pallas strip kernel engages, the port's does too.
    if jap._strips_kfn_spec is not None:
        assert ap.strips_spec is not None


def test_exceptions_take_concat_assembly():
    """160x120 -> 400x300 (5/2) has x- and y-exceptions and takes the
    one-concatenate assembly; 320x180 -> 480x270 takes the paste path."""
    op = _op((160, 120, 400, 300, 3))
    plan = plan_phases(op)
    assert apply_conv.ConvApplier(op, plan=plan, device="cpu").canvas.concat
    assert len(plan.x.exceptions) and len(plan.y.exceptions)
    assert not apply_conv.ConvApplier(_op((320, 180, 480, 270, 3)), device="cpu").canvas.concat


@pytest.mark.parametrize(
    "g",
    [(64, 48, 128, 96, 8), (160, 120, 400, 300, 3), (320, 180, 480, 270, 3)],
    ids=["2x-tap8", "5/2-exceptions", "3/2-drift"],
)
def test_build_conv_operator_fields_match_jax(g):
    """State carries across: the applier's device operator, phase kernels,
    interior rectangle and exception lines equal those of the JAX
    package's ``build_conv_operator``."""
    from jincresize_tpu import apply_conv as japply

    op = _op(g)
    plan = plan_phases(op)
    ap = apply_conv.ConvApplier(op, plan=plan, device="cpu")
    jcop = japply.build_conv_operator(_jop(g))
    np.testing.assert_array_equal(ap.fi.kernels.numpy(), np.asarray(jcop.kernels)[:, 0])
    np.testing.assert_array_equal(plan.x.exceptions, np.asarray(jcop.exc_x))
    np.testing.assert_array_equal(plan.y.exceptions, np.asarray(jcop.exc_y))
    ylo, xlo, py, px, _, _, _, _, nyb, nxb = jcop.meta[:10]
    assert ap.canvas.rect == (ylo, ylo + py * nyb, xlo, xlo + px * nxb)
    for f in ("start_x", "start_y", "cx_idx", "cy_idx", "pair_blocks"):
        np.testing.assert_array_equal(
            getattr(ap._dop, f).numpy(), np.asarray(getattr(jcop.dop, f))
        )
    for s, js in zip(ap._dop.strips, jcop.dop.strips, strict=True):
        assert (s.y0, s.y1, s.x0, s.x1) == (js.y0, js.y1, js.x0, js.x1)
        np.testing.assert_array_equal(s.blocks.numpy(), np.asarray(js.blocks))


def test_build_conv_operator_aperiodic_is_none():
    """No phase plan: the fused applier declines the geometry."""
    op = build_plane_operator(48, 32, 72, 50, radius_for_tap(3))
    assert plan_phases(op) is None
    with pytest.raises(ValueError, match="aperiodic"):
        apply_conv.ConvApplier(op, device="cpu")


def test_float_clamp_min_and_single_plane():
    op = _op((64, 48, 128, 96, 8))
    src = (_src(op, np.float32, None, seed=3, frames=1)[0] - np.float32(0.5)) * 3
    ap = apply_conv.ConvApplier(op, device="cpu")
    got = ap(torch.from_numpy(src), float_clamp_min=-0.5).numpy()
    want = apply_plane_numpy(op, src, float_clamp_min=-0.5)
    assert got.shape == want.shape
    assert _maxdiff(got, want) <= F32_TOL
    assert _maxdiff(want, apply_plane_numpy(op, src)) > 0  # the clamp mattered


def test_strip_kernel_declined_uses_strip_values_fast():
    """blur + quant_x=1 breaks the anchor pattern of the top/bottom strips:
    the strip kernel declines and every strip comes from the slicing path."""
    op = build_plane_operator(
        96, 64, 144, 96, radius_for_tap(3), quantize_x=1, quantize_y=1, blur=0.98
    )
    ap = apply_conv.ConvApplier(op, device="cpu")
    assert ap.strips_spec is None
    src = _src(op, np.float32, None, seed=8, frames=1)
    got = ap(torch.from_numpy(src)).numpy()[0]
    assert _maxdiff(got, apply_plane_numpy(op, src[0])) <= F32_TOL


def test_precision_modes():
    op = _op((64, 48, 128, 96, 8))
    src = torch.from_numpy(_src(op, np.uint8, 255.0, seed=6, frames=1))
    a, b = (
        apply_conv.ConvApplier(op, precision=prec, device="cpu")(src, out_dtype=np.uint8, peak=255.0)
        for prec in ("fp32", "fp32_u8src")
    )
    # The u8-source mode's wsplit3 interior runs the fp32 plain form on the CPU.
    assert torch.equal(a, b)
    # bf16 (tests/test_torch_bf16.py): u8 sources are bf16-exact, only the
    # weights round, so the output stays within 2 LSB here.
    ap = apply_conv.ConvApplier(op, precision="bf16", device="cpu")
    assert ap.fi.bf16 and ap.effective_precision == "bf16"
    c = ap(src, out_dtype=np.uint8, peak=255.0)
    assert (c.int() - a.int()).abs().max() <= 2
    with pytest.raises(ValueError, match="unknown precision"):
        apply_conv.ConvApplier(op, precision="fp16", device="cpu")
    # The fused kernel is the only interior: the applier takes no choice of one.
    with pytest.raises(TypeError, match="interior"):
        apply_conv.ConvApplier(op, interior="fused", device="cpu")


def test_anchor_blocks_declined_takes_the_value_path():
    """blur + quant_x=1: ``_anchor_blocks`` returns None for every full-width
    strip, so the strip kernel declines and every strip takes the value path
    (``strip_values_fast``), as the JAX applier's strips do."""
    import jax.numpy as jnp

    from jincresize_tpu.apply_conv import ConvApplier as JaxConvApplier
    from jincresize_tpu_torch.kernels import strips

    kw = dict(quantize_x=1, quantize_y=1, blur=0.98)
    op = build_plane_operator(96, 64, 144, 96, radius_for_tap(3), **kw)
    plan = plan_phases(op)
    full = [s for s in op.strips if s.x0 == 0 and s.x1 == op.dst_width]
    assert full and all(strips._anchor_blocks(s, plan.x, op.filter_size) is None for s in full)
    assert strips.make_strips(op, plan) is None
    ap = apply_conv.ConvApplier(op, plan=plan, device="cpu")
    jop = joperator.build_plane_operator(96, 64, 144, 96, joperator.radius_for_tap(3), **kw)
    jap = JaxConvApplier(jop, interior="fused")
    assert ap.strips_spec is None and jap._strips_kfn_spec is None
    src = _src(op, np.float32, None, seed=12, frames=1)
    got = ap(torch.from_numpy(src)).numpy()
    assert _maxdiff(got, np.asarray(jap(jnp.asarray(src)))) <= F32_TOL


DEEP_CASES = [
    ("tap16-2x-fs65-f32", (480, 270, 240, 135, 16), np.float32, None),
    ("tap16-2/3-fs49-u8", (480, 270, 320, 180, 16), np.uint8, 255.0),
]


@pytest.mark.parametrize("name,g,dtype,peak", DEEP_CASES, ids=[c[0] for c in DEEP_CASES])
def test_deep_tap_applier_matches_jax_fused(name, g, dtype, peak):
    """Deep taps on the fused applier: interior, strip kernel and the
    left/right strip glue at fs = 65 and 49, against the JAX fused applier
    (interpret mode) at 4e-6 (fp32) or 1 LSB, the one-concatenate assembly
    on both sides."""
    import jax.numpy as jnp

    from jincresize_tpu.apply_conv import ConvApplier as JaxConvApplier

    op = _op(g)
    src = _src(op, dtype, peak, seed=21, frames=1)
    ap = apply_conv.ConvApplier(op, device="cpu")
    assert ap.fi.fs == op.filter_size and op.filter_size**2 > 1200
    assert ap.strips_spec is not None and ap._strip_plans is not None
    jap = JaxConvApplier(_jop(g), interior="fused")
    got = ap(torch.from_numpy(src), out_dtype=dtype, peak=peak).numpy()
    want = np.asarray(jap(jnp.asarray(src), out_dtype=dtype, peak=peak))
    assert ap.canvas.concat and jap._concat is not None
    assert _maxdiff(got, want) <= (4e-6 if dtype == np.float32 else 1)
