"""Port's fused-engine applier against JAX ``ConvApplier(interior='fused')``.

The JAX applier runs its Pallas kernels in interpret mode on the CPU; the
port's applier runs its kernels' plain forms (CPU tensors). Both are also
held to the host golden. Tolerances: 2e-6 absolute for fp32 (exact fp32
products, summation order differs), <= 1 LSB for u8/u16 after ``finalize``.
"""

import numpy as np
import pytest
import torch

from jincresize_tpu.golden import apply_plane_numpy
from jincresize_tpu.operator import build_plane_operator, radius_for_tap
from jincresize_tpu.phase import plan_phases
from jincresize_tpu_torch import apply_conv

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
    ap = apply_conv.ConvApplier(op)
    got = ap(torch.from_numpy(src), out_dtype=dtype, peak=peak).numpy()
    jap = JaxConvApplier(op, interior="fused")
    want = np.asarray(jap(jnp.asarray(src), out_dtype=dtype, peak=peak))
    golden = np.stack([apply_plane_numpy(op, s, out_dtype=dtype, peak=peak) for s in src])
    tol = F32_TOL if dtype == np.float32 else 1
    assert got.dtype == np.dtype(dtype)
    assert _maxdiff(got, want) <= tol
    assert _maxdiff(got, golden) <= tol
    # Same assembly route: one concatenate exactly when the JAX applier uses one.
    assert ap._concat == jap._concat
    # Where the Pallas strip kernel engages, the port's does too.
    if jap._strips_kfn_spec is not None:
        assert ap.strips_spec is not None


def test_exceptions_take_concat_assembly():
    """160x120 -> 400x300 (5/2) has x- and y-exceptions and takes the
    one-concatenate assembly; 320x180 -> 480x270 takes the paste path."""
    ap = apply_conv.ConvApplier(_op((160, 120, 400, 300, 3)))
    assert ap._concat is not None
    assert ap.cop.exc_x.shape[0] and ap.cop.exc_y.shape[0]
    assert apply_conv.ConvApplier(_op((320, 180, 480, 270, 3)))._concat is None


@pytest.mark.parametrize(
    "g",
    [(64, 48, 128, 96, 8), (160, 120, 400, 300, 3), (320, 180, 480, 270, 3)],
    ids=["2x-tap8", "5/2-exceptions", "3/2-drift"],
)
def test_build_conv_operator_fields_match_jax(g):
    """State carries across: every operator field equals the JAX one."""
    from jincresize_tpu import apply_conv as japply

    op = _op(g)
    cop = apply_conv.build_conv_operator(op)
    jcop = japply.build_conv_operator(op)
    for f in ("kernels", "exc_x", "exc_y"):
        np.testing.assert_array_equal(getattr(cop, f).numpy(), np.asarray(getattr(jcop, f)))
    assert cop.meta == jcop.meta
    assert cop.phase_offsets == jcop.phase_offsets
    for f in ("start_x", "start_y", "cx_idx", "cy_idx", "pair_blocks"):
        np.testing.assert_array_equal(
            getattr(cop.dop, f).numpy(), np.asarray(getattr(jcop.dop, f))
        )
    for s, js in zip(cop.dop.strips, jcop.dop.strips, strict=True):
        assert (s.y0, s.y1, s.x0, s.x1) == (js.y0, js.y1, js.x0, js.x1)
        np.testing.assert_array_equal(s.blocks.numpy(), np.asarray(js.blocks))


def test_build_conv_operator_aperiodic_is_none():
    op = build_plane_operator(48, 32, 72, 50, radius_for_tap(3))
    assert plan_phases(op) is None
    assert apply_conv.build_conv_operator(op) is None
    with pytest.raises(ValueError, match="aperiodic"):
        apply_conv.ConvApplier(op)


def test_float_clamp_min_and_single_plane():
    op = _op((64, 48, 128, 96, 8))
    src = (_src(op, np.float32, None, seed=3, frames=1)[0] - np.float32(0.5)) * 3
    ap = apply_conv.ConvApplier(op)
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
    ap = apply_conv.ConvApplier(op)
    assert ap.strips_spec is None
    src = _src(op, np.float32, None, seed=8, frames=1)
    got = ap(torch.from_numpy(src)).numpy()[0]
    assert _maxdiff(got, apply_plane_numpy(op, src[0])) <= F32_TOL


def test_precision_modes():
    op = _op((64, 48, 128, 96, 8))
    src = torch.from_numpy(_src(op, np.uint8, 255.0, seed=6, frames=1))
    a, b = (
        apply_conv.ConvApplier(op, precision=prec)(src, out_dtype=np.uint8, peak=255.0)
        for prec in ("fp32", "fp32_u8src")
    )
    assert torch.equal(a, b)  # the u8-source mode runs the same exact kernel
    with pytest.raises(NotImplementedError, match="bf16"):
        apply_conv.ConvApplier(op, precision="bf16")
    with pytest.raises(ValueError, match="unknown precision"):
        apply_conv.ConvApplier(op, precision="fp16")
    with pytest.raises(NotImplementedError, match="shift"):
        apply_conv.ConvApplier(op, interior="shift")
