"""Port's general engine (apply_xla) against the JAX one and the host golden.

Both branches of ``apply_plane`` are covered: the class-contraction branch
(few row classes, ``n_uy * H <= 2 * dst_h``) and the general branch.
Tolerances: 2e-6 absolute for fp32 (exact fp32 products, summation order
differs) and <= 1 LSB for u8/u16 after ``finalize``.
"""

import numpy as np
import pytest
import torch

from jincresize_tpu import operator as joperator
from jincresize_tpu_torch import apply_xla
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


F32_TOL = 2e-6

BRANCHES = {
    "contract": (32, 24, 64, 48, 3),  # 2x up: 2 row classes
    "general": (48, 32, 72, 50, 3),  # irregular ratio: many row classes
}
DTYPES = [
    ("u8", np.uint8, 255.0, None),
    ("u16", np.uint16, 1023.0, None),
    ("f32", np.float32, None, None),
    ("f32-clamp", np.float32, None, -0.5),
]


def _op(branch):
    sw, sh, dw, dh, tap = BRANCHES[branch]
    op = build_plane_operator(sw, sh, dw, dh, radius_for_tap(tap))
    contract = op.pair_blocks.shape[0] * op.src_height <= 2 * op.dst_height
    assert contract == (branch == "contract")
    return op


def _jop(branch):
    """The JAX package's operator of the same geometry, from its own host layer."""
    sw, sh, dw, dh, tap = BRANCHES[branch]
    return joperator.build_plane_operator(sw, sh, dw, dh, joperator.radius_for_tap(tap))


def _src(op, dtype, peak, clamp, seed, frames=2):
    rng = np.random.default_rng(seed)
    shape = (frames, op.src_height, op.src_width)
    if dtype == np.float32:
        src = rng.random(shape, dtype=np.float32)
        if clamp is not None:
            src = (src - np.float32(0.5)) * np.float32(3.0)
        return src
    return rng.integers(0, int(peak) + 1, shape).astype(dtype)


def _close(a, b, dtype):
    if dtype == np.float32:
        return float(np.abs(a - b).max()) <= F32_TOL
    return int(np.abs(a.astype(np.int64) - b.astype(np.int64)).max()) <= 1


@pytest.mark.parametrize("branch", sorted(BRANCHES))
@pytest.mark.parametrize("name,dtype,peak,clamp", DTYPES, ids=[d[0] for d in DTYPES])
def test_resize_plane_batch_matches_jax_and_golden(branch, name, dtype, peak, clamp):
    import jax.numpy as jnp

    from jincresize_tpu import apply_xla as japply

    op = _op(branch)
    src = _src(op, dtype, peak, clamp, seed=len(name) + len(branch))
    got = apply_xla.resize_plane_batch(
        apply_xla.to_device(op, "cpu"),
        torch.from_numpy(src),
        out_dtype=dtype,
        peak=peak,
        float_clamp_min=clamp,
    ).numpy()
    assert got.dtype == np.dtype(dtype)
    want_jax = np.asarray(
        japply.resize_plane_batch(
            japply.to_device(_jop(branch)),
            jnp.asarray(src),
            out_dtype=dtype,
            peak=peak,
            float_clamp_min=clamp,
        )
    )
    golden = np.stack(
        [
            apply_plane_numpy(op, s, out_dtype=dtype, peak=peak, float_clamp_min=clamp)
            for s in src
        ]
    )
    assert _close(got, want_jax, dtype)
    assert _close(got, golden, dtype)


@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_to_device_fields_match_jax(branch):
    from jincresize_tpu import apply_xla as japply

    op = _op(branch)
    dop = apply_xla.to_device(op, "cpu")
    jdop = japply.to_device(_jop(branch))
    for f in ("start_x", "start_y", "cx_idx", "cy_idx", "pair_blocks"):
        np.testing.assert_array_equal(getattr(dop, f).numpy(), np.asarray(getattr(jdop, f)))
    for s, js in zip(dop.strips, jdop.strips, strict=True):
        assert (s.y0, s.y1, s.x0, s.x1) == (js.y0, js.y1, js.x0, js.x1)
        np.testing.assert_array_equal(s.blocks.numpy(), np.asarray(js.blocks))
    for f in ("src_width", "src_height", "dst_width", "dst_height", "filter_size"):
        assert getattr(dop, f) == getattr(jdop, f)


def test_fully_border_geometry_keeps_zero_dictionary():
    """A source smaller than the filter has no interior: a 1x1 zero
    dictionary keeps the gathers shape-valid and strips own every pixel."""
    op = build_plane_operator(6, 5, 12, 10, radius_for_tap(3))
    assert op.pair_blocks.size == 0
    dop = apply_xla.to_device(op, "cpu")
    assert tuple(dop.pair_blocks.shape) == (1, 1, op.filter_size, op.filter_size)
    assert not dop.pair_blocks.any()
    src = _src(op, np.float32, None, None, seed=9, frames=1)
    got = apply_xla.resize_plane_batch(dop, torch.from_numpy(src)).numpy()[0]
    assert _close(got, apply_plane_numpy(op, src[0]), np.float32)


def test_finalize_rounds_half_to_even_and_clamps():
    acc = torch.tensor([-3.0, 0.5, 1.5, 2.5, 254.5, 255.49, 300.0])
    got = apply_xla.finalize(acc, np.uint8, 255.0)
    assert got.dtype == torch.uint8
    assert got.tolist() == [0, 0, 2, 2, 254, 255, 255]
    u16 = apply_xla.finalize(torch.tensor([65535.6, 1023.5]), np.uint16, 65535.0)
    assert u16.dtype == torch.uint16
    assert u16.to(torch.int32).tolist() == [65535, 1024]
    assert torch.equal(apply_xla.finalize(acc, np.float32, None), acc)  # raw passthrough


def test_single_plane_equals_batch():
    """A 2-D source is one frame; the batched einsums may sum in another
    order, so the bound is the fp32 one."""
    op = _op("contract")
    dop = apply_xla.to_device(op, "cpu")
    src = torch.from_numpy(_src(op, np.float32, None, None, seed=4, frames=3))
    batch = apply_xla.apply_plane(dop, src)
    for f in range(3):
        one = apply_xla.apply_plane(dop, src[f])
        assert one.shape == batch[f].shape
        assert float((one - batch[f]).abs().max()) <= F32_TOL
