"""The port's tools, probe kernel and entry points on the CPU.

Every tool's ``main`` runs at a tiny ``size`` with ``--device cpu`` and must
print the last line its JAX twin prints (their numbers are host-clock times
of the plain forms). The probe's plain form and its wrapper on a CPU tensor
are held to the JAX probe's ``pallas_call``, rebuilt here in interpret mode
(the JAX tool runs at import and cannot be imported). ``entry`` is held to
``__graft_entry__.entry`` (2e-6, fp32).
"""

import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import __graft_entry__
from jincresize_tpu_torch import apply_conv, apply_conv_seg, apply_gather, apply_xla, entry
from jincresize_tpu_torch.golden import apply_plane_numpy
from jincresize_tpu_torch.kernels import fused as fused_k
from jincresize_tpu_torch.kernels import probe
from jincresize_tpu_torch.operator import build_plane_operator, radius_for_tap
from jincresize_tpu_torch.phase import plan_phases
from jincresize_tpu_torch.tools import (
    assemble_breakdown,
    bench_gather,
    device_loop_timing,
    fused_tile_sweep,
    streaming_pipeline,
)


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


CPU = ["--device", "cpu"]
TINY = (48, 32, 96, 64)


def _jax_out_only(frames, shape, tile):
    """The TPU tool's probe: a zero block per grid step, vmapped over frames."""
    (h, w), (th, tw) = shape, tile

    def kern(o_ref):
        o_ref[:] = jnp.zeros((th, tw), jnp.float32)

    call = pl.pallas_call(
        kern,
        out_shape=jax.ShapeDtypeStruct((h, w), jnp.float32),
        grid=(h // th, w // tw),
        out_specs=pl.BlockSpec((th, tw), lambda i, j: (i, j)),
        interpret=True,
    )
    return np.asarray(jax.vmap(lambda _: call())(jnp.zeros(frames)))


def test_out_only_equals_the_jax_probe():
    ref = _jax_out_only(3, (96, 512), probe.TILE)
    assert ref.shape == (3, 96, 512)
    out = torch.full((3, 96, 512), 7.0)
    assert probe.out_only(out) is out
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(probe.out_only_plain((3, 96, 512)).numpy(), ref)
    plane = torch.full((100, 300), -1.0)  # 2-D and ragged against the tiles
    assert not probe.out_only(plane).any()


def test_out_only_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="float32"):
        probe.out_only(torch.zeros((2, 8, 8), dtype=torch.float64))
    with pytest.raises(ValueError, match="float32"):
        probe.out_only(torch.zeros((2, 8, 16))[:, :, ::2])
    with pytest.raises(ValueError, match="positive"):
        probe.out_only(torch.zeros((2, 8, 8)), tile=(0, 256))


def test_fused_tiles_agree_and_unknown_tiles_raise():
    op = build_plane_operator(*TINY, radius_for_tap(8))
    fi = fused_k.make_fused_interior(op, plan_phases(op))
    src = torch.from_numpy(np.random.default_rng(0).random((2, 32, 48), dtype=np.float32))
    ref = fused_k.fused_interior(fi, src)
    assert fused_k.SHAPES == (fused_k.DEFAULT_SHAPE, fused_k.NARROW_SHAPE) == ((128, 4, 8), (32, 4, 8))
    for shape in fused_k.SHAPES:
        assert torch.equal(fused_k.fused_interior(fi, src, shape), ref)
    with pytest.raises(ValueError, match="shape"):
        fused_k.fused_interior(fi, src, (32, 8))


# tool -> (argv, regex of its last stdout line)
TOOLS = {
    "device_loop_timing": (
        device_loop_timing, ["--frames", "2", "--reps", "1"],
        r"full ConvApplier call\s+[\d.]+ ms/frame \(1 back-to-back calls, [\d.]+ ms/call\)",
    ),
    "fused_tile_sweep": (
        fused_tile_sweep, ["--geometry", "4k-8k", "--frames", "2", "--reps", "1"],
        r"4k-8k shape 32t r4 cg8\s+[\d.]+ ms/frame  err=0\.0e\+00  \[cpu\]",
    ),
    "assemble_breakdown": (
        assemble_breakdown, ["--frames", "2", "--reps", "1"],
        r"full \(=\+exceptions\+finalize\)\s+[\d.]+ ms/frame  \[cpu\]",
    ),
    "bench_gather": (
        bench_gather, ["--frames", "2", "--iters", "1", "--check"],
        r"impl=gather frames=2: [\d.]+ ms/frame \([\d.]+ Gpx/s device\)",
    ),
    "streaming_pipeline": (
        streaming_pipeline, ["--frames", "2", "--batches", "3"],
        r'\{"metric": "streaming_overlap_factor", "value": [\d.e-]+, "unit": "x", '
        r'"vs_baseline": [\d.e-]+\}',
    ),
}  # fmt: skip


@pytest.mark.parametrize("name", list(TOOLS))
def test_tool_runs_tiny_and_prints_the_jax_last_line(name, capsys):
    mod, argv, last = TOOLS[name]
    res = mod.main([*argv, *CPU], size=TINY)
    lines = capsys.readouterr().out.strip().splitlines()
    assert re.fullmatch(last, lines[-1]), lines[-1]
    assert res
    if name == "streaming_pipeline":
        assert json.loads(lines[-1]) == res


def test_device_loop_timing_rows():
    res = device_loop_timing.main(["--frames", "2", "--reps", "1", *CPU], size=TINY)
    assert res["grid_per_frame"] == 2  # two (48, 256) tiles cover 64x96
    for k in ("zeros_ms", "out_only_ms", "fused_ms", "full_ms"):
        assert res[k] > 0
    assert res["out_only_graph_ms"] is None and res["fused_graph_ms"] is None  # no graphs on a CPU


@pytest.mark.parametrize(
    "impl,flags,engine",
    [("gather", [], "gather"), ("seg", ["--u8"], "fused-seg"), ("auto", [], "fused"),
     ("xla", ["--pos-precision", "f64"], "xla")],
)  # fmt: skip
def test_bench_gather_impls_check_against_the_golden(impl, flags, engine):
    argv = ["--impl", impl, "--frames", "1", "--iters", "1", "--check", "--geometry", "1.5x"]
    res = bench_gather.main([*argv, *flags, *CPU], size=(64, 48, 96, 72))
    assert res["engine"] == engine and res["check_lsb"] <= 1


def test_bench_gather_geometries_are_the_jax_ones():
    assert bench_gather.GEOMETRIES == {
        "2x": (1920, 1080, 3840, 2160),
        "1.5x": (1920, 1080, 2880, 1620),
        "4k": (2560, 1440, 3840, 2160),
    }


def test_entry_equals_the_jax_entry():
    fn, (src,) = entry.entry(device="cpu")
    jfn, (jsrc,) = __graft_entry__.entry()
    np.testing.assert_array_equal(src.numpy(), np.asarray(jsrc))
    got = fn(src).numpy()
    want = np.asarray(jax.jit(jfn)(jsrc))  # the JAX entry's fn is a jit step
    assert got.shape == want.shape == (540, 960)
    assert float(np.abs(got - want).max()) <= 2e-6


def test_dryrun_multichip_on_cpu_shards():
    out = entry.dryrun_multichip(4, devices=["cpu"] * 4)
    assert tuple(out.shape) == (2, 120, 160)
    op = build_plane_operator(96, 72, 160, 120, radius_for_tap(3))
    src = np.random.default_rng(0).random((2, 72, 96), dtype=np.float32)
    for i in range(2):
        assert float(np.abs(out[i].numpy() - apply_plane_numpy(op, src[i])).max()) <= 2e-6
    assert tuple(entry.dryrun_multichip(3, devices=["cpu"] * 3).shape) == (1, 120, 160)


def _no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize(
    "build",
    [
        lambda op: apply_conv.ConvApplier(op),
        lambda op: apply_conv.ConvApplier(op, plan=plan_phases(op)),
        lambda op: apply_gather.GatherApplier(op),
        lambda op: apply_xla.to_device(op),
        lambda op: apply_conv_seg.SegConvApplier(op),
        lambda op: apply_conv.ConvApplier(op, device="cuda"),
    ],
    ids=["ConvApplier", "ConvApplier-plan", "GatherApplier", "to_device", "SegConvApplier",
         "ConvApplier-cuda"],
)  # fmt: skip
def test_default_constructors_run_on_the_card_or_raise(build, monkeypatch):
    _no_card(monkeypatch)
    op = build_plane_operator(96, 64, 144, 96, radius_for_tap(3), crop_left=0.3, crop_top=0.3)
    with pytest.raises(RuntimeError, match="no CUDA device is visible"):
        build(op)


@pytest.mark.parametrize("name", list(TOOLS))
def test_tools_default_to_the_card(name, monkeypatch):
    _no_card(monkeypatch)
    mod, argv, _ = TOOLS[name]
    with pytest.raises(RuntimeError, match="no CUDA device is visible"):
        mod.main(argv, size=TINY)


def test_entries_default_to_the_card(monkeypatch):
    _no_card(monkeypatch)
    with pytest.raises(RuntimeError, match="no CUDA device is visible"):
        entry.entry()
    with pytest.raises(RuntimeError, match="no CUDA device is visible"):
        entry.dryrun_multichip(4)


def test_probe_kernel_is_built_and_bound():
    """The probe's source and C signature (one pointer, five sizes, the
    stream); the fused kernel's signature carries the shape and its ring, and
    its bf16 mode (the tensor-core kernel) has an entry of its own with its
    layout and warps; a tensor neither on the CPU nor on a CUDA device is
    refused, with no launch counted."""
    from jincresize_tpu_torch.kernels import _build

    assert "out_only.cu" in {p.name for p in _build._sources()}
    assert _build._SIGNATURES["jt_out_only"] == [_build._P] + [_build._I] * 5 + [_build._P]
    assert "jt_out_only(" in (_build.CSRC / "out_only.cu").read_text()
    assert _build._SIGNATURES["jt_fused_interior"] == [_build._P] * 3 + [_build._I] * 22 + [_build._P]
    assert _build._SIGNATURES["jt_fused_interior_bf16"] == [_build._P] * 3 + [_build._I] * 22 + [_build._P]
    assert "jt_fused_interior_bf16(" in (_build.CSRC / "fused_interior.cu").read_text()
    with pytest.raises(RuntimeError, match="unsupported device"):
        probe.out_only(torch.empty((1, 8, 8), device="meta"))
    assert probe.out_only.launches == 0
