"""The port's multi-process sharded apply (``jincresize_tpu_torch.distributed``)
on the CPU: the twin of ``tests/test_distributed_mp.py`` and of
``tests/test_aux.py::test_init_distributed_partial_args_raise``.

The two-process test launches this file as its own worker, twice, joined by
a gloo process group on localhost. Each rank builds ``global_mesh(n_rows=4,
devices=["cpu"] * 2)`` (rows 0-1 on rank 0, rows 2-3 on rank 1) and, with
the source rows of the other rank's shards set to NaN in its copy, runs
every sharded interior: the halo rows of those shards can only arrive over
the process group. Each rank holds its rows (``.index``, ``.data``) to the
one-process ``ShardedApplier`` on four CPU row shards (bit-equal: the same
functions run on the same band contents) and to the JAX package's golden on
the JAX package's operator (NumPy only: ``jincresize_tpu.golden``,
``jincresize_tpu.operator``): fp32 within twice the float32 rounding bound
of a pixel's fs**2 taps (``kernels.fused.f32_sum_bound``: the two sides sum
in different orders), u8 within 1 LSB; with no NaN anywhere.

Usage of the worker: ``python tests/test_torch_distributed.py <port> <rank>``.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (name, (src_w, src_h, dst_w, dst_h, tap), impl, interior, frames, u8 out):
# the JAX worker's plane (one 2-D frame, u8 out), one case per interior on
# tests/test_torch_sharding.py's geometries, its 2-hop plan (hop 2 crosses
# the rank boundary both ways) and a plan that replicates the source.
CASES = [
    ("mp-worker-64x48", (64, 48, 128, 96, 3), "auto", "conv-fused", 0, True),
    ("conv-2x-tap8", (128, 96, 256, 192, 8), "conv", "conv-fused", 2, False),
    ("seg-960x540", (640, 360, 960, 540, 8), "seg", "seg", 2, False),
    ("up-160x120", (96, 72, 160, 120, 3), "gather", "gather", 2, False),
    ("deep-multihop-16", (256, 256, 16, 16, 4), "auto", "gather", 2, False),
    ("replicated-8", (256, 256, 8, 8, 4), "auto", "gather-scan", 2, False),
]


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


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_init_distributed_partial_args_raise():
    from jincresize_tpu_torch.distributed import init_distributed

    with pytest.raises(ValueError, match="missing.*num_processes"):
        init_distributed(coordinator_address="localhost:1234")
    with pytest.raises(ValueError, match="missing.*coordinator_address"):
        init_distributed(num_processes=2, process_id=0)
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize(
    "env,missing",
    [
        ({"JINCRESIZE_COORDINATOR": "localhost:1234"}, "num_processes"),
        ({"JINCRESIZE_NUM_PROCESSES": "2", "JINCRESIZE_PROCESS_ID": "0"}, "coordinator_address"),
        ({"JINCRESIZE_COORDINATOR": "localhost:1234", "JINCRESIZE_PROCESS_ID": "1"}, "num_processes"),
    ],
)
def test_init_distributed_partial_env_raises(monkeypatch, env, missing):
    from jincresize_tpu_torch.distributed import init_distributed

    for k in ("JINCRESIZE_COORDINATOR", "JINCRESIZE_NUM_PROCESSES", "JINCRESIZE_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match=f"missing.*{missing}"):
        init_distributed()
    assert not torch.distributed.is_initialized()


def test_init_distributed_with_nothing_set_does_nothing(monkeypatch):
    from jincresize_tpu_torch.distributed import global_mesh, init_distributed

    for k in ("JINCRESIZE_COORDINATOR", "JINCRESIZE_NUM_PROCESSES", "JINCRESIZE_PROCESS_ID",
              "MASTER_ADDR", "WORLD_SIZE", "RANK"):  # fmt: skip
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")  # torchrun's three, only one of them set
    init_distributed()
    assert not torch.distributed.is_initialized()
    # Without a process group the global mesh is this process's.
    mesh = global_mesh(n_rows=2, devices=["cpu"] * 2)
    assert mesh.ranks is None and not mesh.spans_ranks and mesh.n_rows == 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device is visible"):
        global_mesh()


def test_default_backend_is_gloo_unless_torchrun_gives_each_process_a_card(monkeypatch):
    """NCCL only where torchrun's LOCAL_WORLD_SIZE is set and at most the
    number of visible cards; processes started by hand (the ``JINCRESIZE_*``
    recipe), which may share a card, get gloo."""
    from jincresize_tpu_torch.distributed import default_backend

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.distributed, "is_nccl_available", lambda: True)
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    assert default_backend() == "gloo"
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    assert default_backend() == "nccl"
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "3")
    assert default_backend() == "gloo"
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "1")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert default_backend() == "gloo"


def test_mesh_that_spans_ranks_is_refused_by_the_resizers():
    from jincresize_tpu_torch import api
    from jincresize_tpu_torch.clip import Clip, random_frame, yuv420p
    from jincresize_tpu_torch.sharding import RowMesh

    cpu = torch.device("cpu")
    mesh = RowMesh(((cpu,) * 4,), ranks=((0, 0, 1, 1),))
    assert mesh.spans_ranks
    assert not RowMesh(((cpu,) * 2,), ranks=((0, 0),)).spans_ranks
    with pytest.raises(ValueError, match="grid of the devices' shape"):
        RowMesh(((cpu,) * 4,), ranks=((0, 1),))
    clip = Clip.from_frames([random_frame(yuv420p(8), 32, 24, seed=1)])
    with pytest.raises(api.JincError, match="ShardedApplier"):
        api.jinc_resize(clip, 64, 48, device="cpu", mesh=mesh, operator_cache=False)
    with pytest.raises(api.JincError, match="ShardedApplier"):
        api.jinc_resize_chain(clip, [dict(target_width=64, target_height=48)],
                              device="cpu", mesh=mesh)  # fmt: skip


def test_two_process_gloo_sharded_parity():
    port = _free_port()
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH", "")}  # fmt: skip
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(port), str(rank)],
            env=env,
            cwd=ROOT,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        for rank in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=120)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out}"
        for name, *_ in CASES:
            assert f"CASE_OK rank{rank} {name}" in out, f"rank {rank} skipped {name}:\n{out}"
        assert f"DIST_OK rank{rank}" in out, f"rank {rank} no parity line:\n{out}"


# ---------------------------------------------------------------------------
# The worker.
# ---------------------------------------------------------------------------


def _other_rows(mesh, ts: int, src_h: int, rank: int) -> np.ndarray:
    """Source rows of the shards another rank owns (data row 0)."""
    rows = [
        r
        for d, owner in enumerate(mesh.ranks[0])
        if owner != rank
        for r in range(d * ts, min((d + 1) * ts, src_h))
    ]
    return np.asarray(rows, dtype=np.int64)


def _check_case(case, mesh, ref_mesh, rank: int) -> None:
    from jincresize_tpu import golden as jgolden
    from jincresize_tpu import operator as joperator
    from jincresize_tpu_torch.kernels.fused import f32_sum_bound
    from jincresize_tpu_torch.operator import build_plane_operator, radius_for_tap
    from jincresize_tpu_torch.sharding import ShardedApplier

    name, (sw, sh, dw, dh, tap), impl, interior, frames, u8 = case
    op = build_plane_operator(sw, sh, dw, dh, radius_for_tap(tap))
    jop = joperator.build_plane_operator(sw, sh, dw, dh, joperator.radius_for_tap(tap))
    app = ShardedApplier(op, mesh, impl=impl)
    ref = ShardedApplier(op, ref_mesh, impl=impl)
    assert app.interior == ref.interior == interior, (name, app.interior, ref.interior)
    assert app.plan.replicate_src == (name == "replicated-8"), name
    kw = dict(out_dtype=torch.uint8, peak=255.0) if u8 else {}
    shape = (sh, sw) if frames == 0 else (frames, sh, sw)
    src = np.random.default_rng(7).random(shape, dtype=np.float32)  # the JAX worker's seed
    poisoned = src.copy()
    poisoned[..., _other_rows(mesh, app._fn.ts, sh, rank), :] = np.nan
    got = app(torch.from_numpy(poisoned), **kw)
    want = ref(torch.from_numpy(src), **kw).numpy()
    planes = src.reshape(-1, sh, sw)
    golden = np.stack([
        jgolden.apply_plane_numpy(jop, s, out_dtype=np.uint8 if u8 else np.float32, peak=255.0)
        for s in planes
    ]).reshape(want.shape)  # fmt: skip
    wsum = max(float(np.abs(b).sum((-2, -1), dtype=np.float64).max())
               for b in [jop.pair_blocks, *(st.blocks for st in jop.strips)] if b.size)  # fmt: skip
    tol = 2 * f32_sum_bound(jop.filter_size**2, wsum, float(src.max()))
    assert isinstance(got, list) and got, name
    mine = sorted({(s.index[-2].start, s.index[-2].stop) for s in got})
    td = -(-dh // mesh.n_rows)
    assert mine == [(d * td, min((d + 1) * td, dh)) for d, r in enumerate(mesh.ranks[0])
                    if r == rank and d * td < dh], (name, mine)  # fmt: skip
    worst = 0.0
    for s in got:
        data = s.data.numpy()
        assert data.shape == want[s.index].shape, (name, s.index)
        if not u8:
            assert not np.isnan(data).any(), (name, s.index)
        assert np.array_equal(data, want[s.index]), (name, s.index)
        if u8:
            d = int(np.abs(data.astype(int) - golden[s.index].astype(int)).max())
            assert d <= 1, (name, s.index, d)
            worst = max(worst, d)
        else:
            d = float(np.abs(data - golden[s.index]).max())
            assert d <= tol, (name, s.index, d, tol)
            worst = max(worst, d)
    ex = app._fn.exchange
    assert ex["bytes_received"] > 0 and ex["bytes_sent"] > 0, (name, ex)
    print(f"CASE_OK rank{rank} {name} interior={app.interior} "
          f"sent={ex['bytes_sent']} received={ex['bytes_received']} "
          f"golden={worst:g} bound={tol:g}", flush=True)  # fmt: skip


def _check_data_axis(rank: int) -> None:
    """Frames over the data axis, one data row a rank: three frames padded
    to four, the padded frame cut from the indices; no halo crosses."""
    from jincresize_tpu_torch.distributed import global_mesh
    from jincresize_tpu_torch.operator import build_plane_operator, radius_for_tap
    from jincresize_tpu_torch.sharding import ShardedApplier, make_mesh

    mesh = global_mesh(n_rows=2, n_data=2, devices=["cpu"] * 2)
    assert mesh.ranks == ((0, 0), (1, 1)), mesh.ranks
    op = build_plane_operator(64, 48, 128, 96, radius_for_tap(3))
    src = torch.from_numpy(np.random.default_rng(3).random((3, 48, 64), dtype=np.float32))
    got = ShardedApplier(op, mesh)(src)
    want = ShardedApplier(op, make_mesh(n_rows=2, n_data=2, devices=["cpu"] * 4))(src).numpy()
    frames = sorted({(s.index[0].start, s.index[0].stop) for s in got})
    assert frames == [[(0, 2)], [(2, 3)]][rank], frames
    for s in got:
        assert np.array_equal(s.data.numpy(), want[s.index]), s.index


def worker(port: int, rank: int) -> int:
    torch.set_num_threads(1)
    from jincresize_tpu_torch.distributed import global_mesh, init_distributed
    from jincresize_tpu_torch.sharding import make_mesh

    init_distributed(coordinator_address=f"127.0.0.1:{port}", num_processes=2,
                     process_id=rank, backend="gloo")  # fmt: skip
    assert torch.distributed.get_world_size() == 2
    init_distributed(coordinator_address=f"127.0.0.1:{port}", num_processes=2,
                     process_id=rank, backend="gloo")  # idempotent  # fmt: skip
    mesh = global_mesh(n_rows=4, devices=["cpu"] * 2)
    assert mesh.ranks == ((0, 0, 1, 1),), mesh.ranks
    ref_mesh = make_mesh(n_rows=4, devices=["cpu"] * 4)
    for case in CASES:
        _check_case(case, mesh, ref_mesh, rank)
    _check_data_axis(rank)
    torch.distributed.destroy_process_group()
    print(f"DIST_OK rank{rank}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(worker(int(sys.argv[1]), int(sys.argv[2])))
