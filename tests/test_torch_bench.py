"""The port's bench twin (``python -m jincresize_tpu_torch.bench``) on the CPU.

At tiny sizes (``main(argv, size=...)``) and ``--device cpu``, each mode must
run the engine it names and print, as its last line, one JSON object with the
root ``bench.py``'s keys and metric names. The numbers of such a run are
host-clock times of the plain forms, not a card's: the ``device`` key says so.
"""

import json

import pytest
import torch

from jincresize_tpu_torch import bench


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


# mode flags -> (tiny geometry, metric, --small metric)
MODES = {
    "default": ([], (48, 32, 96, 64), "jinc256_4k_to_8k", "jinc256_1080p"),
    "downscale": (["--downscale"], (96, 54, 48, 27), "jinc256_4k_to_1080p", "jinc256_1080p_to_540p"),
    "tap16-downscale": (
        ["--tap16-downscale"], (240, 136, 120, 68), "tap16_4k_to_1080p", "tap16_1080p_to_540p"
    ),
}  # fmt: skip
CPU = ["--device", "cpu", "--frames", "2", "--iters", "1"]


@pytest.mark.parametrize("small", [False, True], ids=["full-name", "small-name"])
@pytest.mark.parametrize("mode", list(MODES))
def test_bench_modes_print_the_jax_bench_line(mode, small, capsys):
    flags, size, metric, small_metric = MODES[mode]
    res = bench.main([*flags, *CPU, *(["--small"] if small else [])], size=size)
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last == res
    assert list(res)[:4] == ["metric", "value", "unit", "vs_baseline"]
    assert res["metric"] == f"{small_metric if small else metric}_fp32_px_per_s_per_chip"
    assert res["unit"] == "px/s" and res["value"] > 0 and res["vs_baseline"] > 0
    assert res["engine"] == "fused" and res["device"] == "cpu"


def test_vs_baseline_follows_the_jax_bench(capsys):
    """vs_baseline = value / bar, the bar computed as the root bench does."""
    res = bench.main([*CPU], size=(48, 32, 96, 64))
    assert res["vs_baseline"] == pytest.approx(res["value"] / bench.BASELINE_PX_PER_S)
    res = bench.main(["--tap16-downscale", *CPU], size=(240, 136, 120, 68))
    fs = 65
    assert res["vs_baseline"] == pytest.approx(res["value"] / (1.54e12 / (fs * 80)))


def test_mode_geometries_are_the_jax_bench_ones():
    args = bench.parse_args([])
    assert bench.geometry(args) == (3840, 2160, 7680, 4320, 8)
    assert bench.geometry(bench.parse_args(["--small"])) == (960, 540, 1920, 1080, 8)
    assert bench.geometry(bench.parse_args(["--downscale"])) == (3840, 2160, 1920, 1080, 8)
    assert bench.geometry(bench.parse_args(["--tap16-downscale"])) == (3840, 2160, 1920, 1080, 16)
    assert bench.geometry(bench.parse_args(["--tap16-downscale", "--small"])) == (1920, 1080, 960, 540, 16)
    assert (args.frames, args.iters, args.impl, args.precision, args.device) == (
        32, 3, "auto", "fp32", "cuda"
    )  # fmt: skip


@pytest.mark.parametrize(
    "impl,engine", [("xla", "xla"), ("conv", "fused"), ("pallas", "fused"), ("auto", "fused")]
)
def test_impl_selects_the_engine(impl, engine, capsys):
    res = bench.main(["--impl", impl, *CPU], size=(48, 32, 96, 64))
    assert res["engine"] == engine


def test_seg_and_gather_impls():
    """'seg' and 'gather' select their engines on geometries they accept
    (the selection alone: their plain forms are many small operations)."""
    from jincresize_tpu_torch.operator import build_plane_operator, radius_for_tap

    cpu = torch.device("cpu")
    for impl, geom, engine in (("seg", (96, 64, 288, 192, 2), "fused-seg"),
                               ("gather", (96, 64, 167, 113, 3), "gather")):  # fmt: skip
        op = build_plane_operator(*geom[:4], radius_for_tap(geom[4]))
        app, got = bench.make_engine(op, impl, "fp32", cpu)
        assert got == engine and app.interior == engine


def test_bf16_and_missing_card_raise(monkeypatch):
    """'bf16' runs (it raised before it was ported) and names its precision;
    a missing card still raises."""
    res = bench.main(["--precision", "bf16", *CPU], size=(48, 32, 96, 64))
    assert res["metric"] == "jinc256_4k_to_8k_fp32_px_per_s_per_chip"  # the JAX bench's names
    assert (res["engine"], res["precision"]) == ("fused", "bf16")
    assert res["effective_precision"] == "bf16"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["--frames", "1"], size=(48, 32, 96, 64))


def test_scaling_prints_the_jax_harness_line(tmp_path):
    """``--scaling --device cpu --frames 2`` as ``python -m``: exit 0, the
    root ``bench.py --scaling`` keys on the last line, k = 1, 2, 4 and 8,
    the honest CPU mode, and the same object in ``$JINCRESIZE_SCALING_OUT``."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    out_path = tmp_path / "scaling.json"
    env = {**os.environ, "JINCRESIZE_SCALING_OUT": str(out_path), "OMP_NUM_THREADS": "1",
           "PYTHONPATH": str(root) + os.pathsep + os.environ.get("PYTHONPATH", "")}  # fmt: skip
    r = subprocess.run(
        [sys.executable, "-m", "jincresize_tpu_torch.bench", "--scaling", "--device", "cpu",
         "--frames", "2"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300,
    )  # fmt: skip
    assert r.returncode == 0, r.stderr
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert list(res) == ["metric", "value", "unit", "vs_baseline", "per_k", "mode",
                         "mesh_scaling_like_engine", "note"]  # fmt: skip
    assert res["metric"] == "nnz_scaling_8dev" and res["unit"] == "fraction_of_linear"
    assert res["vs_baseline"] == pytest.approx(res["value"] / 0.9)
    assert [p["k"] for p in res["per_k"]] == [1, 2, 4, 8]
    assert all(set(p) == {"k", "ms_batch", "gnnz_s", "interior"} for p in res["per_k"])
    assert res["per_k"][0]["interior"] == "fused"
    assert all(p["interior"] == "conv-fused" for p in res["per_k"][1:])
    assert res["mode"] == "serial-shards-cpu" and "one after another" in res["note"]
    gnnz = [p["gnnz_s"] for p in res["per_k"]]
    assert res["value"] == pytest.approx(gnnz[-1] / (8 * gnnz[0]))
    assert json.loads(out_path.read_text()) == res
    assert "cpu" in r.stderr.splitlines()[0]
