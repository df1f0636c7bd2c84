"""A CPU rehearsal of ``run.py``: its arguments, and that it exits nonzero
and prints no result without a card or without the program."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import harness

ROOT = Path(__file__).resolve().parents[2]
CELL = harness.load_spec()["workloads"][0]["name"]  # any cell: no run gets past its start
NO_CARD = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}


def run_py(cwd, *args):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", *args], cwd=cwd, env=NO_CARD,
        capture_output=True, text=True, timeout=120,
    )  # fmt: skip


def test_arguments():
    a = harness.parse_args(["--workload", CELL, "--seed", str(2**31 + 7), "--seconds", "10", "--trace", "1"])
    assert (a.workload, a.seed, a.seconds, a.trace, a.control) == (CELL, 2**31 + 7, 10.0, 1, False)
    assert harness.parse_args(["--workload", CELL, "--seed", "3", "--seconds", "1"]).trace == 0
    with pytest.raises(SystemExit):
        harness.parse_args(["--workload", CELL, "--seed", "3"])
    with pytest.raises(SystemExit):
        harness.parse_args(["--workload", CELL, "--seed", "3", "--seconds", "1", "--trace", "2"])


def test_every_cell_resolves():
    spec = harness.load_spec()
    for w in spec["workloads"]:
        cell = harness.workload(spec, w["name"])
        assert harness.config_of(spec, cell)["name"] == w["config"]
        assert harness.traffic_of(cell)["name"] == w["traffic"]
    with pytest.raises(SystemExit):
        harness.workload(spec, "no_such_cell")


def no_result(p):
    lines = p.stdout.strip().splitlines()
    if not lines:
        return True
    try:
        json.loads(lines[-1])
    except json.JSONDecodeError:
        return True
    return False


def test_no_card_no_result():
    p = run_py(ROOT, "--workload", CELL, "--seed", "5", "--seconds", "1", "--trace", "0")
    assert p.returncode != 0 and no_result(p)
    assert "CUDA card" in p.stderr


def test_without_the_program_no_result(tmp_path):
    """A directory with only BENCHMARK.json and benchmark/: no card here,
    and past the card check the program's import fails."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))  # fmt: skip
    p = run_py(tmp_path, "--workload", CELL, "--seed", "5", "--seconds", "1", "--trace", "0")
    assert p.returncode != 0 and no_result(p)
    code = (
        "import sys, time; sys.path[0] = '.'\n"
        "from benchmark import harness\n"
        "spec = harness.load_spec()\n"
        f"harness.run_cell(spec, harness.workload(spec, {CELL!r}), 5, 1.0, False, 'cpu', time.perf_counter())\n"
    )
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=NO_CARD,
                       capture_output=True, text=True, timeout=120)  # fmt: skip
    assert p.returncode != 0 and "jincresize_tpu_torch" in p.stderr


def test_configurations_name_their_entry_and_reference():
    """The harness builds the system under test and judges it with the
    modules a configuration names, so a deployment with another entry point
    or another reference is a file and a key, not an edit of the harness."""
    from benchmark.reference import jinc_ewa

    spec = harness.load_spec()
    for c in spec["configs"]:
        body = harness.config_of(spec, {"config": c["name"]})
        entry, ref = harness.module(body["entry"]), harness.module(body["reference"])
        assert all(callable(getattr(entry, f)) for f in ("build", "count", "frames"))
        assert callable(ref.compare) and callable(ref.out_shapes)
    assert harness.module("reference/jinc_ewa.py") is jinc_ewa


def test_plane_shapes_by_family():
    from benchmark import clips

    def shapes(family, **kw):
        fmt = {"family": family, "bits": 8, **kw}
        return clips.plane_shapes({"format": fmt, "src_width": 64, "src_height": 36})

    assert shapes("YUV", sub_w=1, sub_h=1) == {"Y": (36, 64), "U": (18, 32), "V": (18, 32)}
    assert shapes("YUV", sub_w=1, sub_h=0, has_alpha=True)["U"] == (36, 32)
    assert shapes("YUV", has_alpha=True)["A"] == (36, 64)
    assert shapes("GRAY") == {"Y": (36, 64)}
    assert list(shapes("RGB")) == ["G", "B", "R"]
