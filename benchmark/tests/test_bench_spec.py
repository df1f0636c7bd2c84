"""BENCHMARK.json keeps to the benchmark's rules: its keys, the
characters of every name and unit, and a file for every configuration,
traffic mix and metric, found by name."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
METRIC_KEYS = {"name", "unit", "better", "source"}


def line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_size():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}  # fmt: skip
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_command_and_paths():
    cmd, paths = SPEC["command"], SPEC["paths"]
    assert 1 <= len(cmd) <= 32 and all(line(w) for w in cmd)
    assert not any(w.startswith("/") or ".." in w.split("/") for w in cmd)
    assert 1 <= len(paths) <= 16
    for p in paths:
        assert PATH.match(p) and not p.endswith("_torch") and (ROOT / p).is_dir()
    files = [w for w in cmd if "/" in w]
    assert all(any(f.startswith(p + "/") for p in paths) and (ROOT / f).is_file() for f in files)
    for p in paths:
        for f in (ROOT / p).rglob("*"):
            if "__pycache__" not in f.parts and f.is_file():
                assert PATH.match(f.relative_to(ROOT).as_posix()), f


def test_run_seconds_fits_a_full_check():
    s = SPEC["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_lines():
    names = [c["name"] for c in SPEC["configs"]] + [w["name"] for w in SPEC["workloads"]]
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    names += [m["name"] for m in metrics]
    names += [w["config"] for w in SPEC["workloads"]] + [w["traffic"] for w in SPEC["workloads"]]
    names += [k for c in SPEC["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    for group in (SPEC["configs"], SPEC["workloads"], metrics):
        assert len({x["name"] for x in group}) == len(group)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert line(c["source"]) and line(c["why"]) and len(c["reduced"]) <= 16
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and line(w["why"])


def test_end_to_end_metrics():
    e2e = SPEC["end_to_end"]
    assert 1 <= len(e2e) <= 16 and "setup_s" in {m["name"] for m in e2e}
    for m in e2e:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"bound"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_per_layer_metrics():
    cells = {w["name"] for w in SPEC["workloads"]}
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert 1 <= len(SPEC["per_layer"]) <= 128
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"layer", "moves"}
        assert line(m["layer"]) and m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells
    layers = {m["layer"] for m in SPEC["per_layer"]}
    assert all(line(x) for x in layers)


def reported(group, cell):
    return {m["name"] for m in SPEC[group] if cell in m.get("workloads", [cell])}


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda w: w["name"])
def test_every_cell(cell):
    configs = {c["name"]: c for c in SPEC["configs"]}
    assert cell["config"] in configs and cell["chips"] in (1, 4)
    e2e = reported("end_to_end", cell["name"])
    assert "setup_s" in e2e and len(e2e) >= 2
    assert reported("per_layer", cell["name"])
    assert (ROOT / "benchmark" / "traffic" / f"{cell['traffic']}.json").is_file()
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert pairs.count((cell["config"], cell["traffic"])) == 1


def test_four_chip_cells_are_few():
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, len(SPEC["workloads"]) // 4)


@pytest.mark.parametrize("config", SPEC["configs"], ids=lambda c: c["name"])
def test_config_files(config):
    path = ROOT / config["file"]
    assert any(config["file"].startswith(p + "/") for p in SPEC["paths"]) and path.is_file()
    body = json.loads(path.read_text())
    assert body["name"] == config["name"] and body["reduced"] == config["reduced"]
    for key in ("entry", "reference"):
        assert (path.parent.parent / body[key]).is_file()
    assert {"max_lsb", "mismatch_ppm"} <= set(body["checks"])
    assert body["jinc_config"]["impl"] == "auto" and body["jinc_config"]["precision"] == "fp32"
    used = [w for w in SPEC["workloads"] if w["config"] == config["name"]]
    assert used
    files = [c["file"] for c in SPEC["configs"]]
    assert files.count(config["file"]) == 1


@pytest.mark.parametrize("metric", SPEC["end_to_end"] + SPEC["per_layer"], ids=lambda m: m["name"])
def test_a_reader_per_metric(metric):
    from benchmark.harness import reader

    assert callable(reader(metric["name"]))


@pytest.mark.parametrize("config", SPEC["configs"], ids=lambda c: c["name"])
def test_config_standin_and_engines(config):
    """Each configuration carries what the CPU tests need to run it: a
    stand-in size with a line on the plan it keeps, and the engine each
    plane takes on the card, as ``JincResizer(...).engines`` reports it."""
    body = json.loads((ROOT / config["file"]).read_text())
    s = body["standin"]
    assert set(s) == {"src_width", "src_height", "target_width", "target_height", "why"}
    sizes = [s[k] for k in ("src_width", "src_height", "target_width", "target_height")]
    assert all(isinstance(n, int) and n > 0 for n in sizes) and line(s["why"])
    engines = body["engines"]
    assert isinstance(engines, dict) and "luma" in engines and set(engines) <= {"luma", "chroma"}
    assert all(isinstance(e, str) and e for e in engines.values())
