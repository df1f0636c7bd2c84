"""The port's spans and set-up counters (``jincresize_tpu_torch.metrics``) on
the CPU, at small stand-ins: the span tree one ``JincResizer`` call writes
into a ``metrics.device_trace``, that no span records without a profiler,
and the operator cache's and the constructor's counters."""

import json
import logging
import time

import numpy as np
import pytest
import torch

from jincresize_tpu_torch import api, metrics
from jincresize_tpu_torch.clip import Clip, random_frame, yuv420p


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread for this module's tests: pytest-xdist runs
    several workers on one machine, and each worker's default pool (a
    thread a core) oversubscribes the cores. The old count is back after
    the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (id, src_w, src_h, dst_w, dst_h, tap, bits, frames, impl, engine on every plane)
CASES = [
    ("fused-2x", 96, 64, 192, 128, 3, 8, 1, "pallas", "fused"),
    ("fused-seg-tap16", 256, 144, 192, 108, 16, 10, 1, "pallas", "fused-seg"),
    ("gather", 96, 64, 167, 113, 3, 8, 1, "gather", "gather"),
    ("fused-2x-clip", 96, 64, 192, 128, 3, 8, 2, "pallas", "fused"),
]
ENGINE_STEPS = {"jinc.source_f32", "jinc.interior", "jinc.strips", "jinc.assemble",
                "jinc.finalize"}  # fmt: skip
PLANE_STEPS = {"jinc.stack", "jinc.upload", "jinc.engine", "jinc.download"}


def resizer(case):
    _, sw, sh, dw, dh, tap, bits, _, impl, _ = case
    cfg = api.JincConfig(target_width=dw, target_height=dh, tap=tap, impl=impl,
                         operator_cache=False)  # fmt: skip
    return api.JincResizer(yuv420p(bits), sw, sh, cfg, device="cpu")


def clip_of(case):
    _, sw, sh, _, _, _, bits, frames, _, _ = case
    return Clip.from_frames([random_frame(yuv420p(bits), sw, sh, seed=s) for s in range(frames)])


def spans(trace_path) -> list[dict]:
    """The ``jinc.*`` spans of a Chrome trace, each with its parent: the
    innermost other span that covers it."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    out = [dict(name=e["name"], a=e["ts"], b=e["ts"] + e["dur"]) for e in events
           if e.get("ph") == "X" and e.get("cat") == "user_annotation"
           and e["name"].startswith("jinc.")]  # fmt: skip
    for s in out:
        cover = [p for p in out if p is not s and p["a"] <= s["a"] and s["b"] <= p["b"]]
        s["parent"] = min(cover, key=lambda p: p["b"] - p["a"])["name"] if cover else None
    return out


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_a_call_writes_the_span_tree(case, tmp_path):
    r = resizer(case)
    assert set(r.engines.values()) == {case[-1]}
    clip = clip_of(case)
    r(clip)  # first-call set-up outside the trace
    with metrics.device_trace(str(tmp_path)):
        out = r(clip)
    assert len(out.frames) == len(clip.frames)
    got = spans(tmp_path / "trace.json")
    children = {}
    for s in got:
        children.setdefault(s["parent"], []).append(s["name"])
    planes = [f"jinc.plane.{n}" for n in ("Y", "U", "V")]
    assert children[None] == ["jinc.call"]
    assert sorted(children["jinc.call"]) == sorted(planes + ["jinc.frame_out"] * (
        1 if len(clip.frames) > 1 else 2))  # fmt: skip
    for p in planes:
        assert sorted(children[p]) == sorted(PLANE_STEPS)
    assert set(children["jinc.engine"]) == ENGINE_STEPS
    assert len(children["jinc.engine"]) == 3 * len(ENGINE_STEPS)
    assert not set(children) - {None, "jinc.call", "jinc.engine", *planes}  # nothing deeper
    assert len(got) <= 40


def test_no_span_records_without_a_profiler(monkeypatch):
    """With no profiler recording, a call enters no ``record_function``;
    under one, the same call reaches it."""

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler recording")

    case = CASES[0]
    r, clip = resizer(case), clip_of(case)
    want = r(clip).frames[0].planes["Y"]
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert metrics.span("jinc.call") is metrics.span("jinc.engine")  # one shared no-op
    np.testing.assert_array_equal(r(clip).frames[0].planes["Y"], want)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with pytest.raises(AssertionError, match="jinc.call"):
            r(clip)


def test_count_takes_only_the_set_up_keys():
    before = metrics.counters()
    assert set(before) == {"operator_s", "engine_s", "operator_cache_loads",
                           "operator_cache_builds", "exception_launches",
                           "exception_lines", "gather_launches", "gather_grouped_launches",
                           "strips_band_launches", "seg_launches", "engine_bytes"}  # fmt: skip
    with pytest.raises(KeyError):
        metrics.count("frames", 1)
    got = metrics.counters()
    got["engine_s"] = -1.0  # a copy: the record is not touched
    assert metrics.counters()["engine_s"] >= before["engine_s"] >= 0


def built_by(fn):
    before = metrics.counters()
    out = fn()
    return out, {k: v - before[k] for k, v in metrics.counters().items()}


def test_operator_cache_counts_loads_and_builds(tmp_path, monkeypatch, caplog):
    """Cold, warm, and with one corrupt entry (rebuilt: a build)."""
    monkeypatch.setenv("JINCRESIZE_TORCH_CACHE_DIR", str(tmp_path))

    def build():
        cfg = api.JincConfig(target_width=192, target_height=128, tap=3, impl="xla")
        return api.JincResizer(yuv420p(8), 96, 64, cfg, device="cpu")

    with caplog.at_level(logging.INFO, logger="jincresize_tpu_torch"):
        _, cold = built_by(build)
        _, warm = built_by(build)
    assert (cold["operator_cache_builds"], cold["operator_cache_loads"]) == (2, 0)
    assert (warm["operator_cache_builds"], warm["operator_cache_loads"]) == (0, 2)
    lines = [m for m in caplog.messages if m.startswith("resizer built:")]
    assert len(lines) == 2 and lines[1].endswith("operator cache 2 loads, 0 builds")
    entries = sorted(tmp_path.glob("op_*.npz"))
    assert len(entries) == 2
    entries[0].write_bytes(b"not an npz")
    _, mixed = built_by(build)
    assert (mixed["operator_cache_builds"], mixed["operator_cache_loads"]) == (1, 1)


@pytest.mark.parametrize("case", CASES[:3], ids=[c[0] for c in CASES[:3]])
def test_build_times_fit_in_the_constructor(case):
    t0 = time.perf_counter()
    r, built = built_by(lambda: resizer(case))
    wall = time.perf_counter() - t0
    assert set(r.engines.values()) == {case[-1]}
    assert built["operator_s"] > 0 and built["engine_s"] > 0
    assert built["operator_s"] + built["engine_s"] <= wall

