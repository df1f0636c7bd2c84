"""The port's observability (``jincresize_tpu_torch.metrics`` and the API's
drift hint) against ``jincresize_tpu.metrics`` and the JAX API, on the CPU."""

import json
import logging

import numpy as np
import pytest
import torch

from jincresize_tpu import api as japi
from jincresize_tpu import clip as jclip
from jincresize_tpu import metrics as jmetrics
from jincresize_tpu.operator import build_plane_operator as jbuild
from jincresize_tpu_torch import api, metrics
from jincresize_tpu_torch.clip import Clip, gray, random_frame
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


OPERATORS = [
    (96, 64, 192, 128, 8, {}),
    (96, 64, 167, 113, 3, {}),
    (192, 144, 128, 96, 3, {"crop_left": 0.3, "crop_top": 0.3}),
]


@pytest.mark.parametrize("geom", OPERATORS, ids=lambda g: "{}x{}->{}x{}".format(*g[:4]))
def test_log_operator_stats_equal_jax(geom, caplog):
    sw, sh, dw, dh, tap, kw = geom
    op = build_plane_operator(sw, sh, dw, dh, radius_for_tap(tap), **kw)
    jop = jbuild(sw, sh, dw, dh, radius_for_tap(tap), **kw)
    with caplog.at_level(logging.INFO, logger="jincresize_tpu_torch"):
        st = metrics.log_operator_stats(op, "luma")
    assert st == jmetrics.log_operator_stats(jop, "luma")
    assert f"luma stats: {json.dumps(st)}" in caplog.messages


# (name, src_w, src_h, dst_w, dst_h, JincConfig kwargs, hint expected): the
# 1.5x crop geometry plans periodic only with float64 positions.
DRIFT = {"src_left": 0.123, "src_top": 0.456}
HINT_CASES = [
    ("drifted 1.5x", 1280, 720, 1920, 1080, DRIFT, True),
    ("drifted 1.5x impl=xla", 1280, 720, 1920, 1080, {**DRIFT, "impl": "xla"}, False),
    ("drifted 1.5x f64", 1280, 720, 1920, 1080, {**DRIFT, "pos_precision": "f64"}, False),
    ("periodic 2x", 96, 64, 192, 128, {}, False),
    ("aperiodic", 96, 64, 167, 113, {}, False),
]


@pytest.mark.parametrize("case", HINT_CASES, ids=[c[0] for c in HINT_CASES])
def test_drift_hint_fires_where_jax_does(case, caplog):
    _, sw, sh, dw, dh, kw, want = case
    cfg = dict(target_width=dw, target_height=dh, tap=8, operator_cache=False, **kw)
    with caplog.at_level(logging.INFO):
        r = api.JincResizer(gray(8), sw, sh, api.JincConfig(**cfg), device="cpu")
        jr = japi.JincResizer(jclip.gray(8), sw, sh, japi.JincConfig(**cfg))
    fired = {
        name: any("pos_precision='f64'" in rec.getMessage() for rec in caplog.records
                  if rec.name == name)
        for name in ("jincresize_tpu_torch", "jincresize_tpu")
    }  # fmt: skip
    assert fired == {"jincresize_tpu_torch": want, "jincresize_tpu": want}
    assert r.engines["luma"] == jr.engines["luma"].replace("shift", "fused")
    port_msg = [rec.getMessage() for rec in caplog.records if rec.name == "jincresize_tpu_torch"]
    assert not any("MXU" in m or "JINCRESIZE_SEG_MIN_PIXELS" in m for m in port_msg)


def test_device_trace_writes_a_trace_of_a_cpu_resize(tmp_path):
    clip = Clip.from_frames([random_frame(gray(8), 32, 24, seed=1)])
    with metrics.device_trace(str(tmp_path)) as prof:
        out = api.jinc_resize(clip, 64, 48, device="cpu", operator_cache=False)
    assert out.frames[0].planes["Y"].shape == (48, 64)
    trace = json.loads((tmp_path / "trace.json").read_text())
    assert trace["traceEvents"]
    assert any(e.key.startswith("aten::") for e in prof.key_averages())
    assert np.isfinite(out.frames[0].planes["Y"]).all()
    assert metrics.device_time_by_op(tmp_path / "trace.json") == {}  # no CUDA activity
    assert metrics.device_busy(tmp_path / "trace.json") == (0.0, 0.0)


def test_device_time_by_op_sums_device_events(tmp_path):
    """Kernels, copies and memsets summed by name, the largest first; host
    operations and instant events left out."""
    events = [
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pageable -> Device)", "ts": 0.0,
         "dur": 3000.0},
        {"ph": "X", "cat": "kernel", "name": "fused_interior_kernel", "ts": 4000.0, "dur": 1500.0},
        {"ph": "X", "cat": "kernel", "name": "fused_interior_kernel", "ts": 6000.0, "dur": 500.0},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset (Device)", "ts": 9750.0, "dur": 250.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 0.0, "dur": 20000.0},
        {"ph": "i", "cat": "kernel", "name": "marker", "ts": 30000.0},
    ]  # fmt: skip
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    got = metrics.device_time_by_op(path)
    assert list(got.items()) == [
        ("Memcpy HtoD (Pageable -> Device)", (3.0, 1)),
        ("fused_interior_kernel", (2.0, 2)),
        ("Memset (Device)", (0.25, 1)),
    ]
    assert metrics.device_busy(path) == (5.25, 10.0)  # the device idles 47.5% of its span
    # A download and a kernel under an upload count once: busy is the union
    # of the intervals (0-4 ms, 5-6 ms), not their 8 ms sum.
    events = [
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pageable -> Device)", "ts": 0.0,
         "dur": 3000.0},
        {"ph": "X", "cat": "kernel", "name": "fused_interior_kernel", "ts": 1000.0, "dur": 3000.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH (Device -> Pageable)", "ts": 1500.0,
         "dur": 1000.0},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset (Device)", "ts": 5000.0, "dur": 1000.0},
    ]  # fmt: skip
    path.write_text(json.dumps({"traceEvents": events}))
    assert metrics.device_busy(path) == (5.0, 6.0)
