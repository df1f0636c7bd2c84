"""The trace reader on synthetic Chrome traces: interval unions, the idle
share, per-frame division and the breakdown."""

import json

import pytest

from benchmark import chrome_trace
from benchmark.harness import Run, reader


def ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


WS3 = "void (anonymous namespace)::fused_ws3_kernel<4, 4, true>((anonymous namespace)::FusedWsArgs)"


def synthetic(frames=4):
    """Two traced calls, [0, 44] and [46, 100] us. Device: an upload
    [0, 20], a kernel [10, 40] that overlaps it, a glue kernel [50, 60], a
    download [60, 90], a memset [95, 96], and a kernel after the window."""
    return chrome_trace.Trace(
        [
            ev(chrome_trace.SPAN, "user_annotation", 0, 44),
            ev(chrome_trace.SPAN, "user_annotation", 46, 54),
            ev("aten::copy_", "cpu_op", 0, 20),
            ev("aten::copy_", "cpu_op", 60, 30),
            ev("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 0, 20),
            ev(WS3, "kernel", 10, 30),
            ev("void at::native::elementwise_kernel<128, 2>(int, F)", "kernel", 50, 10),
            ev("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 60, 30),
            ev("Memset (Device)", "gpu_memset", 95, 1),
            ev("void seg_tc_kernel<1>(SegTcArgs)", "kernel", 150, 10),  # after the window
            {"ph": "i", "name": "marker", "ts": 5},
        ],
        frames,
    )


def test_union_counts_overlap_once():
    assert chrome_trace.union_us([(0, 20), (10, 40), (50, 60)]) == 50
    assert chrome_trace.union_us([(0, 10), (2, 3), (10, 12)]) == 12
    assert chrome_trace.union_us([]) == 0


def test_gaps():
    assert chrome_trace.gaps([(10, 20), (15, 30), (40, 50)], 0, 60) == [(0, 10), (30, 40), (50, 60)]
    assert chrome_trace.gaps([(0, 60)], 0, 60) == []


def test_window_and_busy():
    t = synthetic()
    assert (t.t0, t.t1) == (0, 100) and t.calls == 2
    assert t.window_s == pytest.approx(100e-6)
    # 0-40 (upload under the kernel), 50-90, 95-96: 81 us, not the 91 us summed.
    assert t.busy_s() == pytest.approx(81e-6)
    assert len(t.device) == 5  # the kernel past the last call is left out


def per_layer(t, name, config=None, **kw):
    run = Run(config=config or {}, trace=t, **kw)
    return reader(name)(run)


def test_per_frame_readers():
    t = synthetic(frames=4)
    assert per_layer(t, "copy_ms_per_frame") == pytest.approx(50e-3 / 4)  # 0-20, 60-90
    assert per_layer(t, "interior_ms_per_frame") == pytest.approx(30e-3 / 4)
    assert per_layer(t, "glue_ms_per_frame") == pytest.approx(11e-3 / 4)  # glue + memset
    assert per_layer(t, "launches_per_frame") == pytest.approx(5 / 4)
    assert per_layer(t, "device_idle") == pytest.approx(19.0)


def test_idle_never_below_zero():
    """Copies and kernels stacked over the whole window: idle reads 0."""
    events = [ev(chrome_trace.SPAN, "user_annotation", 0, 10)]
    events += [ev("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 0, 10)] * 3
    events += [ev("void strips_kernel(StripsArgs)", "kernel", 0, 10)]
    t = chrome_trace.Trace(events, 1)
    assert per_layer(t, "device_idle") == pytest.approx(0.0)


def test_readers_without_a_trace_read_nothing():
    for name in ("copy_ms_per_frame", "device_idle", "interior_ms_per_frame",
                 "glue_ms_per_frame", "launches_per_frame", "resample_roofline"):  # fmt: skip
        assert per_layer(None, name) is None
    cpu_only = chrome_trace.Trace([ev(chrome_trace.SPAN, "user_annotation", 0, 10)], 1)
    assert per_layer(cpu_only, "device_idle") is None
    assert per_layer(cpu_only, "resample_roofline", nnz_per_frame=10) is None


def test_roofline_reads_least_time_over_non_copy_time():
    t = synthetic(frames=1)
    cfg = {"format": {"bits": 8, "sub_w": 1, "sub_h": 1}, "src_width": 8, "src_height": 8,
           "jinc_config": {"target_width": 16, "target_height": 16}}  # fmt: skip
    nnz = 989e12 * 1e-6 / 2  # 1 us of operations at the peak
    got = per_layer(t, "resample_roofline", config=cfg, nnz_per_frame=nnz)
    assert got == pytest.approx(100.0 * 1e-6 / 41e-6)  # kernel 30 + glue 10 + memset 1


def test_breakdown_and_host_labels():
    t = synthetic()
    ops = dict(t.device_ops())
    assert ops["Memcpy DtoH (Device -> Pageable)"] == pytest.approx(30e-6)
    assert ops["elementwise_kernel<128, 2>(int, F)"] == pytest.approx(10e-6)
    gaps = dict(t.idle_gaps())
    assert gaps["between calls"] == pytest.approx(10e-6)  # 40-50, its middle between calls
    assert gaps["host code in a call outside torch ops"] == pytest.approx(9e-6)  # 90-95, 96-100
    assert sum(gaps.values()) == pytest.approx(19e-6)
    assert chrome_trace.bare_name(WS3) == "fused_ws3_kernel"
    assert "fused_ws3_kernel<4, 4, true>(FusedWsArgs)" in ops
    assert chrome_trace.bare_name("void (anonymous namespace)::seg_tile_kernel<4>((anonymous namespace)::SegArgs)") == "seg_tile_kernel"
    assert chrome_trace.bare_name("void at::native::vectorized_elementwise_kernel<4>(int)") == (
        "vectorized_elementwise_kernel"
    )


def test_load_reads_a_file(tmp_path):
    p = tmp_path / "trace.json"
    p.write_text(json.dumps({"traceEvents": [ev(chrome_trace.SPAN, "user_annotation", 0, 5)]}))
    assert chrome_trace.load(p, 2).frames == 2
