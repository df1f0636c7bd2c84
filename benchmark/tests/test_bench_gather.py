"""The deep aperiodic configuration's own yardsticks: the work count of
``gather_roofline`` (``benchmark/gather_work.py``) against the program's
interior at the stand-in and by hand at full size, its reader on synthetic
traces, and ``engine_mb`` on the program's counter and on a program older
than it."""

import json
from pathlib import Path

import pytest

from benchmark import chrome_trace, gather_work, work
from benchmark.harness import Run, reader

CONFIG = Path(__file__).resolve().parents[1] / "configs" / "jinc_tap16_2160p_to_768p_yuv420p8.json"
GATHER = "void (anonymous namespace)::gather_tile_kernel<1, false>((anonymous namespace)::GatherArgs)"
WS3 = "void (anonymous namespace)::fused_ws3_kernel<4, 4, true>((anonymous namespace)::FusedWsArgs)"


def load():
    return json.loads(CONFIG.read_text())


def ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def per_layer(t, name, config=None):
    return reader(name)(Run(config=config or {}, trace=t))


def test_gather_work_at_the_stand_in_matches_the_programs_interior(at_standin):
    """The interior that ``gather_work`` counts from the reference's
    geometry is the rectangle the program's gather engine computes, plane
    by plane, at the stand-in (fs 92 luma, fs 93 chroma)."""
    from jincresize_tpu_torch.api import JincConfig, JincResizer
    from jincresize_tpu_torch.clip import VideoFormat

    cfg = load()
    cfg.update(at_standin(cfg))
    r = JincResizer(VideoFormat(**cfg["format"]), cfg["src_width"], cfg["src_height"],
                    JincConfig(**cfg["jinc_config"]), device="cpu")  # fmt: skip
    got = gather_work.interior(cfg)
    for (name, fs, n, src), op in zip(got, (r.op_luma, r.op_chroma, r.op_chroma), strict=True):
        assert fs == op.filter_size
        assert n == (op.y_hi - op.y_lo) * (op.x_hi - op.x_lo) > 0, name
        assert src == op.src_width * op.src_height
    assert [n for _, _, n, _ in got] == [4725, 210, 210]
    assert gather_work.frame_ops(cfg) == 2 * (92**2 * 4725 + 2 * 93**2 * 210)
    assert gather_work.frame_bytes(cfg) == 4 * (384 * 216 + 4725 + 2 * (192 * 108 + 210))


def test_gather_work_at_the_configurations_size():
    """3840x2160 -> 1366x768 at tap 16: interiors of 736 x 1334 (luma) and
    352 x 651 (each chroma plane) at fs 92, so 2 * 8464 * 1,440,128 =
    2.438e10 operations (24.65 us at 989 TFLOP/s) against 55.5 MB (16.6 us):
    bound by operations."""
    cfg = load()
    assert gather_work.interior(cfg) == [("Y", 92, 736 * 1334, 3840 * 2160),
                                         ("U", 92, 352 * 651, 1920 * 1080),
                                         ("V", 92, 352 * 651, 1920 * 1080)]  # fmt: skip
    assert gather_work.frame_ops(cfg) == 2 * 92**2 * (736 * 1334 + 2 * 352 * 651)
    t, by = gather_work.least_s(cfg)
    assert by == "operations" and t == pytest.approx(24.65e-6, rel=1e-3)
    assert gather_work.frame_bytes(cfg) / work.PEAK_BYTES_S == pytest.approx(16.58e-6, rel=1e-3)


def test_gather_roofline_reads_least_time_over_the_gather_kernels():
    """Two calls of one frame each, with 100 us of gather kernels a frame
    (two overlapping launches in the second call) beside glue, a copy and
    another kernel that do not count: a frame's least time, 24.65 us of
    operations, over 100 us."""
    t = chrome_trace.Trace(
        [
            ev(chrome_trace.SPAN, "user_annotation", 0, 200),
            ev(chrome_trace.SPAN, "user_annotation", 200, 200),
            ev("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 0, 20),
            ev(GATHER, "kernel", 20, 100),
            ev("void at::native::elementwise_kernel<128, 2>(int, F)", "kernel", 120, 50),
            ev(GATHER, "kernel", 220, 60),
            ev(GATHER, "kernel", 260, 60),
            ev(WS3, "kernel", 330, 10),
        ],
        2,
    )
    least, _ = gather_work.least_s(load())
    assert per_layer(t, "gather_roofline", load()) == pytest.approx(100.0 * least / 100e-6)
    assert least == pytest.approx(24.6496e-6, rel=1e-4)


def test_gather_roofline_reads_nothing_without_a_gather_kernel():
    fused_only = chrome_trace.Trace(
        [ev(chrome_trace.SPAN, "user_annotation", 0, 50), ev(WS3, "kernel", 10, 20)], 1
    )
    assert per_layer(fused_only, "gather_roofline", load()) is None
    assert per_layer(None, "gather_roofline", load()) is None


def test_engine_mb_reads_the_engine_bytes_counter(monkeypatch):
    from jincresize_tpu_torch import metrics

    assert per_layer(None, "engine_mb") == metrics.counters()["engine_bytes"] / 1e6
    monkeypatch.setitem(metrics._COUNTERS, "engine_bytes", 3_955_000_000)
    assert per_layer(None, "engine_mb") == 3955.0


def test_engine_mb_reads_nothing_on_a_program_without_the_counter(monkeypatch):
    from jincresize_tpu_torch import metrics

    older = {k: v for k, v in metrics.counters().items() if k != "engine_bytes"}
    monkeypatch.setattr(metrics, "counters", lambda: dict(older))
    assert per_layer(None, "engine_mb") is None
    monkeypatch.delattr(metrics, "counters")  # older than the counters
    assert per_layer(None, "engine_mb") is None


@pytest.mark.parametrize("cell", ["jinc_tap16_2160p_to_768p_yuv420p8.frame1",
                                  "jinc36_1080p_to_2160p_yuv420p8.frame1"])  # fmt: skip
def test_engine_mb_is_reported_in_a_traced_run(tiny_run, cell):
    """The gather cell and an older one: ``engine_mb`` is in every cell's
    list, and reads the tables that the run's build added to the counter."""
    from jincresize_tpu_torch import metrics

    before = metrics.counters()["engine_bytes"]
    r = tiny_run(cell, 2**33 + 5, seconds=0.1, trace=True)
    assert r["correct"]
    got = r["metrics"]["engine_mb"]
    assert got["unit"] == "MB" and got["value"] * 1e6 > before
