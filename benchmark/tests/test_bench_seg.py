"""The seg kernel's yardstick, ``seg_roofline``: the interior work that
``benchmark/gather_work.py`` counts, at both fused-seg configurations'
sizes by hand, and its reader on synthetic traces."""

import json
from pathlib import Path

import pytest

from benchmark import chrome_trace, gather_work, work
from benchmark.harness import Run, reader

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
UPSCALE = "jinc256_1440p_to_2160p_yuv420p10"
TAP16 = "jinc_tap16_1440p_to_1080p_yuv420p10"
SEG = "void (anonymous namespace)::seg_tile_kernel<1>((anonymous namespace)::SegArgs)"
SEG_TC = "void (anonymous namespace)::seg_tc_kernel<1, false, false>((anonymous namespace)::SegTcArgs)"
BAND = "void (anonymous namespace)::strips_band_kernel<1>((anonymous namespace)::BandArgs)"
GATHER = "void (anonymous namespace)::gather_class_kernel<16, 1>((anonymous namespace)::GroupArgs)"


def load(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())


def ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def seg_roofline(t, config):
    return reader("seg_roofline")(Run(config=config, trace=t))


def test_seg_work_of_the_upscale():
    """2560x1440 -> 3840x2160 at tap 8: interiors of 2136 x 3816 (luma)
    and 1056 x 1896 (each chroma plane) at fs 17, so 2 * 289 * 12,155,328
    = 7.03e9 operations (7.10 us at 989 TFLOP/s) against 70.7 MB (21.1 us
    at 3.35 TB/s): bound by bytes."""
    cfg = load(UPSCALE)
    assert gather_work.interior(cfg) == [("Y", 17, 2136 * 3816, 2560 * 1440),
                                         ("U", 17, 1056 * 1896, 1280 * 720),
                                         ("V", 17, 1056 * 1896, 1280 * 720)]  # fmt: skip
    assert 2136 * 3816 == 8_150_976 and 1056 * 1896 == 2_002_176
    assert gather_work.frame_ops(cfg) == 2 * 17**2 * (8_150_976 + 2 * 2_002_176) == 7_025_779_584
    assert gather_work.frame_bytes(cfg) == 4 * (3_686_400 + 2 * 921_600 + 12_155_328)
    t, by = gather_work.least_s(cfg)
    assert by == "bytes" and t == pytest.approx(21.116e-6, rel=1e-4)
    assert gather_work.frame_ops(cfg) / work.PEAK_FLOPS == pytest.approx(7.104e-6, rel=1e-3)


def test_seg_work_of_the_tap16_downscale():
    """2560x1440 -> 1920x1080 at tap 16 (fs 44): 2,921,472 interior pixels,
    1.131e10 operations, 11.44 us at 989 TFLOP/s against 33.8 MB (10.09
    us): bound by operations, where the upscale is bound by bytes."""
    cfg = load(TAP16)
    got = gather_work.interior(cfg)
    assert {fs for _, fs, _, _ in got} == {44}
    assert [n for _, _, n, _ in got] == [1_978_624, 471_424, 471_424]
    assert gather_work.frame_ops(cfg) == 2 * 44**2 * 2_921_472 == 11_311_939_584
    t, by = gather_work.least_s(cfg)
    assert by == "operations" and t == pytest.approx(11.438e-6, rel=1e-4)
    assert gather_work.frame_bytes(cfg) / work.PEAK_BYTES_S == pytest.approx(10.091e-6, rel=1e-3)


@pytest.mark.parametrize("name", [UPSCALE, TAP16])
def test_seg_roofline_reads_least_time_over_the_seg_kernels(name):
    """Two calls of one frame each, with 200 us of seg kernels a frame
    (three plane launches in the second call, two of them overlapping, one
    in the tensor-core kernel) beside a copy, the band-strips kernel, glue
    and a gather kernel, none of which count."""
    t = chrome_trace.Trace(
        [
            ev(chrome_trace.SPAN, "user_annotation", 0, 400),
            ev(chrome_trace.SPAN, "user_annotation", 400, 400),
            ev("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 0, 50),
            ev(SEG, "kernel", 50, 200),
            ev(BAND, "kernel", 250, 40),
            ev("void at::native::elementwise_kernel<128, 2>(int, F)", "kernel", 290, 30),
            ev(SEG, "kernel", 420, 100),
            ev(SEG, "kernel", 480, 60),
            ev(SEG_TC, "kernel", 540, 80),
            ev(GATHER, "kernel", 650, 70),
        ],
        2,
    )
    cfg = load(name)
    least, _ = gather_work.least_s(cfg)
    assert seg_roofline(t, cfg) == pytest.approx(100.0 * least / 200e-6)


def test_seg_roofline_reads_nothing_without_a_seg_kernel():
    cfg = load(UPSCALE)
    gather_only = chrome_trace.Trace(
        [ev(chrome_trace.SPAN, "user_annotation", 0, 100), ev(GATHER, "kernel", 10, 50),
         ev(BAND, "kernel", 60, 20)],
        1,
    )  # fmt: skip
    assert seg_roofline(gather_only, cfg) is None
    assert seg_roofline(None, cfg) is None
