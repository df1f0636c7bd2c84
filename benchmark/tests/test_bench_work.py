"""The work count of ``resample_roofline``: the reference's nonzero weights
against a hand count, and fs**2 a pixel as the upper limit at the
configurations' sizes."""

import json
from pathlib import Path

import pytest

from benchmark import work
from benchmark.reference import jinc_ewa

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def load(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())


def tiny(w, h, dw, dh, tap, bits=8):
    return {"format": {"family": "YUV", "sub_w": 1, "sub_h": 1, "bits": bits},
            "src_width": w, "src_height": h,
            "jinc_config": {"target_width": dw, "target_height": dh, "tap": tap}}  # fmt: skip


def test_hand_count_identity_tap1():
    """8x8 -> 8x8 at tap 1 (radius 1.2197, fs 3): pixels sit on source
    samples, so a tap is nonzero iff its squared distance d2 is under
    radius**2 = 1.488 (d2 = 0 or 1; d2 = 2 reads past the LUT). An interior
    pixel keeps 5 taps; a border one, whose window is clamped to one side,
    4 on an edge and 3 in a corner. Luma 8x8: 4*3 + 24*4 + 36*5 = 288;
    each 4x4 chroma plane (MPEG2 siting is no shift at scale 1):
    4*3 + 8*4 + 4*5 = 64."""
    got = jinc_ewa.compare(tiny(8, 8, 8, 8, 1), [], "cpu")
    assert got["nnz_per_frame"] == 288 + 2 * 64
    assert jinc_ewa.upper_nnz_per_frame(tiny(8, 8, 8, 8, 1)) == 9 * (64 + 2 * 16)


@pytest.mark.parametrize("dims", [(16, 12, 32, 24, 3), (32, 18, 24, 14, 8), (40, 24, 31, 19, 4)])
def test_count_within_the_upper_limit(dims):
    cfg = tiny(*dims)
    nnz = jinc_ewa.compare(cfg, [], "cpu")["nnz_per_frame"]
    assert 0 < nnz <= jinc_ewa.upper_nnz_per_frame(cfg)


def test_upper_limits_at_the_configurations_sizes():
    """The arithmetic by hand: 2*289*49.77 Mpx = 2.88e10 operations (29.1
    us) against 62.2 MB (18.6 us) for a 2160p->4320p frame; 2*1936*3.11 Mpx
    = 1.20e10 (12.2 us) against 17.3 MB (5.2 us) for 1440p->1080p tap 16."""
    up = load("jinc256_2160p_to_4320p_yuv420p8")
    ops = 2 * jinc_ewa.upper_nnz_per_frame(up)
    assert ops == 2 * 289 * (7680 * 4320 + 2 * 3840 * 2160)
    assert work.frame_bytes(up) == 3840 * 2160 * 3 // 2 + 7680 * 4320 * 3 // 2
    t, by = work.bound_s(ops, work.frame_bytes(up))
    assert by == "operations" and t == pytest.approx(29.09e-6, rel=1e-3)
    assert work.frame_bytes(up) / work.PEAK_BYTES_S == pytest.approx(18.57e-6, rel=1e-3)

    down = load("jinc_tap16_1440p_to_1080p_yuv420p10")
    ops = 2 * jinc_ewa.upper_nnz_per_frame(down)
    assert ops == 2 * 1936 * (1920 * 1080 + 2 * 960 * 540)
    assert work.frame_bytes(down) == 2 * (2560 * 1440 * 3 // 2 + 1920 * 1080 * 3 // 2)
    t, by = work.bound_s(ops, work.frame_bytes(down))
    assert by == "operations" and t == pytest.approx(12.17e-6, rel=1e-3)
    assert work.frame_bytes(down) / work.PEAK_BYTES_S == pytest.approx(5.16e-6, rel=1e-3)


def test_count_at_the_default_filter_upscale():
    """1920x1080 -> 3840x2160 at tap 3 (fs 7): the reference counts
    390,945,716 nonzero weights a frame, 0.6413 of the fs**2 = 49 a pixel
    that bound it. 2 x that is 7.82e8 operations (0.79 us) against 15.55 MB (4.64 us): the
    least time of this frame is set by its bytes, not its operations."""
    cfg = load("jinc36_1080p_to_2160p_yuv420p8")
    up = jinc_ewa.upper_nnz_per_frame(cfg)
    assert up == 49 * (3840 * 2160 + 2 * 1920 * 1080)
    nnz = jinc_ewa.compare(cfg, [], "cpu")["nnz_per_frame"]
    assert 0 < nnz <= up and nnz / up == pytest.approx(0.6413, abs=1e-4)
    assert work.frame_bytes(cfg) == 1920 * 1080 * 3 // 2 + 3840 * 2160 * 3 // 2
    t, by = work.bound_s(2 * nnz, work.frame_bytes(cfg))
    assert by == "bytes" and t == pytest.approx(4.642e-6, rel=1e-3)
    assert 2 * nnz / work.PEAK_FLOPS == pytest.approx(0.7906e-6, rel=1e-3)
