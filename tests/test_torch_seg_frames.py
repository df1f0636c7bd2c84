"""Whole frames through the fused-seg engine upscaling, judged by the
benchmark's float64 reference: seeded 10-bit YUV420 frames through
``JincResizer`` at the CPU stand-in of the seg upscale
(``benchmark/configs/jinc256_1440p_to_2160p_yuv420p10.json``: 2560x1440 ->
3840x2160 at tap 8, cut to 256x144 -> 384x216, a drifted 3/2 plan at fs 17
on every plane, no phase plan). ``impl='pallas'`` takes the engines in the
order ``'auto'`` takes them on a card, so every plane runs
``SegConvApplier``: the seg interior's plain form, the band strips' plain
form (``kernels.band_strips.band_strips_plain``) and ``canvas.Canvas``.
Also the engine counter ``seg_launches``.

The limits are the configuration's own ``checks``: the benchmark holds the
card's runs to them, and the stand-in runs the same engine and plan kind in
its plain forms, which sum the taps in the kernel's order. The control, the
seg kernel's bf16 mode, must read above them here too.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.reference import jinc_ewa
from jincresize_tpu_torch import metrics
from jincresize_tpu_torch.api import JincConfig, JincResizer
from jincresize_tpu_torch.apply_conv_seg import SegConvApplier
from jincresize_tpu_torch.clip import Clip, Frame, VideoFormat
from jincresize_tpu_torch.kernels import seg as seg_k

CONFIG = json.loads(
    (Path(__file__).resolve().parents[1] / "benchmark" / "configs"
     / "jinc256_1440p_to_2160p_yuv420p10.json").read_text()
)  # fmt: skip
# Two frames a call: the reference's float64 weights at fs 17 take about a
# second a frame at the stand-in on one thread.
FRAMES = 2
SEED = 2**31 + 125
FMT = VideoFormat(**CONFIG["format"])


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


def standin(**jinc):
    """The configuration at its stand-in size, with ``jinc`` overrides."""
    s = CONFIG["standin"]
    jc = dict(CONFIG["jinc_config"], target_width=s["target_width"],
              target_height=s["target_height"], **jinc)  # fmt: skip
    return dict(CONFIG, src_width=s["src_width"], src_height=s["src_height"], jinc_config=jc)


def build(config):
    jc = dict(config["jinc_config"], impl="pallas", operator_cache=False)
    return JincResizer(FMT, config["src_width"], config["src_height"], JincConfig(**jc),
                       device="cpu")  # fmt: skip


def source_frames(config, seed):
    """``FRAMES`` frames of uniform noise over the full 10-bit range."""
    rng = np.random.default_rng(seed)
    w, h = config["src_width"], config["src_height"]
    shapes = {"Y": (h, w), "U": (h >> 1, w >> 1), "V": (h >> 1, w >> 1)}
    peak = 1 << CONFIG["format"]["bits"]
    return [{n: rng.integers(0, peak, s, dtype=np.uint16) for n, s in shapes.items()}
            for _ in range(FRAMES)]  # fmt: skip


def judged(config, resizer, seed):
    """The reference's verdict on ``FRAMES`` seeded frames through ``resizer``
    in one call, and the counters' change over that call."""
    srcs = source_frames(config, seed)
    clip = Clip.from_frames([Frame(format=FMT, planes=p, props={}) for p in srcs])
    before = metrics.counters()
    out = resizer(clip)
    moved = {k: v - before[k] for k, v in metrics.counters().items()}
    pairs = [(s, {n: np.asarray(p) for n, p in f.planes.items()})
             for s, f in zip(srcs, out.frames, strict=True)]  # fmt: skip
    return jinc_ewa.compare(config, pairs, "cpu"), moved


def ppm(verdict):
    return 1e6 * verdict["mismatches"] / verdict["samples"]


@pytest.fixture(scope="module")
def program():
    """(configuration at the stand-in, its resizer)."""
    config = standin()
    return config, build(config)


def test_stand_in_takes_fused_seg_on_every_plane(program):
    """Both planes run the seg applier on a drifted plan at fs 17, an
    interior framed by four border strips, the fp32 mode: a 10-bit source
    is not exact in bfloat16, so no weight split."""
    _, r = program
    assert r.engines == {"luma": "fused-seg", "chroma": "fused-seg"} == CONFIG["engines"]
    for ap, op in ((r._applier_luma, r.op_luma), (r._applier_chroma, r.op_chroma)):
        assert isinstance(ap, SegConvApplier)
        assert op.filter_size == 17 and ap.si.fs == 17
        assert ap.si.precision == "fp32" and ap.effective_precision == "fp32"
        assert op.y_hi > op.y_lo and op.x_hi > op.x_lo and len(op.strips) == 4
    assert (r.op_luma.dst_width, r.op_luma.dst_height) == (384, 216)
    assert (r.op_chroma.dst_width, r.op_chroma.dst_height) == (192, 108)


def test_whole_frames_hold_to_the_reference(program):
    config, r = program
    calls = seg_k.seg_interior_plain.calls
    verdict, moved = judged(config, r, SEED)
    assert verdict["samples"] == FRAMES * (384 * 216 + 2 * 192 * 108)
    assert verdict["max_lsb"] <= CONFIG["checks"]["max_lsb"], verdict
    assert ppm(verdict) <= CONFIG["checks"]["mismatch_ppm"], verdict
    # Three plane calls of the seg plain form; the CPU launches no kernel.
    assert seg_k.seg_interior_plain.calls == calls + 3
    assert moved["seg_launches"] == 0 and moved["strips_band_launches"] == 0


def test_the_bf16_control_reads_above_the_limit():
    """The configuration's control rounds the seg interior's weights and
    samples to bfloat16: the reference sees it over the mismatch limit."""
    control = CONFIG["control"]["jinc_config"]
    config = standin()
    r = build(standin(**control))
    assert r.engines == CONFIG["engines"]
    assert r._applier_luma.si.precision == r._applier_chroma.si.precision == "bf16"
    verdict, moved = judged(config, r, SEED)
    assert ppm(verdict) > CONFIG["checks"]["mismatch_ppm"], verdict
    assert moved["seg_launches"] == 0


def test_seg_launches_is_a_counter_the_cpu_leaves_alone(program):
    """``seg_launches`` is one of the fixed counters; the seg wrapper on a
    CPU tensor, in either mode, is the plain form and counts no launch."""
    _, r = program
    assert "seg_launches" in metrics.counters()
    si = r._applier_luma.si
    src = torch.rand((1, si.src_height, si.src_width), generator=torch.Generator().manual_seed(3))
    before, launches = metrics.counters()["seg_launches"], seg_k.seg_interior.launches
    got = seg_k.seg_interior(si, src)
    assert torch.equal(got, seg_k.seg_interior_plain(si, src))
    assert metrics.counters()["seg_launches"] == before
    assert seg_k.seg_interior.launches == launches
