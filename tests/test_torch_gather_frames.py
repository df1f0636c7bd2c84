"""Whole frames through the gather engine, judged by the benchmark's float64
reference: seeded 8-bit YUV420 frames through ``JincResizer`` at the CPU
stand-in of the deep aperiodic downscale (``benchmark/configs/
jinc_tap16_2160p_to_768p_yuv420p8.json``: 3840x2160 -> 1366x768 at tap 16,
cut to 384x216 -> 137x77, fs 92 on luma and 93 on chroma, no phase plan and
no seg plan). ``impl='pallas'`` takes the engines in the order ``'auto'``
takes them on a card, so every plane runs ``GatherApplier``: the gather
interior's plain form, the per-pixel strips' plain form
(``kernels.band_strips.band_strips_plain``), and ``canvas.Canvas``. Also the
engine counters ``gather_launches`` and ``engine_bytes``.

The mismatch limit is the configuration's own ``checks`` (5000 per million
samples, ``max_lsb`` 1): the benchmark holds the card's runs to it, and
the stand-in runs the same engine and plan kind in its plain forms, which
sum the taps in the kernel's order.
"""

import json
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.reference import jinc_ewa
from jincresize_tpu_torch import metrics
from jincresize_tpu_torch.api import JincConfig, JincResizer
from jincresize_tpu_torch.apply_gather import GatherApplier
from jincresize_tpu_torch.clip import Clip, Frame, VideoFormat
from jincresize_tpu_torch.kernels import gather as gather_k

CONFIG = json.loads(
    (Path(__file__).resolve().parents[1] / "benchmark" / "configs"
     / "jinc_tap16_2160p_to_768p_yuv420p8.json").read_text()
)  # fmt: skip
# One frame a call, as the benchmark's frame1 traffic sends them; the
# reference's float64 weights at fs 92 take ~11 s a verdict on one thread.
FRAMES = 1
SEED = 2**31 + 121


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


FMT = VideoFormat(**CONFIG["format"])


def build(config):
    jc = dict(config["jinc_config"], impl="pallas", operator_cache=False)
    return JincResizer(FMT, config["src_width"], config["src_height"], JincConfig(**jc),
                       device="cpu")  # fmt: skip


def source_frames(config, seed):
    rng = np.random.default_rng(seed)
    w, h = config["src_width"], config["src_height"]
    shapes = {"Y": (h, w), "U": (h >> 1, w >> 1), "V": (h >> 1, w >> 1)}
    return [{n: rng.integers(0, 256, s, dtype=np.uint8) for n, s in shapes.items()}
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
    """(configuration at the stand-in, its resizer, the counters' change
    over the resizer's construction)."""
    config = standin()
    before = metrics.counters()
    r = build(config)
    return config, r, {k: v - before[k] for k, v in metrics.counters().items()}


def test_stand_in_takes_gather_on_every_plane(program):
    _, r, _ = program
    assert r.engines == {"luma": "gather", "chroma": "gather"} == CONFIG["engines"]
    assert isinstance(r._applier_luma, GatherApplier)
    assert isinstance(r._applier_chroma, GatherApplier)
    assert r.op_luma.filter_size == 92 and r.op_chroma.filter_size == 93
    for op in (r.op_luma, r.op_chroma):  # an interior, and border strips around it
        assert op.y_hi > op.y_lo and op.x_hi > op.x_lo and len(op.strips) == 4


def test_whole_frames_hold_to_the_reference(program):
    config, r, _ = program
    verdict, moved = judged(config, r, SEED)
    assert verdict["samples"] == FRAMES * (137 * 77 + 2 * 68 * 38)
    assert verdict["max_lsb"] <= CONFIG["checks"]["max_lsb"], verdict
    assert ppm(verdict) <= CONFIG["checks"]["mismatch_ppm"], verdict
    assert moved["gather_launches"] == 0  # the plain form on the CPU launches nothing


def test_the_quant_control_reads_above_the_limit():
    """The configuration's control coarsens the sub-pixel classes that the
    gather dictionary holds: the reference, at the plugin's default
    quantization, sees it in the interior."""
    control = CONFIG["control"]["jinc_config"]
    config = standin()
    r = build(standin(**control))
    assert r.engines == CONFIG["engines"]
    verdict, _ = judged(config, r, SEED)
    assert ppm(verdict) > CONFIG["checks"]["mismatch_ppm"], verdict
    assert verdict["max_lsb"] > CONFIG["checks"]["max_lsb"], verdict


def test_engine_bytes_count_the_appliers_tensors(program):
    """``engine_bytes`` grows at construction by the ``nbytes`` of every
    tensor the two gather appliers hold: the dictionary twice (the device
    operator's and the kernel's padded copy), the strip blocks, the index
    tables and the strips' window groups (606 MB at the stand-in, where the
    4,725 luma blocks of fs 92 lead; at full size the strip blocks do). The
    strips' spec holds the device operator's blocks, no copy of them."""
    _, r, built = program

    def tensors(app):
        gi, dop, spec = app.gi, app._dop, app.band_spec
        yield from (gi.blocks, gi.start_y, gi.cy_idx, gi.start_x, gi.cx_idx)
        yield from (dop.start_x, dop.start_y, dop.cx_idx, dop.cy_idx, dop.pair_blocks)
        yield from (s.blocks for s in dop.strips)
        yield from (spec.groups, spec.members)

    want = sum(t.nbytes for app in (r._applier_luma, r._applier_chroma) for t in tensors(app))
    assert built["engine_bytes"] == want == r.engine_bytes()
    assert built["gather_launches"] == 0 and built["strips_band_launches"] == 0


@dataclass
class _Holder:
    tables: dict


def test_held_bytes_counts_each_storage_once():
    a = torch.zeros(10, dtype=torch.float32)
    b = torch.zeros(3, 4, dtype=torch.int64)
    holder = _Holder({"a": a, "view": a[2:5], "more": [b, (b.T, None, 7)], "np": np.zeros(99)})
    assert metrics.held_bytes(holder) == 0  # not the port's own object: not walked
    assert metrics.held_bytes(holder.tables) == 40 + 96
    loop = [a]
    loop.append(loop)
    assert metrics.held_bytes(loop, a, None) == 40
    gi = gather_k.GatherInterior(a, b, b, b[0], b[1], 1, 1, 1, 1)
    assert metrics.held_bytes(gi) == 40 + 96
