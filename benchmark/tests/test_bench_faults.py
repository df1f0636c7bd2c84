"""The check catches a broken timed path: the whole harness runs on the CPU
at small sizes (no look for a card), with the program's call broken
underneath, and ``correct`` comes out false. The faults a resizing cell can
have: an output left unchanged from the call before, half of a call's frames
left out (dropped, or filled from the other half where a call carries
several), and one sample altered where it is produced. The cells run on one
card, so no exchange between cards can be left out."""

from dataclasses import replace

import pytest

from benchmark import harness
from jincresize_tpu_torch.clip import Clip

CELLS = [w["name"] for w in harness.load_spec()["workloads"]]


def stale(system):
    """Each call returns the previous call's output: the state unchanged."""
    last = []

    def call(clip):
        out = system(clip)
        last.append(out)
        return last[-2] if len(last) > 1 else out

    return call


def dropped(system):
    """Only the first half of a call's frames comes back (none of a
    one-frame call), and nothing fills the gap."""

    def call(clip):
        out = system(clip)
        return replace(out, frames=out.frames[: len(out.frames) // 2])

    return call


def half_batch(system):
    """Only the first half of a call's frames is resized; the other half
    of the output repeats it."""

    def call(clip):
        half = len(clip.frames) // 2
        out = system(replace(clip, frames=clip.frames[:half]))
        frames = out.frames + out.frames
        return Clip(format=out.format, frames=frames, width=out.width, height=out.height)

    return call


def altered(system):
    """One luma sample of every frame flipped by 64 LSB as it is produced."""

    def call(clip):
        out = system(clip)
        frames = []
        for f in out.frames:
            y = f.planes["Y"].copy()
            y[1, 2] ^= 64
            frames.append(replace(f, planes={**f.planes, "Y": y}))
        return replace(out, frames=tuple(frames))

    return call


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(tiny_run, cell):
    r = tiny_run(cell, 2**31 + 11)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0
    spec = harness.load_spec()
    assert list(r)[-1] == "checks"
    assert set(r["metrics"]) == {m["name"] for m in harness.cell_metrics(spec, cell, False)}


def fault_cases():
    """Every fault on every cell, but no half batch of a one-frame call."""
    spec = harness.load_spec()
    for cell in CELLS:
        frames = harness.traffic_of(harness.workload(spec, cell))["frames_per_call"]
        for fault in (stale, dropped, half_batch, altered):
            if fault is not half_batch or frames > 1:
                yield pytest.param(cell, fault, id=f"{fault.__name__}-{cell}")


@pytest.mark.parametrize("cell, fault", list(fault_cases()))
def test_fault_is_not_correct(tiny_run, cell, fault):
    r = tiny_run(cell, 2**31 + 12, fault=fault)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_dropped_frames_fail_and_are_not_counted(tiny_run, cell):
    """A call that returns fewer frames than it was given fails all of
    them: they count in ``failed``, not in ``fps``, and ``correct`` reads
    false even though no returned frame is wrong."""
    r = tiny_run(cell, 2**31 + 14, fault=dropped)
    assert r["failed"] == r["attempted"] > 0
    assert r["checks"]["failed_frames"]["value"] == r["failed"] > r["checks"]["failed_frames"]["limit"]
    assert "fps" not in r["metrics"] and not r["correct"]


def test_traced_run_reports_per_layer_metrics(tiny_run):
    r = tiny_run(CELLS[0], 2**31 + 13, trace=True)
    assert r["correct"] and "breakdown" in r and r["device"]["window_s"] > 0
    assert "resizer_build_s" in r["metrics"] and "fps" not in r["metrics"]
