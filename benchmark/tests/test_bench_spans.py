"""The readers of the program's spans and counters: synthetic traces with
known values, the idle labels the spans give, and traced runs of each cell
on the CPU at small stand-ins."""

import pytest

from benchmark import chrome_trace
from benchmark.harness import Run, load_spec, reader

SPAN_METRICS = ("upload_host_ms_per_frame", "download_host_ms_per_frame",
                "enqueue_ms_per_frame", "glue_launches_per_frame")  # fmt: skip
COUNTER_METRICS = {"operator_load_s": "operator_s", "engine_build_s": "engine_s"}
CELLS = [w["name"] for w in load_spec()["workloads"]]


def ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def span(name, ts, end):
    return ev(name, "user_annotation", ts, end - ts)


def runtime(name, ts, cat="cuda_runtime"):
    return ev(name, cat, ts, 0.5)


def synthetic(frames=2):
    """One traced call, [0, 100] us, its plane's steps as the program nests
    them, launch calls in and around the glue spans, and device work that
    leaves a gap while the host waits in ``jinc.download``."""
    return chrome_trace.Trace(
        [
            span(chrome_trace.SPAN, 0, 100),
            span("jinc.call", 1, 99),
            span("jinc.plane.Y", 2, 98),
            span("jinc.stack", 2.5, 6),
            span("jinc.upload", 5, 15),  # overlaps the stack: 2.5-15 in all
            span("jinc.engine", 15, 60),
            span("jinc.source_f32", 15, 20),
            runtime("cudaLaunchKernel", 16),  # glue
            runtime("cudaMemsetAsync", 18),  # glue
            span("jinc.interior", 20, 30),
            runtime("cudaLaunchKernel", 21),  # the interior kernel: not glue
            span("jinc.strips", 30, 40),
            runtime("cuLaunchKernel", 31, "cuda_driver"),  # glue
            runtime("cudaLaunchKernel", 35),  # glue
            span("jinc.assemble", 40, 50),
            runtime("cudaMemcpyAsync", 41),  # glue
            runtime("cudaStreamSynchronize", 45),  # no launch
            runtime("cudaLaunchKernel", 50.5),  # just after the assembly: not glue
            span("jinc.finalize", 52, 58),
            runtime("cudaLaunchKernel", 53),  # glue
            span("jinc.download", 60, 92),
            runtime("cudaMemcpyAsync", 61),  # the download: not glue
            span("jinc.frame_out", 96, 98),
            ev("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 6, 10),
            ev("void seg_tile_kernel<1>(SegArgs)", "kernel", 22, 40),
            ev("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 75, 15),
        ],
        frames,
    )


def per_layer(t, name):
    return reader(name)(Run(config={}, trace=t))


def test_span_readers_on_a_synthetic_trace():
    t = synthetic(frames=2)
    assert per_layer(t, "upload_host_ms_per_frame") == pytest.approx(12.5e-3 / 2)
    assert per_layer(t, "download_host_ms_per_frame") == pytest.approx(32e-3 / 2)
    assert per_layer(t, "enqueue_ms_per_frame") == pytest.approx(45e-3 / 2)
    assert per_layer(t, "glue_launches_per_frame") == pytest.approx(6 / 2)


def test_launches_count_once_under_nested_glue_spans():
    """A launch under two overlapping glue spans counts once; one at a
    glue span's end counts, one just past it does not."""
    t = chrome_trace.Trace(
        [
            span(chrome_trace.SPAN, 0, 50),
            span("jinc.strips", 10, 30),
            span("jinc.assemble", 20, 40),
            runtime("cudaLaunchKernel", 25),
            runtime("cudaLaunchKernel", 40),
            runtime("cudaLaunchKernel", 40.5),
            runtime("cudaLaunchKernel", 5),
        ],
        1,
    )
    assert per_layer(t, "glue_launches_per_frame") == 2


def test_idle_gaps_are_put_down_to_the_spans():
    """The device idles 62-75 us while the host waits in ``jinc.download``:
    the gap carries that label, and none is left to host code outside
    torch ops."""
    gaps = dict(synthetic().idle_gaps())
    assert gaps["jinc.download"] == pytest.approx(13e-6)
    assert gaps["jinc.stack"] == pytest.approx(6e-6)  # 0-6, the batch on the host
    assert gaps["jinc.source_f32"] == pytest.approx(6e-6)  # 16-22
    assert "host code in a call outside torch ops" not in gaps


def test_span_readers_read_nothing_without_spans():
    """A program without the spans (one older than them), or no trace."""
    t = chrome_trace.Trace(
        [span(chrome_trace.SPAN, 0, 10), runtime("cudaLaunchKernel", 2),
         ev("void strips_kernel(StripsArgs)", "kernel", 3, 4)],
        1,
    )  # fmt: skip
    for name in SPAN_METRICS:
        assert per_layer(t, name) is None
        assert per_layer(None, name) is None


@pytest.mark.parametrize("name", sorted(COUNTER_METRICS))
def test_counter_readers(name, monkeypatch):
    from jincresize_tpu_torch import metrics

    want = metrics.counters()[COUNTER_METRICS[name]]
    assert per_layer(None, name) == want
    monkeypatch.delattr(metrics, "counters")  # a program without the counters
    assert per_layer(None, name) is None


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reports_the_span_and_counter_metrics(tiny_run, cell):
    r = tiny_run(cell, 2**31 + 15, seconds=2.5, trace=True)  # past the skipped call
    assert r["correct"]
    got = r["metrics"]
    assert set(SPAN_METRICS) | set(COUNTER_METRICS) <= set(got)
    for name in ("upload_host_ms_per_frame", "download_host_ms_per_frame",
                 "enqueue_ms_per_frame", *COUNTER_METRICS):  # fmt: skip
        assert got[name]["value"] > 0, name
    assert got["glue_launches_per_frame"]["value"] == 0  # the CPU launches nothing
    assert got["glue_launches_per_frame"]["unit"] == "launches"
