"""Run one cell of ``BENCHMARK.json``: set-up, the measured window, the check.

Set-up (``setup_s``, from the start of ``run.py``): torch, the card, the
program's import, the input ring from ``--seed``, the system under test that
the configuration's ``entry`` builds (for ``JincResizer(...)``, its host
operator build or the operator cache in ``build/`` of the checkout) and the
warm-up calls, whose first launch builds or loads the kernel library
(``build/kernels/`` of the checkout). Each part is printed on a line before
the window.

Window: a closed loop. One caller calls the system on host clips and takes
back host clips; the next call starts when the previous one returns, until
``--seconds`` have passed. A call that raises, or returns another number of
frames than it was given, fails all of its frames. With ``--trace 1`` a
``torch.profiler`` records a stretch of calls the traffic file names.

Check: after the window, with the program's state freed, the reference the
configuration names (``reference``) judges a sample of the calls, drawn from
the seed, frame by frame and plane by plane. Each compared number is printed
beside its limit on the last lines of stderr and under ``checks``, the last
key of the result line.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import traceback
from contextlib import nullcontext
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from . import chrome_trace, clips

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "jincresize_tpu")


# ------------------------------------------------------------------ the spec
def load_spec() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def workload(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has "
                     + ", ".join(w["name"] for w in spec["workloads"]))  # fmt: skip


def config_of(spec: dict, cell: dict) -> dict:
    entry = next(c for c in spec["configs"] if c["name"] == cell["config"])
    with open(ROOT / entry["file"]) as f:
        return json.load(f)


def traffic_of(cell: dict) -> dict:
    with open(HERE / "traffic" / f"{cell['traffic']}.json") as f:
        return json.load(f)


def cell_metrics(spec: dict, cell: str, trace: bool) -> list[dict]:
    """The cell's end-to-end metrics (``trace`` False) or per-layer ones."""
    group = spec["per_layer"] if trace else spec["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def module(rel: str):
    """The module at ``rel``, a path under ``benchmark/`` that a
    configuration names (its ``entry`` or its ``reference``)."""
    return importlib.import_module(f"{__package__}." + rel.removesuffix(".py").replace("/", "."))


def reader(name: str):
    """``metrics/<name>.py``: its ``read(run)`` gives the metric or None."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# ------------------------------------------------------------------- the run
@dataclass
class Run:
    """What one run measured; the metric readers read it."""

    config: dict
    setup: dict = field(default_factory=dict)  # seconds by part
    setup_s: float = 0.0
    calls: list = field(default_factory=list)  # (start, end) host seconds
    frames: int = 0  # frames returned in the window
    window_start: float = 0.0
    window_end: float = 0.0
    trace: chrome_trace.Trace | None = None
    nnz_per_frame: int = 0  # nonzero weights a frame applies (reference)


class Sample:
    """Reservoir of ``k`` calls, uniform over the window, drawn from the
    seed: (ring index, output clip)."""

    def __init__(self, k: int, seed: int):
        self.k, self.kept = k, []
        self.rng = np.random.default_rng([seed, 1])

    def offer(self, i: int, ring_index: int, out) -> None:
        if i < self.k:
            self.kept.append((ring_index, out))
        else:
            j = int(self.rng.integers(0, i + 1))
            if j < self.k:
                self.kept[j] = (ring_index, out)


def parse_args(argv):
    p = argparse.ArgumentParser(prog="benchmark/run.py", description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument(
        "--control", action="store_true",
        help="run the configuration's control (its 'control' overrides, a lower "
        "precision) in the program's place; the check must read it as not correct",
    )  # fmt: skip
    return p.parse_args(argv)


def forbidden_modules() -> list[str]:
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def card_power_limit() -> str:
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )  # fmt: skip
        return r.stdout.strip().splitlines()[0] if r.returncode == 0 else "not read"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "not read"


def main(argv, t_start: float | None = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    imports_s = time.perf_counter() - t_start  # run.py's start to here: torch, numpy
    args = parse_args(argv)
    spec = load_spec()
    cell = workload(spec, args.workload)
    t = time.perf_counter()
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(
            f"benchmark: cell {cell['name']} needs {cell['chips']} CUDA card(s); "
            f"torch.cuda.is_available()={torch.cuda.is_available()}, "
            f"device_count()={torch.cuda.device_count()}; no result",
            file=sys.stderr,
        )
        return 2
    setup = {"imports_s": imports_s, "card_check_s": time.perf_counter() - t}
    try:
        result = run_cell(
            spec, cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0),
            t_start=t_start, control=args.control, setup=setup,
        )  # fmt: skip
    except Exception:
        traceback.print_exc()
        print("benchmark: the run failed; no result", file=sys.stderr)
        return 1
    found = forbidden_modules()
    if found:
        print(f"benchmark: sys.modules holds {found} after the window; no result", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(result))
    return 0


def run_cell(
    spec: dict,
    cell: dict,
    seed: int,
    seconds: float,
    trace: bool,
    device,
    t_start: float,
    control: bool = False,
    setup: dict | None = None,
    config: dict | None = None,
    traffic: dict | None = None,
    fault=None,
) -> dict:
    """One run of ``cell``; returns the result line as a dict.

    ``config`` and ``traffic`` replace the cell's files, and ``fault``
    wraps the program's call (``fault(call) -> call``): the tests run the
    harness with them on the CPU at tiny sizes.
    """
    cuda = torch.device(device).type == "cuda"
    config = config_of(spec, cell) if config is None else config
    traffic = traffic_of(cell) if traffic is None else traffic
    run = Run(config=config, setup=dict(setup or {}))

    def part(name, t0):
        run.setup[name] = time.perf_counter() - t0

    t = time.perf_counter()
    if cuda:
        torch.cuda.init()
        torch.empty(1, device=device)
        torch.cuda.synchronize(device)
    part("card_init_s", t)

    t = time.perf_counter()
    entry = module(config["entry"])  # imports the program
    part("import_program_s", t)

    t = time.perf_counter()
    planes = clips.ring(config, traffic, seed)
    part("inputs_s", t)

    jc = dict(config["jinc_config"])
    if control:
        jc.update(config["control"]["jinc_config"])
    t = time.perf_counter()
    system = entry.build(config, jc, device)
    part("resizer_build_s", t)
    t = time.perf_counter()
    ring = [system.clip(c) for c in planes]
    run.setup["inputs_s"] += time.perf_counter() - t
    engines = system.engines
    call = system if fault is None else fault(system)

    t = time.perf_counter()
    for k in range(traffic["warmup_calls"]):  # from the ring's end: the window starts at 0
        call(ring[-1 - k % len(ring)])
    part("warmup_s", t)

    prof = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        t = time.perf_counter()
        with torch.profiler.profile(activities=acts):  # CUPTI starts here, not in the window
            call(ring[-1])
        part("profiler_warmup_s", t)
        prof = torch.profiler.profile(activities=acts)

    run.setup_s = time.perf_counter() - t_start
    print("setup: " + json.dumps({"setup_s": run.setup_s, **run.setup, "engines": engines,
                                  "control": control}), flush=True)  # fmt: skip

    # ---------------------------------------------------------------- window
    sample = Sample(traffic["check_calls"], seed)
    skip, n_traced = traffic["trace_skip"], traffic["trace_calls"]
    traced_frames, tracing, attempted, failed = 0, False, 0, 0
    run.window_start = time.perf_counter()
    i = 0
    while True:
        r = i % len(ring)
        if prof is not None and i == skip:
            prof.start()
            tracing = True
        with torch.profiler.record_function(chrome_trace.SPAN) if tracing else nullcontext():
            t0 = time.perf_counter()
            try:
                out = call(ring[r])
            except Exception:
                out = None
                if failed == 0:
                    traceback.print_exc()
            t1 = time.perf_counter()
        n = len(planes[r])
        attempted += n
        if out is None or entry.count(out) != n:
            failed += n
        else:
            run.frames += n
            sample.offer(i, r, out)
        run.calls.append((t0, t1))
        if tracing:
            traced_frames += n
            if i == skip + n_traced - 1:
                prof.stop()
                tracing = False
        i += 1
        if t1 - run.window_start >= seconds:
            break
    if tracing:
        prof.stop()
    run.window_end = run.calls[-1][1]
    times = sorted(b - a for a, b in run.calls)
    quarters = [sorted(b - a for a, b in run.calls[k * len(run.calls) // 4 : (k + 1) * len(run.calls) // 4])
                for k in range(4)]  # fmt: skip
    print(f"window: {len(run.calls)} calls in {run.window_end - run.window_start:.3f} s; call ms "
          f"p95 {1e3 * times[math.ceil(0.95 * len(times)) - 1]:.3f}, median by quarter "
          + " ".join(f"{1e3 * q[len(q) // 2]:.2f}" for q in quarters if q), file=sys.stderr)  # fmt: skip

    # ------------------------------------------------------------ after it
    device_info = {"platform": "gpu" if cuda else torch.device(device).type,
                   "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                   "count": cell["chips"],
                   "memory_peak_bytes": torch.cuda.max_memory_allocated(device) if cuda else 0}  # fmt: skip
    del call, system, out, ring
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    if prof is not None and traced_frames:
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "trace.json")
            prof.export_chrome_trace(path)
            del prof
            print(f"trace: {os.path.getsize(path)} bytes", file=sys.stderr)
            run.trace = chrome_trace.load(path, traced_frames)
        device_info["busy_s"] = run.trace.busy_s()
        device_info["window_s"] = run.trace.window_s

    # ----------------------------------------------------------------- check
    t = time.perf_counter()
    reference = module(config["reference"])
    pairs, bad = [], 0
    want = reference.out_shapes(config)
    for r, out in sample.kept:
        for src, got in zip(planes[r], entry.frames(out)):  # as many as sent: see the window
            if any(n not in got or got[n].shape != s for n, s in want.items()):
                bad += 1
            else:
                pairs.append((src, got))
    verdict = reference.compare(config, pairs, device)
    run.nnz_per_frame = verdict["nnz_per_frame"]
    ref_s = time.perf_counter() - t
    limits = config["checks"]
    ppm = 1e6 * verdict["mismatches"] / verdict["samples"] if verdict["samples"] else math.inf
    checks = {
        "failed_frames": {"value": failed, "limit": 0},
        "max_lsb": {"value": verdict["max_lsb"], "limit": limits["max_lsb"]},
        "mismatch_ppm": {"value": ppm, "limit": limits["mismatch_ppm"]},
        "bad_frames": {"value": bad, "limit": 0},
    }
    correct = bool(pairs) and all(c["value"] <= c["limit"] for c in checks.values())
    print(f"check: {len(pairs)} frames of {len(sample.kept)} calls against the reference "
          f"in {ref_s:.3f} s; {verdict}", file=sys.stderr)  # fmt: skip

    # --------------------------------------------------------------- metrics
    metrics = {}
    for m in cell_metrics(spec, cell["name"], trace):
        v = reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    if cuda:
        print(f"card: {card_power_limit()}", file=sys.stderr)
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device_info}  # fmt: skip
    if run.trace is not None:
        result["breakdown"] = {"device_ops": run.trace.device_ops(),
                               "idle_gaps": run.trace.idle_gaps()}  # fmt: skip
    if control:
        result["control"] = True
    result["checks"] = checks
    return result

