"""Shared set-up of the benchmark's own tests (run them with
``python -m pytest benchmark/tests -q`` from the root of the checkout).

Tests that need a CUDA card carry the ``card`` marker and skip inside the
``card`` fixture when none is visible; everything else runs on the CPU at
tiny sizes. torch runs on one thread here, as the repository's port tests do.
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card visible")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    import torch

    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def at_standin(config: dict) -> dict:
    """The keys of ``config`` that put it at its stand-in size under
    ``impl='pallas'``, with no operator cache: ``config.update(...)`` them."""
    s = config["standin"]
    jc = dict(config["jinc_config"], target_width=s["target_width"],
              target_height=s["target_height"], impl="pallas", operator_cache=False)  # fmt: skip
    return {"src_width": s["src_width"], "src_height": s["src_height"], "jinc_config": jc}


@pytest.fixture(name="at_standin")
def at_standin_fixture():
    """``at_standin(config)``, for tests that build the system alone."""
    return at_standin


@pytest.fixture
def tiny_run():
    """``tiny_run(cell, seed, **kw)``: one run of ``cell`` on the CPU at the
    stand-in size its configuration file gives (``standin``), with its own
    format, filter and limits. ``impl='pallas'`` takes the engines in the
    order ``'auto'`` takes them on a card (on the CPU ``'auto'`` goes from
    ``fused`` to ``xla``), and ``test_bench_standins.py`` holds each
    stand-in to the engines its file states."""
    import time

    from benchmark import harness

    def run(cell_name, seed, seconds=0.3, **kw):
        spec = harness.load_spec()
        cell = harness.workload(spec, cell_name)
        config = harness.config_of(spec, cell)
        config.update(at_standin(config))
        traffic = dict(harness.traffic_of(cell), trace_skip=1, trace_calls=2, check_calls=1)
        return harness.run_cell(spec, cell, seed, seconds, kw.pop("trace", False), "cpu",
                                time.perf_counter(), config=config, traffic=traffic, **kw)  # fmt: skip

    return run
