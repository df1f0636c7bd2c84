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


# Small stand-ins of the cells' sizes, for runs of the whole harness on the
# CPU, where the program runs its plain forms. Each keeps its cell's ratio,
# and 256x144 -> 192x108 at tap 16 is drifted, as 1440p -> 1080p is.
# ``impl='pallas'`` takes the engines in the order ``'auto'`` takes them on
# a card (on the CPU ``'auto'`` goes from ``fused`` to ``xla``): fused on
# every plane of the first, fused-seg on every plane of the second.
TINY = {
    "jinc256_2160p_to_4320p_yuv420p8": (64, 36, 128, 72),
    "jinc_tap16_1440p_to_1080p_yuv420p10": (256, 144, 192, 108),
}


@pytest.fixture
def tiny_run():
    """``tiny_run(cell, seed, **kw)``: one run of ``cell`` on the CPU at a
    small stand-in of its size, with its own format, filter and limits."""
    import time

    from benchmark import harness

    def run(cell_name, seed, seconds=0.3, **kw):
        spec = harness.load_spec()
        cell = harness.workload(spec, cell_name)
        config = harness.config_of(spec, cell)
        sw, sh, dw, dh = TINY[config["name"]]
        config.update(src_width=sw, src_height=sh)
        config["jinc_config"].update(
            target_width=dw, target_height=dh, impl="pallas", operator_cache=False
        )
        traffic = dict(harness.traffic_of(cell), trace_skip=1, trace_calls=2, check_calls=1)
        return harness.run_cell(spec, cell, seed, seconds, kw.pop("trace", False), "cpu",
                                time.perf_counter(), config=config, traffic=traffic, **kw)  # fmt: skip

    return run
