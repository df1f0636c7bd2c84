"""The control, the program's own lower-precision path
(``precision='bf16'``, the configuration's ``control``), comes out as not
correct, at a small stand-in of each configuration's size on the CPU. At the
cells' own sizes on the card, ``run.py --control`` reads the same (the
``card`` test below, and the readings in PERF.md)."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import harness

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in harness.load_spec()["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [2**31 + 21, 2**31 + 22, 2**31 + 23])
def test_control_is_not_correct(tiny_run, cell, seed):
    sound = tiny_run(cell, seed)
    control = tiny_run(cell, seed, control=True)
    assert sound["correct"] and not control["correct"], (sound["checks"], control["checks"])


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_on_the_card(card, cell):
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed", str(2**31 + 31),
         "--seconds", "3", "--control"],
        cwd=ROOT, capture_output=True, text=True, timeout=900,
    )  # fmt: skip
    assert p.returncode == 0, p.stderr[-2000:]
    assert json.loads(p.stdout.strip().splitlines()[-1])["correct"] is False
