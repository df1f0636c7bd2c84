"""The port imports no jax and nothing of the JAX package: every module, plus
a tiny resize and a sharded resize, in a fresh process."""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

SCRIPT = """
import sys
import numpy as np
import jincresize_tpu_torch
from jincresize_tpu_torch import (api, apply_conv, apply_conv_seg, apply_gather,
                                  apply_strips_fast, apply_xla, bench, cache, cli, compose,
                                  entry, filters, geometry, golden, metrics, native, operator,
                                  phase, sharding)
from jincresize_tpu_torch.kernels import _build, fused, gather, probe, seg, strips
from jincresize_tpu_torch.tools import (_timing, assemble_breakdown, bench_gather,
                                        device_loop_timing, fused_tile_sweep,
                                        streaming_pipeline)
from jincresize_tpu_torch.clip import Clip, random_frame, yuv420p

clip = Clip.from_frames([random_frame(yuv420p(8), 32, 24, seed=1)])
r = api.JincResizer(clip.format, 32, 24, api.JincConfig(target_width=64, target_height=48,
                    operator_cache=False), device="cpu")
out = r(clip)
assert r.engines == {"luma": "fused", "chroma": "fused"}, r.engines
assert out.frames[0].planes["Y"].shape == (48, 64)
assert out.frames[0].planes["U"].dtype == np.uint8
mesh = sharding.make_mesh(n_rows=2, devices=["cpu"] * 2)
r = api.JincResizer(clip.format, 32, 24, api.JincConfig(target_width=64, target_height=48,
                    operator_cache=False, impl="sharded"), device="cpu", mesh=mesh)
assert r(clip).frames[0].planes["Y"].shape == (48, 64)
assert all(e.startswith("sharded/") for e in r.engines.values()), r.engines
jax_mods = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib")))
assert not jax_mods, jax_mods
ref_mods = sorted(m for m in sys.modules if m == "jincresize_tpu" or m.startswith("jincresize_tpu."))
assert not ref_mods, ref_mods
print("ok")
"""


def test_port_imports_no_jax():
    r = subprocess.run(
        [sys.executable, "-c", SCRIPT],
        cwd=ROOT,
        capture_output=True,
        text=True,
        timeout=300,
    )
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


def test_port_sources_name_no_jax_package_import():
    """No module of the port, and not chip_smoke.py, imports the JAX package."""
    import re

    pat = re.compile(r"^\s*(from|import) jincresize_tpu([. ]|$)", re.M)
    files = sorted((ROOT / "jincresize_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    offenders = [str(f.relative_to(ROOT)) for f in files if pat.search(f.read_text())]
    assert not offenders, offenders
