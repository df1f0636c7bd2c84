"""The port's CLI (``python -m jincresize_tpu_torch``) against the JAX
package's (``jincresize_tpu.cli``) on the same files, on the CPU.

Most cases run both CLIs in-process through ``main(argv)``; two
subprocesses check the module entry and the missing-card error. Outputs
agree within 1 LSB (integers) or 2e-6 (fp32), stdout lines word for word but
for the engine names (the JAX package's CPU conv engine is ``shift``, the
port's ``fused``).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from jincresize_tpu import cli as jcli
from jincresize_tpu_torch import cli


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread for this module's tests: pytest-xdist runs
    several workers on one machine, and each worker's default pool (a
    thread a core) oversubscribes the cores, so the plain forms' thousands
    of small ops wait on contended threads. The old count is back after the
    module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli_in")
    rng = np.random.default_rng(42)
    np.save(d / "gray.npy", rng.integers(0, 256, (40, 48), dtype=np.uint8))
    np.save(d / "frames.npy", rng.random((2, 40, 48), dtype=np.float32))
    np.save(d / "rgb.npy", rng.integers(0, 65536, (3, 24, 32), dtype=np.uint16))
    np.savez(
        d / "clip.npz",
        Y=rng.integers(0, 256, (2, 48, 64), dtype=np.uint8),
        U=rng.integers(0, 256, (2, 24, 32), dtype=np.uint8),
        V=rng.integers(0, 256, (2, 24, 32), dtype=np.uint8),
        _props=np.array(json.dumps({"_ChromaLocation": 0})),
    )
    return d


def _arrays(path):
    if str(path).endswith(".npz"):
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    return {"": np.load(path)}


def _assert_outputs_close(a, b):
    A, B = _arrays(a), _arrays(b)
    assert sorted(A) == sorted(B)
    for k in A:
        if k == "_props":
            assert json.loads(str(A[k])) == json.loads(str(B[k]))
            continue
        assert A[k].dtype == B[k].dtype and A[k].shape == B[k].shape, k
        tol = 2e-6 if A[k].dtype == np.float32 else 1
        assert float(np.abs(A[k].astype(np.float64) - B[k].astype(np.float64)).max()) <= tol, k


# (name, input, output suffix, flags)
CASES = [
    ("npy gray", "gray.npy", ".npy", ["--width", "96", "--height", "80"]),
    ("npy rgb u16", "rgb.npy", ".npy", ["--width", "48", "--height", "36", "--tap", "2"]),
    ("npz clip", "clip.npz", ".npz", ["--width", "128", "--height", "96", "--cplace", "mpeg2"]),
    ("clip flag", "frames.npy", ".npy", ["--width", "72", "--height", "60", "--clip"]),
    ("chain", "clip.npz", ".npz",
     ["--chain", '[{"target_width": 96, "target_height": 72}, {"target_width": 128, "target_height": 96}]']),
]  # fmt: skip


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_cli_matches_the_jax_cli(case, inputs, tmp_path, capsys):
    _, src, suffix, flags = case
    out, jout = tmp_path / f"port{suffix}", tmp_path / f"jax{suffix}"
    assert cli.main([str(inputs / src), str(out), *flags, "--no-cache", "--device", "cpu"]) == 0
    line = capsys.readouterr().out.strip()
    assert jcli.main([str(inputs / src), str(jout), *flags, "--no-cache"]) == 0
    jline = capsys.readouterr().out.strip()
    assert line == jline.replace("shift", "fused")
    _assert_outputs_close(out, jout)


def test_cli_mesh_matches_the_jax_cli_on_one_device(inputs, tmp_path, capsys):
    """--mesh 2 with --device cpu: two row shards of the CPU, against the
    JAX CLI's single-device output."""
    flags = ["--width", "72", "--height", "60", "--no-cache"]
    out, jout = tmp_path / "port.npy", tmp_path / "jax.npy"
    assert cli.main([str(inputs / "gray.npy"), str(out), *flags, "--mesh", "2", "--device", "cpu"]) == 0
    assert "engines: luma=sharded/" in capsys.readouterr().out
    assert jcli.main([str(inputs / "gray.npy"), str(jout), *flags]) == 0
    _assert_outputs_close(out, jout)


def test_cli_validation_exit_code_and_message(inputs, tmp_path, capsys):
    argv = [str(inputs / "gray.npy"), str(tmp_path / "o.npy"), "--width", "72", "--height", "60"]
    assert cli.main([*argv, "--tap", "17", "--device", "cpu"]) == 2
    err = capsys.readouterr().err
    assert jcli.main([*argv, "--tap", "17"]) == 2
    assert err == capsys.readouterr().err == "JincResize: tap must be between 1..16.\n"
    with pytest.raises(SystemExit, match="--width/--height are required"):
        cli.main([*argv[:2], "--device", "cpu"])


def test_cli_defaults_to_the_card(inputs, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [str(inputs / "gray.npy"), str(tmp_path / "o.npy"), "--width", "72", "--height", "60"]
    with pytest.raises(RuntimeError, match="no CUDA device is visible"):
        cli.main(argv)
    with pytest.raises(RuntimeError, match="no CUDA device is visible"):
        cli.main([*argv, "--device", "cuda"])
    assert not (tmp_path / "o.npy").exists()


def _run(*args, env=None):
    return subprocess.run(
        [sys.executable, "-m", "jincresize_tpu_torch", *map(str, args)],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": "", **(env or {})},
    )  # fmt: skip


def test_module_entry_roundtrip(inputs, tmp_path, capsys):
    """``python -m jincresize_tpu_torch`` writes what ``cli.main`` writes, and
    its missing-card error reaches the shell."""
    flags = ["--width", "96", "--height", "72", "--no-cache"]
    r = _run(inputs / "clip.npz", tmp_path / "sub.npz", *flags, "--device", "cpu")
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == (
        "64x48 -> 96x72 x2 (YUV, 8-bit, tap=3, engines: luma=fused,chroma=fused)"
    )
    assert cli.main([str(inputs / "clip.npz"), str(tmp_path / "main.npz"), *flags, "--device", "cpu"]) == 0
    A, B = _arrays(tmp_path / "sub.npz"), _arrays(tmp_path / "main.npz")
    assert all(np.array_equal(A[k], B[k]) for k in A if k != "_props")
    r = _run(inputs / "gray.npy", tmp_path / "y.npy", *flags)
    assert r.returncode != 0 and "no CUDA device is visible" in r.stderr
    assert not (tmp_path / "y.npy").exists()
