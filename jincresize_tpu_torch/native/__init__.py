"""Native builder loader: compile-on-demand C++ core with ctypes binding.

The reference ships its builder as compiled C++ (SURVEY C11/C24); here the
hot block-computation kernel is C++ too, built lazily with the system g++
into a cached shared library. Falls back silently to the NumPy path when no
toolchain is available (set JINCRESIZE_NATIVE=0 to force the fallback).

A copy of ``jincresize_tpu/native/__init__.py``. The library is built into
``build/native/<hash of the source>/`` at the root of the checkout (a
directory ``.gitignore`` lists), compiled to a temporary name and renamed into
place, so concurrent first uses never load a half-written file.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sysconfig
from pathlib import Path

import numpy as np

_LIB = None
_TRIED = False


def _source_path() -> Path:
    return Path(__file__).parent / "jinc_builder.cpp"


BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "native"


def _cache_path() -> Path:
    src = _source_path().read_bytes()
    tag = hashlib.sha256(src).hexdigest()[:16]
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    return BUILD_ROOT / tag / f"jinc_builder{suffix}"


def _build_library(out: Path) -> bool:
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [
        os.environ.get("CXX", "g++"),
        "-O2",
        "-std=c++17",
        "-fPIC",
        "-shared",
        "-ffp-contract=off",  # bit-parity with the NumPy reference path
        str(_source_path()),
        "-o",
        str(tmp),
    ]
    try:
        out.parent.mkdir(parents=True, exist_ok=True)
        r = subprocess.run(cmd, capture_output=True, timeout=120)
        if r.returncode != 0 or not tmp.exists():
            return False
        os.replace(tmp, out)
        return True
    except (OSError, subprocess.TimeoutExpired):
        return False
    finally:
        tmp.unlink(missing_ok=True)


def get_library():
    """Load (building if needed) the native library; None if unavailable."""
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("JINCRESIZE_NATIVE", "1") == "0":
        return None
    path = _cache_path()
    if not path.exists() and not _build_library(path):
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:
        return None
    lib.build_blocks.argtypes = [
        ctypes.POINTER(ctypes.c_float),  # dist_y
        ctypes.POINTER(ctypes.c_float),  # dist_x
        ctypes.c_int64,  # ny
        ctypes.c_int64,  # nx
        ctypes.c_int64,  # fs
        ctypes.c_double,  # step_y
        ctypes.c_double,  # step_x
        ctypes.POINTER(ctypes.c_double),  # lut
        ctypes.c_int64,  # lut_size
        ctypes.c_double,  # radius2
        ctypes.c_double,  # samples-1
        ctypes.POINTER(ctypes.c_float),  # out
    ]
    lib.build_blocks.restype = None
    _LIB = lib
    return _LIB


def compute_blocks_native(
    dist_y: np.ndarray,
    dist_x: np.ndarray,
    step_y: float,
    step_x: float,
    lut: np.ndarray,
    radius: float,
    samples: int,
) -> np.ndarray | None:
    """Native counterpart of operator.compute_blocks; None if lib missing."""
    lib = get_library()
    if lib is None:
        return None
    dist_y = np.ascontiguousarray(dist_y, dtype=np.float32)
    dist_x = np.ascontiguousarray(dist_x, dtype=np.float32)
    lut = np.ascontiguousarray(lut, dtype=np.float64)
    ny, fs = dist_y.shape
    nx = dist_x.shape[0]
    out = np.empty((ny, nx, fs, fs), dtype=np.float32)
    fp = ctypes.POINTER(ctypes.c_float)
    dp = ctypes.POINTER(ctypes.c_double)
    lib.build_blocks(
        dist_y.ctypes.data_as(fp),
        dist_x.ctypes.data_as(fp),
        ny,
        nx,
        fs,
        float(step_y),
        float(step_x),
        lut.ctypes.data_as(dp),
        len(lut),
        float(radius) * float(radius),
        float(samples - 1),
        out.ctypes.data_as(fp),
    )
    return out
