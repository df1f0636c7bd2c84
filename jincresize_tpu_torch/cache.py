"""Operator cache: deterministic serialization keyed by geometry.

SURVEY.md §5 (checkpoint/resume): the filter is stateless per frame; the only
durable state is the coefficient table, rebuilt deterministically at
construction. This module provides the optional startup-latency optimization
the survey calls for — serialize the built operator keyed by the full
geometry tuple so repeated constructions (e.g. a fleet of workers resizing
the same format) skip the host build.

Format: a single .npz per operator under a cache directory; the key hashes
every input that affects coefficients (dims, radius, crop, quantization,
blur, LUT size) plus the builder version.

A copy of ``jincresize_tpu/cache.py`` with two changes: the default directory
is the port's own (``build/operator_cache/`` at the root of the checkout, or
``$JINCRESIZE_TORCH_CACHE_DIR``), so the two packages never load each other's
files; and ``cached_build`` counts its loads and builds in ``metrics``.
"""

from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path

import numpy as np

from .metrics import count
from .operator import BorderStrip, PlaneOperator

_BUILDER_VERSION = 1  # bump on any coefficient-semantics change


def geometry_key(**kw) -> str:
    """Stable hash of the geometry tuple."""
    payload = json.dumps(
        {"v": _BUILDER_VERSION, **{k: kw[k] for k in sorted(kw)}}, sort_keys=True
    )
    return hashlib.sha256(payload.encode()).hexdigest()[:24]


def default_cache_dir() -> Path:
    return Path(
        os.environ.get(
            "JINCRESIZE_TORCH_CACHE_DIR",
            Path(__file__).resolve().parents[1] / "build" / "operator_cache",
        )
    )


def save_operator(op: PlaneOperator, path: str | Path) -> None:
    arrays = {
        "start_x": op.start_x,
        "start_y": op.start_y,
        "cx_idx": op.cx_idx,
        "cy_idx": op.cy_idx,
        "pair_blocks": op.pair_blocks,
        "meta": np.array(
            [
                op.src_width,
                op.src_height,
                op.dst_width,
                op.dst_height,
                op.filter_size,
                op.x_lo,
                op.x_hi,
                op.y_lo,
                op.y_hi,
                len(op.strips),
            ],
            dtype=np.int64,
        ),
        "radius": np.array([op.radius], dtype=np.float64),
    }
    for i, s in enumerate(op.strips):
        arrays[f"strip{i}_rect"] = np.array([s.y0, s.y1, s.x0, s.x1], dtype=np.int64)
        arrays[f"strip{i}_blocks"] = s.blocks
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".tmp.npz")
    np.savez_compressed(tmp, **arrays)
    os.replace(tmp, path)


def load_operator(path: str | Path) -> PlaneOperator:
    with np.load(path) as z:
        meta = z["meta"]
        n_strips = int(meta[9])
        strips = []
        for i in range(n_strips):
            r = z[f"strip{i}_rect"]
            strips.append(
                BorderStrip(
                    y0=int(r[0]),
                    y1=int(r[1]),
                    x0=int(r[2]),
                    x1=int(r[3]),
                    blocks=z[f"strip{i}_blocks"],
                )
            )
        return PlaneOperator(
            src_width=int(meta[0]),
            src_height=int(meta[1]),
            dst_width=int(meta[2]),
            dst_height=int(meta[3]),
            filter_size=int(meta[4]),
            radius=float(z["radius"][0]),
            start_x=z["start_x"],
            start_y=z["start_y"],
            x_lo=int(meta[5]),
            x_hi=int(meta[6]),
            y_lo=int(meta[7]),
            y_hi=int(meta[8]),
            cx_idx=z["cx_idx"],
            cy_idx=z["cy_idx"],
            pair_blocks=z["pair_blocks"],
            strips=tuple(strips),
        )


def cached_build(build_fn, cache_dir: str | Path | None = None, **geometry):
    """Build-or-load: returns build_fn(**geometry), cached on disk by key.
    Counts ``operator_cache_loads`` or ``operator_cache_builds`` (a corrupt
    entry is rebuilt, and counts as a build)."""
    cdir = Path(cache_dir) if cache_dir is not None else default_cache_dir()
    key = geometry_key(**{k: v for k, v in geometry.items() if v is not None})
    path = cdir / f"op_{key}.npz"
    if path.exists():
        try:
            op = load_operator(path)
        except Exception:
            pass  # corrupt cache entry: rebuild
        else:
            count("operator_cache_loads")
            return op
    op = build_fn(**geometry)
    count("operator_cache_builds")
    try:
        save_operator(op, path)
    except OSError:
        pass  # cache write failure is non-fatal
    return op
