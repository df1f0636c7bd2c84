"""The one generator of input clips, driven by a traffic file's parameters.

A traffic mix (``traffic/<name>.json``) says how many frames a call carries
(``frames_per_call``) and how many distinct calls the ring holds
(``ring_calls``); the configuration says the format and the source size.
Every sample is drawn uniformly over the format's full range from
``--seed``, so one seed always gives the same frames, and every seed the
same sizes. The planes are NumPy arrays: the program receives host clips,
as a frame server hands them over.
"""

from __future__ import annotations

import numpy as np

from .work import sample_bytes


def plane_shapes(config: dict) -> dict[str, tuple[int, int]]:
    """(height, width) of each source plane of a planar format: GRAY (Y),
    YUV (chroma subsampled by ``sub_w``/``sub_h``) or RGB (G, B, R), and A
    at full size where the format has alpha."""
    fmt = config["format"]
    w, h = config["src_width"], config["src_height"]
    a, b = fmt.get("sub_w", 0), fmt.get("sub_h", 0)
    shapes = {
        "GRAY": {"Y": (h, w)},
        "YUV": {"Y": (h, w), "U": (h >> b, w >> a), "V": (h >> b, w >> a)},
        "RGB": {"G": (h, w), "B": (h, w), "R": (h, w)},
    }[fmt["family"]]
    return {**shapes, "A": (h, w)} if fmt.get("has_alpha") else shapes


def ring(config: dict, traffic: dict, seed: int) -> list[list[dict[str, np.ndarray]]]:
    """``ring_calls`` calls of ``frames_per_call`` frames each, every frame
    a dict of planes; no two frames alike."""
    bits = config["format"]["bits"]
    dtype = {1: np.uint8, 2: np.uint16}[sample_bytes(bits)]
    rng = np.random.default_rng(seed)
    shapes = plane_shapes(config)
    return [
        [
            {n: rng.integers(0, 1 << bits, s, dtype=dtype) for n, s in shapes.items()}
            for _ in range(traffic["frames_per_call"])
        ]
        for _ in range(traffic["ring_calls"])
    ]
