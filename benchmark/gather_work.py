"""The work of the gather kernels in one frame and the least time an H100
could take for it: the yardstick of ``gather_roofline``.

The gather engine serves the interior pixels, those whose row and column
are both non-border in the reference's window geometry
(``reference/geometry.py``): the pixels the plugin computes from its
quantized sub-pixel classes. That set is a property of the deployment, not
of an implementation. Operations are 2 x fs**2 an interior pixel of every
plane; bytes are each source plane read once as float32 and each plane's
interior written once as float32. The peaks are ``work.PEAK_FLOPS`` and
``work.PEAK_BYTES_S``, so no implementation, tensor-core or not, can read
above 100%.
"""

from __future__ import annotations

from . import work
from .reference import geometry, jinc_ewa


def interior(config: dict) -> list[tuple[str, int, int, int]]:
    """(plane name, filter size, interior pixels, source pixels) of each
    plane of a frame."""
    out = []
    for name, geo in jinc_ewa.plane_specs(config):
        g = geometry.plane_geometry(**geo)
        rows, cols = int((~g.y.border).sum()), int((~g.x.border).sum())
        out.append((name, g.filter_size, rows * cols, geo["src_width"] * geo["src_height"]))
    return out


def frame_ops(config: dict) -> int:
    """2 x fs**2 x the interior pixels, summed over a frame's planes."""
    return sum(2 * fs * fs * n for _, fs, n, _ in interior(config))


def frame_bytes(config: dict) -> int:
    """Every source plane read once and every interior written once, float32."""
    return sum(4 * (src + n) for _, _, n, src in interior(config))


def least_s(config: dict) -> tuple[float, str]:
    """(seconds, 'operations' or 'bytes') of a frame's gather work at the peaks."""
    return work.bound_s(frame_ops(config), frame_bytes(config))
