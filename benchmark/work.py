"""The work of one frame and the least time an H100 could take for it.

The yardstick of ``resample_roofline``: it counts the resampling itself,
whatever implements it. Operations are 2 x the nonzero weights that the
reference applies over every output pixel of every plane (``compare`` in
``reference/jinc_ewa.py`` counts them); bytes are each source plane read
once and each output plane written once at the format's sample size.
"""

from __future__ import annotations

# NVIDIA's data sheet for one H100 SXM at its 700 W limit: the dense bf16
# tensor-core rate (the u8 path sums exactly there by splitting weights)
# and the HBM3 bandwidth.
PEAK_FLOPS = 989e12
PEAK_BYTES_S = 3.35e12


def sample_bytes(bits: int) -> int:
    """Bytes of an integer sample: uint8 up to 8 bits, uint16 above."""
    return 1 if bits <= 8 else 2


def frame_bytes(config: dict) -> int:
    """Bytes one frame moves at least: every source plane read once and
    every output plane written once (planar YUV, chroma subsampled)."""
    fmt, jc = config["format"], config["jinc_config"]
    a, b = fmt.get("sub_w", 0), fmt.get("sub_h", 0)

    def px(w, h):
        return w * h + 2 * (w >> a) * (h >> b)

    src = px(config["src_width"], config["src_height"])
    dst = px(jc["target_width"], jc["target_height"])
    return (src + dst) * sample_bytes(fmt["bits"])


def bound_s(ops: float, nbytes: float) -> tuple[float, str]:
    """(seconds, 'operations' or 'bytes'): the larger of the two times."""
    t_ops, t_bytes = ops / PEAK_FLOPS, nbytes / PEAK_BYTES_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
