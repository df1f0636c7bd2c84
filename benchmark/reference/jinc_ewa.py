"""Plain EWA Lanczos (Jinc) resampling of whole frames, in float64 PyTorch.

The benchmark's yardstick for JincResize: every destination pixel is the
sum, over its fs x fs window of source samples (window rows and columns
clamped into the plane), of the windowed-jinc weight of the squared
distance, each weight divided by the window's sum of weights. Weights come
from the frozen copies of the LUT (``filters``) and the window geometry
(``geometry``); the per-pixel LUT lookup is the plugin's
(``rint(1023 * d2 / radius**2)``, float32 LUT values, zero past the end).
Sums and the normalisation run in float64, so this reference rounds once,
at the store: clamp to ``[0, store_max]`` and round half to even.

The reference recomputes every weight per pixel, in blocks of destination
rows, on whatever device it is given. It imports nothing of the program it
judges and takes nothing the program made: the harness hands it the source
planes it generated and the program's output planes, which it only judges.
"""

from __future__ import annotations

import numpy as np
import torch

from . import filters, geometry

# Elements of one (rows, width, fs, fs) block: 16 Mi float64 values (128 MiB)
# a tensor, a handful of such tensors live at once.
BLOCK_ELEMENTS = 1 << 24


def store_max(bits: int, opt: int = -1) -> float:
    """Largest stored integer: the format's peak, but 65535 for 9..15-bit
    planes under the plugin's default dispatch (``opt != 0``), whose SIMD
    stores saturate at the uint16 type's maximum."""
    if opt != 0 and 8 < bits < 16:
        return 65535.0
    return float((1 << bits) - 1)


def plane_specs(config: dict) -> list[tuple[str, dict]]:
    """(plane name, ``geometry.plane_geometry`` keywords) for each plane of
    the configuration's format (planar YUV, chroma subsampled by
    ``sub_w``/``sub_h``). User crops are not part of any configuration."""
    jc, fmt = config["jinc_config"], config["format"]
    for key in ("src_left", "src_top", "src_width", "src_height"):
        if key in jc:
            raise ValueError(f"reference: crop key {key!r} is not supported")
    if fmt["family"] != "YUV" or fmt.get("has_alpha"):
        raise ValueError("reference: planar YUV without alpha only")
    sw, sh = config["src_width"], config["src_height"]
    dw, dh = jc["target_width"], jc["target_height"]
    common = dict(
        radius=float(filters.JINC_ZEROS[jc.get("tap", 3) - 1]),
        quantize_x=jc.get("quant_x", 256),
        quantize_y=jc.get("quant_y", 256),
    )
    luma = dict(
        src_width=sw, src_height=sh, dst_width=dw, dst_height=dh,
        crop_left=0.0, crop_top=0.0, crop_width=float(sw), crop_height=float(sh), **common,
    )  # fmt: skip
    a, b = fmt.get("sub_w", 0), fmt.get("sub_h", 0)
    # Frames carry no _ChromaLocation, so the plugin's default siting holds.
    cl, ct, cw, ch = geometry.chroma_crop(jc.get("cplace") or "mpeg2", sw, sh, dw, dh, a, b)
    chroma = dict(
        src_width=sw >> a, src_height=sh >> b, dst_width=dw >> a, dst_height=dh >> b,
        crop_left=cl, crop_top=ct, crop_width=cw, crop_height=ch, **common,
    )  # fmt: skip
    return [("Y", luma), ("U", chroma), ("V", chroma)]


def out_shapes(config: dict) -> dict[str, tuple[int, int]]:
    """(height, width) of each output plane, by plane name."""
    return {name: (geo["dst_height"], geo["dst_width"]) for name, geo in plane_specs(config)}


class PlaneWeights:
    """Per-pixel normalised weights of one plane, block of rows by block."""

    def __init__(self, geo: dict, blur: float, device):
        self.g = geometry.plane_geometry(**geo)
        self.device = device
        radius = geo["radius"]
        lut = filters.build_lut(radius, blur).astype(np.float32)
        # One zero past the end: indices >= 1024 read 0 (Lut::GetFactor).
        self.lut = torch.from_numpy(np.append(lut, np.float32(0)).astype(np.float64)).to(device)
        self.radius2 = radius * radius
        g, fs = self.g, self.g.filter_size
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
        taps = np.arange(fs)
        self.rows_idx = t(np.clip(g.y.start[:, None] + taps, 0, g.y.size_src - 1))
        self.cols_idx = t(np.clip(g.x.start[:, None] + taps, 0, g.x.size_src - 1))
        self.border_y, self.border_x = t(g.y.border), t(g.x.border)
        f64 = lambda d, step: t(d.astype(np.float64) * step)  # noqa: E731
        self.dy_raw, self.dy_q = f64(g.y.dist_raw, g.y.filter_step), f64(g.y.dist_quant, g.y.filter_step)
        self.dx_raw, self.dx_q = f64(g.x.dist_raw, g.x.filter_step), f64(g.x.dist_quant, g.x.filter_step)
        self.height, self.width = len(g.y.start), len(g.x.start)
        self.block_rows = max(1, BLOCK_ELEMENTS // (self.width * fs * fs))

    @staticmethod
    def _d2(dy, dx):
        """(rows, cols, fs, fs) squared distances, dx*dx + dy*dy."""
        return (dx * dx)[None, :, None, :] + (dy * dy)[:, None, :, None]

    def weights(self, y0: int, y1: int) -> torch.Tensor:
        """(y1 - y0, width, fs, fs) float64 weights of rows [y0, y1).
        Interior pixels take the quantized distances on both axes; a pixel
        whose row or column is a border one takes the raw ones on both."""
        by = self.border_y[y0:y1]
        d2 = self._d2(self.dy_q[y0:y1], self.dx_q)
        if bool(by.any()):
            d2[by] = self._d2(self.dy_raw[y0:y1][by], self.dx_raw)
        rows = (~by).nonzero().squeeze(1)
        cols = self.border_x.nonzero().squeeze(1)
        if len(rows) and len(cols):
            d2[rows[:, None], cols[None, :]] = self._d2(
                self.dy_raw[y0:y1][rows], self.dx_raw[cols]
            )
        idx = torch.round((1023.0 * d2) / self.radius2).clamp_(max=len(self.lut) - 1)
        w = self.lut[idx.long()]
        return w / w.sum((2, 3), keepdim=True)

    def apply(self, src: torch.Tensor, w: torch.Tensor, y0: int, y1: int) -> torch.Tensor:
        """(y1 - y0, width) float64 values of rows [y0, y1) of ``src``."""
        r = self.rows_idx[y0:y1]
        win = src[r[:, None, :, None], self.cols_idx[None, :, None, :]]
        return (win * w).sum((2, 3))


def compare(config: dict, pairs: list[tuple[dict, dict]], device) -> dict:
    """Judge the program's output frames against this reference.

    ``pairs`` holds (source planes, program's output planes) per frame,
    NumPy arrays by plane name. Returns the largest gap in LSB between a
    program sample and the reference's stored value (``max_lsb``), the
    count of samples that differ (``mismatches``), the count compared
    (``samples``) and the nonzero weights one frame applies over all of
    its planes (``nnz_per_frame``), which is the frame's resampling work.
    """
    jc, bits = config["jinc_config"], config["format"]["bits"]
    top = store_max(bits, jc.get("opt", -1))
    blur = jc.get("blur") or 1.0
    max_lsb, mismatches, samples, nnz = 0, 0, 0, 0
    for name, geo in plane_specs(config):
        pw = PlaneWeights(geo, blur, device)
        srcs = [torch.from_numpy(np.asarray(s[name], dtype=np.float64)).to(device) for s, _ in pairs]
        outs = [torch.from_numpy(np.asarray(o[name]).astype(np.int64)).to(device) for _, o in pairs]
        for y0 in range(0, pw.height, pw.block_rows):
            y1 = min(y0 + pw.block_rows, pw.height)
            w = pw.weights(y0, y1)
            nnz += int((w != 0).sum())
            for src, out in zip(srcs, outs):
                ref = torch.round(pw.apply(src, w, y0, y1).clamp_(0.0, top)).long()
                gap = (out[y0:y1] - ref).abs()
                max_lsb = max(max_lsb, int(gap.max()))
                mismatches += int((gap != 0).sum())
                samples += gap.numel()
            del w
    return {"max_lsb": max_lsb, "mismatches": mismatches, "samples": samples, "nnz_per_frame": nnz}


def upper_nnz_per_frame(config: dict) -> int:
    """fs**2 weights for every output pixel of every plane: the most that
    ``compare``'s ``nnz_per_frame`` can read."""
    total = 0
    for _, geo in plane_specs(config):
        g = geometry.plane_geometry(**geo)
        total += g.filter_size**2 * geo["dst_width"] * geo["dst_height"]
    return total
