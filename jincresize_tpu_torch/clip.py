"""Video format / frame / clip model (host-side data plane).

Stand-in for the AviSynth host structures the reference plugin consumes
(``AVS_VideoInfo``/``AVS_VideoFrame``/frame props — used throughout the
reference's src/JincResize.cpp via ``avs_*`` calls): planar frames are
dicts of NumPy arrays, frame properties (e.g. ``_ChromaLocation``) are a
plain metadata dict (SURVEY.md §2 C21), and a Clip is a frame sequence with a
format. There is no global mutable state; the resizer is a pure function of
(operator, frame). A copy of ``jincresize_tpu/clip.py`` with its code
unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

import numpy as np

# Plane orders match the reference kernels (resize_plane_*.cpp:12-13):
# YUV-family planes Y,U,V,A; planar RGB planes G,B,R,A.
YUV_PLANES = ("Y", "U", "V", "A")
RGB_PLANES = ("G", "B", "R", "A")


@dataclass(frozen=True)
class VideoFormat:
    """Planar video format: color family, subsampling, bit depth, alpha."""

    family: str  # 'YUV' | 'RGB' | 'GRAY'
    sub_w: int = 0  # chroma width subsampling (log2)
    sub_h: int = 0  # chroma height subsampling (log2)
    bits: int = 8  # 8..16 integer, 32 => float32
    has_alpha: bool = False

    def __post_init__(self):
        if self.family not in ("YUV", "RGB", "GRAY"):
            raise ValueError(f"unknown color family {self.family!r}")
        if self.family != "YUV" and (self.sub_w or self.sub_h):
            raise ValueError("subsampling requires YUV")

    @property
    def dtype(self):
        if self.bits == 32:
            return np.float32
        return np.uint8 if self.bits <= 8 else np.uint16

    @property
    def peak(self) -> float:
        """``(1 << bits) - 1`` (JincResize.cpp:793); unused for float."""
        return float((1 << self.bits) - 1)

    @property
    def plane_names(self) -> tuple[str, ...]:
        if self.family == "GRAY":
            return ("Y", "A") if self.has_alpha else ("Y",)
        base = RGB_PLANES if self.family == "RGB" else YUV_PLANES
        return base if self.has_alpha else base[:3]

    @property
    def num_planes(self) -> int:
        return len(self.plane_names)

    @property
    def is_subsampled(self) -> bool:
        return self.sub_w > 0 or self.sub_h > 0

    def plane_dims(self, name: str, width: int, height: int) -> tuple[int, int]:
        """(width, height) of the named plane for given luma dimensions."""
        if name in ("U", "V"):
            return width >> self.sub_w, height >> self.sub_h
        return width, height

    @property
    def is_420(self) -> bool:
        return self.family == "YUV" and self.sub_w == 1 and self.sub_h == 1

    @property
    def is_422(self) -> bool:
        return self.family == "YUV" and self.sub_w == 1 and self.sub_h == 0

    @property
    def is_411(self) -> bool:
        return self.family == "YUV" and self.sub_w == 2 and self.sub_h == 0

    @property
    def is_444(self) -> bool:
        return self.family == "YUV" and self.sub_w == 0 and self.sub_h == 0


# Common format shorthands.
def yuv420p(bits: int = 8, alpha: bool = False) -> VideoFormat:
    return VideoFormat("YUV", 1, 1, bits, alpha)


def yuv422p(bits: int = 8, alpha: bool = False) -> VideoFormat:
    return VideoFormat("YUV", 1, 0, bits, alpha)


def yuv444p(bits: int = 8, alpha: bool = False) -> VideoFormat:
    return VideoFormat("YUV", 0, 0, bits, alpha)


def yuv411p(bits: int = 8) -> VideoFormat:
    return VideoFormat("YUV", 2, 0, bits)


def rgbp(bits: int = 8, alpha: bool = False) -> VideoFormat:
    return VideoFormat("RGB", 0, 0, bits, alpha)


def gray(bits: int = 8) -> VideoFormat:
    return VideoFormat("GRAY", 0, 0, bits)


@dataclass(frozen=True)
class Frame:
    """One planar video frame: named plane arrays + frame properties."""

    format: VideoFormat
    planes: dict  # name -> array (h, w)
    props: dict = field(default_factory=dict)

    @property
    def width(self) -> int:
        return self.planes[self.format.plane_names[0]].shape[1]

    @property
    def height(self) -> int:
        return self.planes[self.format.plane_names[0]].shape[0]

    def with_props(self, **kv) -> "Frame":
        props = dict(self.props)
        props.update(kv)
        return replace(self, props=props)

    def validate(self) -> "Frame":
        w, h = self.width, self.height
        for name in self.format.plane_names:
            pw, ph = self.format.plane_dims(name, w, h)
            arr = self.planes[name]
            if arr.shape != (ph, pw):
                raise ValueError(
                    f"plane {name}: expected {(ph, pw)}, got {arr.shape}"
                )
            if np.dtype(arr.dtype) != np.dtype(self.format.dtype):
                raise ValueError(
                    f"plane {name}: expected dtype {self.format.dtype}, got {arr.dtype}"
                )
        return self


@dataclass(frozen=True)
class Clip:
    """An eager frame sequence with a shared format (the host pipeline unit)."""

    format: VideoFormat
    frames: tuple  # tuple[Frame, ...]
    width: int
    height: int

    @classmethod
    def from_frames(cls, frames) -> "Clip":
        frames = tuple(frames)
        f0 = frames[0]
        return cls(format=f0.format, frames=frames, width=f0.width, height=f0.height)

    def __len__(self) -> int:
        return len(self.frames)

    def get_frame(self, n: int) -> Frame:
        return self.frames[n]


def random_frame(
    fmt: VideoFormat, width: int, height: int, seed: int = 0, props: dict | None = None
) -> Frame:
    """Test/bench helper: random frame of the given format."""
    rng = np.random.default_rng(seed)
    planes = {}
    for name in fmt.plane_names:
        pw, ph = fmt.plane_dims(name, width, height)
        if fmt.bits == 32:
            if name in ("U", "V"):
                planes[name] = rng.random((ph, pw), dtype=np.float32) - np.float32(0.5)
            else:
                planes[name] = rng.random((ph, pw), dtype=np.float32)
        else:
            planes[name] = rng.integers(
                0, (1 << fmt.bits), size=(ph, pw)
            ).astype(fmt.dtype)
    return Frame(format=fmt, planes=planes, props=dict(props or {}))
