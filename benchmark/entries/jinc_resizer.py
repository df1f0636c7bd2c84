"""The system under test of a JincResize deployment: ``JincResizer.__call__``
of ``jincresize_tpu_torch`` on host clips, as a frame server or a clip API
calls it. A clip of one frame goes through ``process_frame``, a longer one
through ``process_clip_batched``.

The harness builds it with ``build`` during set-up, turns each call's
frames into a clip with ``System.clip`` before the window, calls the system
in the window, and reads what came back with ``count`` (in the window) and
``frames`` (after it).
"""

from __future__ import annotations

import numpy as np

from jincresize_tpu_torch.api import JincConfig, JincResizer
from jincresize_tpu_torch.clip import Clip, Frame, VideoFormat


class System:
    def __init__(self, config: dict, jinc_config: dict, device):
        self.fmt = VideoFormat(**config["format"])
        self.resizer = JincResizer(
            self.fmt, config["src_width"], config["src_height"], JincConfig(**jinc_config),
            device=device,
        )  # fmt: skip
        self.engines = dict(self.resizer.engines)

    def clip(self, frames: list[dict[str, np.ndarray]]) -> Clip:
        return Clip.from_frames([Frame(format=self.fmt, planes=f, props={}) for f in frames])

    def __call__(self, clip: Clip) -> Clip:
        return self.resizer(clip)


def build(config: dict, jinc_config: dict, device) -> System:
    """``JincResizer(...)`` for ``config`` with ``jinc_config`` (the
    configuration's, or its control's) on ``device``."""
    return System(config, jinc_config, device)


def count(out: Clip) -> int:
    """Frames a call returned."""
    return len(out.frames)


def frames(out: Clip) -> list[dict[str, np.ndarray]]:
    """The planes of every frame a call returned, by plane name."""
    return [{n: np.asarray(p) for n, p in f.planes.items()} for f in out.frames]
