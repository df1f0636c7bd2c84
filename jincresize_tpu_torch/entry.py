"""Entry points of the port: a one-card step and a mesh dry run.

Twins of ``__graft_entry__.entry`` and ``dryrun_multichip``.
"""

from __future__ import annotations

import numpy as np
import torch

from .apply_conv import ConvApplier
from .apply_xla import resolve_device
from .operator import build_plane_operator, radius_for_tap
from .sharding import make_mesh, make_sharded_apply

# (src_w, src_h, dst_w, dst_h, tap) of the one-card step and of the dry run.
STEP = (480, 270, 960, 540, 8)
DRYRUN = (96, 72, 160, 120, 3)


def entry(device="cuda"):
    """Return ``(fn, (src,))``: one forward step of the main path.

    Jinc256 (tap 8) 480x270 -> 960x540 fp32 through the fused
    ``ConvApplier`` on ``device``; ``fn(src)`` maps the (270, 480) source to
    the (540, 960) float32 plane.
    """
    device = resolve_device(device)
    sw, sh, dw, dh, tap = STEP
    applier = ConvApplier(build_plane_operator(sw, sh, dw, dh, radius_for_tap(tap)), device=device)

    def fn(src):
        return applier(src)

    rng = np.random.default_rng(0)
    src = torch.from_numpy(rng.random((sh, sw), dtype=np.float32)).to(device)
    return fn, (src,)


def dryrun_multichip(n_devices: int, devices=None) -> torch.Tensor:
    """Build an ``n_devices`` ('data', 'rows') mesh and run the sharded step
    once on 96x72 -> 160x120 tap 3; returns the (n_data, 120, 160) output.

    Frames split over 2 data rows when ``n_devices`` is even, rows over the
    rest. ``devices`` (default: every visible CUDA device) may repeat a
    device, e.g. ``[torch.device("cuda", 0)] * 4`` or ``["cpu"] * 4``.
    """
    n_data = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    n_rows = n_devices // n_data
    mesh = make_mesh(n_rows=n_rows, n_data=n_data, devices=devices)
    dev0 = resolve_device(mesh.devices[0][0])
    sw, sh, dw, dh, tap = DRYRUN
    fn, _plan = make_sharded_apply(
        build_plane_operator(sw, sh, dw, dh, radius_for_tap(tap)), mesh, data_axis="data"
    )
    rng = np.random.default_rng(0)
    src = torch.from_numpy(rng.random((n_data, sh, sw), dtype=np.float32)).to(dev0)
    out = fn(src)
    if dev0.type == "cuda":
        torch.cuda.synchronize(dev0)
    if tuple(out.shape) != (n_data, dh, dw):
        raise AssertionError(f"dryrun_multichip: output shape {tuple(out.shape)}")
    return out
