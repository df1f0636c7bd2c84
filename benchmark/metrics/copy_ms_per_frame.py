"""copy_ms_per_frame (ms): the union of the traced window's host-to-device
and device-to-host copies on the device, per frame returned."""

from benchmark.chrome_trace import is_copy


def read(run):
    t = run.trace
    if t is None or not any(is_copy(o) for o in t.device):
        return None
    return 1e3 * t.busy_s(is_copy) / t.frames
