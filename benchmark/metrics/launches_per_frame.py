"""launches_per_frame (launches): device kernels, copies and memsets in the
traced window, per frame: what the ctypes wrappers of ``kernels/*.py`` and
the torch ops of the engines enqueue."""


def read(run):
    t = run.trace
    if t is None or not t.device:
        return None
    return len(t.device) / t.frames
