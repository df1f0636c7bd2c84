"""enqueue_ms_per_frame (ms): host time in the program's ``jinc.engine``
spans (the engines' host work and launches; the device runs behind), their
union per frame."""

from benchmark.spans import ms_per_frame


def read(run):
    return ms_per_frame(run, ("jinc.engine",))
