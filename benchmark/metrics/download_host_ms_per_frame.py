"""download_host_ms_per_frame (ms): host time in the program's
``jinc.download`` spans (waiting for the device, the pageable
device-to-host copy and the first touch of the fresh host array), their
union per frame."""

from benchmark.spans import ms_per_frame


def read(run):
    return ms_per_frame(run, ("jinc.download",))
