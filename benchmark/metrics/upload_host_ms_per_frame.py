"""upload_host_ms_per_frame (ms): host time in the program's ``jinc.stack``
(the (F, h, w) batch built on the host) and ``jinc.upload`` spans (the
pageable host-to-device copy, from the host's side), their union per
frame."""

from benchmark.spans import ms_per_frame


def read(run):
    return ms_per_frame(run, ("jinc.stack", "jinc.upload"))
