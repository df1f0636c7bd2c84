"""engine_mb (MB): the program's counter ``engine_bytes``
(``jincresize_tpu_torch.metrics.counters()``) / 1e6: the device tables the
engines hold after set-up (dictionaries, padded blocks, weight splits, strip
blocks, index tables). The counter is process-wide, and a run builds one
system. None where the program keeps no such counter."""

from jincresize_tpu_torch import metrics


def read(run):
    counters = getattr(metrics, "counters", None)
    held = None if counters is None else counters().get("engine_bytes")
    return None if held is None else held / 1e6
