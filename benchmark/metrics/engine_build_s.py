"""engine_build_s (s): the program's counter ``engine_s``
(``jincresize_tpu_torch.metrics.counters()``): host seconds selecting and
building the engines (appliers, tables, weight splits, uploads). The
counter is process-wide, and a run builds one system. None where the
program keeps no such counter."""

from jincresize_tpu_torch import metrics


def read(run):
    counters = getattr(metrics, "counters", None)
    return None if counters is None else counters().get("engine_s")
