"""operator_load_s (s): the program's counter ``operator_s``
(``jincresize_tpu_torch.metrics.counters()``): host seconds in
``JincResizer.__init__`` building or loading the plane operators. The
counter is process-wide, and a run builds one system. None where the
program keeps no such counter."""

from jincresize_tpu_torch import metrics


def read(run):
    counters = getattr(metrics, "counters", None)
    return None if counters is None else counters().get("operator_s")
