"""glue_launches_per_frame (launches): kernel launch, copy and memset calls
(``cudaLaunch*``, ``cuLaunch*``, ``cudaMemcpy*``, ``cudaMemset*``) whose
start lies in the program's glue spans (``jinc.source_f32``,
``jinc.strips``, ``jinc.assemble``, ``jinc.finalize``), per frame: the
engines' work outside the interior kernels, as launches."""

from benchmark.spans import launches_per_frame_in

GLUE = ("jinc.source_f32", "jinc.strips", "jinc.assemble", "jinc.finalize")


def read(run):
    return launches_per_frame_in(run, GLUE)
