"""resizer_build_s (s): host clock around ``JincResizer(...)``: the host
operator build (or the operator cache's load), the phase plans and the
engines' tables."""


def read(run):
    return run.setup.get("resizer_build_s")
