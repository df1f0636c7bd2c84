"""fps (frames/s): frames returned to the host over the whole window, each
frame with all its planes, from the first call's start to the last call's
return."""


def read(run):
    span = run.window_end - run.window_start
    return run.frames / span if span > 0 and run.frames else None
