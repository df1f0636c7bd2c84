"""device_idle (%): the share of the traced window (host clock on the
trace, first traced call's start to the last one's return, so host gaps
count) in which no device operation ran. Busy time is the union of the
device intervals, so it never reads below 0."""


def read(run):
    t = run.trace
    if t is None or not t.device or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
