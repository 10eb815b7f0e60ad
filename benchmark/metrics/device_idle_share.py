"""device_idle_share: the share of the traced window, from its start to the
last answer, in which no device operation (kernel, copy or fill) ran."""


def read(run):
    trace = run["trace"]
    if trace is None:
        return None
    lo, hi = trace.window()
    if hi <= lo:
        return None
    return 100.0 * (1.0 - trace.busy(lo, hi) / (hi - lo))
