"""kernel_launches: the device kernels in the traced window, over the
searches it completed."""


def read(run):
    trace = run["trace"]
    if trace is None or not run["search_lengths"]:
        return None
    lo, hi = trace.window()
    n = sum(1 for a, b, *_ in trace.kernels if a >= lo and b <= hi)
    return n / len(run["search_lengths"])
