"""engine_host_ms: the mean, over the traced window's searches, of each
call's wall time less the time a device operation ran inside it: what the
engine's host path (profile, planning, launches, transfer, scatter or top-K
resolve and E-value fit) adds to a search.  Only where a request is one
search."""


def read(run):
    trace = run["trace"]
    if trace is None or run["call"] != "search":
        return None
    host = trace.request_host_ms()
    return sum(host) / len(host) if host else None
