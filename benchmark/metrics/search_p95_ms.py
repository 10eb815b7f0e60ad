"""search_p95_ms: the 95th percentile of the window's search latencies, each
timed on the host from the call to its answer (linear interpolation
between order statistics).  Only where a request is one search."""

import numpy as np


def read(run):
    if run["call"] != "search":
        return None
    lat = [(r.t1 - r.t0) * 1e3 for r in run["records"] if r.error is None]
    return float(np.percentile(lat, 95)) if lat else None
