"""search_p50_ms: the median latency of the window's searches, each timed
on the host from the call to its answer (linear interpolation between
order statistics).  Only where a request is one search."""

import numpy as np


def read(run):
    if run["call"] != "search":
        return None
    lat = [(r.t1 - r.t0) * 1e3 for r in run["records"] if r.error is None]
    return float(np.percentile(lat, 50)) if lat else None
