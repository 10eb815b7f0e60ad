"""device_idle_share.prefilter: device_idle_share
(metrics/device_idle_share.py) in the prefiltered cells, where a request
is one search and the share moves search_p50_ms (they report no
search_gcups: a prefiltered search scores a few thousand subjects, not the
database)."""

from swbench.spec import reader

read = reader("device_idle_share")
