"""device_idle_share.single: device_idle_share
(metrics/device_idle_share.py) in the cells where a request is one
search, where it moves search_gcups."""

from swbench.spec import reader

read = reader("device_idle_share")
