"""search_gcups: gcups (metrics/gcups.py) where a request is one search:
the throughput one interactive client gets."""

from swbench.spec import reader

read = reader("gcups")
