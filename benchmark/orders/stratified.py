"""One query a request, so that any stretch of requests holds the same
sizes whatever the seed:
``{"name": "stratified", "strata": S, "warmup": W, "periodic": [{"query", "first", "every"}]}``.

The queries not named under ``periodic`` are sorted by length and cut into
``strata`` strata; each pass over them takes a fresh seeded order within
each stratum, and every block of ``strata`` requests holds one query of
each stratum, in a seeded order.  A periodic query takes the requests
``first``, ``first + every``, ... instead.  Warm-up sends the shortest and
the longest query and ``warmup`` more spread over the lengths."""

import numpy as np

from swbench.data import STREAM_REQUESTS, rng


def requests(order: dict, qs: list, seed: int):
    index = {q["name"]: i for i, q in enumerate(qs)}
    periodic = [(index[p["query"]], p["every"], p["first"]) for p in order.get("periodic", [])]
    fixed = {i for i, _, _ in periodic}
    pool = sorted((i for i in range(len(qs)) if i not in fixed), key=lambda i: qs[i]["residues"].size)
    strata = np.array_split(np.array(pool, dtype=np.int64), order.get("strata", 1))
    r = rng(seed, STREAM_REQUESTS)

    def passes():
        while True:
            members = [s[r.permutation(s.size)] for s in strata]
            for b in range(max(s.size for s in members)):
                for k in r.permutation(len(members)):
                    if b < members[k].size:
                        yield int(members[k][b])

    stream = passes()
    pos = 0
    while True:
        due = [i for i, every, first in periodic if pos >= first and (pos - first) % every == 0]
        yield due[:1] or [next(stream)]
        pos += 1


def warmup(order: dict, qs: list):
    by_len = sorted(range(len(qs)), key=lambda i: qs[i]["residues"].size)
    w = order.get("warmup", 4)
    picks = {by_len[0], by_len[-1]} | {by_len[(k * len(by_len)) // w] for k in range(w)}
    return [[i] for i in sorted(picks)]
