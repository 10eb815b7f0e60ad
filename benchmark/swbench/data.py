"""A cell's inputs, made from the seed: the queries, the database with the
queries' homologs planted in it, and the order of the requests.

Each piece is found by the name the configuration or the mix gives it
(``swbench.spec.plugin``): a group of queries by its ``source``
(``sources/<name>.py``: ``make(group, gen)``), the database by its
``recipe`` (``databases/<name>.py``: ``make(spec, qs, seed, device)``), the
requests by the mix's ``order`` (``orders/<name>.py``: ``requests`` and
``warmup``).  What several of them share lives here: the seeded streams,
the length law, uniform residues made on the device, and the planting of
homologs.
"""

from __future__ import annotations

import statistics
from typing import Dict, Iterator, List

import numpy as np

from .spec import plugin

ALPHABET_SIZE = 25

# independent random streams of one run seed
(STREAM_ORDER, STREAM_QUERIES, STREAM_PLANT, STREAM_MUTATE, STREAM_RESIDUES, STREAM_REQUESTS, STREAM_CHECK,
 STREAM_CHECK_IDS) = range(1, 9)


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([stream, int(seed) % (1 << 64)])


def lognormal_lengths(spec: dict, count: int) -> np.ndarray:
    """``count`` lengths drawn from the clipped lognormal with the spec's own
    ``length_seed``."""
    return np.clip(
        np.random.default_rng(spec["length_seed"]).lognormal(mean=spec["log_mean"], sigma=spec["log_sigma"], size=count),
        spec["min_length"],
        spec["max_length"],
    ).astype(np.int64)


def quantile_lengths(spec: dict, count: int) -> np.ndarray:
    """``count`` lengths at the (k + 1/2) / count quantiles of the clipped
    lognormal: the same sizes for every seed."""
    nd = statistics.NormalDist(spec["log_mean"], spec["log_sigma"])
    qs = [np.exp(nd.inv_cdf((k + 0.5) / count)) for k in range(count)]
    return np.clip(np.round(qs), spec["min_length"], spec["max_length"]).astype(np.int64)


def uniform_residues(total: int, seed: int, device) -> np.ndarray:
    """``total`` residues uniform over the alphabet, drawn on ``device`` in
    one call from a generator seeded from the run seed, then brought to the
    host (the program takes its database there)."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(int(rng(seed, STREAM_RESIDUES).integers(0, 1 << 63)))
    out = torch.randint(0, ALPHABET_SIZE, (total,), generator=gen, device=device, dtype=torch.int8)
    return out.cpu().numpy()


def queries(mix: dict, seed: int) -> List[Dict]:
    """The mix's queries, in its groups' order: [{"name", "residues" (int8)}]."""
    gen = rng(seed, STREAM_QUERIES)
    out = []
    for group in mix["queries"]:
        out += [dict(name=name, residues=res) for name, res in plugin("sources", group["source"]).make(group, gen)]
    return out


def database(spec: dict, qs: List[Dict], seed: int, device="cpu"):
    """(residues int8, offsets int64, planted) of the configuration's
    recipe: ``planted[i]`` holds query i's ids, its exact copies first."""
    return plugin("databases", spec["recipe"]).make(spec, qs, seed, device)


def plant_ids(plant: dict, n: int, qs: List[Dict], seed: int) -> List[np.ndarray]:
    """Seeded distinct ids, ``exact + mutants`` of them a query."""
    per = plant["exact"] + plant["mutants"]
    ids = rng(seed, STREAM_PLANT).choice(n, size=per * len(qs), replace=False)
    return [ids[i * per : (i + 1) * per] for i in range(len(qs))]


def write_homologs(plant: dict, residues: np.ndarray, offsets: np.ndarray, qs: List[Dict], planted: List[np.ndarray],
                   seed: int) -> None:
    """Write each query's exact copies, then its mutants (a seeded share
    ``substitution`` of its positions changed), at its planted ids, whose
    lengths are already the query's."""
    mut = rng(seed, STREAM_MUTATE)
    for q, pid in zip(qs, planted):
        res = q["residues"]
        for k, i in enumerate(pid):
            copy = res.copy()
            if k >= plant["exact"]:
                hit = mut.random(res.size) < plant["substitution"]
                # a substitution changes the residue: add 1..24 modulo 25
                copy[hit] = (copy[hit].astype(np.int64) + mut.integers(1, ALPHABET_SIZE, int(hit.sum()))) % ALPHABET_SIZE
            residues[offsets[i] : offsets[i + 1]] = copy


def requests(mix: dict, qs: List[Dict], seed: int) -> Iterator[List[int]]:
    """The query indices of each request, without end."""
    return plugin("orders", mix["order"]["name"]).requests(mix["order"], qs, seed)


def warmup(mix: dict, qs: List[Dict]) -> List[List[int]]:
    """The requests set-up sends before the window: one of every call shape
    the mix's order makes."""
    return plugin("orders", mix["order"]["name"]).warmup(mix["order"], qs)
