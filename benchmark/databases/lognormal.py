"""A SwissProt-shaped synthetic database: ``sequences`` lengths drawn once
from a lognormal clipped to [``min_length``, ``max_length``] with the
recipe's own ``length_seed`` (so every run seed gives the same set of
sizes), put in an order drawn from the run seed; residues uniform over the
25-letter alphabet, drawn on the device from the run seed; each query
planted as ``planted.exact`` copies and ``planted.mutants`` mutants at
seeded ids, in place of the subjects there."""

import numpy as np

from swbench.data import STREAM_ORDER, lognormal_lengths, plant_ids, rng, uniform_residues, write_homologs


def make(spec: dict, qs: list, seed: int, device):
    n = spec["sequences"]
    lengths = lognormal_lengths(spec, n)[rng(seed, STREAM_ORDER).permutation(n)]
    planted = plant_ids(spec["planted"], n, qs, seed)
    for q, pid in zip(qs, planted):
        lengths[pid] = q["residues"].size
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lengths, out=offsets[1:])
    residues = uniform_residues(int(offsets[-1]), seed, device)
    write_homologs(spec["planted"], residues, offsets, qs, planted, seed)
    return residues, offsets, planted
