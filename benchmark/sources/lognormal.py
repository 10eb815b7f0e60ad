"""``count`` queries whose lengths sit at the quantiles of a clipped
lognormal (the same sizes for every seed) and whose residues are drawn
from the seed, uniform over the alphabet:
``{"source": "lognormal", "log_mean", "log_sigma", "min_length", "max_length", "count"}``."""

import numpy as np

from swbench.data import ALPHABET_SIZE, quantile_lengths


def make(group: dict, gen: np.random.Generator):
    return [(f"q{k}-{n}aa", gen.integers(0, ALPHABET_SIZE, int(n), dtype=np.int8))
            for k, n in enumerate(quantile_lengths(group, group["count"]))]
