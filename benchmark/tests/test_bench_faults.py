"""The check must fail a broken program and the lower-precision control.

* Faults, planted underneath a whole run of each cell on the CPU (the look
  for a card skipped, everything else as on the card): a search that
  returns the answer of the search before it (the state left unchanged; single-query
  cells only, since a batch of fixed queries has nothing to go stale);
  half of the database's buckets left out of every search; answers altered
  where the kernel produces them.  A cell on one card has no exchange
  between cards to leave out.
* The control: the reference at the next precision down (saturating int16
  scores, float32 E-values) in the program's place, at test size with the
  planted copy of a long vendored query whose self-alignment passes
  32,767.

Run with ``python -m pytest benchmark/tests -q`` from the checkout's root.
"""

import functools

import numpy as np
import pytest
import torch

from tiny import SEED, small

import run  # noqa: E402
from swbench import check, data, spec  # noqa: E402
from swbench.drive import Record  # noqa: E402

BENCHMARK = spec.load()
CELLS = [w["name"] for w in BENCHMARK["workloads"]]
COUNTERS = ("launches", "multi_launches", "affine_launches", "carry_launches")


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _kernel_fault(monkeypatch, alter):
    from swtpu_torch.ops import wave_sw

    orig = wave_sw.sw_wave
    calls = [0]

    @functools.wraps(orig)
    def broken(*args, **kw):
        out = orig(*args, **kw)
        calls[0] += 1
        alter(out if not isinstance(out, tuple) else out[0], calls[0])
        return out

    for name in COUNTERS:
        setattr(broken, name, getattr(orig, name))
    monkeypatch.setattr(wave_sw, "sw_wave", broken)


def _half_left_out(out, k):
    if k % 2 == 0:
        out.zero_()


def _altered(out, k):
    out[..., ::7] += 1


def _stale(monkeypatch):
    from swtpu_torch.models.search import SearchEngine

    orig = SearchEngine.search
    last = {}

    def search(self, query, db, plan=None):
        res = orig(self, query, db, plan)
        prev, last["res"] = last.get("res"), res
        return res if prev is None else prev

    monkeypatch.setattr(SearchEngine, "search", search)


FAULTS = [(c, f) for c in CELLS for f in ("half_left_out", "altered")] + [
    (c, "stale") for c in CELLS if c.endswith(".single")
]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_a_broken_program_is_not_correct(cell, fault, monkeypatch):
    cfg, mix = small(BENCHMARK, cell, n=1500, count=4)
    if fault == "stale":
        _stale(monkeypatch)
    else:
        _kernel_fault(monkeypatch, _half_left_out if fault == "half_left_out" else _altered)
    out = run.run_cell(BENCHMARK, cell, SEED, 0.3, False, "cpu", cfg=cfg, mix=mix)
    assert out["correct"] is False, out["check"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    """The control's answers replace the program's (sound records of the
    right shape stand in for the window): it must fail one number."""
    cfg, mix = small(BENCHMARK, cell, n=600, count=3, vendored=("P02232", "Q9UKN1"))
    mix["check"]["no_full_scan"] = []  # the long query is scanned whole here: the database is small
    qs = data.queries(mix, SEED)
    res, off, planted = data.database(cfg["database"], qs, SEED)
    n, k = off.size - 1, cfg["returns"]["top_k"]
    long = next(i for i, q in enumerate(qs) if q["name"] == "Q9UKN1")
    sound = np.zeros(n, np.int32) if k is None else [(i, 0, 1.0, 1.0) for i in range(k)]
    sample = check.Sample(mix["check"], qs, n, k, planted, SEED)
    sample.offer_request(0, Record(0.0, 1.0, [long], None), [sound])
    numbers = check.check(cfg, qs, res, off, planted, sample, "cpu", control=True)
    numbers.pop("reference_seconds"), numbers.pop("_detail")
    failing = [name for name, v in numbers.items() if v["value"] > v["limit"]]
    assert failing and "answers_missing" not in failing, numbers
