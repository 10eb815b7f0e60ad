"""Public names of swtpu that the port carries: ``REFERENCE_PARITY`` (also
exported by the package), ``SearchMetrics.to_json``, and ``PhaseTimer.total``
and ``counts``, each against swtpu's."""

import dataclasses
import json
import time

import pytest
import torch

import swtpu
import swtpu_torch
from swtpu.utils import metrics as ref_metrics
from swtpu_torch.config import REFERENCE_PARITY
from swtpu_torch.utils import metrics


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_reference_parity_equals_swtpu():
    assert swtpu_torch.REFERENCE_PARITY is REFERENCE_PARITY and swtpu_torch.SWConfig is type(REFERENCE_PARITY)
    ours = dataclasses.asdict(REFERENCE_PARITY)
    theirs = dataclasses.asdict(swtpu.REFERENCE_PARITY)
    # use_pallas keeps each package's default: None resolves from the device here (D3)
    assert ours.pop("use_pallas") == swtpu_torch.SWConfig().use_pallas
    assert theirs.pop("use_pallas") == swtpu.SWConfig().use_pallas
    assert {k: v for k, v in theirs.items() if k in ours} == ours
    # TPU-only (ROADMAP, Rules), and swtpu's composed-dispatch switch (ROADMAP, D21)
    assert set(theirs) - set(ours) == {"interpret", "wave_unroll_block", "wave_compose"}
    assert (REFERENCE_PARITY.length_quantum, REFERENCE_PARITY.matrix, REFERENCE_PARITY.gap_penalty) == (8, "blosum50_ref", 2)


def test_search_metrics_to_json_equals_swtpu():
    kw = dict(query_length=144, n_subjects=111, residue_sum=40_000, padded8_sum=40_400, packed_cells=7_000_000,
              wall_seconds=0.25, device_seconds=0.125, phases={"plan": 0.01}, transfer_seconds=0.001)
    ours, theirs = metrics.SearchMetrics(**kw, kernel_launches=3), ref_metrics.SearchMetrics(**kw)
    got, want = json.loads(ours.to_json()), json.loads(theirs.to_json())
    assert got == ours.to_dict() and want == theirs.to_dict()
    assert {k: v for k, v in got.items() if k in want} == want
    assert set(got) - set(want) == {"kernel_launches", "rescored_lanes", "prefilter_candidates", "long_candidates"}


def test_phase_timer_total_equals_swtpu():
    ours, theirs = metrics.PhaseTimer(), ref_metrics.PhaseTimer()
    assert ours.total() == theirs.total() == 0
    for name in ("parse", "pack", "parse"):
        with ours.phase(name):
            time.sleep(0.002)
    for name in ("parse", "pack", "parse"):
        with theirs.phase(name):
            pass
    assert ours.counts == theirs.counts == {"parse": 2, "pack": 1}
    theirs.phases.update(ours.phases)
    assert ours.total() == theirs.total() == sum(ours.phases.values()) >= 0.006
