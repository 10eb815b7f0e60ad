"""On the card, at each cell's own size: a short sound run is correct, and
its control (the reference at the next precision down in the program's
place) is not.  Marked ``gpu``; each test looks for a card itself.

Run on a machine with the card: ``python -m pytest benchmark/tests -q -m gpu``.
"""

import json
import subprocess
import sys

import pytest

from tiny import BENCH, SEED

from swbench import spec  # noqa: E402

CELLS = [w["name"] for w in spec.load()["workloads"]]


def _run(cell, seed, control):
    proc = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload", cell, "--seed", str(seed),
                           "--seconds", "3", "--trace", "0", "--control", str(control)],
                          capture_output=True, text=True, cwd=BENCH.parent, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_on_the_card_the_program_passes_and_its_control_fails(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    assert _run(cell, SEED, 0)["correct"] is True
    for seed in (SEED + 1, SEED + 2, SEED + 3):
        assert _run(cell, seed, 1)["correct"] is False
