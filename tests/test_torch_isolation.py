"""The port stands alone and never hides the device.

* importing swtpu_torch and running a search loads neither JAX nor swtpu
  (a subprocess: every pytest process here has imported JAX already);
* with no device argument the engine and CLI use CUDA, and raise without it;
* every knob of a later slice raises instead of being ignored.
"""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

from swtpu_torch.config import SWConfig
from swtpu_torch.models.search import SearchEngine, resolve_device

ROOT = Path(__file__).resolve().parent.parent


def test_port_imports_neither_jax_nor_swtpu():
    code = """
import sys
import swtpu_torch.cli, swtpu_torch.models.search, swtpu_torch.synth, swtpu_torch.ops._build
from swtpu_torch.io.fasta import parse_database, parse_query
from swtpu_torch.models.search import SearchEngine
from swtpu_torch.config import SWConfig
res = SearchEngine(SWConfig(), device="cpu").search(
    parse_query("tests/data/queries/P05013.fasta"), parse_database("tests/data/uniprot_subset.fasta"))
assert res.scores.shape == (111,)
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.") or m == "swtpu" or m.startswith("swtpu."))
print("LOADED", bad)
"""
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300
    )
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


def test_default_device_is_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SearchEngine()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SearchEngine(SWConfig(), device="cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_cli_defaults_to_cuda(monkeypatch, capsys):
    from swtpu_torch.cli import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = ["--query", str(ROOT / "tests/data/queries/P05013.fasta"), "--db", str(ROOT / "tests/data/uniprot_subset.fasta")]
    assert main(args) == 2
    assert "no CUDA device" in capsys.readouterr().err


@pytest.mark.parametrize(
    "knob,value",
    [
        ("top_k", 5),
        ("evalue", True),
        ("prefilter", 0.1),
        ("gap_open", 11),
        ("mesh_shape", (2,)),
        ("query_shard", True),
        ("wave_compose", True),
        ("score_dtype", "int16"),
        ("use_pallas", True),
        ("use_wave", False),
        ("device_resident", False),
        ("segment_packing", False),
        ("query_ladder", True),
    ],
)
def test_unported_knobs_raise(knob, value):
    with pytest.raises(NotImplementedError, match="slice A"):
        SWConfig(**{knob: value})


def test_ported_knobs_accepted():
    cfg = SWConfig(gap_penalty=3, matrix="blosum50", device_resident_cells=1 << 20, wave_chain=False, use_wave=True)
    assert cfg.replace(gap_penalty=1).gap_penalty == 1
    with pytest.raises(ValueError):
        SWConfig(gap_penalty=-1)
