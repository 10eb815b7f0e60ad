"""The port stands alone and never hides the device.

* importing every module of swtpu_torch (``pkgutil.walk_packages``: the
  kernels' wrappers, the native host runtime, the parallel package, the
  tools, the card fuzz and GPU battery, the pairwise aligner, the UniProt
  preprocessor and the profiler helper included) and running a search, a
  row-path search, a batched top-K with E-values, a prefiltered search
  (through the native parse, packers and signatures), lane-sharded,
  query-sharded and row-path searches on a CPU mesh, and a 2-process gloo
  search loads neither JAX nor swtpu (a subprocess: every pytest process
  here has imported JAX already);
* with no device argument the engine and CLI use CUDA, and raise without it;
* the combinations a mesh refused until slice A14b run, and the serving,
  affine-gap, row-path, prefilter and mesh knobs are accepted.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from swtpu_torch.config import SWConfig
from swtpu_torch.io.fasta import parse_database, parse_query
from swtpu_torch.models.search import SearchEngine, resolve_device

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small searches: intra-op threads gain nothing here, and beside the
    other test workers on the same cores they only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_port_imports_neither_jax_nor_swtpu():
    code = """
import importlib, pkgutil, sys
import swtpu_torch

def _raise(name):
    raise ImportError(f"walk_packages could not import {name}")

modules = [m.name for m in pkgutil.walk_packages(swtpu_torch.__path__, "swtpu_torch.", onerror=_raise)]
for name in modules:
    importlib.import_module(name)
new = {"swtpu_torch.cpu_align", "swtpu_torch.io.uniprot", "swtpu_torch.tools.card_fuzz",
       "swtpu_torch.tools.gpu_validate", "swtpu_torch.utils.profiling"}
assert new <= set(modules) and len(modules) >= 50, modules
from swtpu_torch.io.fasta import parse_database, parse_query
from swtpu_torch.models.search import SearchEngine
from swtpu_torch.config import SWConfig
q, db = parse_query("tests/data/queries/P05013.fasta"), parse_database("tests/data/uniprot_subset.fasta")
res = SearchEngine(SWConfig(), device="cpu").search(q, db)
assert res.scores.shape == (111,)
rows = SearchEngine(SWConfig(use_wave=False, use_pallas=True), device="cpu").search(q, db)
assert (rows.scores == res.scores).all()
hits = SearchEngine(SWConfig(top_k=3, evalue=True), device="cpu").search_many([q], db)[0].top_k_stats(3)
assert len(hits) == 3
alns = swtpu_torch.models.align.align_top_k(q, db, k=2, config=SWConfig(gap_open=10, gap_extend=1), device="cpu")
assert len(alns) == 2
pre = SearchEngine(SWConfig(prefilter=0.3, top_k=3, prefilter_min_candidates=1), device="cpu").search(q, db)
assert pre.scores is None and len(pre.hits) == 3 and all(res.scores[i] == s for i, s in pre.hits)
lanes = SearchEngine(SWConfig(mesh_shape=(2,), top_k=3), device="cpu").search(q, db)
assert lanes.hits == res.top_k(3)
bands = SearchEngine(SWConfig(mesh_shape=(2,), query_shard=True), device="cpu").search(q, db)
assert (bands.scores == res.scores).all()
mesh_rows = SearchEngine(SWConfig(mesh_shape=(2,), use_wave=False), device="cpu").search(q, db)
assert (mesh_rows.scores == res.scores).all()
import socket, subprocess
s = socket.socket(); s.bind(("127.0.0.1", 0)); port = s.getsockname()[1]; s.close()
cmd = [sys.executable, "-m", "swtpu_torch.parallel.launch", "--query", "tests/data/queries/P05013.fasta",
       "--db", "tests/data/uniprot_subset.fasta", "--top-k", "3", "--device", "cpu", "--json",
       "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2"]
ranks = [subprocess.Popen(cmd + ["--process-id", str(p)], stdout=subprocess.PIPE, text=True) for p in range(2)]
try:
    outs = [r.communicate(timeout=120)[0] for r in ranks]
finally:
    for r in ranks:
        r.kill()
import json
fleet = [json.loads(o.strip().splitlines()[-1]) for o in outs]
assert fleet[0]["hits"] == fleet[1]["hits"] == [list(h) for h in res.top_k(3)], fleet
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.") or m == "swtpu" or m.startswith("swtpu."))
print("LOADED", bad)
"""
    # one intra-op thread in the subprocess and the fleet's processes it
    # starts, as in this process (the module fixture)
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1"},
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
        ("use_wave", False),
        ("score_dtype", "int16"),
        ("prefilter", 0.1),
        ("device_resident", False),
    ],
)
def test_unported_knobs_raise(knob, value):
    """The combinations of a mesh that raised NotImplementedError until
    slice A14b (the row path, the int16 mode, the prefilter, a streamed
    database under query_shard) now run on a 2-shard CPU mesh, equal to one
    device; nothing in the port names a slice still to come."""
    extra = {"prefilter": {"top_k": 5}, "device_resident": {"query_shard": True}}.get(knob, {})
    q, db = parse_query(ROOT / "tests/data/queries/P05013.fasta"), parse_database(ROOT / "tests/data/uniprot_subset.fasta")
    cfg = SWConfig(**{knob: value}, mesh_shape=(2,), **extra)
    got = SearchEngine(cfg, device="cpu").search(q, db)
    want = SearchEngine(cfg.replace(mesh_shape=(1,)), device="cpu").search(q, db)
    assert got.hits == want.hits and (got.scores is None or (got.scores == want.scores).all())
    for path in (ROOT / "swtpu_torch").rglob("*.py"):
        assert "slice A1" not in path.read_text(), path


@pytest.mark.parametrize(
    "knob,value",
    [
        ("top_k", 5), ("evalue", True), ("device_resident", False), ("query_ladder", True), ("gap_open", 11),
        ("score_dtype", "int16"), ("use_pallas", True), ("use_wave", False), ("segment_packing", False),
        ("prefilter", 0.1), ("prefilter_min_candidates", 7),
        ("mesh_shape", (2,)), ("mesh_axes", ("model",)), ("query_shard", True),
    ],
)
def test_serving_knobs_accepted(knob, value):
    # affine gaps are set as a pair; the prefilter needs a top-K
    extra = {"gap_open": {"gap_extend": 1}, "prefilter": {"top_k": 5}}.get(knob, {})
    cfg = SWConfig(**{knob: value}, **extra)
    assert getattr(cfg, knob) == value
    SearchEngine(cfg, device="cpu")


def test_ported_knobs_accepted():
    cfg = SWConfig(gap_penalty=3, matrix="blosum50", device_resident_cells=1 << 20, wave_chain=False, use_wave=True)
    assert cfg.replace(gap_penalty=1).gap_penalty == 1
    with pytest.raises(ValueError):
        SWConfig(gap_penalty=-1)
