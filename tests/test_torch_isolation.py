"""The port stands alone and never hides the device.

* importing swtpu_torch (its stats copy, the prefilter, the int8, chain,
  wavefront-lab, row-lab and int16 kernels' wrappers, the native host
  runtime, the parallel package and the roofline and lab tools included)
  and running a search, a row-path search, a batched top-K with E-values, a
  prefiltered search (through the native parse, packers and signatures),
  and lane-sharded and query-sharded searches on a CPU mesh loads neither
  JAX nor swtpu (a subprocess: every pytest process here has imported JAX
  already);
* with no device argument the engine and CLI use CUDA, and raise without it;
* every combination of a later slice raises instead of being ignored or
  falling back to one device, and the serving, affine-gap, row-path,
  composed-dispatch, prefilter and mesh knobs are accepted.
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
import swtpu_torch.cli, swtpu_torch.models.search, swtpu_torch.synth, swtpu_torch.ops._build, swtpu_torch.stats
import swtpu_torch.models.align, swtpu_torch.ops.oracle
import swtpu_torch.ops.row_sw, swtpu_torch.ops.bucket_sw, swtpu_torch.utils.segpack
import swtpu_torch.ops.prefilter, swtpu_torch.ops.int8_mma, swtpu_torch.ops.vpu_chain, swtpu_torch.tools.roofline
import swtpu_torch.ops.wave_lab, swtpu_torch.ops.i16_probe, swtpu_torch.tools.buckets
import swtpu_torch.tools.probe_i16, swtpu_torch.tools.probe_breakdown, swtpu_torch.tools.wave_lab
import swtpu_torch.ops.rows_lab, swtpu_torch.tools.pallas_lab, swtpu_torch.native
import swtpu_torch.parallel, swtpu_torch.parallel.mesh, swtpu_torch.parallel.search, swtpu_torch.parallel.query_shard
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
        ("use_wave", False),
        ("score_dtype", "int16"),
        ("prefilter", 0.1),
        ("device_resident", False),
    ],
)
def test_unported_knobs_raise(knob, value):
    """The combinations of a mesh that slice A14b brings: the row path, the
    prefilter, and a streamed database under query_shard."""
    extra = {"prefilter": {"top_k": 5}, "device_resident": {"query_shard": True}}.get(knob, {})
    with pytest.raises(NotImplementedError, match="slice A14b"):
        SWConfig(**{knob: value}, mesh_shape=(2,), **extra)


@pytest.mark.parametrize(
    "knob,value",
    [
        ("top_k", 5), ("evalue", True), ("device_resident", False), ("query_ladder", True), ("gap_open", 11),
        ("score_dtype", "int16"), ("use_pallas", True), ("use_wave", False), ("segment_packing", False),
        ("wave_compose", True), ("prefilter", 0.1), ("prefilter_min_candidates", 7),
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
