"""The port's alignment traceback and its CLI output, held to swtpu on the CPU.

``swtpu_torch.models.align`` is a copy of ``swtpu.models.align`` over the
port's own oracle copy: every ``Alignment`` field must equal swtpu's, on the
full-matrix and the blocked (checkpoint-recompute) paths, for linear and
affine gaps; ``align_top_k`` and the CLI (``--gap-open --gap-extend
--align-top-k``) must print what swtpu's do.  swtpu's affine engine runs in
interpret mode, which its CLI cannot ask for, so the comparison builds
swtpu's config with ``use_wave=True, interpret=True``.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import swtpu.cli
from swtpu.alphabet import decode as j_decode
from swtpu.config import SWConfig as JConfig
from swtpu.io.fasta import Database as JDatabase
from swtpu.io.fasta import Query as JQuery
from swtpu.matrices import blosum50_ref
from swtpu.models import align as jalign
from swtpu_torch.alphabet import decode
from swtpu_torch.config import SWConfig
from swtpu_torch.io.fasta import Database, Query
from swtpu_torch.models import align as talign

ROOT = Path(__file__).resolve().parent.parent
DATA = ROOT / "tests" / "data"
MAT = blosum50_ref()


def _pairs(seed, n=8):
    """Seeded (query, subject) pairs, half with a planted homologous stretch."""
    r = np.random.default_rng(seed)
    out = []
    for t in range(n):
        q = r.integers(0, 25, int(r.integers(20, 120))).astype(np.int8)
        s = r.integers(0, 25, int(r.integers(20, 160))).astype(np.int8)
        if t % 2:
            k = min(len(q), max(len(s) - 5, 0), 40)
            s[5 : 5 + k] = q[:k]
        out.append((q, s))
    return out


def _fields(aln):
    return dataclasses.astuple(aln)


@pytest.mark.parametrize("max_full_bytes", [128 << 20, 0], ids=["full", "blocked"])
@pytest.mark.parametrize("gap", [2, 5])
def test_traceback_pair_matches_swtpu(gap, max_full_bytes):
    for sid, (q, s) in enumerate(_pairs(gap)):
        mine = talign.traceback_pair(q, s, MAT, gap, subject_id=sid, max_full_bytes=max_full_bytes)
        ref = jalign.traceback_pair(q, s, MAT, gap, subject_id=sid, max_full_bytes=max_full_bytes)
        assert _fields(mine) == _fields(ref)
        assert (mine.query_start, mine.subject_start, mine.midline()) == (ref.query_start, ref.subject_start, ref.midline())


@pytest.mark.parametrize("max_full_bytes", [128 << 20, 0], ids=["full", "blocked"])
@pytest.mark.parametrize("gaps", [(10, 1), (11, 2), (4, 4)])
def test_traceback_pair_affine_matches_swtpu(gaps, max_full_bytes):
    for sid, (q, s) in enumerate(_pairs(sum(gaps))):
        mine = talign.traceback_pair_affine(q, s, MAT, *gaps, subject_id=sid, max_full_bytes=max_full_bytes)
        ref = jalign.traceback_pair_affine(q, s, MAT, *gaps, subject_id=sid, max_full_bytes=max_full_bytes)
        assert _fields(mine) == _fields(ref)
        assert mine.pretty() == ref.pretty()


def test_blocked_accessors_bound_memory_on_a_long_pair():
    r = np.random.default_rng(3)
    q = r.integers(0, 25, 600).astype(np.int8)
    s = r.integers(0, 25, 3000).astype(np.int8)
    s[100:400] = q[200:500]  # planted homology
    for blk, full in (
        (talign._BlockedH(q, s, MAT, 2), talign.traceback_pair(q, s, MAT, 2)),
        (talign._BlockedHEF(q, s, MAT, 11, 1), talign.traceback_pair_affine(q, s, MAT, 11, 1)),
    ):
        blk._ensure(blk.bi)
        assert (blk.best, blk.bi, blk.bj) == (full.score, full.query_end, full.subject_end)
        kept = sum(sum(a.nbytes for a in (v if isinstance(v, tuple) else (v,))) for v in blk.checkpoints.values())
        assert kept < 601 * 3001 * 8 // 4  # a fraction of the full int64 H


def _small_db(seed):
    r = np.random.default_rng(seed)
    lens = r.integers(1, 50, 40)
    lens[7] = 45
    off = np.zeros(41, np.int64)
    np.cumsum(lens, out=off[1:])
    res = r.integers(0, 25, off[-1]).astype(np.int8)
    qres = r.integers(0, 25, 30).astype(np.int8)
    res[off[7] + 5 : off[7] + 35] = qres  # a planted hit
    return (Query("t", qres, ""), Database(residues=res, offsets=off)), (JQuery("t", qres, ""), JDatabase(residues=res, offsets=off))


@pytest.mark.parametrize("gaps", [None, (10, 1)], ids=["linear", "affine"])
def test_align_top_k_matches_swtpu(gaps):
    (q, db), (jq, jdb) = _small_db(13)
    kw = {} if gaps is None else dict(gap_open=gaps[0], gap_extend=gaps[1])
    mine = talign.align_top_k(q, db, k=4, config=SWConfig(**kw), device="cpu")
    ref = jalign.align_top_k(jq, jdb, k=4, config=JConfig(**kw, **({} if gaps is None else dict(use_wave=True, interpret=True))))
    assert [_fields(a) for a in mine] == [_fields(a) for a in ref]
    assert len(mine) == 4 and mine[0].subject_id == 7


def test_align_top_k_defaults_to_cuda(monkeypatch):
    (q, db), _ = _small_db(1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        talign.align_top_k(q, db, k=2)


def test_align_hits_checks_the_device_score():
    (q, db), _ = _small_db(2)
    assert talign.align_hits(q, db, [], SWConfig()) == []
    score = talign.traceback_pair(q.residues, db.sequence(7), MAT, 2).score
    assert talign.align_hits(q, db, [(7, score)], SWConfig())[0].score == score
    with pytest.raises(AssertionError, match="device score"):
        talign.align_hits(q, db, [(7, score + 1)], SWConfig())


def test_decode_matches_swtpu():
    idx = np.arange(-3, 40, dtype=np.int64)
    assert decode(idx) == j_decode(idx)
    assert decode(np.array([0, 1, 24, 25], np.int8)) == "AR**"


# --- CLI -----------------------------------------------------------------------------------------


def _before_metrics(out):
    lines = out.splitlines()
    return lines[: lines.index("=" * 80)]


@pytest.mark.parametrize(
    "flags",
    [
        ["--gap-open", "10", "--gap-extend", "1"],
        ["--gap-open", "10", "--gap-extend", "1", "--align-top-k", "3"],
        ["--align-top-k", "3"],
    ],
    ids=["affine_scores", "affine_alignments", "linear_alignments"],
)
def test_cli_matches_swtpu_cli(capsys, monkeypatch, flags):
    from swtpu_torch.cli import main as tmain

    args = ["--query", str(DATA / "queries" / "P02232.fasta"), "--db", str(DATA / "uniprot_subset.fasta")] + flags
    if "--gap-open" in flags:  # swtpu runs affine gaps on its wavefront kernel only: interpret mode on the CPU
        monkeypatch.setattr(swtpu.cli, "SWConfig", lambda **kw: JConfig(**dict(kw, use_wave=True, interpret=True)))
    assert swtpu.cli.main(args) == 0
    ref = _before_metrics(capsys.readouterr().out)
    assert tmain(args + ["--device", "cpu"]) == 0
    mine = _before_metrics(capsys.readouterr().out)
    assert mine == ref
    if "--align-top-k" in flags:
        assert sum(ln.startswith("subject ") for ln in mine) == 3
        assert not any(ln.split(":")[0].isdigit() for ln in mine)  # no score dump
    else:
        assert sum(ln.split(":")[0].isdigit() for ln in mine) == 111


@pytest.mark.parametrize(
    "flags",
    [["--gap-open", "10"], ["--gap-extend", "1"], ["--gap-open", "1", "--gap-extend", "3"], ["--align-top-k", "0"]],
)
def test_cli_gap_and_align_errors_exit_2(capsys, flags):
    from swtpu_torch.cli import main as tmain

    args = ["--query", str(DATA / "queries" / "P02232.fasta"), "--db", str(DATA / "uniprot_subset.fasta"), "--device", "cpu"]
    assert tmain(args + flags) == 2
    assert "error" in capsys.readouterr().err
