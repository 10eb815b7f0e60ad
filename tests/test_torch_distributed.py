"""The port's multi-process search (swtpu_torch.parallel.distributed and
.launch) held to swtpu's on the CPU.

Two fleets of real processes (2 and 3 ranks, gloo on 127.0.0.1, one free
port each, every process killed on expiry) run a list of jobs each, and the
launcher runs as 2 ranks with ``--json`` and as one process with text
output; all start together in one module fixture and import only torch.
The jobs cover swtpu's cases (tests/test_distributed.py): even and odd
shards, the row path and the wavefront path, affine gaps, ``full_scores``,
``search_many`` plain, with the prefilter and with E-values, a local mesh
engine and an empty shard.  Hits must equal swtpu's single-process
``SearchEngine.top_k`` on the whole database; null statistics and E-values
must equal swtpu's own merge of the same shards (its ``_merge_hits`` run in
this process, one thread a shard, ``process_allgather`` stubbed to stack
the shards' payloads) within 1e-9 relative, on shards that are copies of
one another (no skew).  Then the port's three divergences, each on a case
that shows it: D13 (a process without null statistics: every process
still gathers the same payload and returns none), D14 (homologs all on one
shard: the port's E-values are the whole database's, swtpu's are not) and
D15 (a trim above the merged list raises).  And the single OOM retry with
its unretried deterministic error, ``initialize`` and ``process_device``.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap
import threading
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from swtpu.config import SWConfig as JConfig
from swtpu.io.fasta import parse_database as j_parse_database
from swtpu.io.fasta import parse_query as j_parse_query
from swtpu.models.search import SearchEngine as JEngine
from swtpu.parallel import distributed as JD
from swtpu_torch.config import SWConfig
from swtpu_torch.alphabet import encode_str
from swtpu_torch.io.fasta import Query, database_from_sequences, write_fasta
from swtpu_torch.models.search import SearchEngine
from swtpu_torch.ops import _build
from swtpu_torch.parallel import distributed as D
from swtpu_torch.stats import hit_significance
from swtpu_torch.utils.memory import is_oom, reraise_oom

REPO = Path(__file__).resolve().parent.parent
ALPHABET = "ARNDCQEGHILKMFPSTWYV"
TIMEOUT = 240  # seconds a spawned process may take before it is killed

WORKER = textwrap.dedent(
    """
    import json, os, sys
    sys.path.insert(0, os.environ["SWTPU_REPO"])
    import torch
    torch.set_num_threads(1)
    import torch.distributed as dist
    from swtpu_torch.config import SWConfig
    from swtpu_torch.io.fasta import parse_database, parse_query
    from swtpu_torch.parallel import distributed as D

    pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    D.initialize(f"127.0.0.1:{port}", nproc, pid, timeout=120)
    calls = [0]
    _gather = dist.all_gather
    def counted(*a, **k):
        calls[0] += 1
        return _gather(*a, **k)
    dist.all_gather = counted

    for job in json.loads(os.environ["SWTPU_JOBS"]):
        db = parse_database(job["db"])
        queries = [parse_query(p) for p in job["queries"]]
        eng = D.DistributedSearchEngine(SWConfig(**job["config"]), full_scores=job.get("full", False), device="cpu")
        if job.get("drop_null") == pid:  # this process's local results lose their null statistics
            local = eng._search_local
            def dropped(*a, local=local):
                out = local(*a)
                for r in (out if isinstance(out, list) else [out]):
                    r.null_stats = None
                return out
            eng._search_local = dropped
        shard, base = eng.shard_of(db)
        calls[0] = 0
        if job["method"] == "search":
            res = [eng.search(queries[0], shard, base, top_k=job["top_k"])]
        else:
            res = eng.search_many(queries, shard, base, top_k=job["top_k"])
        out = {"job": job["name"], "pid": pid, "base": base, "n_local": int(shard.n), "collectives": calls[0],
               "hits": [r.hits for r in res],
               "local_sizes": [None if r.local_scores is None else int(r.local_scores.shape[0]) for r in res]}
        if job["config"].get("evalue"):
            out["null"], out["stats"] = [], []
            for r in res:
                ns = r.null_stats
                out["null"].append(None if ns is None else dict(
                    count=ns.count, total=ns.total, total_sq=ns.total_sq, n_subjects=ns.n_subjects,
                    mean_subject_length=ns.mean_subject_length, top_vals=[float(v) for v in ns.top_vals]))
                try:
                    out["stats"].append([[h.evalue, h.bits] for h in r.hit_stats()])
                except ValueError as e:
                    out["stats"].append(str(e))
        print("RESULT " + json.dumps(out), flush=True)
    dist.destroy_process_group()
    """
)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _seqs(seed, n, lo=20, hi=120):
    rng = np.random.default_rng(seed)
    return ["".join(ALPHABET[i] for i in rng.integers(0, 20, int(rng.integers(lo, hi)))) for _ in range(n)]


def _env(**extra):
    env = {"SWTPU_REPO": str(REPO), "PATH": os.environ.get("PATH", "/usr/bin:/bin"), "HOME": os.environ.get("HOME", "/tmp"),
           "OMP_NUM_THREADS": "1", **extra}
    for key in ("TMPDIR", "LD_LIBRARY_PATH"):
        if key in os.environ:
            env[key] = os.environ[key]
    return env


def _collect(procs):
    """Wait for every process (killing all on expiry) and return their
    stdout texts; a failed process fails the fixture with its stderr."""
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT)
            assert p.returncode == 0, f"process failed:\n{err[-3000:]}"
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The jobs' databases and queries, as FASTA files."""
    d = tmp_path_factory.mktemp("fleet")
    out = {}
    for name, seqs in {
        "db30": _seqs(17, 30), "db31": _seqs(18, 31), "db24": _seqs(19, 24), "db28": _seqs(23, 28),
        "db2": _seqs(24, 2),
        # copies of one block, one a process: shards with the same scores (no skew)
        "copies2": _seqs(25, 45) * 2, "copies3": _seqs(25, 45) * 3,
    }.items():
        write_fasta(d / f"{name}.fasta", seqs)
        out[name] = (str(d / f"{name}.fasta"), seqs)
    for name, (db, i, lo, hi) in {
        "q30": ("db30", 7, 5, 60), "q31": ("db31", 7, 5, 60), "q24": ("db24", 7, 5, 60), "q2": ("db2", 0, 0, 15),
        "qc": ("copies2", 3, 0, 50),
        **{f"m{j}": ("db28", 2 + j, 0, ln) for j, ln in enumerate((25, 40, 55, 70))},
    }.items():
        write_fasta(d / f"{name}.fasta", [out[db][1][i][lo:hi]], headers=[name])
        out[name] = (str(d / f"{name}.fasta"), None)
    return out


ROWS = dict(batch_rows=8, length_quantum=8, use_wave=False)
MANY = ["m0", "m1", "m2", "m3"]


def _jobs(files, nproc):
    """(name, config, database, queries, method, top_k, extra) of each job of
    the nproc-rank fleet."""
    if nproc == 2:
        jobs = [
            ("rows_full", ROWS, "db30", ["q30"], "search", 5, dict(full=True)),
            ("wave", {}, "db24", ["q24"], "search", 5, {}),
            ("affine", dict(gap_open=10, gap_extend=1), "db24", ["q24"], "search", 5, {}),
            ("mesh_local", dict(ROWS, mesh_shape=(2,)), "db30", ["q30"], "search", 5, {}),
            ("many", {}, "db28", MANY, "search_many", 5, {}),
            ("many_prefilter", dict(prefilter=0.5, top_k=5), "db28", MANY, "search_many", 5, {}),
            ("many_evalue", dict(evalue=True), "copies2", ["qc", *MANY], "search_many", 5, {}),
            ("drop_null", dict(evalue=True), "copies2", ["qc"], "search", 5, dict(drop_null=1)),
        ]
    else:
        jobs = [
            ("rows_odd", ROWS, "db31", ["q31"], "search", 5, {}),
            ("empty_shard", {}, "db2", ["q2"], "search", 5, {}),
            ("many_evalue", dict(evalue=True), "copies3", ["qc", *MANY], "search_many", 5, {}),
        ]
    return [dict(name=n, config=c, db=files[d][0], queries=[files[q][0] for q in qs], method=m, top_k=k, **x)
            for n, c, d, qs, m, k, x in jobs]


@pytest.fixture(scope="module")
def fleets(files):
    """Every spawned process at once: the 2- and 3-rank fleets and the
    launcher (2 ranks with --json, one process with text).  Returns
    {(nproc, job): {pid: result}} and the launcher's outputs."""
    procs, kinds = [], []
    for nproc in (2, 3):
        port, env = _free_port(), _env(SWTPU_JOBS=json.dumps(_jobs(files, nproc)))
        for pid in range(nproc):
            procs.append(subprocess.Popen([sys.executable, "-c", WORKER, str(pid), str(nproc), str(port)],
                                          stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env))
            kinds.append(("fleet", nproc))
    base = [sys.executable, "-m", "swtpu_torch.parallel.launch", "--query", files["q30"][0], "--db", files["db30"][0],
            "--top-k", "4", "--device", "cpu"]
    port = _free_port()
    for pid in range(2):
        args = base + ["--json", "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2", "--process-id", str(pid)]
        procs.append(subprocess.Popen(args, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=_env()))
        kinds.append(("launch_json", 2))
    procs.append(subprocess.Popen(base, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=_env()))
    kinds.append(("launch_text", 1))
    results, launch = {}, {"json": [], "text": None}
    for (kind, nproc), out in zip(kinds, _collect(procs)):
        if kind == "fleet":
            for line in out.splitlines():
                if line.startswith("RESULT "):
                    d = json.loads(line[len("RESULT "):])
                    results.setdefault((nproc, d["job"]), {})[d["pid"]] = d
        elif kind == "launch_json":
            launch["json"].append(json.loads([ln for ln in out.splitlines() if ln.startswith("{")][0]))
        else:
            launch["text"] = out
    return results, launch


def _swtpu_top_k(files, db, query, **kw):
    eng = JEngine(JConfig(batch_rows=8, length_quantum=8, **kw))
    return [[int(i), int(s)] for i, s in eng.search(j_parse_query(files[query][0]), j_parse_database(files[db][0])).top_k(5)]


FLEET_CASES = [
    (2, "rows_full", "db30", "q30", {}),
    (2, "wave", "db24", "q24", {}),
    (2, "affine", "db24", "q24", dict(use_wave=True, interpret=True, gap_open=10, gap_extend=1)),
    (2, "mesh_local", "db30", "q30", {}),
    (3, "rows_odd", "db31", "q31", {}),
    (3, "empty_shard", "db2", "q2", {}),
]


@pytest.mark.parametrize("nproc,job,db,query,jkw", FLEET_CASES, ids=[c[1] for c in FLEET_CASES])
def test_fleet_search_matches_swtpu(files, fleets, nproc, job, db, query, jkw):
    """Every process prints the same global top-K, swtpu's whole-database
    top-K; the shards tile the database (uneven for an odd count, one empty
    for 2 sequences on 3 processes) and the top-K-first mode keeps no full
    local array, while full_scores keeps the shard's."""
    results, _ = fleets
    res = results[nproc, job]
    assert sorted(res) == list(range(nproc))
    for p in range(nproc):
        assert res[p]["hits"] == res[0]["hits"] and res[p]["collectives"] == 1
        # the row path has no device top-K: its local array exists as swtpu's
        # XLA path's does; a shard of fewer sequences than K takes the full
        # array (the device top-K's short-candidate fallback)
        if job != "empty_shard":
            keeps = job.startswith(("rows", "mesh"))
            assert res[p]["local_sizes"] == [res[p]["n_local"] if keeps else None]
    n_seqs = len(files[db][1])
    assert sum(res[p]["n_local"] for p in range(nproc)) == n_seqs
    assert [res[p]["base"] for p in range(nproc)] == list(np.cumsum([0] + [res[p]["n_local"] for p in range(nproc - 1)]))
    if n_seqs % nproc:
        assert len({res[p]["n_local"] for p in range(nproc)}) > 1
    assert res[0]["hits"] == [_swtpu_top_k(files, db, query, **jkw)]


@pytest.mark.parametrize("job", ["many", "many_prefilter"])
def test_fleet_search_many_matches_swtpu(files, fleets, job):
    """One collective for the whole batch; each query's hits are swtpu's
    whole-database top-K (the prefilter ranks each shard on its own, as
    swtpu's fleet does)."""
    results, _ = fleets
    res = results[2, job]
    assert res[0]["hits"] == res[1]["hits"] and res[0]["collectives"] == res[1]["collectives"] == 1
    assert res[0]["hits"] == [_swtpu_top_k(files, "db28", q)[:5] for q in MANY]


class _Collective:
    """A stand-in for a collective across n threads, one a process:
    ``gather(x)`` returns every thread's x stacked by rank (a pytree of
    arrays for swtpu's ``process_allgather``, an array for the port's
    ``_all_gather``); ``run(fn)`` calls ``fn(p)`` in thread p."""

    def __init__(self, n):
        self.n, self.slots = n, [None] * n
        self.barrier, self.local = threading.Barrier(n, timeout=120), threading.local()

    def gather(self, x):
        self.slots[self.local.p] = x
        self.barrier.wait()
        out = jax.tree_util.tree_map(lambda *xs: np.stack([np.asarray(v) for v in xs]), *self.slots)
        self.barrier.wait()
        return out

    def run(self, fn):
        results, errors = [None] * self.n, []

        def one(p):
            self.local.p = p
            try:
                results[p] = fn(p)
            except BaseException as e:  # noqa: BLE001 - re-raised below, once every thread has ended
                errors.append(e)
                self.barrier.abort()

        threads = [threading.Thread(target=one, args=(p,)) for p in range(self.n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=180)
            assert not t.is_alive()
        if errors:
            raise errors[0]
        return results


def _swtpu_fleet(monkeypatch, db_path, query_paths, nproc, **kw):
    """swtpu's DistributedSearchEngine.search_many on nproc shards of the
    database, in this process: each shard's local search, then its
    ``_merge_hits`` in one thread a shard, ``process_allgather`` stubbed."""
    from jax.experimental import multihost_utils

    jdb, jq = j_parse_database(db_path), [j_parse_query(q) for q in query_paths]
    engines = []
    for p in range(nproc):
        eng = JD.DistributedSearchEngine(JConfig(**kw))
        eng.process_id, eng.process_count = p, nproc
        engines.append(eng)
    shards = [eng.shard_of(jdb) for eng in engines]
    local = [eng._search_local("search_many", jq, shard, 5) for eng, (shard, _) in zip(engines, shards)]
    coll = _Collective(nproc)
    monkeypatch.setattr(multihost_utils, "process_allgather", coll.gather)
    return coll.run(lambda p: engines[p]._merge_hits(local[p], shards[p][0], shards[p][1], 5))


def _port_fleet(db, queries, nproc, **kw):
    """The port's DistributedSearchEngine.search_many on nproc shards, in
    this process, one thread a process, ``_all_gather`` stubbed."""
    coll = _Collective(nproc)
    engines = []
    for p in range(nproc):
        eng = D.DistributedSearchEngine(SWConfig(**kw), device="cpu")
        eng.process_id, eng.process_count = p, nproc
        eng._all_gather = coll.gather
        engines.append(eng)
    return coll.run(lambda p: engines[p].search_many(queries, *engines[p].shard_of(db), top_k=5))


def _rel(a, b):
    return abs(a - b) <= 1e-9 * max(abs(a), abs(b))


@pytest.mark.parametrize("nproc", [2, 3])
def test_fleet_null_and_evalues_match_swtpu_merge(files, fleets, monkeypatch, nproc):
    """On shards that are copies of one another: the fleet's merged null
    statistics and E-values equal swtpu's merge of the same shards (within
    1e-9 relative; the f32 sums travel as swtpu's do), identical on every
    process, with two collectives a batch; the hits are swtpu's
    whole-database top-K."""
    results, _ = fleets
    res = results[nproc, "many_evalue"]
    name = f"copies{nproc}"
    qpaths = [files[q][0] for q in ["qc", *MANY]]
    want = _swtpu_fleet(monkeypatch, files[name][0], qpaths, nproc, evalue=True)[0]
    jeng = JEngine(JConfig())
    jdb = j_parse_database(files[name][0])
    for p in range(nproc):
        assert res[p]["collectives"] == 2
        assert res[p]["hits"] == res[0]["hits"] and res[p]["null"] == res[0]["null"] and res[p]["stats"] == res[0]["stats"]
    for qi, (w, got, stats) in enumerate(zip(want, res[0]["null"], res[0]["stats"])):
        assert res[0]["hits"][qi] == [[int(i), int(s)] for i, s in jeng.search(j_parse_query(qpaths[qi]), jdb).top_k(5)]
        assert [list(h) for h in w.hits] == res[0]["hits"][qi]
        ns = w.null_stats
        assert got["count"] == ns.count and got["n_subjects"] == ns.n_subjects
        for key in ("total", "total_sq", "mean_subject_length"):
            assert _rel(got[key], getattr(ns, key)), key
        cut = int(np.ceil(0.02 * ns.count))
        assert got["top_vals"][:cut] == list(np.asarray(ns.top_vals)[:cut])
        for (ev, bits), h in zip(stats, w.hit_stats()):
            assert _rel(ev, h.evalue) and _rel(bits, h.bits)


def test_d13_missing_null_statistics_on_one_process(fleets):
    """D13: whether the null scalars travel is the config's evalue, so a
    process whose local results lack them gathers the same payload as the
    others: no hang; every process returns the same hits and no null
    statistics, and hit_stats says why."""
    results, _ = fleets
    res = results[2, "drop_null"]
    assert res[0]["hits"] == res[1]["hits"] and res[0]["collectives"] == res[1]["collectives"] == 2
    for p in range(2):
        assert res[p]["null"] == [None] and "merged null statistics" in res[p]["stats"][0]


def _fasta(tmp_path, name, seqs):
    write_fasta(tmp_path / name, seqs)
    return str(tmp_path / name)


def test_d14_skewed_shards_keep_the_global_trim(monkeypatch, tmp_path):
    """D14: every homolog of the query on shard 0.  Each process ships its
    top ceil(trim x the global count) values, so the port's merged fit is
    the whole database's pooled fit; swtpu's merge ships ceil(trim x the
    largest shard count) a process and fits homolog scores of shard 0 into
    the body, so its E-values differ."""
    rng = np.random.default_rng(31)
    core = "".join(rng.choice(list(ALPHABET), 60))
    homologs = ["".join(rng.choice(list(ALPHABET), 10)) + core + "".join(rng.choice(list(ALPHABET), 10)) for _ in range(12)]
    seqs = homologs + _seqs(32, 188) + _seqs(33, 200)  # shard 0 = the first 200
    db, q = database_from_sequences(seqs), Query("q", encode_str(core), core)
    got = _port_fleet(db, [q], 2, evalue=True)[0][0]
    single = SearchEngine(SWConfig(evalue=True), device="cpu").search(q, db)
    whole = hit_significance(single.null_stats, single.top_k(5), length_correct=False)
    assert got.hits == single.top_k(5)
    assert [(h.evalue, h.bits) for h in got.hit_stats()] == [(h.evalue, h.bits) for h in whole]
    swtpu = _swtpu_fleet(monkeypatch, _fasta(tmp_path, "db.fasta", seqs), [_fasta(tmp_path, "q.fasta", [core])], 2, evalue=True)
    assert swtpu[0][0].hits == got.hits
    assert [h.evalue for h in swtpu[0][0].hit_stats()] != [h.evalue for h in whole]


def test_d15_trim_above_the_merge_raises(monkeypatch, tmp_path):
    """D15: hit_stats at a trim whose top scores the merge does not hold
    raises, as SearchResult.top_k_stats does; swtpu's clamps silently.  The
    default trim works."""
    seqs = _seqs(41, 120)
    db, q = database_from_sequences(seqs), Query("q", encode_str(seqs[3][:50]), seqs[3][:50])
    got = _port_fleet(db, [q], 2, evalue=True)[0][0]
    assert len(got.hit_stats()) == 5
    with pytest.raises(ValueError, match="merge covers"):
        got.hit_stats(trim=0.5)
    swtpu = _swtpu_fleet(
        monkeypatch, _fasta(tmp_path, "db.fasta", seqs), [_fasta(tmp_path, "q.fasta", [seqs[3][:50]])], 2, evalue=True
    )
    assert len(swtpu[0][0].hit_stats(trim=0.5)) == 5  # swtpu fits at whatever its list covers


def test_launcher_json_and_text(files, fleets):
    """python -m swtpu_torch.parallel.launch: 2 ranks with --json print the
    same hits, swtpu's top-4, with their shard and timings; one process
    prints swtpu's text format."""
    _, launch = fleets
    want = _swtpu_top_k(files, "db30", "q30", use_wave=False)[:4]
    outs = sorted(launch["json"], key=lambda d: d["process"])
    assert [d["process"] for d in outs] == [0, 1] and all(d["n_processes"] == 2 for d in outs)
    assert outs[0]["hits"] == outs[1]["hits"] == want
    assert [d["shard_base"] for d in outs] == [0, outs[0]["n_local"]] and sum(d["n_local"] for d in outs) == 30
    for d in outs:
        assert d["device"] == "cpu" and d["route"] == "resident"
        assert all(d[k] >= 0 for k in ("wall_seconds", "parse_seconds", "pack_seconds", "search_seconds", "collective_seconds"))
    lines = launch["text"].splitlines()
    assert lines[0].startswith("# process 0/1 shard [0, 30) wall ")
    assert lines[1:] == [f"{i}:{s}" for i, s in want]


# --- the single retry, initialize, the process's device ----------------------------------


def _db_and_query(seed=4):
    seqs = _seqs(seed, 10, 40, 41)
    rng = np.random.default_rng(seed)
    return database_from_sequences(seqs), Query("q", np.asarray(rng.integers(0, 20, 20), np.int8), "")


def test_deterministic_error_propagates_unretried():
    """A failure that is not memory exhaustion propagates at once (no
    streaming retry hides it), a CUDA fault included."""
    db, q = _db_and_query()
    eng = D.DistributedSearchEngine(SWConfig(), device="cpu")
    for exc in (ValueError("deterministic bug"), RuntimeError("sw_wave failed: an illegal memory access was encountered (700)")):
        class Boom:
            def search(self, *a, exc=exc, **k):
                raise exc

        eng._engines[5] = Boom()
        with pytest.raises(type(exc), match=str(exc)[:20]):
            eng.search(q, db, 0, top_k=5)
        assert not is_oom(exc)


def _check_error():
    try:
        _build.check(2, lambda rc: b"out of memory", "sw_wave")
    except RuntimeError as e:
        return e


@pytest.mark.parametrize(
    "exc",
    [torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 4.00 GiB"), "check", "hint"],
    ids=["torch", "kernel_entry_point", "engine_hint"],
)
def test_oom_retries_once_streaming(exc):
    """An OOM-classified failure (torch's, a kernel entry point's
    cudaErrorMemoryAllocation through _build.check, or the engine's own
    hint) retries once through a streaming engine and gives the merged
    top-K; when the retry fails too, both failures are chained."""
    if exc == "check":
        exc = _check_error()
    elif exc == "hint":
        with pytest.raises(RuntimeError) as info:
            reraise_oom(torch.cuda.OutOfMemoryError("CUDA out of memory"), "scoring")
        exc = info.value
    assert is_oom(exc)
    db, q = _db_and_query()
    eng = D.DistributedSearchEngine(SWConfig(), device="cpu")

    class FakeOOM:
        def search(self, *a, **k):
            raise exc

    eng._engines[3] = FakeOOM()
    res = eng.search(q, db, 0, top_k=3)
    assert res.hits == SearchEngine(SWConfig(), device="cpu").search(q, db).top_k(3)

    class Again(Exception):
        pass

    retried = []
    orig = eng._local_engine

    def failing(config):
        retried.append(config.device_resident)
        e = orig(config)
        e.search = lambda *a, **k: (_ for _ in ()).throw(Again("the retry failed too"))
        return e

    eng._local_engine = failing
    with pytest.raises(Again) as info:
        eng.search(q, db, 0, top_k=3)
    assert retried == [False] and info.value.__cause__ is exc


def test_initialize_is_a_noop_for_one_process_and_reads_torchrun(monkeypatch):
    import torch.distributed as dist

    calls = []
    monkeypatch.setattr(dist, "init_process_group", lambda *a, **k: calls.append((a, k)))
    for key in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    D.initialize()
    D.initialize(num_processes=1)
    assert calls == [] and not dist.is_initialized()
    with pytest.raises(ValueError, match="coordinator_address"):
        D.initialize(num_processes=2)
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "2")
    monkeypatch.setenv("MASTER_ADDR", "10.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "9911")
    D.initialize(timeout=30)
    (args, kw), = calls
    assert args == ("gloo",) and kw["init_method"] == "tcp://10.0.0.1:9911"
    assert (kw["world_size"], kw["rank"], kw["timeout"].total_seconds()) == (4, 2, 30)


def test_process_device(monkeypatch):
    """A card a process: LOCAL_RANK, else the process id, modulo the cards;
    the CPU only when asked; no card and no request raises."""
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    assert D.process_device(3, "cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        D.process_device(0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert D.process_device(3) == D.process_device(1, "cuda") == torch.device("cuda", 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert D.process_device(3) == torch.device("cuda", 1)
    monkeypatch.setenv("LOCAL_RANK", "0")
    assert D.process_device(3) == torch.device("cuda", 0)
    assert D.process_device(3, "cuda:1") == torch.device("cuda", 1)
