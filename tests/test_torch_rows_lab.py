"""The row-parallel lab kernels (K10) of the port.

On the CPU the port's wrappers (``swtpu_torch.ops.rows_lab``) run their
plain PyTorch version; these cases hold them, exactly, to
``tools/pallas_lab.py``'s four JAX kernels in interpret mode on the same
numpy inputs, built as that tool's ``main`` builds them: ``sw_v2`` on the
block-diagonal lhs at ``tile_b`` 8, ``sw_v3`` at ``tile_b`` 16, ``sw_v4`` (at
``n_ilp`` 2 and 4) and ``sw_v41`` with the gap folded into the int8 lhs,
each at strips 8 and 16 (16 on the shapes that compile quickly), the rebase ``j * gap``.  Each subject holds L/4 to
L residues (the tool's own rows stop at L - 1, which would leave an L = 1
bucket empty).  The CUDA kernels are held to the plain version on the card
(tests/test_torch_gpu.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swtpu.matrices import blosum50_ref
from swtpu.ops import xla_sw
from swtpu_torch.ops import rows_lab
from swtpu_torch.ops.profile import PAD_SUBJECT
from tools import pallas_lab

MAT = blosum50_ref()
# (B, L, Q, gap): B a multiple of every tile_b (sw_v41 drops a remainder)
SHAPES = [(16, 64, 40, 2), (32, 60, 37, 2), (16, 1, 8, 3), (16, 200, 70, 5)]
# (variant, JAX strip, n_ilp): every variant at strip 8, v4 at ILP 2 and 4, on every shape; strip 16
# on the shapes whose interpret-mode compile stays within a few seconds (it grows with strip x ILP x
# log2(L): sw_v4 at strip 16, ILP 4 and L = 200 takes ~30 s to compile on the CPU).
STRIP8 = [("v2", 8, 1), ("v3", 8, 1), ("v4", 8, 2), ("v4", 8, 4), ("v41", 8, 1)]
STRIP16 = [("v2", 16, 1), ("v3", 16, 1), ("v4", 16, 2), ("v4", 16, 4), ("v41", 16, 1)]
CASES = ([(shape, cfg) for shape in SHAPES for cfg in STRIP8]
         + [((16, 1, 8, 3), cfg) for cfg in STRIP16]
         + [((32, 60, 37, 2), cfg) for cfg in STRIP16 if cfg[0] in ("v2", "v41")]
         + [((16, 200, 70, 5), ("v41", 16, 1))])


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These tensors are small: intra-op threads gain nothing here, and next
    to other test workers on the same cores they only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(B, L, Q, seed):
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 25, Q).astype(np.int8)
    subj = np.full((B, L), PAD_SUBJECT, np.int8)
    for i in range(B):
        n = int(rng.integers(L // 4, L + 1))
        subj[i, :n] = rng.integers(0, 25, n)
    return q, subj


def _jax(variant, prof, subj, gap, strip, ilp):
    B, L = subj.shape
    reb = jnp.broadcast_to((jnp.arange(L, dtype=jnp.int32) * gap)[None, :], (B, L))
    sd = jnp.asarray(subj)
    if variant == "v2":
        lhs = pallas_lab.expand_profile_blockdiag(prof, strip, 8)
        return pallas_lab.sw_v2(jnp.asarray(lhs), sd, reb, gap=gap, strip=strip, tile_b=8, interpret=True)
    if variant == "v3":
        lhs = pallas_lab.expand_profile_blockdiag(prof, strip, 8)
        return pallas_lab.sw_v3(jnp.asarray(lhs), sd, reb, gap=gap, strip=strip, tile_b=16, interpret=True)
    lhs = jnp.asarray(pallas_lab.expand_profile_blockdiag(prof + np.int8(gap), strip, 8))  # gap folded in int8
    if variant == "v4":
        return pallas_lab.sw_v4(lhs, sd, reb, gap=gap, strip=strip, tile_b=16, n_ilp=ilp, interpret=True)
    return pallas_lab.sw_v41(lhs, sd, reb, gap=gap, strip=strip, tile_b=16, interpret=True)


def _port(variant, prof, subj, gap, strip, ilp):
    """The port's wrapper at its own band height: the JAX strip 8 is 16
    here, 16 is 32; v4 runs at 32."""
    kw = dict(gap=gap, strip=32 if variant == "v4" or strip == 16 else 16)
    if variant == "v4":
        kw["ilp"] = ilp
    return rows_lab.WRAPPERS[variant](torch.from_numpy(prof), torch.from_numpy(subj), **kw)


@pytest.mark.parametrize("shape,config", CASES, ids=[f"{s}-{c}" for s, c in CASES])
def test_port_matches_pallas_lab(shape, config):
    (B, L, Q, gap), (variant, strip, ilp) = shape, config
    q, subj = _inputs(B, L, Q, seed=B + L + Q)
    prof = xla_sw.make_profile(q, MAT, pad_rows_to=strip)
    want = np.asarray(_jax(variant, prof, subj, gap, strip, ilp))
    before = rows_lab.WRAPPERS[variant].launches
    got = _port(variant, prof, subj, gap, strip, ilp)
    assert rows_lab.WRAPPERS[variant].launches == before  # the CPU runs the plain version: no launch
    assert got.dtype == torch.int32 and got.shape == (B,)
    assert np.array_equal(got.numpy(), want), (got.numpy(), want)
    assert np.array_equal(want, np.asarray(xla_sw.sw_score_bucket(prof, subj, gap=gap, strip=strip)))


def _numpy_sw(prof, subj, gap):
    """Smith-Waterman maxima in H-space, cell by cell over the columns (an
    independent statement: no u-space, no cummax)."""
    B, L = subj.shape
    p = prof.astype(np.int64)
    idx = subj.astype(np.int64) & 31
    h = np.zeros((B, L + 1), np.int64)
    best = np.zeros(B, np.int64)
    for r in range(p.shape[0]):
        prev = h.copy()
        for j in range(1, L + 1):
            h[:, j] = np.maximum.reduce([np.zeros(B, np.int64), prev[:, j - 1] + p[r][idx[:, j - 1]],
                                         prev[:, j] - gap, h[:, j - 1] - gap])
        best = np.maximum(best, h.max(1))
    return best


@pytest.mark.parametrize("gap", [113, 200])
def test_gap_above_112_matches_its_plain_version(gap):
    """Past 15 + gap = 127 the JAX kernels' int8 lhs wraps (v4, v41), so a
    gap above 112 is held to the port's own plain version only (and that to
    a cell-by-cell H-space recurrence); the CUDA kernels fold the gap into an
    int32 accumulator, exact at any gap (tests/test_torch_gpu.py)."""
    from swtpu_torch.ops.profile import make_profile

    q, subj = _inputs(16, 60, 37, seed=gap)
    subj[3, 10:20] = q[5:15]  # a planted match long enough to outscore the gaps
    prof = make_profile(q, MAT, pad_rows_to=32)
    want = _numpy_sw(prof, subj, gap)
    assert want.max() > 0
    plain = rows_lab.rows_lab_plain(torch.from_numpy(prof), torch.from_numpy(subj)[None], gap=gap)
    assert plain.shape == (1, 16) and np.array_equal(plain[0].numpy(), want)
    for v, s, ilp in rows_lab.INSTANCES:
        kw = dict(ilp=ilp) if v == "v4" else {}
        got = rows_lab.WRAPPERS[v](torch.from_numpy(prof), torch.from_numpy(subj), gap=gap, strip=s, **kw)
        assert np.array_equal(got.numpy(), want), (v, s, ilp)


def test_stack_scores_every_chunk():
    """A (C, B, L) stack gives (C, B), each chunk its own bucket's scores."""
    from swtpu_torch.ops.profile import make_profile

    q, subj = _inputs(24, 45, 30, seed=7)
    prof = torch.from_numpy(make_profile(q, MAT, pad_rows_to=16))
    stack = torch.from_numpy(subj).reshape(3, 8, 45)
    for v, s, ilp in rows_lab.INSTANCES:
        kw = dict(ilp=ilp) if v == "v4" else {}
        got = rows_lab.WRAPPERS[v](prof, stack, gap=2, strip=s, **kw)
        assert got.shape == (3, 8)
        for c in range(3):
            assert torch.equal(got[c], rows_lab.WRAPPERS[v](prof, stack[c], gap=2, strip=s, **kw))


def test_instances_cover_every_variant_and_knob():
    assert rows_lab.INSTANCES == (("v2", 16, 1), ("v2", 32, 1), ("v3", 16, 1), ("v3", 32, 1), ("v4", 32, 2),
                                  ("v4", 32, 4), ("v41", 16, 1), ("v41", 32, 1))
    assert set(rows_lab.WRAPPERS) == set(rows_lab.VARIANTS)


@pytest.mark.parametrize("variant", rows_lab.VARIANTS)
def test_wrappers_check_their_knobs_and_inputs(variant):
    from swtpu_torch.ops.profile import make_profile

    q, subj = _inputs(8, 20, 10, seed=1)
    prof, st = torch.from_numpy(make_profile(q, MAT, pad_rows_to=16)), torch.from_numpy(subj)
    fn = rows_lab.WRAPPERS[variant]
    bad = [
        (lambda: fn(prof, st, gap=2, strip=8), "strip must be"),
        (lambda: fn(prof, st, gap=2, strip=64), "strip must be"),
        (lambda: fn(prof.int(), st, gap=2), "int8"),
        (lambda: fn(prof[:, :31].contiguous(), st, gap=2), r"\(qpad, 32\)"),
        (lambda: fn(prof[0], st, gap=2), r"\(qpad, 32\)"),
        (lambda: fn(prof[:0], st, gap=2), r"\(qpad, 32\)"),
        (lambda: fn(prof, st.int(), gap=2), "subjects must be"),
        (lambda: fn(prof, st[0], gap=2), "subjects must be"),
        (lambda: fn(prof, st, gap=-1), "gap"),
    ]
    if variant == "v4":
        bad += [(lambda: fn(prof, st, gap=2, strip=16), "strip must be"),
                (lambda: fn(prof, st, gap=2, ilp=3), "ilp must be"),
                (lambda: fn(prof, st, gap=2, ilp=1), "ilp must be")]
    for call, match in bad:
        with pytest.raises(ValueError, match=match):
            call()


def test_pallas_lab_tool_exits_1_without_cuda(monkeypatch, capsys):
    from swtpu_torch.tools import pallas_lab as tool

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tool.main([]) == 1
    assert tool.main(["--swissprot"]) == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_pallas_lab_tool_inputs_are_the_jax_tools():
    """The tool's synthetic bucket is ``tools/pallas_lab.py``'s: the same
    generator calls in the same order."""
    from swtpu_torch.tools import pallas_lab as tool

    B, L, Q = 40, 64, 30
    rng = np.random.default_rng(0)
    q = rng.integers(0, 25, Q).astype(np.int8)
    subj = np.full((B, L), xla_sw.PAD_SUBJECT, np.int8)
    for i in range(B):
        n = int(rng.integers(L // 4, L))
        subj[i, :n] = rng.integers(0, 25, n)
    got_q, got_subj = tool.synthetic_bucket(B, L, Q)
    assert np.array_equal(got_q, q) and np.array_equal(got_subj, subj)


def test_pallas_lab_tool_launches_every_instance_on_the_row_groups():
    """``--swissprot``'s launches on a small database's row-path groups: K2,
    then one entry an instantiation, each equal to K2; the groups' scores
    reduce to the row engine's search."""
    from swtpu_torch import synth
    from swtpu_torch.config import SWConfig
    from swtpu_torch.models.search import SearchEngine
    from swtpu_torch.tools import buckets
    from swtpu_torch.tools import pallas_lab as tool

    assert sorted((fn.__name__, tuple(sorted(kw.items()))) for fn, kw in tool.VARIANTS.values()) == sorted(
        (rows_lab.WRAPPERS[v].__name__, tuple(sorted(dict(strip=s, **({"ilp": i} if v == "v4" else {})).items())))
        for v, s, i in rows_lab.INSTANCES)
    engine = SearchEngine(SWConfig(use_wave=False, use_pallas=True), device="cpu")
    rg = buckets.swissprot_rows(db=synth.synth_database(300, seed=0), engine=engine)
    assert rg.groups and rg.packed.seg_groups
    fns = tool.launches(rg)
    assert list(fns) == ["K2", *tool.VARIANTS]
    g = min(rg.groups, key=lambda g: g.stack.numel())
    k2 = fns["K2"](g)
    for name in tool.VARIANTS:
        assert torch.equal(fns[name](g), k2), name
    flats = [fns["v41/S16"](grp) for grp in rg.groups]
    assert np.array_equal(rg.reduce(flats), engine.search(rg.query, rg.db).scores)
    with pytest.raises(ValueError, match="row-path engine"):
        buckets.swissprot_rows(db=rg.db, engine=SearchEngine(device="cpu"))
