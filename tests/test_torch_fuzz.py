"""The card fuzz and the GPU battery, run on the CPU.

On the CPU a kernel wrapper runs its plain version, so each of
``swtpu_torch.tools.card_fuzz``'s functions here checks its own oracle
sample; this file also holds every case's scores to swtpu's
``xla_sw.sw_score_bucket`` (linear) or oracle (affine) on the same numpy
inputs, at 2-3 cases with query lengths, widths and lanes capped at 48.
``main_thresholds`` runs with the two thresholds patched down to CPU sizes,
and must hit both sides of each at every shard count.  A wrapper that is
off by one is caught and reported with its replay key.  The battery
(``swtpu_torch.tools.gpu_validate``) runs its subset, saturation and
affine-engine checks with ``--device cpu`` (the 10k-golden checks take
seconds more here; the card runs them).
"""

import contextlib
import functools
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swtpu.matrices import get_matrix as ref_matrix
from swtpu.ops import oracle as ref_oracle
from swtpu.ops import xla_sw
from swtpu_torch.ops import bucket_sw, wave_sw
from swtpu_torch.tools import card_fuzz, gpu_validate

CAP = 48
PAD = 25  # PAD_SUBJECT of both packages


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _swtpu_scores(case) -> np.ndarray:
    """swtpu's scores of every kept query against every kept subject."""
    mat = ref_matrix(case["matrix"])
    subj, gaps = case["subjects"], case["gaps"]
    out = []
    for q in case["queries"]:
        if "gap_open" in gaps:
            out.append([ref_oracle.sw_affine_score_diag(q, s[s != PAD], mat, gaps["gap_open"], gaps["gap_extend"])
                        for s in subj])
            continue
        # one compiled shape a gap: subjects to a power-of-two count and 64 columns, the profile to 64 rows
        n = max(64, 1 << (subj.shape[0] - 1).bit_length())
        padded = np.full((n, 64), PAD, np.int8)
        padded[: subj.shape[0], : subj.shape[1]] = subj
        prof = xla_sw.make_profile(q, mat, pad_rows_to=64)
        out.append(np.asarray(xla_sw.sw_score_bucket(jnp.asarray(prof), jnp.asarray(padded), gap=gaps["gap"], strip=32))
                   [: subj.shape[0]])
    return np.asarray(out, dtype=np.int64)


@pytest.mark.parametrize(
    "name,n_cases", [("main", 3), ("main_multi", 2), ("main_shard", 2), ("main_chain", 3), ("main_affine", 2),
                     ("main_rows", 3), ("main_shapes", None)]
)
def test_function_on_cpu_matches_swtpu(name, n_cases):
    fz = card_fuzz.Fuzz("cpu", cap=CAP, keep=True)
    kw = {} if n_cases is None else dict(n_cases=n_cases)
    assert getattr(card_fuzz, name)(fuzz=fz, **kw) == 0, fz.failures
    assert fz.cases[name] == len(fz.kept) > 0 and not fz.failures
    for (fn, i), case in fz.kept.items():
        got = np.asarray(case["scores"], dtype=np.int64).reshape(len(case["queries"]), -1)
        assert np.array_equal(got, _swtpu_scores(case)), f"{fn} case {i}"
    if name == "main_shapes":  # every mode at every compiled shape
        launched = {k.rsplit(" ", 1)[1] for k in fz.launches if k.startswith("K1 ")}
        assert launched == {card_fuzz.shape_key(s) for s in wave_sw.SHAPES}
        assert {k.split()[1] for k in fz.launches} == set(card_fuzz.K1_MODES)
    if name == "main_rows":
        for kernel in ("K2 stack", "K3 bucket"):
            assert all(fz.launches[f"{kernel} {card_fuzz.shape_key(s)}"] for s in bucket_sw.SHAPES)


def test_thresholds_hit_both_sides(monkeypatch):
    monkeypatch.setattr(wave_sw, "BAND_THREADS", 96)
    monkeypatch.setattr(wave_sw, "BAND_THREADS_AFFINE", 96)
    monkeypatch.setattr(bucket_sw, "BAND_ROWS", 64)
    fz = card_fuzz.Fuzz("cpu", keep=False)
    assert card_fuzz.main_thresholds(fuzz=fz) == 0, fz.failures
    assert fz.cases["main_thresholds"] == 32
    assert fz.sides == {(k, n, side) for k in ("K1", "K2") for n in card_fuzz.SHARDS for side in (False, True)}


def test_a_wrong_kernel_is_caught_with_its_replay_key(monkeypatch, capsys):
    real = wave_sw.sw_wave

    @functools.wraps(real)
    def off_by_one(*args, **kw):
        out = real(*args, **kw)
        return out + (out > 0).to(out.dtype)

    monkeypatch.setattr(wave_sw, "sw_wave", off_by_one)
    fz = card_fuzz.Fuzz("cpu", cap=CAP)
    assert card_fuzz.main_chain(2, seed=5, fuzz=fz) == 1
    assert fz.failures and all("replay: --seed 5 --case" in f and "--only main_chain" in f for f in fz.failures)
    assert "MISMATCH main_chain case 0" in capsys.readouterr().out


def test_cli_and_replay(capsys):
    assert card_fuzz.cli(["--device", "cpu", "--only", "main_chain,main_affine", "--cases", "1"]) == 0
    out = capsys.readouterr().out.strip().splitlines()[-1]
    assert out.startswith("card_fuzz: ") and '"case_total": 2' in out and '"failures": 0' in out
    full = card_fuzz.Fuzz("cpu", cap=CAP, keep=True)
    card_fuzz.main(3, seed=11, fuzz=full)
    one = card_fuzz.Fuzz("cpu", cap=CAP, keep=True)
    card_fuzz.main(seed=11, fuzz=one, case=2)
    assert list(one.kept) == [("main", 2)]
    assert all(np.array_equal(one.kept[("main", 2)][k], full.kept[("main", 2)][k]) for k in ("subjects", "scores"))
    with pytest.raises(SystemExit):
        card_fuzz.cli(["--device", "cpu", "--only", "main_nothing"])


def test_battery_on_cpu(capsys):
    keys = ["subset", "saturation", "affine_engine"]
    assert gpu_validate.run(keys, device="cpu") == {k: True for k in keys}
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == len(keys) and all(": OK (" in line for line in lines)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert gpu_validate.main(["--device", "cpu", "--checks", "subset"]) == 0
    assert buf.getvalue().splitlines() == [buf.getvalue().splitlines()[0], "gpu_validate: ALL OK"]
    with pytest.raises(ValueError, match="unknown checks"):
        gpu_validate.run(["unroll_block"], device="cpu")
    assert [k for k, _, _ in gpu_validate.CHECKS][:4] == ["subset", "scale", "saturation", "fuzz"]
    # tools/tpu_validate.py's 17 but its TPU-only check 8 and its two composed checks
    assert len(gpu_validate.CHECKS) == 14
