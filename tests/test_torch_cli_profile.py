"""The CLI's ``--profile DIR``: a torch.profiler Chrome trace of the search.

``python -m swtpu_torch --device cpu --profile DIR`` (run in-process) on the
subset writes ``DIR/swtpu_torch_trace.json``, which parses as JSON and holds
events; its stdout without the METRICS block equals the same CLI's without
``--profile`` and swtpu's CLI's with ``--profile`` (swtpu writes
``jax.profiler``'s layout instead of a Chrome trace: D18).  A profiler that
raises fails the CLI.
"""

import json
from pathlib import Path

import pytest
import torch

from swtpu import cli as ref_cli
from swtpu_torch import cli
from swtpu_torch.utils import profiling

DATA = Path(__file__).resolve().parent / "data"
ARGS = ["--query", str(DATA / "queries" / "P02232.fasta"), "--db", str(DATA / "uniprot_subset.fasta")]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(main, argv, capsys):
    assert main(argv) == 0
    out = capsys.readouterr()
    body = out.out.split("=" * 80)[0]  # the METRICS block times the run
    assert body.count("\n") > 100
    return body, out.err


def test_profile_writes_a_chrome_trace(tmp_path, capsys):
    body, err = _run(cli.main, ARGS + ["--device", "cpu", "--profile", str(tmp_path / "new" / "dir")], capsys)
    path = tmp_path / "new" / "dir" / profiling.TRACE_NAME
    trace = json.loads(path.read_text())
    assert any(e.get("ph") == "X" for e in trace["traceEvents"])
    summary = profiling.trace_summary(path)
    assert summary["events"] > 0 and summary["device_events"] == 0 and summary["busy_share"] is None
    assert f"swtpu_torch: profile: {path}: {summary['events']} events, 0 on the device" in err
    plain, _ = _run(cli.main, ARGS + ["--device", "cpu"], capsys)
    assert body == plain
    ref, _ = _run(ref_cli.main, ARGS + ["--profile", str(tmp_path / "jax")], capsys)
    assert body == ref


def test_a_profiler_that_raises_fails_the_cli(tmp_path, monkeypatch):
    def broken(*args, **kw):
        raise RuntimeError("profiler unavailable")

    monkeypatch.setattr(torch.profiler, "profile", broken)
    with pytest.raises(RuntimeError, match="profiler unavailable"):
        cli.main(ARGS + ["--device", "cpu", "--profile", str(tmp_path)])


def test_kernel_label_and_busy_share(tmp_path):
    events = [
        {"ph": "X", "cat": "kernel", "name": "void (anonymous namespace)::sw_wave_kernel<false, false, 16>(int*, int)",
         "ts": 100.0, "dur": 30.0},
        {"ph": "X", "cat": "kernel", "name": "void (anonymous namespace)::sw_wave_kernel<false, false, 16>(int*, int)",
         "ts": 150.0, "dur": 20.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 190.0, "dur": 10.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::cat", "ts": 0.0, "dur": 500.0},
        {"ph": "i", "cat": "kernel", "name": "instant", "ts": 0.0},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    s = profiling.trace_summary(path)
    assert s["events"] == 4 and s["device_events"] == 3
    assert s["kernel_ms"] == {"sw_wave_kernel<false, false, 16>": 0.05}
    assert s["device_ms"] == pytest.approx(0.06) and s["window_ms"] == pytest.approx(0.1)
    assert s["busy_share"] == pytest.approx(0.6)


def test_the_profile_span_is_the_window(tmp_path):
    """With the profiled block's ``swtpu.profile`` span in the trace, the
    window is that span and the busy share counts the device's time inside
    it."""
    events = [
        {"ph": "X", "cat": "user_annotation", "name": profiling.PROFILE_SPAN, "ts": 50.0, "dur": 200.0},
        {"ph": "X", "cat": "kernel", "name": "void sw_band_kernel<false, false, 64>(int*)", "ts": 100.0, "dur": 30.0},
        {"ph": "X", "cat": "kernel", "name": "void sw_band_kernel<false, false, 64>(int*)", "ts": 240.0, "dur": 20.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 190.0, "dur": 10.0},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    s = profiling.trace_summary(path)
    assert s["device_events"] == 3 and s["device_ms"] == pytest.approx(0.06)
    assert s["window_ms"] == pytest.approx(0.2)
    assert s["busy_share"] == pytest.approx((30 + 10 + 10) / 200)  # the last kernel half inside
