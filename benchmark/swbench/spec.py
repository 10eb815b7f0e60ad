"""Everything of a cell, found by name.

* ``BENCHMARK.json`` at the checkout's root names the cells
  (``<config>.<traffic>``), the configurations and the metrics;
* a configuration is the JSON file its entry names
  (``benchmark/configs/<config>.json``);
* a traffic mix is ``benchmark/traffic/<traffic>.json``;
* a metric is read by ``benchmark/metrics/<metric>.py``'s ``read(run)``;
* what a configuration or a mix names by kind and name is the module
  ``benchmark/<kind>/<name>.py`` (``plugin``): the database's recipe
  (``databases``), the engine's builder (``engines``), the source of a
  group of queries (``sources``), the order of the requests (``orders``),
  the loop that sends them (``loops``), the program's entry a request
  calls (``calls``), and the comparison that decides ``correct``
  (``checks``: ``check(cfg, qs, residues, offsets, planted, sample,
  device, control)``; a configuration that names none is checked by
  ``swbench/check.py``).

Adding a cell, a configuration, a mix, a metric or a new kind of any of
those pieces adds files and entries; nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List, Tuple

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent


def load() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {[w['name'] for w in bench['workloads']]})")


def config(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return json.loads((ROOT / c["file"]).read_text())
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    path = BENCH / "traffic" / f"{name}.json"
    if not path.exists():
        raise KeyError(f"no traffic mix {name!r}: {path} is missing")
    return json.loads(path.read_text())


def metrics(bench: dict, cell_name: str, traced: bool) -> List[dict]:
    """The metrics a run of the cell reports: its end-to-end metrics
    untraced, its per-layer metrics traced.  A metric without a
    ``workloads`` key belongs to every cell."""
    group = bench["per_layer"] if traced else bench["end_to_end"]
    return [m for m in group if cell_name in m.get("workloads", [cell_name])]


_plugins: Dict[Tuple[str, str], ModuleType] = {}


def plugin(kind: str, name: str) -> ModuleType:
    """The module ``benchmark/<kind>/<name>.py``, loaded once."""
    key = (kind, name)
    if key not in _plugins:
        path = BENCH / kind / f"{name}.py"
        if not path.exists():
            raise KeyError(f"no {kind} named {name!r}: {path} is missing")
        spec = importlib.util.spec_from_file_location(f"benchmark_{kind}_{name.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _plugins[key] = mod
    return _plugins[key]


def reader(name: str) -> Callable[[dict], object]:
    """``read`` of ``benchmark/metrics/<name>.py``."""
    return plugin("metrics", name).read
