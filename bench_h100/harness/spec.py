"""Cells, configurations, traffic mixes, drivers and metric readers, found
by the names BENCHMARK.json gives them:

    configs/<config>.json      a configuration: sizes, source, cuts
    traffic/<traffic>.json     a traffic mix: the driver it runs on
                               ("driver") and its parameters
    drivers/<driver>.py        a traffic driver: `run(...)`, the set-up,
                               window and check of one run, and
                               `readings(...)`, calibrate.py's
                               (harness/cell.py says what they return)
    metrics/<metric>.py        a metric's reader, end-to-end or
                               per-layer: `read(window) -> float or None`

Adding a cell, a configuration, a mix, a driver or a metric adds files
and entries and edits none."""
from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent.parent


def load_benchmark(root: Path) -> Dict:
    with open(root / "BENCHMARK.json") as fh:
        return json.load(fh)


def cell(bench: Dict, name: str) -> Dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: Dict, name: str, base: Path = BENCH_DIR.parent) -> Dict:
    for c in bench["configs"]:
        if c["name"] == name:
            with open(base / c["file"]) as fh:
                return json.load(fh)
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str, base: Path = BENCH_DIR) -> Dict:
    with open(base / "traffic" / f"{name}.json") as fh:
        return json.load(fh)


def metrics_of(bench: Dict, workload: str, section: str) -> List[Dict]:
    """The metrics of `section` ("end_to_end" or "per_layer") that the
    workload reports: those whose `workloads` name it, or that have
    none."""
    return [m for m in bench[section]
            if workload in m.get("workloads", [workload])]


def _load(path: Path) -> ModuleType:
    """The module in file `path`, loaded once under a name made from the
    path (so that copies of the benchmark do not clash)."""
    key = "bench_h100_file_" + re.sub(r"\W", "_", str(path.resolve()))
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        try:
            spec.loader.exec_module(mod)
        except BaseException:
            del sys.modules[key]
            raise
    return sys.modules[key]


def driver(name: str, base: Path = BENCH_DIR) -> ModuleType:
    """drivers/<name>.py."""
    return _load(base / "drivers" / f"{name}.py")


def reader(name: str, base: Path = BENCH_DIR) -> Callable:
    """metrics/<name>.py's `read`."""
    return _load(base / "metrics" / f"{name}.py").read


def read_metrics(bench: Dict, workload: str, section: str, window,
                 base: Path = BENCH_DIR) -> Dict[str, Dict]:
    """{metric: {"value", "unit"}} of the metrics of `section`
    ("end_to_end" or "per_layer") that the workload reports, each read
    from `window` by its reader; a reader that finds nothing to read
    leaves its metric out."""
    out = {}
    for m in metrics_of(bench, workload, section):
        value: Optional[float] = reader(m["name"], base)(window)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
