"""The benchmark's spec (``BENCHMARK.json`` at the root of the checkout) and
the files it names.

Everything that belongs to one configuration, traffic mix, cell or metric
sits in a file of its own, found by the name that ``BENCHMARK.json`` gives:

* a configuration: the ``file`` of its entry (``perfbench/configs/<name>.json``);
* a traffic mix: ``perfbench/traffic/<mix>.json``;
* the limits of a cell's correctness check: ``perfbench/limits/<cell>.json``;
* a metric's reader: ``perfbench/metrics/<metric>.py``, whose ``read(ctx)``
  returns the metric's value or None where it finds nothing to read;
* a system's driver: ``perfbench/systems/<system>.py``, named by the
  configuration's ``system`` key.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, Optional

ROOT = Path(__file__).resolve().parents[2]
PKG = ROOT / "perfbench"

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: Path = ROOT) -> Dict[str, Any]:
    return load_json(root / "BENCHMARK.json")


def by_name(entries: List[Dict[str, Any]], name: str, what: str) -> Dict[str, Any]:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def config_of(bench: Dict[str, Any], cell: Dict[str, Any], root: Path = ROOT) -> Dict[str, Any]:
    return load_json(root / by_name(bench["configs"], cell["config"], "configuration")["file"])


def traffic_of(cell: Dict[str, Any], root: Path = ROOT) -> Dict[str, Any]:
    return load_json(root / "perfbench" / "traffic" / f"{cell['traffic']}.json")


def limits_of(cell_name: str, root: Path = ROOT) -> Dict[str, float]:
    return load_json(root / "perfbench" / "limits" / f"{cell_name}.json")


def applies(metric: Dict[str, Any], cell_name: str, e2e_names: List[str]) -> bool:
    """Whether ``metric`` is reported in the cell: listed there, or without a
    ``workloads`` key and moving an end-to-end metric the cell reports."""
    if "workloads" in metric:
        return cell_name in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_names


def metrics_of(bench: Dict[str, Any], cell_name: str, trace: bool) -> List[Dict[str, Any]]:
    """The cell's end-to-end metrics (``trace`` False) or per-layer ones."""
    e2e = [m for m in bench["end_to_end"] if applies(m, cell_name, [])]
    if not trace:
        return e2e
    names = [m["name"] for m in e2e]
    return [m for m in bench["per_layer"] if applies(m, cell_name, names)]


def load_file_module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric_name: str, root: Path = ROOT) -> ModuleType:
    """The module of ``perfbench/metrics/<metric_name>.py`` (a metric name
    may hold dots, so it is loaded from its path)."""
    path = root / "perfbench" / "metrics" / f"{metric_name}.py"
    return load_file_module(path, "perfbench_metric_" + re.sub(r"\W", "_", metric_name))


def system(name: str) -> ModuleType:
    if not NAME_RE.match(name):
        raise ValueError(f"bad system name {name!r}")
    return importlib.import_module(f"perfbench.systems.{name}")


def problems(bench: Dict[str, Any], root: Path = ROOT) -> List[str]:
    """What in ``bench`` breaks the name and unit rules or names a file that
    is not there (empty when all is well)."""
    out: List[str] = []

    def name_ok(n: Optional[str], where: str) -> None:
        if not isinstance(n, str) or not NAME_RE.match(n):
            out.append(f"{where}: bad name {n!r}")

    for c in bench["configs"]:
        name_ok(c["name"], "config")
        for k in c["reduced"]:
            name_ok(k, f"config {c['name']} reduced")
        if not (root / c["file"]).is_file():
            out.append(f"config {c['name']}: no file {c['file']}")
    for w in bench["workloads"]:
        for key in ("name", "config", "traffic"):
            name_ok(w[key], f"workload {w['name']} {key}")
        if not (root / "perfbench" / "traffic" / f"{w['traffic']}.json").is_file():
            out.append(f"workload {w['name']}: no traffic file")
        if not (root / "perfbench" / "limits" / f"{w['name']}.json").is_file():
            out.append(f"workload {w['name']}: no limits file")
        if len(w["why"]) > 200 or "\n" in w["why"] or "\t" in w["why"]:
            out.append(f"workload {w['name']}: bad why")
    for m in bench["end_to_end"] + bench["per_layer"]:
        name_ok(m["name"], "metric")
        if not UNIT_RE.match(m["unit"]):
            out.append(f"metric {m['name']}: bad unit {m['unit']!r}")
        if m["better"] not in ("lower", "higher"):
            out.append(f"metric {m['name']}: bad better")
        if not (root / "perfbench" / "metrics" / f"{m['name']}.py").is_file():
            out.append(f"metric {m['name']}: no reader")
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in bench[kind]]
        if len(names) != len(set(names)):
            out.append(f"{kind}: names repeat")
    return out
