"""Discovery: the cells of ``BENCHMARK.json`` and the files each names.

A cell names a configuration and a traffic mix; both are YAML files found
by name (``configs/<config>.yaml``, ``traffic/<traffic>.yaml``), as are the
cell's correctness limits (``limits/<cell>.yaml``). A per-layer metric is a
module ``metrics/<metric>.py`` with ``read(record)``, loaded by path (the
names hold dots). Adding a cell, a mix or a metric adds files and entries
only.
"""

from __future__ import annotations

import copy
import dataclasses
import importlib.util
import json
import os
from typing import Any, Callable, Dict, List, Optional

import yaml

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    limits: Dict[str, float]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]


def _yaml(path: str) -> Dict[str, Any]:
    with open(path, "r") as f:
        return yaml.safe_load(f)


def benchmark(root: str = ROOT) -> Dict[str, Any]:
    with open(os.path.join(root, "BENCHMARK.json"), "r") as f:
        return json.load(f)


def config(name: str, here: str = HERE) -> Dict[str, Any]:
    return _yaml(os.path.join(here, "configs", f"{name}.yaml"))


def traffic(name: str, here: str = HERE) -> Dict[str, Any]:
    return _yaml(os.path.join(here, "traffic", f"{name}.yaml"))


def limits(cell: str, here: str = HERE) -> Dict[str, float]:
    path = os.path.join(here, "limits", f"{cell}.yaml")
    if not os.path.exists(path):
        return {}
    return {k: float(v) for k, v in (_yaml(path).get("limits") or {}).items()}


def _applies(metric: Dict[str, Any], cell: str, e2e_names) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names


def cell(name: str, bench: Optional[Dict[str, Any]] = None, here: str = HERE) -> Cell:
    """The cell ``name`` with its configuration, traffic, limits and the
    metrics it reports."""
    bench = bench if bench is not None else benchmark(os.path.dirname(here))
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: {sorted(by_name)}")
    w = by_name[name]
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _applies(m, name, e2e_names)]
    return Cell(name=name, chips=int(w["chips"]), config=config(w["config"], here),
                traffic=traffic(w["traffic"], here), limits=limits(name, here),
                end_to_end=e2e, per_layer=per_layer)


def metric_reader(name: str, here: str = HERE) -> Callable[[Dict[str, Any]], Optional[float]]:
    """``read(record)`` of ``metrics/<name>.py``."""
    path = os.path.join(here, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"h100_bench_metric_{name.replace('.', '_')}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def merged(base: Dict[str, Any], over: Dict[str, Any]) -> Dict[str, Any]:
    """``base`` with ``over`` laid over it, nested dicts merged key by key."""
    out = copy.deepcopy(base)
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = merged(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out
