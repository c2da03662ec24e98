"""A cell's files, found by the names in ``BENCHMARK.json``.

``perfbench/workloads/<cell>.json`` is a traffic mix (with the cell's
limits for ``correct``), ``perfbench/configs/<config>.json`` a
configuration, ``perfbench/metrics/<metric>.py`` the reader of one
metric: a module with ``read(ctx) -> float | None`` (:class:`Context`), and
the traffic's ``path`` names ``perfbench/paths/<path>.py``, the route
through the program (``harness/program.py``). Adding a cell, a
configuration, a metric or a route adds files and entries; no file here
names one.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent.parent          # perfbench/
ROOT = HERE.parent


def load_benchmark(root: Path = ROOT) -> Dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def cell(bench: Dict, name: str) -> Dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def workload(name: str, base: Path = HERE) -> Dict:
    return _load_json(base / "workloads" / f"{name}.json")


def config(name: str, base: Path = HERE) -> Dict:
    return _load_json(base / "configs" / f"{name}.json")


def reader(name: str, base: Path = HERE) -> Callable:
    """The ``read`` function of ``metrics/<name>.py``."""
    path = base / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def metrics_for(bench: Dict, name: str, trace: bool) -> List[Dict]:
    """The metrics a run of cell ``name`` reports: its end-to-end metrics
    without the trace, its per-layer metrics with it. A metric with a
    ``workloads`` list belongs to those cells; a per-layer metric without
    one to every cell that reports the end-to-end metric it moves."""
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    if not trace:
        return e2e
    mine = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (name in m["workloads"] if "workloads" in m
                else m["moves"] in mine)]


@dataclass
class Context:
    """What a metric's reader reads. ``host``: the spans of the measured
    window (``window.run_process``'s ``host``); ``trace``: the traced
    window (a :class:`trace.Trace`, or None without the trace) and
    ``traced_calls`` the attempts of each call in it."""
    cell: Dict
    workload: Dict
    config: Dict
    host: Dict
    trace: Optional[Any] = None
    traced_calls: List[int] = field(default_factory=list)

    def geometry(self):
        from ..reference.flagship import Geometry
        return Geometry.from_config(self.config)


def read_metrics(specs: List[Dict], ctx: Context,
                 base: Path = HERE) -> Dict[str, Dict]:
    """``{name: {"value", "unit"}}`` of the metrics whose reader found
    something to read."""
    out: Dict[str, Dict] = {}
    for m in specs:
        value: Optional[float] = reader(m["name"], base)(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
