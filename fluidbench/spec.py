"""Finding a cell's parts by name.

``BENCHMARK.json`` at the checkout's root names each cell's configuration
and traffic mix and each metric; the harness finds them as files of their
own under ``fluidbench/``:

- ``configs/<config>.json``: the preset, its overrides and every physical
  parameter as run (``fluid``), its source, ``reduced`` and ``assumed``;
- ``traffic/<traffic>.json``: the parameters of a mix, read by the one
  generator (``generator.py``);
- ``limits/<workload>.json``: the limit of each number ``correct``
  compares in that cell;
- ``metrics/<metric>.py``: a reader of the run's records with a
  ``read(records)`` that returns the metric or None.

A later cell, mix or metric is a new file and a new entry, never an edit.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, List, Optional

HERE = Path(__file__).resolve().parent
BENCHMARK = HERE.parent / "BENCHMARK.json"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def workload(bench: dict, name: str) -> dict:
    """The cell ``name`` of ``bench``; raises for an unknown name."""
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str, root: Path = HERE) -> dict:
    return load_json(root / "configs" / f"{name}.json")


def traffic(name: str, root: Path = HERE) -> dict:
    return load_json(root / "traffic" / f"{name}.json")


def limits(name: str, root: Path = HERE) -> dict:
    return load_json(root / "limits" / f"{name}.json")


def reader(name: str, root: Path = HERE) -> Callable[[dict], Optional[float]]:
    """``read`` of ``metrics/<name>.py`` (a metric's name may hold dots,
    so the file is loaded by its path)."""
    path = root / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("fluidbench_metric_" + name.replace(".", "_"), path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def metrics_for(bench: dict, cell: str, trace: bool) -> List[dict]:
    """The metrics a run of ``cell`` reports: the end-to-end ones untraced,
    the per-layer ones traced, each where its ``workloads`` lists the cell
    or where it has no such key."""
    table = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in table if cell in m.get("workloads", [cell])]
