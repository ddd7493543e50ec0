"""Finding a cell's parts by name.

``BENCHMARK.json`` at the checkout's root names each cell's configuration
and traffic mix and each metric; the harness finds them as files of their
own under ``fluidbench/``:

- ``configs/<config>.json``: the preset, its overrides and every physical
  parameter as run (``fluid``), its source, ``reduced`` and ``assumed``,
  and optionally ``reference``, the name of its plain reference;
- ``reference/<module>.py``: the plain reference a configuration names
  (``step``, the gpu-parity step, where it names none), loaded by its path
  (:func:`reference`).  It imports nothing of the program and gives what
  ``check.py`` and ``run.py`` use: ``Params`` with
  ``Params.from_fluid(fluid)`` (raising for a configuration it does not
  write), ``State``, ``Impulse``, ``init(p, device, dtype)``,
  ``step(p, s, imp, dtype)``, ``host_scalars(s, imp, dtype)`` and
  ``render(p, s, dtype)``; and, where the step's work is not the parity
  step's, ``stages(fluid) -> {stage: (bytes, f32_ops)}``, the count that
  ``roofline.py`` bounds (``roofline.stages`` where it gives none).  A
  stage is named as the port's span of it without ``fluid.step.``;
- ``traffic/<traffic>.json``: the parameters of a mix, read by the one
  generator (``generator.py``); its ``kind`` names its driver: one of
  ``drive.DRIVERS``, or else ``drivers/<kind>.py``, whose ``DRIVER`` is a
  ``drive.Driver`` subclass (:func:`driver`).  The driver's ``records``
  (its ``kind`` where it has none) names the record its window gives, on
  which the readers under ``metrics/`` branch: "rollout" (``units``,
  ``steps``, ``cells``, ``window_s``: the headless readers) or "frames"
  (and ``frame_s``: the live ones); a ``drive.Rollout`` subclass is also
  timed for its host enqueue.  A driver's window may hand ``check.judge``
  a list of captures (an ensemble's judged members): each number is then
  the worst over them;
- ``limits/<workload>.json``: the limit of each number ``correct``
  compares in that cell;
- ``metrics/<metric>.py``: a reader of the run's records with a
  ``read(records)`` that returns the metric or None.

A later cell, mix, reference, driver or metric is a new file and a new
entry, never an edit.  A new cell brings:

- its files: ``configs/<config>.json`` (naming its ``reference`` where its
  step is not the parity step), that ``reference/<module>.py``,
  ``traffic/<traffic>.json``, ``limits/<workload>.json``, a reader
  ``metrics/<metric>.py`` for each metric no reader reads yet, and
  ``drivers/<kind>.py`` where no driver runs its mix;
- its entries in ``BENCHMARK.json``: the configuration under ``configs``
  (its ``source`` that of its file), the cell under ``workloads``, and
  each metric it reports under ``end_to_end`` or ``per_layer``;
- its name in the ``workloads`` of each end-to-end metric it reports
  besides ``setup_s`` (``setup_s`` lists none: every cell reports it),
  of at least one such metric, and of ``build.load_s``, a per-layer
  metric every cell reports;
- in a driver of its own, ``step_factory``: the (module, attribute) of
  the factory that builds its step, where the harness's tests plant a
  broken step.  The module is imported by its dotted name
  (``importlib.import_module``), so it is never the driver's own file,
  which :func:`driver` loads anew on each call.  ``drive.Driver`` names
  the factory of the port's ``Simulation``; a driver whose step comes
  from elsewhere (an ensemble's batched step) names that one.

The harness's per-cell tests (``tests/``) take the cell's reference, that
reference's ``Params`` and the driver by name, as a run does, so a cell
that brings the above goes through them with no edit.  They hold every
cell to this, and a new cell has to meet it:

- ``chips`` 1, and its configuration's ``reduced`` empty;
- a run at 40 x 32 cells, units of 10 steps, on the port's plain ops
  (``tests/small.py``): ``correct``, every end-to-end metric above 0, and
  every compared number exactly 0, so its reference has to agree with the
  port's plain ops bit for bit at that size;
- the same with the reference named in the configuration or left to its
  default, and its ``step_bound_s`` the sum of the bounds of its own
  ``stages`` (``roofline.stages`` where it has none);
- on one unit of its driver at that size, its reference judges the
  capture within its limits, which hold ``step_u`` and ``step_dye``, and
  the reference computed in bfloat16 in the program's place (the
  control) reads above both;
- a step that returns its state unchanged, and one that adds
  0.01 x max(1, max|u|) to one cell of each member's velocity, each
  planted in the driver's ``step_factory``, give ``correct`` false.

A stage whose repeats vary from step to step, such as a V-cycle stopped by
a residual test, is counted once for each occurrence: ``stages(fluid)``
gives one occurrence under a name of its own, and a new reader multiplies
it by the traced count of the span that marks each occurrence (for a step
stopped after k cycles, ``fluid.mg.stopping_read`` counts k + 1).  The
``step_bound_s`` of such a cell then bounds no step, so
``kernel_roofline_share.headless``, which reads it, does not list the cell.
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path
from types import ModuleType
from typing import Callable, List, Optional

HERE = Path(__file__).resolve().parent
BENCHMARK = HERE.parent / "BENCHMARK.json"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _load(path: Path, prefix: str) -> ModuleType:
    """The module at ``path`` (a file name may hold dots and dashes, so it
    is loaded by its path, under a name made from it)."""
    name = f"fluidbench_{prefix}_" + re.sub(r"\W", "_", path.stem)
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None or not path.is_file():
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module  # classes and dataclasses find their module
    spec.loader.exec_module(module)
    return module


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
    """``read`` of ``metrics/<name>.py``."""
    return _load(root / "metrics" / f"{name}.py", "metric").read


def reference(name: Optional[str] = None, root: Path = HERE) -> ModuleType:
    """The plain reference ``reference/<name>.py`` (``step`` for None: a
    configuration file without a ``reference`` key)."""
    return _load(root / "reference" / f"{name or 'step'}.py", "reference")


def driver(kind: str, root: Path = HERE) -> type:
    """The driver of a mix of ``kind``: ``drive.DRIVERS[kind]``, or else
    ``DRIVER`` of ``drivers/<kind>.py``."""
    from fluidbench import drive

    if kind in drive.DRIVERS:
        return drive.DRIVERS[kind]
    return _load(root / "drivers" / f"{kind}.py", "driver").DRIVER


def metrics_for(bench: dict, cell: str, trace: bool) -> List[dict]:
    """The metrics a run of ``cell`` reports: the end-to-end ones untraced,
    the per-layer ones traced, each where its ``workloads`` lists the cell
    or where it has no such key."""
    table = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in table if cell in m.get("workloads", [cell])]
