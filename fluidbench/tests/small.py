"""A cell of ``BENCHMARK.json`` cut to a size the CPU runs in a second:
its configuration at ``nx`` x ``ny`` and units of ``steps`` steps, with
its own limits, run on the port's plain ops (``backend="ref"``).

``root`` is the harness root its files are found under and ``bench`` the
benchmark's table (this checkout's ``fluidbench/`` and ``BENCHMARK.json``
by default), so the same test bodies run on a harness root a test builds."""

import copy
from pathlib import Path

from fluidbench import run, spec

BENCH = spec.load_json(spec.BENCHMARK)


def parts(workload: str, nx: int = 40, ny: int = 32, steps: int = 10,
          root: Path = spec.HERE, bench: dict = BENCH):
    cell = spec.workload(bench, workload)
    conf = copy.deepcopy(spec.config(cell["config"], root))
    conf["overrides"].update(nx=nx, ny=ny)
    conf["fluid"].update(nx=nx, ny=ny)
    mix = dict(spec.traffic(cell["traffic"], root), steps_per_unit=steps)
    return cell, conf, mix, spec.limits(workload, root)


def run_small(workload: str, seed: int = 7, trace: bool = False, root: Path = spec.HERE,
              bench: dict = BENCH, **size):
    cell, conf, mix, limits = parts(workload, root=root, bench=bench, **size)
    metrics = [(m, spec.reader(m["name"], root))
               for m in spec.metrics_for(bench, workload, trace)]
    return run.run_cell(conf, mix, limits, metrics, seed, 0.2, trace, backend="ref", root=root)
