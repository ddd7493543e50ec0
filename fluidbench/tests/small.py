"""A cell of ``BENCHMARK.json`` cut to a size the CPU runs in a second:
its configuration at ``nx`` x ``ny`` and units of ``steps`` steps, with
its own limits, run on the port's plain ops (``backend="ref"``)."""

import copy

from fluidbench import run, spec

BENCH = spec.load_json(spec.BENCHMARK)


def parts(workload: str, nx: int = 40, ny: int = 32, steps: int = 10):
    cell = spec.workload(BENCH, workload)
    conf = copy.deepcopy(spec.config(cell["config"]))
    conf["overrides"].update(nx=nx, ny=ny)
    conf["fluid"].update(nx=nx, ny=ny)
    mix = dict(spec.traffic(cell["traffic"]), steps_per_unit=steps)
    return cell, conf, mix, spec.limits(workload)


def run_small(workload: str, seed: int = 7, trace: bool = False, **size):
    cell, conf, mix, limits = parts(workload, **size)
    metrics = [(m, spec.reader(m["name"])) for m in spec.metrics_for(BENCH, workload, trace)]
    return run.run_cell(conf, mix, limits, metrics, seed, 0.2, trace, backend="ref")
