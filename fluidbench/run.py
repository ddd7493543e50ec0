"""One run of one cell of the benchmark.

    python3 -m fluidbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the checkout's root, on a machine with an NVIDIA card.  The run
finds the cell in ``BENCHMARK.json``, its configuration, traffic mix and
limits under ``fluidbench/`` by name (``spec.py``), then:

1. builds the configuration's step (the port's kernels are built by nvcc
   at first use into ``cudafluidsimulation_tpu_torch/build/``, keyed on
   their sources, so only a checkout's first run compiles) and the mix's
   driver (``drive.py``, or the kind's own file: ``spec.driver``), and
   runs two units of the mix as the warm-up: every shape the window uses;
2. measures for ``--seconds``: units one after another, closed by a
   synchronize; ``setup_s`` is the time from the process's start to the
   window's start;
3. reads the peak device memory, then judges the window's last unit
   against the configuration's plain reference (``check.py``,
   ``spec.reference``), and bounds the step by that reference's count of
   its stages (``roofline.py``): ``stage_bound_s`` and ``step_bound_s``;
4. with ``--trace 1``, traces the mix's ``traced_units`` more units
   (``trace.py``) and, for a rollout, times the host's enqueue of 32-step
   segments right after a synchronize;
5. prints each number compared beside its limit as the last lines on
   stderr, and one JSON line as the last line on stdout: ``correct``,
   ``attempted`` and ``failed`` (units), ``metrics`` (the cell's
   end-to-end metrics, or with ``--trace 1`` its per-layer ones, each from
   its reader ``metrics/<name>.py``), ``device``, with ``--trace 1``
   ``breakdown``, and last ``checks``.

Without a CUDA card, or with fewer than the cell asks for, it exits 2 and
prints no result; it never falls back to the CPU.  It exits 3 and prints
no result if JAX or the JAX package was imported.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Optional  # noqa: E402

import torch  # noqa: E402

from fluidbench import check, drive, roofline, spec  # noqa: E402
from fluidbench import trace as tracing  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "cudafluidsimulation_tpu")
ENQUEUE_SEGMENTS = 24
ENQUEUE_STEPS = 32  # 32 x 11 launches stay under the launch queue's depth


def port_config(conf: dict, backend: str):
    """The port's ``FluidConfig`` of a configuration file: its preset with
    its overrides, checked field by field against ``fluid`` (the
    parameters as run, which the reference reads too)."""
    from cudafluidsimulation_tpu_torch.config import FluidConfig

    cfg = getattr(FluidConfig, conf["preset"])(**conf["overrides"], backend=backend)
    built = dataclasses.asdict(cfg)
    wrong = {k: (v, built.get(k)) for k, v in conf["fluid"].items() if built.get(k) != v}
    if wrong or set(built) - set(conf["fluid"]) != {"backend"}:
        raise ValueError(f"preset and fluid table disagree: {wrong}")
    return cfg


def forbidden_modules() -> list:
    """Top-level names of ``sys.modules`` that are JAX or the JAX package."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def power_limit() -> Optional[str]:
    """``nvidia-smi``'s name and power limit of the card, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None


def host_enqueue_ms(driver: drive.Rollout, sync) -> list:
    """ms a step to enqueue :data:`ENQUEUE_STEPS` steps right after a
    synchronize, :data:`ENQUEUE_SEGMENTS` times (the host clock, with no
    wait on the device inside it)."""
    from cudafluidsimulation_tpu_torch.utils.impulse import Impulse

    u = driver._unit(driver.next_index)
    driver.next_index += 1
    arrays = u.stream(driver.fluid["dt"])
    imp = Impulse(*(torch.from_numpy(a[:ENQUEUE_STEPS]) for a in arrays))
    state = driver.sim.init()
    out = []
    for _ in range(ENQUEUE_SEGMENTS):
        sync()
        t = time.perf_counter()
        state = driver.sim.run(state, imp)
        out.append(1e3 * (time.perf_counter() - t) / ENQUEUE_STEPS)
    sync()
    return out


def finite(x: float):
    return x if math.isfinite(x) else str(x)


def run_cell(conf: dict, mix: dict, limits: dict, metrics: list, seed: int, seconds: float,
             trace: bool, backend: str = "cuda", t0: float = T0,
             root: Path = spec.HERE) -> dict:
    """One run of a cell of configuration ``conf`` and mix ``mix``: the
    result line's object.  ``metrics`` is [(entry, reader)] of the metrics
    to report.  ``backend`` "ref" runs the port's plain ops on the CPU (the
    tests' way through a run; the command always runs the card).  The
    configuration's reference and the mix's driver are found under
    ``root``."""
    cfg = port_config(conf, backend)
    ref = spec.reference(conf.get("reference"), root)
    on_card = backend != "ref"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    driver = spec.driver(mix["kind"], root)(cfg, conf["fluid"], mix, seed)
    records = getattr(driver, "records", driver.kind)  # the record the readers know
    # every shape of the window, and the device memory pool as the window
    # holds it: a unit runs while the last one's capture is still held
    driver.units(2)
    sync()
    rec = {"kind": records, "setup_s": time.perf_counter() - t0}
    rec.update(driver.window(seconds, sync))
    kind = torch.cuda.get_device_name() if on_card else "cpu"
    device = {"platform": "gpu" if on_card else "cpu", "kind": kind, "count": 1,
              "memory_peak_bytes": torch.cuda.max_memory_allocated() if on_card else 0}
    numbers = check.judge(rec.pop("capture"), ref.Params.from_fluid(conf["fluid"]), ref=ref)

    breakdown = None
    if trace:
        n = int(mix["traced_units"])
        summary = tracing.traced(lambda: driver.units(n))
        if summary is not None:
            rec["trace"] = summary
            rec["traced_steps"] = n * int(mix["steps_per_unit"])
            rec["traced_frames"] = rec["traced_steps"] if records == "frames" else 0
            breakdown = {"device_ops": summary["device_ops"], "idle_gaps": summary["idle_gaps"]}
            device.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
        if isinstance(driver, drive.Rollout):  # one Simulation to enqueue on
            rec["enqueue_ms"] = host_enqueue_ms(driver, sync)
    stages = roofline.stage_bound_s(conf["fluid"], kind, getattr(ref, "stages", roofline.stages))
    rec["stage_bound_s"] = stages
    rec["step_bound_s"] = None if stages is None else sum(stages.values())
    if on_card:
        device["smi"] = power_limit()
    ok = check.verdict(numbers, limits)
    values = {}
    for entry, read in metrics:
        v = read(rec)
        if v is not None:
            values[entry["name"]] = {"value": v, "unit": entry["unit"]}
    result = {"correct": ok, "attempted": rec["units"], "failed": 0, "metrics": values,
              "device": device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": finite(v), "limit": limits.get(k)} for k, v in numbers.items()}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = spec.load_json(spec.BENCHMARK)
    cell = spec.workload(bench, args.workload)
    chips = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"fluidbench: {args.workload} needs {chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(1)
    metrics = [(m, spec.reader(m["name"])) for m in
               spec.metrics_for(bench, args.workload, bool(args.trace))]
    result = run_cell(spec.config(cell["config"]), spec.traffic(cell["traffic"]),
                      spec.limits(args.workload), metrics, args.seed, args.seconds,
                      bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"fluidbench: the run imported {found}", file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
