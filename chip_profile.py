#!/usr/bin/env python3
"""Profile the port's 2048² steps on one NVIDIA card with ``torch.profiler``.

    python3 chip_profile.py [--warmup 100] [--steps 20] [--paths parity fast quality]

For each path (``chip_smoke.py``'s configurations: gpu-parity, fast,
quality), after ``--warmup`` driven orbit steps, one window of ``--steps``
driven steps is measured three ways:

- its ms a step by CUDA events (median of 3 runs of the window);
- the host's enqueue ms a step: the wall time of issuing the window's
  steps, before the synchronise (the quality step's host reads include
  their waits);
- a ``torch.profiler`` trace of the window: device busy ms a step (the sum
  of the device operations' durations; the port runs on one stream, so
  they do not overlap), the idle share of the window, and each device
  operation's µs and launches a step, largest first (with the count of
  ``torch.cat``/``torch.stack`` copies among them), and the window's
  first step op by op in launch order (µs each).

Prints one JSON line per path, after the card's name and power limit.
Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

N = 2048
FAST = dict(fast_dye=True, fast_velocity=True, fast_diffuse=True)


def configs(FluidConfig):
    return {
        "parity": FluidConfig.gpu_reference(nx=N, ny=N, pressure_iters=40,
                                            max_displacement=31, backend="cuda"),
        "fast": FluidConfig.gpu_reference(nx=N, ny=N, pressure_iters=40,
                                          max_displacement=31, backend="cuda", **FAST),
        "quality": FluidConfig.quality(nx=N, ny=N, backend="cuda"),
    }


def profile(sim, warm, window, cuda_times_ms):
    steps = len(window.dt)
    state = sim.run(sim.init(), warm)
    torch.cuda.synchronize()
    window_ms = statistics.median(cuda_times_ms(lambda: sim.run(state, window), iters=3))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.run(state, window)
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        # a session after the first may drop its first device records: let
        # a few marker kernels take that place (not counted)
        for _ in range(4):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        time.sleep(0.01)
        sim.run(state, window)
        torch.cuda.synchronize()
    timeline = sorted((e for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA
                       and "spin_kernel" not in e.name), key=lambda e: e.time_range.start)
    by_name = {}
    for e in timeline:
        us, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    busy_us = sum(us for us, _ in by_name.values())
    ops = sorted(((name, us / steps, n / steps) for name, (us, n) in by_name.items()),
                 key=lambda r: -r[1])
    # the window's first step op by op, when every step makes as many
    per_step = len(timeline) // steps
    first_step = [[e.name.split("(")[0][-40:], e.time_range.elapsed_us()]
                  for e in timeline[:per_step]] if per_step * steps == len(timeline) else None
    return {
        "steps": steps, "ms_per_step": window_ms / steps,
        "host_enqueue_ms_per_step": 1e3 * enqueue_s / steps,
        "device_busy_ms_per_step": busy_us / 1e3 / steps,
        "idle_share": 1.0 - (busy_us / 1e3) / window_ms if busy_us else None,
        "device_ops_per_step": sum(n for _, _, n in ops),
        # torch.cat / torch.stack copies (the 5-channel pack is written in
        # place, so none is expected)
        "cat_ops_per_step": sum(n for name, _, n in ops if "CatArray" in name),
        "ops": [{"name": name, "us_per_step": us, "launches_per_step": n}
                for name, us, n in ops],
        "first_step_ops_us": first_step,
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--warmup", type=int, default=100)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--paths", nargs="+", default=["parity", "fast", "quality"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from cudafluidsimulation_tpu_torch import FluidConfig, Simulation
    from cudafluidsimulation_tpu_torch.ops import _build
    from cudafluidsimulation_tpu_torch.utils.impulse import Impulse, orbit_impulse
    from cudafluidsimulation_tpu_torch.utils.timing import cuda_times_ms

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    _build.build_all()
    driven = orbit_impulse(args.warmup + args.steps, 1.0 / 60.0, center=(N / 2, N / 2),
                           radius=N / 8, omega=3.0)
    warm = Impulse(*(f[:args.warmup] for f in driven))
    window = Impulse(*(f[args.warmup:] for f in driven))
    cfgs = configs(FluidConfig)
    for path in args.paths:
        row = {"path": path, "grid": f"{N}x{N}", "smi": smi,
               **profile(Simulation(cfgs[path]), warm, window, cuda_times_ms)}
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
