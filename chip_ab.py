#!/usr/bin/env python3
"""Time the port's steps of two checkouts in turns, on one NVIDIA card.

    python3 chip_ab.py PARENT_DIR [CHANGE_DIR] [--rounds 6] [--windows 12] [--grid 2048]
    python3 chip_ab.py PARENT_DIR [CHANGE_DIR] --multicard [--rounds 2]

``CHANGE_DIR`` defaults to this script's checkout.  Each round runs one
process per checkout, the parent first in odd rounds and second in even
ones, so drift on the card and its host falls on both alike.  A process
warms each path (``chip_smoke.py``'s parity, fast and quality
configurations) up with 100 driven orbit steps, then times ``--windows``
windows of 20 driven steps by CUDA events, at ``--grid``² (at a small grid
the device work is short, so a step's time is its host's cost).  Prints
the card's name and power limit, one JSON line per process, then per path
and checkout each process's median ms/step, the median and quartiles over
all windows, and whether every process of the change beat every process
of the parent.
With ``--multicard`` (at least two cards) a round runs each checkout's
``chip_multicard.py`` instead, in the same alternating order, and compares
its rates part by part: the ens groups' member-steps/s a group a card, all
on card 0 (``chip_smoke.py`` phase 13(a)'s mesh, (ens 4, x 1) on one
card) and the one-device ensemble; the rows and 2-D meshes' ms/step a
shard a card, all on card 0 and on one device; the CLI's steps/s.
Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

WARMUP, STEPS = 100, 20
PATHS = ("parity", "fast", "quality")


def child(root: Path, windows: int, n: int) -> dict:
    """ms/step of each window of each path at n², for the checkout at ``root``."""
    sys.path.insert(0, str(root))
    import torch
    from cudafluidsimulation_tpu_torch import FluidConfig, Simulation
    from cudafluidsimulation_tpu_torch.utils.impulse import Impulse, orbit_impulse

    fast = dict(fast_dye=True, fast_velocity=True, fast_diffuse=True)
    parity = dict(nx=n, ny=n, pressure_iters=40, max_displacement=31, backend="cuda")
    cfgs = {"parity": FluidConfig.gpu_reference(**parity),
            "fast": FluidConfig.gpu_reference(**parity, **fast),
            "quality": FluidConfig.quality(nx=n, ny=n, backend="cuda")}
    driven = orbit_impulse(WARMUP + STEPS, 1.0 / 60.0, center=(n / 2, n / 2), radius=n / 8,
                           omega=3.0)
    warm = Impulse(*(f[:WARMUP] for f in driven))
    window = Impulse(*(f[WARMUP:] for f in driven))
    out = {}
    for path in PATHS:
        sim = Simulation(cfgs[path])
        state = sim.run(sim.init(), warm)
        sim.run(state, window)
        torch.cuda.synchronize()
        ms = []
        for _ in range(windows):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            sim.run(state, window)
            end.record()
            torch.cuda.synchronize()
            ms.append(start.elapsed_time(end) / STEPS)
        out[path] = ms
    return out


def multicard(root: Path) -> dict:
    """The rates of one run of the checkout's ``chip_multicard.py``, by part."""
    proc = subprocess.run([sys.executable, str(root / "chip_multicard.py")], cwd=root,
                          check=True, capture_output=True, text=True)
    out = {}
    for line in proc.stdout.splitlines():
        if not line.startswith("{"):
            continue
        row = json.loads(line)
        part = ("ens groups" if "ensemble" in row else f"mesh {row['mesh']}" if "mesh" in row
                else f"cli {row['cli']}" if "cli" in row else None)
        if part is not None:
            out[part] = {k: v for k, v in row.items()
                         if k.startswith(("member_steps_per_s", "ms_per_step", "steps_per_s"))}
    return out


def summarize_multicard(runs: dict, smi: str) -> None:
    """Per part and rate: each process's value, the median, and whether the
    change did better than the parent in every process (a higher rate, a
    lower ms/step)."""
    for part in runs["change"][0]:
        for key in runs["change"][0][part]:
            row = {"part": part, "rate": key, "smi": smi}
            for tree, rs in runs.items():
                vals = [r[part][key] for r in rs]
                row[tree] = {"processes": vals, "median": statistics.median(vals)}
            ch, pa = row["change"]["processes"], row["parent"]["processes"]
            row["change_better_in_every_process"] = (
                max(ch) < min(pa) if key.startswith("ms_") else min(ch) > max(pa))
            print(json.dumps(row), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("parent", type=Path, nargs="?")
    ap.add_argument("change", type=Path, nargs="?", default=Path(__file__).resolve().parent)
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--windows", type=int, default=12)
    ap.add_argument("--grid", type=int, default=2048)
    ap.add_argument("--multicard", action="store_true")
    ap.add_argument("--child", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device", file=sys.stderr)
        return 2
    if args.child is not None:
        print(json.dumps(child(args.child.resolve(), args.windows, args.grid)), flush=True)
        return 0
    if args.parent is None:
        ap.error("PARENT_DIR is required")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    trees = {"parent": args.parent.resolve(), "change": args.change.resolve()}
    runs = {"parent": [], "change": []}
    for i in range(args.rounds):
        order = ("parent", "change") if i % 2 == 0 else ("change", "parent")
        for tree in order:
            if args.multicard:
                runs[tree].append(multicard(trees[tree]))
                print(json.dumps({"round": i + 1, "tree": tree, **runs[tree][-1]}), flush=True)
                continue
            proc = subprocess.run(
                [sys.executable, str(Path(__file__).resolve()), "--child", str(trees[tree]),
                 "--windows", str(args.windows), "--grid", str(args.grid)],
                check=True, capture_output=True, text=True)
            runs[tree].append(json.loads(proc.stdout.strip().splitlines()[-1]))
            print(json.dumps({"round": i + 1, "tree": tree, **runs[tree][-1]}), flush=True)
    if args.multicard:
        summarize_multicard(runs, smi)
        return 0
    for path in PATHS:
        row = {"path": path, "grid": f"{args.grid}x{args.grid}", "smi": smi}
        for tree, rs in runs.items():
            windows = [w for r in rs for w in r[path]]
            row[tree] = {"process_medians": [statistics.median(r[path]) for r in rs],
                         "median": statistics.median(windows),
                         "quartiles": statistics.quantiles(windows, n=4)}
        row["change_faster_in_every_process"] = (
            max(row["change"]["process_medians"]) < min(row["parent"]["process_medians"]))
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
