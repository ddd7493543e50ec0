#!/usr/bin/env python3
"""The sharded rollout across every visible NVIDIA card, against the same
mesh with every shard on one card.

    python3 chip_multicard.py [--grid 8192] [--steps 20] [--shards 4]

Needs at least two CUDA devices (on one card ``chip_smoke.py`` phases 12
and 13 run the meshes).  First the ensemble over an (ens, x 1) mesh
(``parallel.sharded``): BASELINE.json config 4, 64 members of 512² gpu
parity with 40 pressure sweeps and jittered orbits, 200 steps, one ens
group of 64 / ``--shards`` members a card against every group on card 0:
the final states equal bit for bit, each card's launches of batched
H1-H4, and member-steps/s of both placements and of the one-device
ensemble.  Then, for the rows mesh and the 2-D mesh of ``--shards``
shards (gpu parity, 100 pressure sweeps, the CLI's orbit): the rollout
with the shards round-robin on the visible cards equals the rollout with
every shard on card 0 bit for bit (the same kernels on the same inputs;
only the halo copies cross cards), each card's kernel launches, and the
wall ms a step of both placements and of one device (every card
synchronized around each timed rollout).  Then the CLI's ``--mesh rows``
and ``--mesh 2d`` over the visible cards.  Prints the cards' names and
power limits and one JSON line a result; exits non-zero on a mismatch.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--grid", type=int, default=8192)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--shards", type=int, default=4)
    args = p.parse_args()
    import torch

    if torch.cuda.device_count() < 2:
        print("chip_multicard: needs at least two CUDA devices", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import numpy as np

    from cudafluidsimulation_tpu_torch import FluidConfig, Simulation, cli
    from cudafluidsimulation_tpu_torch.models.ensemble import (
        batched_impulse, batched_state, make_ensemble_run)
    from cudafluidsimulation_tpu_torch.ops import _build, advect_cuda, jacobi_cuda
    from cudafluidsimulation_tpu_torch.parallel import mesh as pmesh
    from cudafluidsimulation_tpu_torch.parallel import sharded, shardmap2d, shardmap_step
    from cudafluidsimulation_tpu_torch.utils.impulse import orbit_impulse

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip().splitlines()
    for line in smi:
        print(line, flush=True)
    _build.build_all()
    n, steps, k = args.grid, args.steps, args.shards
    cards = pmesh.visible_devices()
    cfg = FluidConfig.gpu_reference(nx=n, ny=n, pressure_iters=100, backend="cuda")
    imp = orbit_impulse(steps, cfg.dt, center=(n / 2, n / 2), radius=n / 8, omega=3.0)
    sim = Simulation(cfg, device="cuda:0")

    def sync():
        for c in cards:
            torch.cuda.synchronize(c)

    def wall_ms(fn, iters=2, steps=steps):
        fn()
        sync()
        out = []
        for _ in range(iters):
            t0 = time.perf_counter()
            fn()
            sync()
            out.append((time.perf_counter() - t0) * 1e3 / steps)
        return statistics.median(out)

    ok = True
    # the ensemble: a group per card against every group on card 0
    ecfg = FluidConfig.gpu_reference(nx=512, ny=512, pressure_iters=40, backend="cuda")
    n_members, e_steps = 64, 200
    jitter = np.random.default_rng(0).uniform(-32.0, 32.0, (n_members, 2)).astype(np.float32)
    bimp = batched_impulse(orbit_impulse(e_steps, ecfg.dt, center=(256.0, 256.0), radius=64,
                                         omega=3.0), n_members, jitter_pos=jitter)
    start = batched_state(ecfg, n_members, "cuda:0")
    groups = {"spread": sharded.make_mesh(k, ens=k, devices=cards),
              "one card": sharded.make_mesh(k, ens=k, devices=cards[:1])}
    runs = {where: sharded.sharded_rollout(ecfg, m, batched=True) for where, m in groups.items()}
    states = {where: sharded.shard_state(start, m, batched=True) for where, m in groups.items()}
    batched = {"H1 batched": advect_cuda.BATCHED, "H2 batched": jacobi_cuda.VORTICITY_BATCHED,
               "H3 batched": jacobi_cuda.DIFFUSE_BATCHED, "H4 batched": jacobi_cuda.PRESSURE_BATCHED}
    finals, by_card = {}, {}
    for where, m in groups.items():
        for kern in batched.values():
            kern.reset()
        finals[where] = pmesh.gather_state(runs[where](states[where], bimp), "cuda:0")
        sync()
        by_card[where] = {name: {f"group {i} {m.devices[i]}": kern.by_shard.get(i, 0)
                                 for i in range(m.size)} for name, kern in batched.items()}
    equal = {f: bool(torch.equal(getattr(finals["spread"], f), getattr(finals["one card"], f)))
             for f in ("u", "v", "dye", "pressure", "vel_stats")}
    ok = ok and all(equal.values())
    ens_run = make_ensemble_run(ecfg)
    member_steps = n_members * e_steps
    rates = {f"member_steps_per_s_{where.replace(' ', '_')}":
             member_steps / (wall_ms(lambda: runs[where](states[where], bimp), steps=e_steps)
                             * e_steps / 1e3) for where in groups}
    rates["member_steps_per_s_one_device_ensemble"] = member_steps / (
        wall_ms(lambda: ens_run(start, bimp), steps=e_steps) * e_steps / 1e3)
    print(json.dumps({"ensemble": f"{n_members}x512x512", "steps": e_steps,
                      "mesh": dict(groups["spread"].shape),
                      "cards": [str(d) for d in groups["spread"].devices],
                      "spread_equals_one_card": equal, "launches_by_card": by_card, **rates,
                      "smi": smi}), flush=True)
    del finals, states, start

    one_ms = wall_ms(lambda: sim.run(sim.init(), imp))
    nr = int(k ** 0.5)
    while k % nr:
        nr -= 1
    kernels = {"H1 window": advect_cuda.WINDOW, "H3": jacobi_cuda.DIFFUSE,
               "H4 solve": jacobi_cuda.PRESSURE_SOLVE}
    for kind, make in (("rows", lambda devs: pmesh.make_mesh(k, devices=devs)),
                       (f"{nr}x{k // nr}", lambda devs: pmesh.make_mesh2d(nr, k // nr, devs))):
        build = (shardmap_step.make_shardmap_rollout if kind == "rows"
                 else shardmap2d.make_shardmap2d_rollout)
        spread, packed = make(pmesh.place(k, cards)), make(pmesh.place(k, cards[:1]))
        run_s, run_p = build(cfg, spread), build(cfg, packed)
        st_s = pmesh.shard_state(sim.init(), spread)
        st_p = pmesh.shard_state(sim.init(), packed)
        for kern in kernels.values():
            kern.reset()
        a = pmesh.gather_state(run_s(st_s, imp), "cuda:0")
        sync()
        by_card = {name: {str(spread.devices[i]): kern.by_shard.get(i, 0)
                          for i in range(spread.size)} for name, kern in kernels.items()}
        b = pmesh.gather_state(run_p(st_p, imp), "cuda:0")
        equal = {f: bool(torch.equal(getattr(a, f), getattr(b, f)))
                 for f in ("u", "v", "dye", "pressure", "vel_stats")}
        ok = ok and all(equal.values())
        print(json.dumps({"mesh": kind, "grid": f"{n}x{n}", "steps": steps, "shards": k,
                          "cards": [str(d) for d in spread.devices],
                          "spread_equals_one_card": equal, "launches_by_card": by_card,
                          "exchange_pairs_per_step": run_s.counts[0]["exchanges"] / steps,
                          "ms_per_step_spread": wall_ms(lambda: run_s(st_s, imp)),
                          "ms_per_step_one_card": wall_ms(lambda: run_p(st_p, imp)),
                          "ms_per_step_one_device": one_ms, "smi": smi}), flush=True)
        del a, b, st_s, st_p
    for flag in ("rows", "2d"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["--grid", str(n), "--steps", str(steps), "--pressure-iters", "100",
                           "--mesh", flag, "--report"])
        text = buf.getvalue()
        thr = re.search(r"Throughput: ([\d.]+) steps/s", text)
        ok = ok and rc == 0
        print(json.dumps({"cli": flag, "exit": rc,
                          "mesh_lines": re.findall(r"^mesh: .*$", text, flags=re.M),
                          "steps_per_s": float(thr.group(1)) if thr else None}), flush=True)
    print(json.dumps({"ok": ok, "cards": len(cards)}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
