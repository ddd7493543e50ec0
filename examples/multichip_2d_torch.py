"""A 2-D (rows x cols) sharded rollout on the PyTorch/CUDA port: 2 x 4
shards placed round-robin on the visible cards (several shards share a
card), or on the CPU.

    python examples/multichip_2d_torch.py            # on the card(s)
    python examples/multichip_2d_torch.py --cpu      # 8 CPU shards, plain ops
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from cudafluidsimulation_tpu_torch import FluidConfig, init_state
from cudafluidsimulation_tpu_torch.parallel.halo import measure_halo_traffic
from cudafluidsimulation_tpu_torch.parallel.mesh import (
    gather_state, make_mesh2d, place, shard_state_2d)
from cudafluidsimulation_tpu_torch.parallel.shardmap2d import (
    make_shardmap2d_rollout, make_shardmap2d_step)
from cudafluidsimulation_tpu_torch.utils.impulse import orbit_impulse


def main(cpu=False, n=512, steps=50):
    backend = "ref" if cpu else "auto"
    devices = place(8, ["cpu"] if cpu else None)
    mesh = make_mesh2d(2, 4, devices=devices)
    print(f"mesh: 2x4 over {sorted({str(d) for d in devices})}")
    cfg = FluidConfig.gpu_reference(nx=n, ny=n, backend=backend, diffusion_iters=4,
                                    pressure_iters=10)
    run = make_shardmap2d_rollout(cfg, mesh)
    state = shard_state_2d(init_state(cfg, device=devices[0]), mesh)
    imp = orbit_impulse(steps, cfg.dt, center=(n / 2, n / 2), radius=n / 8)
    out = gather_state(run(state, imp))
    print(f"{steps} steps done; max |u| =", float(out.u.abs().max()))
    traffic = measure_halo_traffic(cfg, mesh, step_builder=make_shardmap2d_step)
    print("per-shard per-step collective schedule:", traffic)
    return out


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cpu", action="store_true", help="8 CPU shards on the plain ops")
    main(cpu=p.parse_args().cpu)
