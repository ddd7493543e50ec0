"""Minimal headless simulation on the PyTorch/CUDA port: scripted stirring,
PNG frames through the asynchronous frame sink, and a checkpoint.

    python examples/headless_run_torch.py [--out DIR]

Runs on the CUDA device (``main(..., backend="ref")`` runs the plain
PyTorch ops on the CPU).
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from cudafluidsimulation_tpu_torch import FluidConfig, Simulation
from cudafluidsimulation_tpu_torch.utils.checkpoint import save_state
from cudafluidsimulation_tpu_torch.utils.impulse import orbit_impulse
from cudafluidsimulation_tpu_torch.utils.native_sink import FrameSink


def main(out_dir=".", grid=512, steps=300, backend="auto"):
    cfg = FluidConfig.gpu_reference(nx=grid, ny=grid, backend=backend)
    sim = Simulation(cfg)
    imp = orbit_impulse(steps, cfg.dt, center=(grid / 2, grid / 2), radius=grid / 8, omega=3.0)

    state, frames = sim.collect_frames(sim.init(), imp, every=10)

    frames_dir = os.path.join(out_dir, "out_frames")
    # room for every frame: an offline dump drops none (the sink's default
    # capacity drops the oldest, as a real-time display does)
    with FrameSink(frames_dir, grid, grid, capacity=len(frames)) as sink:
        for frame in frames:
            sink.push(frame)
        sink.flush()
        print(f"wrote {sink.written} frames to {frames_dir}/")

    ckpt = os.path.join(out_dir, "out_state.npz")
    save_state(ckpt, state)
    print(f"checkpoint saved to {ckpt}")
    return state


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=".", help="directory for out_frames/ and out_state.npz")
    main(p.parse_args().out)
