"""The step's least time on a card: each stage's bound, from its shapes.

A stage's bound is the larger of its bytes at the card's memory bandwidth
and its float32 operations at the card's float32 rate.  Each input plane
is read once and each output plane written once (float32, ny x nx cells),
whatever kernel carries the stage or however often it re-reads: the count
reads the same work whichever kernel implements it.  The stages of the
gpu-parity step, with their operations a cell counted from the formulas
(a transcendental counts one):

- advection: reads u, v and the dye (5 planes), writes them (5); the
  velocity's backtrace and clamped taps 18, two blends 2 x 12, two
  decays, the bound's two abs and maxes 4; the dye's backtrace 18, three
  blends with their pow, scale and min 3 x 15;
- vorticity confinement: reads u, v, writes u, v; 25;
- diffusion with the splat: reads the 5-channel pack, writes it; a sweep
  6 a channel, the splat's Gaussian and add 10 a channel;
- pressure with projection: reads u, v, writes u, v and p (and the 8-byte
  velocity bound); the divergence 4, a sweep 5, the projection and the
  bound 8.

A fusion across stages that skips writing an intermediate could beat this
count; at 2048^2 that needs a ~7x cut of the step's device time first.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

# published peaks (NVIDIA's data sheet, SXM part, at its 700 W limit), by
# the name torch.cuda.get_device_name gives
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bytes_per_s": 3.35e12, "f32_ops_per_s": 67e12},
}

F32 = 4

Count = Callable[[dict], Dict[str, tuple]]  # fluid -> stage -> (bytes, f32 ops)


def stages(fluid: dict) -> Dict[str, tuple]:
    """Stage -> (bytes, float32 operations) of one step of ``fluid``."""
    cells = fluid["nx"] * fluid["ny"]
    plane = F32 * cells
    di, pi = fluid["diffusion_iters"], fluid["pressure_iters"]
    return {
        "advection": (10 * plane, cells * ((18 + 2 * 12 + 2 + 4) + (18 + 3 * 15))),
        "vorticity": (4 * plane, cells * 25),
        "diffusion_splat": (10 * plane, 5 * cells * (6 * di + 10)),
        "pressure_projection": (5 * plane + 2 * F32, cells * (4 + 5 * pi + 8)),
    }


def stage_bound_s(fluid: dict, kind: str, count: Count = stages) -> Optional[Dict[str, float]]:
    """Stage -> its bound in seconds on a card named ``kind``, from
    ``count(fluid)`` (:func:`stages`, or a reference's own count of a step
    whose work differs); None for a card without a row in :data:`PEAKS`."""
    peak = PEAKS.get(kind)
    if peak is None:
        return None
    return {name: max(b / peak["bytes_per_s"], ops / peak["f32_ops_per_s"])
            for name, (b, ops) in count(fluid).items()}


def step_bound_s(fluid: dict, kind: str, count: Count = stages) -> Optional[float]:
    """The step's bound in seconds on a card named ``kind``: the sum of its
    stages' (None for a card without a row in :data:`PEAKS`)."""
    bounds = stage_bound_s(fluid, kind, count)
    return None if bounds is None else sum(bounds.values())
