"""The plain quality step: the gpu-parity step with its pressure solved by
geometric multigrid V-cycles to a residual target.

The step is ``reference/step.py``'s up to the pressure stage (the same
frozen ops, ``reference/ops.py``), then divergence -> V-cycles from p = 0
-> projection.  The pressure system is the one the Jacobi sweeps iterate,
A p = rhs with A p = 4 p - (L + R + B + T) (clamped edges) and
rhs = -div, and one V-cycle from a level's iterate p is:

- pre-smooth: ``NU1`` damped-Jacobi sweeps p + omega ((L+R+B+T+rhs) 0.25 - p),
  omega = 0.8, the centre term the current iterate;
- the residual rhs - A p, restricted by a 2x2 average (rows first), times 4
  (the coarse level's mesh width is twice the fine one's): the coarse
  level's right-hand side;
- the coarse correction: a V-cycle of the coarse level from zero (on the
  coarsest level, ``COARSE_SWEEPS`` damped sweeps from zero);
- p plus the correction's cell-centred bilinear (9-3-3-1) prolongation,
  with clamped padding, then ``NU2`` post-smooth sweeps.

Levels halve while both sides stay even and the halves keep at least
``MIN_SIZE`` cells, at most ``MAX_LEVELS`` levels (2048^2: 8 levels, down to
16^2).  The stopping test follows each fine pre-smooth: the solve stops once
mean(res^2) < float32(tol)^2, returning that probed iterate, or once
``mg_max_cycles`` cycles have completed, returning the last completed
cycle's iterate.  mean(res^2) is summed in a fixed order (:func:`mean_square`),
so the same residual gives the same cycle count wherever it is summed.

Every expression keeps the float32 association order written above, so
the step is the multigrid step of the program's plain ops bit for bit.
``dtype`` sets the precision of every field between two ops of the step;
the V-cycles run in that precision throughout (bfloat16: the control).

Departures from a textbook V-cycle, each the deployment's own: the
coarse rhs carries the factor 4 instead of rescaling A by the mesh width;
the first pre-smooth of every coarse level starts from zero; a stopped
solve returns the probed iterate (pre-smoothed), not a completed cycle's.
:class:`Params` refuses every other configuration: the Jacobi solver, a
fixed cycle count (``mg_tol`` <= 0), the cpu variant, a boundary strip and
a grid of one level.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from fluidbench.reference import ops
from fluidbench.reference.ops import F, f32, f32_vec, neighbors
from fluidbench.reference.step import PALETTE, Impulse, State, host_scalars, init, render

__all__ = ["Params", "State", "Impulse", "init", "step", "host_scalars", "render", "stages"]

# the comparison decides in float32 wherever the step runs
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

OMEGA = 0.8  # damped-Jacobi weight
NU1 = NU2 = 2  # pre- and post-smooth sweeps a level
COARSE_SWEEPS = 20  # sweeps on the coarsest level
MAX_LEVELS, MIN_SIZE = 8, 16
THREADS, PER_THREAD = 256, 32  # mean_square's summation order
F32 = 4


class Params(NamedTuple):
    """The physical parameters of one quality configuration (its file's
    ``fluid``)."""

    nx: int
    ny: int
    dt: float
    velocity_diffusion: float
    color_diffusion: float
    decay_rate: float
    vorticity: float
    force_scale: float
    splat_radius: float
    diffusion_iters: int
    half_divergence: bool
    bloom_enabled: bool
    bloom_intense: float
    bloom_duration: float
    mg_tol: float
    mg_max_cycles: int

    @staticmethod
    def from_fluid(fluid: dict) -> "Params":
        """The parameters from a configuration's ``fluid`` table; raises
        ValueError for a step this reference does not write."""
        wanted = {"variant": "gpu", "pressure_solver": "multigrid",
                  "color_diffusion_enabled": True, "boundary_rows": 0}
        for key, value in wanted.items():
            if fluid.get(key) != value:
                raise ValueError(f"the quality reference needs {key}={value!r}, "
                                 f"got {fluid.get(key)!r}")
        if not fluid.get("mg_tol", 0) > 0:
            raise ValueError(f"the quality reference needs mg_tol > 0 (cycles to a "
                             f"residual target), got {fluid.get('mg_tol')!r}")
        if len(level_shapes(fluid["ny"], fluid["nx"])) < 2:
            raise ValueError(f"the quality reference needs two levels or more, got nx="
                             f"{fluid['nx']}, ny={fluid['ny']}")
        return Params(**{k: fluid[k] for k in Params._fields})


# -- the V-cycle ----------------------------------------------------------------


def level_shapes(h: int, w: int) -> list:
    """(h, w) of every level, the fine one first."""
    shapes = [(h, w)]
    while (len(shapes) < MAX_LEVELS and h % 2 == 0 and w % 2 == 0
           and h // 2 >= MIN_SIZE and w // 2 >= MIN_SIZE):
        h, w = h // 2, w // 2
        shapes.append((h, w))
    return shapes


def apply_a(p: torch.Tensor) -> torch.Tensor:
    """A p = 4 p - (L + R + B + T)."""
    l, r, b, t = neighbors(p)
    return 4.0 * p - (l + r + b + t)


def smooth(p: torch.Tensor, rhs: torch.Tensor, sweeps: int) -> torch.Tensor:
    """``sweeps`` damped-Jacobi sweeps of A p = rhs."""
    for _ in range(sweeps):
        l, r, b, t = neighbors(p)
        p = p + OMEGA * ((l + r + b + t + rhs) * 0.25 - p)
    return p


def restrict(x: torch.Tensor) -> torch.Tensor:
    """2x2 average: pairs of rows summed, then pairs of columns."""
    rows = x[0::2, :] + x[1::2, :]
    return (rows[:, 0::2] + rows[:, 1::2]) * 0.25


def prolong(e: torch.Tensor) -> torch.Tensor:
    """Cell-centred bilinear prolongation: fine cell (2i + a, 2j + b) is
    (9 centre + 3 row neighbour + 3 column neighbour + diagonal) / 16 of
    coarse cell (i, j) and its neighbours on the fine cell's side, the
    coarse plane padded by its edge cells."""
    xp = torch.cat([e[:1], e, e[-1:]], dim=0)
    xp = torch.cat([xp[:, :1], xp, xp[:, -1:]], dim=1)
    c = xp[1:-1, 1:-1]
    lo, hi = xp[:-2, 1:-1], xp[2:, 1:-1]  # rows i - 1, i + 1
    left, right = xp[1:-1, :-2], xp[1:-1, 2:]
    s = 1.0 / 16.0
    out = torch.empty((2 * e.shape[0], 2 * e.shape[1]), dtype=e.dtype, device=e.device)
    out[0::2, 0::2] = (9.0 * c + 3.0 * lo + 3.0 * left + xp[:-2, :-2]) * s
    out[0::2, 1::2] = (9.0 * c + 3.0 * lo + 3.0 * right + xp[:-2, 2:]) * s
    out[1::2, 0::2] = (9.0 * c + 3.0 * hi + 3.0 * left + xp[2:, :-2]) * s
    out[1::2, 1::2] = (9.0 * c + 3.0 * hi + 3.0 * right + xp[2:, 2:]) * s
    return out


def vcycle(p: torch.Tensor, rhs: torch.Tensor, level: int) -> torch.Tensor:
    """One V-cycle from ``p`` on a level with ``level`` levels below and at
    it (1: the coarsest, swept alone)."""
    if level == 1:
        return smooth(p, rhs, COARSE_SWEEPS)
    p = smooth(p, rhs, NU1)
    return complete(p, rhs - apply_a(p), rhs, level)


def complete(p: torch.Tensor, res: torch.Tensor, rhs: torch.Tensor,
             level: int) -> torch.Tensor:
    """The rest of a cycle after its pre-smooth left ``p`` and residual
    ``res``: the coarse correction from zero, prolonged, and the
    post-smooth."""
    rhs_c = 4.0 * restrict(res)
    e_c = vcycle(torch.zeros_like(rhs_c), rhs_c, level - 1)
    return smooth(p + prolong(e_c), rhs, NU2)


def _tree(x: torch.Tensor) -> torch.Tensor:
    """(..., T) -> (...), T a power of two: x[t] += x[t + T/2], then T/4, ... 1."""
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        x = x[..., :half] + x[..., half:]
    return x[..., 0]


def _chunk_sums(x: torch.Tensor, per_thread: int) -> torch.Tensor:
    """(n,) -> (chunks,): chunks of THREADS x per_thread values (the last
    padded with zeros); in each, thread t adds values t, t + THREADS, ...
    from zero in turn, and the threads' sums meet in a tree."""
    chunk = THREADS * per_thread
    chunks = -(-x.shape[0] // chunk)
    x = torch.cat([x, x.new_zeros(chunks * chunk - x.shape[0])])
    x = x.reshape(chunks, per_thread, THREADS)
    acc = x.new_zeros(chunks, THREADS)
    for j in range(per_thread):
        acc = acc + x[:, j, :]
    return _tree(acc)


def mean_square(r: torch.Tensor) -> torch.Tensor:
    """mean(r^2) of a plane, 0-d: the squares summed in chunks of
    THREADS x PER_THREAD cells (:func:`_chunk_sums`), the chunks' sums
    summed the same way in one chunk, divided by the plane's cells."""
    n = r.shape[0] * r.shape[1]
    part = _chunk_sums((r * r).reshape(n), PER_THREAD)
    total = _chunk_sums(part, -(-part.shape[0] // THREADS))[0]
    return total / torch.full_like(total, float(n))


def solve(rhs: torch.Tensor, tol: float, max_cycles: int):
    """(p, cycles): V-cycles from p = 0 until the residual's mean square
    after a fine pre-smooth falls under float32(tol)^2 (that iterate), or
    ``max_cycles`` cycles have completed (the last one's iterate)."""
    levels = len(level_shapes(*rhs.shape))
    tol2 = float(F(tol) ** 2)

    def presmooth(q):
        q = smooth(q, rhs, NU1)
        return q, rhs - apply_a(q)

    completed = torch.zeros_like(rhs)
    p, res = presmooth(completed)
    cycles = 0
    while float(mean_square(res)) >= tol2:
        if cycles == max_cycles:
            return completed, cycles
        completed = complete(p, res, rhs, levels)
        cycles += 1
        p, res = presmooth(completed)
    return p, cycles


# -- the step -------------------------------------------------------------------


def step(p: Params, s: State, imp: Impulse, dtype=torch.float32) -> State:
    """One step from ``s`` under ``imp``; every field rounded to ``dtype``
    after each op, the V-cycles computed in it."""
    c = lambda t: t.to(dtype)  # noqa: E731
    dt = f32(imp.dt)
    u, v, dye = c(s.u), c(s.v), c(s.dye)

    u, v = map(c, ops.advect_velocity(u, v, dt, p.decay_rate))
    dye = c(ops.advect_dye(dye, u, v, dt, p.decay_rate))
    u, v = map(c, ops.vorticity_confinement(u, v, dt, p.vorticity))

    scalars = host_scalars(s, imp, dtype)
    pressed_f = F(bool(imp.pressed))
    color = ops.cycle_color(PALETTE, scalars.press_time)
    cur = f32_vec(imp.pos)
    last = f32_vec(imp.last_pos)
    force = F(p.force_scale) * pressed_f
    amps = np.concatenate([
        np.asarray([(last[0] - cur[0]) * force * dt, (last[1] - cur[1]) * force * dt],
                   np.float32),
        color * pressed_f])
    coeffs = np.asarray([p.velocity_diffusion] * 2 + [p.color_diffusion] * 3, np.float32)
    pack = torch.cat([torch.stack([u, v]), dye])
    pack = c(ops.diffuse_multi(pack, dt, coeffs, p.diffusion_iters))
    pack = c(ops.splat_tail(pack, amps, last, p.splat_radius))
    u, v, dye = pack[0], pack[1], pack[2:]

    div = c(ops.divergence(u, v, p.half_divergence))
    pres = c(solve(-div, p.mg_tol, p.mg_max_cycles)[0])
    u, v = map(c, ops.project(u, v, pres))

    return scalars._replace(u=u, v=v, dye=dye, pressure=pres, vel_stats=ops.vel_max(u, v))


# -- the step's work, for roofline.py ---------------------------------------------


def stages(fluid: dict) -> dict:
    """Stage -> (bytes, float32 operations) of one quality step at the
    grid of ``fluid``, by ``roofline.py``'s rule: each input plane read
    once and each output plane written once, at each level's size (n_j
    cells, n_0 the fine level's), counted for each smoother end the step
    runs (the divergence, a pre-smooth with its residual and restriction, a
    post-smooth with the prolonged correction, the coarsest sweeps, the
    stopping test's sum, the projection).  Operations a cell: divergence
    and its sign 5; a damped sweep 8 (from zero 2); the residual 6; the
    restriction and its factor 5 a coarse cell; the prolongation and its
    add 8; a square and its sum 2; the projection and the bound 8.

    - advection, vorticity, diffusion_splat: the parity step's
      (``roofline.stages``);
    - pressure_projection, once a step: the divergence and the first fine
      pre-smooth with its residual and restriction (reads u, v; writes p,
      rhs, res, rhs_1), the first stopping sum (reads res) and the
      projection with its bound (reads u, v, p; writes u, v, the bound):
      11 n_0 + n_1 planes' cells and 3 floats; 31 n_0 + 5 n_1 operations;
    - mg_cycle, once a completed cycle: on each coarse level j above the
      coarsest, a pre-smooth from zero (reads rhs_j; writes e_j,
      rhs_(j+1)) and a post-smooth (reads e_j, rhs_j, e_(j+1); writes e_j):
      5 n_j + 2 n_(j+1), 40 n_j + 5 n_(j+1) operations; the coarsest level's
      sweeps from zero (reads rhs, writes e): 2 n_c, 154 n_c; the fine
      post-smooth (reads p, rhs, e_1; writes p), the next pre-smooth with
      its residual and restriction (reads p, rhs; writes p, res, rhs_1) and
      its stopping sum (reads res, writes one float): 8 n_0 + 2 n_1 and one
      float, 48 n_0 + 5 n_1 operations.

    A step of k cycles is bounded by pressure_projection + k mg_cycle; the
    sum of the stages bounds no step (``spec.py``)."""
    h, w = fluid["ny"], fluid["nx"]
    n = [a * b for a, b in level_shapes(h, w)]
    n0, n1 = n[0], n[1]
    plane = F32 * n0
    di = fluid["diffusion_iters"]
    cyc_b, cyc_o = 8 * n0 + 2 * n1 + 1, 48 * n0 + 5 * n1
    for j in range(1, len(n) - 1):
        cyc_b += 5 * n[j] + 2 * n[j + 1]
        cyc_o += 40 * n[j] + 5 * n[j + 1]
    cyc_b += 2 * n[-1]
    cyc_o += (2 + (COARSE_SWEEPS - 1) * 8) * n[-1]
    return {
        "advection": (10 * plane, n0 * ((18 + 2 * 12 + 2 + 4) + (18 + 3 * 15))),
        "vorticity": (4 * plane, n0 * 25),
        "diffusion_splat": (10 * plane, 5 * n0 * (6 * di + 10)),
        "pressure_projection": (F32 * (11 * n0 + n1 + 3), 31 * n0 + 5 * n1),
        "mg_cycle": (F32 * cyc_b, cyc_o),
    }
