"""H2–H5: the stencil kernels on the card.

Each wrapper takes the plain version (``ops.ref``) for CPU tensors and
launches its kernel or raises for CUDA tensors.  Byte counts below are for
the 2048² main path (one float32 plane is 16 MiB).

**H2 vorticity** (``csrc/vorticity.cu``) replaces
``cudafluidsimulation_tpu/ops/jacobi_pallas.py`` ``vorticity_confinement``
→ ``_vorticity_kernel`` (``_curl_taps``, ``_confinement``).  Bound by bytes:
read u, v and write u', v' (64 MiB).  One kernel: a block loads its
128 × 16 tile of u and v once, with the halo the curl's ring needs, into
shared memory as 16-byte loads, computes the curl of the tile and its
one-cell ring there, then the confinement force, 4 columns a thread with
16-byte stores; the force reads the curl at clamped coordinates, as
``ops.ref`` clamps the curl field.  The curl never goes to device memory.
A width that is not a multiple of 4, or a plane that is not 16-byte
aligned, takes scalar loads and stores in the same kernel.

**H3 diffusion** (``csrc/diffuse.cu``) replaces ``_diffuse_bursts`` →
``_diffuse_kernel`` and ``_diffuse_burst_tiled`` → ``_diffuse_kernel_tiled``
(entries ``diffuse``, ``diffuse_multi``, ``diffuse_multi_splat``).  Each
launch is a burst of sweeps, temporally blocked (``csrc/burst.cuh``): a
block loads its channel's tile plus a ring as deep as the burst into
shared memory, sweeps there (the region shrinks a ring a sweep), and
writes the tile; the splat tail rides the last sweep of the last burst.
A sweep moves 8 bytes a cell, so one launch per sweep (the first design,
2.45 ms for 5 channels × 20 sweeps at 2048²) was bound by device memory;
a burst moves them once per ``depth`` sweeps and is bound by the SMs'
instruction issue and shared-memory traffic and by the halo's redundant
cells: 0.57 ms on an NVIDIA H100 80GB HBM3 at 700 W.

**H4 pressure** (``csrc/pressure.cu``) replaces ``pressure_project`` →
``_single_pressure_kernel``, ``_first_pressure_kernel``,
``_pressure_kernel``, ``_last_pressure_kernel`` (and the tiled twins), with
the same bursts: the first computes the divergence of its region from u
and v and sweeps from p = 0, the last runs one ring deeper, subtracts the
gradient and emits [max|u'|, max|v'|].  Its standalone entry
``pressure_solve`` (``PRESSURE_SOLVE``, its own launch count) replaces
``jacobi_pallas.pressure_solve`` → ``_pressure_kernel``: the same bursts
over a given ``div``, from p = 0 or, as JAX's ``init``, from a given
iterate.  40 sweeps at 2048²: 0.385 ms, against 0.96 ms one
launch a sweep (same card); the solve alone 0.32 ms.

:func:`plan_bursts` chooses the tile and the sweeps of each burst: fewer,
deeper bursts trade device-memory round trips and launches for redundant
halo work, (TX + 2k)(TY + 2k) / (TX·TY) cells computed per cell kept, and
for shared memory per block.  A grid inside one tile runs every sweep in
one launch.  The default, 48 × 112 tiles and bursts of at most 8 sweeps,
makes a shared row 128 floats (one warp's width) and runs 20 sweeps in 3
launches, 40 in 5; other tiles and depths measured within a few percent.

**H5 divergence and projection** (``csrc/pressure.cu``, ``STENCIL``)
replaces ``divergence`` → ``_divergence_kernel`` and ``project`` →
``_project_kernel``: one launch each.  Bound by bytes: the divergence
reads u, v and writes div (48 MiB); the projection reads p, u, v and
writes u', v' (80 MiB), with the velocity bound as a block max and an
atomic max (zeroed on the stream first).  The multigrid projection
(``ops/multigrid.py``) ends on ``project``.  ``divergence_batched`` and
``project_batched`` (``STENCIL_BATCHED``) take B members a launch, member b
on grid z, u and v at any member stride (a (B, 5, H, W) pack's planes).
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from cudafluidsimulation_tpu_torch.ops import member_params, ref
from cudafluidsimulation_tpu_torch.ops._build import (
    Kernel, check_f32, check_planes, on_card, stream_of)

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong

# fluid_vorticity(u, v, u2, v2, h, w, cpu_variant, dt, vorticity, nb, u_ms,
#                 v_ms, u2_ms, v2_ms, prm, prm_stride, stream)
_VORTICITY = {"fluid_vorticity": [_P] * 4 + [_I] * 3 + [_F, _F, _I] + [_L] * 4 + [_P, _I, _P]}
VORTICITY = Kernel("vorticity", _VORTICITY)
# fluid_diffuse(in, out, scratch, n, h, w, tile_h, tile_w, depths*, nbursts,
#               alpha*, inv_beta*, amp*, lx, ly, radius, splat, prm,
#               prm_stride, chans, stream); depths, alpha, inv_beta and amp
#               are host pointers, prm a device pointer
_DIFFUSE = {"fluid_diffuse": [_P] * 3 + [_I] * 5 + [_P, _I] + [_P] * 3 + [_F] * 3
            + [_I, _P, _I, _I, _P]}
DIFFUSE = Kernel("diffuse", _DIFFUSE)
# fluid_pressure_project(u, v, u2, v2, p, div, scratch, stats, h, w, tile_h,
#                        tile_w, depths*, nbursts, half, nb, u_ms, v_ms, stream)
_PRESSURE = {"fluid_pressure_project": [_P] * 8 + [_I] * 4 + [_P] + [_I] * 3 + [_L] * 2 + [_P]}
PRESSURE = Kernel("pressure", _PRESSURE)
# the same entries, B members a launch (their own launch counts)
VORTICITY_BATCHED = Kernel("vorticity", _VORTICITY)
DIFFUSE_BATCHED = Kernel("diffuse", _DIFFUSE)
PRESSURE_BATCHED = Kernel("pressure", _PRESSURE)
# fluid_pressure_solve(div, p, scratch, h, w, tile_h, tile_w, depths*,
#                      nbursts, init, stream); init may be null
PRESSURE_SOLVE = Kernel("pressure", {
    "fluid_pressure_solve": [_P] * 3 + [_I] * 4 + [_P, _I, _P, _P],
})
# fluid_divergence(u, v, div, h, w, half, nb, u_ms, v_ms, stream);
# fluid_project(p, u, v, u2, v2, stats, h, w, nb, u_ms, v_ms, stream),
# stats may be null
_STENCIL = {"fluid_divergence": [_P] * 3 + [_I] * 4 + [_L] * 2 + [_P],
            "fluid_project": [_P] * 6 + [_I] * 3 + [_L] * 2 + [_P]}
STENCIL = Kernel("pressure", _STENCIL)
# the same entries, B members a launch (their own launch count)
STENCIL_BATCHED = Kernel("pressure", _STENCIL)

MAX_CHANNELS = 8  # csrc/diffuse.cu FLUID_MAX_CHANNELS: by-value parameters
MAX_GRID_Z = 65535  # csrc/fluid_common.cuh: a block walks z beyond it

# -- the burst planner ---------------------------------------------------------

# Dynamic shared memory a block may ask for on sm_90: 227 KB, less 1 KB for
# the kernels' static shared memory (the block max of the velocity bound).
SMEM_LIMIT = 227 * 1024 - 1024
# (rows, columns) of a block's output tile, and the deepest burst: with
# halos up to 8 a shared row is 128 floats, one warp's 4 columns a lane
TILE = (48, 112)
DEPTH = 8
# shared buffers a block holds: two iterates, and the divergence for H4 or
# the right-hand side for H6's "smooth" (sweeps only) and "smooth_res"
# (sweeps, then a residual or a gradient on the tile) bursts
_BUFFERS = {"diffuse": 2, "project": 3, "solve": 3, "smooth": 3, "smooth_res": 3}
# kinds whose last burst runs one ring deeper, for a tail that reads p
# beyond the tile
_RING = ("project", "smooth_res")


@dataclass(frozen=True)
class BurstPlan:
    """The launches of one H3 or H4 call: each burst's sweeps, the halo a
    block loads around its tile, and its dynamic shared memory.  The C
    entry puts the splat on the last burst, H4's divergence on the first
    and its projection on the last."""

    tile: Tuple[int, int]
    depths: Tuple[int, ...]
    halos: Tuple[int, ...]
    smem: Tuple[int, ...]

    @property
    def iters(self) -> int:
        return sum(self.depths)


def burst_smem(kind: str, h: int, w: int, tile, halo: int) -> int:
    """Bytes of shared memory a block of one burst holds
    (``csrc/burst.cuh`` ``burst_smem_bytes``): its buffers of tile ± halo
    rows (clipped to the grid) by the tile's width (clipped, rounded up to
    4 floats) plus the halo rounded up to 4 floats on each side."""
    rows = min(tile[0] + 2 * halo, h)
    pad = (min(halo, w) + 3) // 4 * 4
    stride = (min(tile[1], w) + 3) // 4 * 4 + 2 * pad
    return 4 * _BUFFERS[kind] * rows * stride


def plan_bursts(h: int, w: int, iters: int, kind: str, *,
                tile: Optional[Tuple[int, int]] = None,
                depth: Optional[int] = None) -> BurstPlan:
    """Split ``iters`` sweeps of a ``kind`` call ("diffuse", "project",
    "solve", or H6's "smooth" and "smooth_res") into bursts of at most
    ``depth`` sweeps, as even as they come, one launch each; the whole of
    them in one launch when the grid fits in one tile (no halo to
    recompute).  The last "project" or "smooth_res" burst runs one ring
    deeper (the gradient or the residual reads p beyond the tile).
    ``iters`` = 0 is one burst of no sweeps (the splat alone; p = 0 and the
    projection), or none for "solve" and H6.  A depth whose shared memory
    exceeds :data:`SMEM_LIMIT` is lowered."""
    if kind not in _BUFFERS:
        raise ValueError(f"kind must be one of {sorted(_BUFFERS)}, got {kind!r}")
    if h < 1 or w < 1 or iters < 0:
        raise ValueError(f"bad shape or iters: {h}x{w}, {iters}")
    tile = tuple(tile or TILE)
    depth = depth or DEPTH
    if min(tile) < 1 or depth < 1:
        raise ValueError(f"bad tile or depth: {tile}, {depth}")
    project = kind in _RING
    while True:
        if iters == 0:
            depths = (0,) if kind in ("diffuse", "project") else ()
        elif h <= tile[0] and w <= tile[1]:
            depths = (iters,)
        else:
            n = math.ceil(iters / depth)
            depths = tuple(iters // n + (j < iters % n) for j in range(n))
        halos = tuple(d + (project and j == len(depths) - 1)
                      for j, d in enumerate(depths))
        smem = tuple(0 if kind == "diffuse" and d == 0 else
                     burst_smem(kind, h, w, tile, a) for d, a in zip(depths, halos))
        if max(smem, default=0) <= SMEM_LIMIT:
            break
        if depth == 1:
            raise ValueError(f"tile {tile} does not fit in shared memory")
        depth -= 1
    return BurstPlan(tile, depths, halos, smem)


def _depths(plan: BurstPlan):
    """(host int array, count) of the plan's depths for the C entry."""
    depths = np.ascontiguousarray(plan.depths, np.int32)
    return depths, (depths.ctypes.data if depths.size else None), int(depths.size)


def vorticity_confinement(u, v, dt, vorticity, variant: str = "gpu", *,
                          out=None):
    """Curl + confinement force; ``ops.ref.vorticity_confinement_{gpu,cpu}``
    semantics.  ``out`` (2, H, W) receives u' and v' (``ref.check_out``):
    the step hands it channels 0-1 of its 5-channel pack."""
    if variant not in ("gpu", "cpu"):
        raise ValueError(f"variant must be 'gpu' or 'cpu', got {variant!r}")
    if out is not None:
        ref.check_out(out, (2,) + tuple(u.shape), u, v)
    if not on_card(*[t for t in (u, v, out) if t is not None]):
        fn = (ref.vorticity_confinement_gpu if variant == "gpu"
              else ref.vorticity_confinement_cpu)
        return fn(u, v, dt, vorticity, out=out)
    h, w = u.shape
    check_f32("u", u, (h, w))
    check_f32("v", v, (h, w))
    if out is None:
        out = torch.empty((2, h, w), dtype=torch.float32, device=u.device)
    with torch.cuda.device(u.device):
        VORTICITY.launch(
            "fluid_vorticity", u.data_ptr(), v.data_ptr(), out[0].data_ptr(),
            out[1].data_ptr(), h, w, int(variant == "cpu"),
            float(ref.f32(dt)), float(ref.f32(vorticity)), 1, 0, 0, 0, 0, None, 0,
            stream_of(u))
    return out[0], out[1]


def _diffuse(fields, dt, coeffs, iters: int, splat=None,
             plan: Optional[BurstPlan] = None):
    """Shared launcher: ``fields`` (C, H, W) on the card, ``coeffs`` one per
    channel, ``splat`` = (amps, last, radius) or None; ``plan`` defaults to
    :func:`plan_bursts`'s.  Up to :data:`MAX_CHANNELS` planes take their
    parameters by value; more go through device rows as a batch of one."""
    if fields.dim() != 3:
        raise ValueError(f"fields: expected (C, H, W), got {tuple(fields.shape)}")
    c, h, w = fields.shape
    check_f32("fields", fields, (c, h, w))
    alpha, inv_beta = ref.diffusion_alphas(dt, coeffs)
    if alpha.shape[0] != c:
        raise ValueError(f"coeffs: expected {c} values, got {alpha.shape[0]}")
    amps = None if splat is None else ref.f32_vec(splat[0])
    if amps is not None and amps.shape[0] != c:
        raise ValueError(f"amps: expected {c} values, got {amps.shape[0]}")
    if c > MAX_CHANNELS:
        last = None if splat is None else ref.f32_vec(splat[1])[None]
        rows = member_params.diffuse_cols(ref.f32_vec(dt), ref.f32_vec(coeffs)[None],
                                          None if amps is None else amps[None], last)
        return _diffuse_rows(fields[None], iters, splat is not None,
                             1.0 if splat is None else splat[2],
                             member_params.upload(rows, fields.device), plan)[0]
    if iters < 0:
        raise ValueError("iters must be >= 0")
    if splat is None:
        lx, ly, radius = 0.0, 0.0, 1.0
    else:
        last = ref.f32_vec(splat[1])
        lx, ly, radius = float(last[0]), float(last[1]), float(ref.f32(splat[2]))
    plan = plan or plan_bursts(h, w, iters, "diffuse")
    if plan.iters != iters:
        raise ValueError(f"plan runs {plan.iters} sweeps, not {iters}")
    depths, depths_ptr, nbursts = _depths(plan)
    out = torch.empty_like(fields)
    scratch = torch.empty_like(fields) if nbursts >= 2 else None
    host = [np.ascontiguousarray(a, np.float32) if a is not None else None
            for a in (alpha, inv_beta, amps)]
    with torch.cuda.device(fields.device):
        DIFFUSE.launch(
            "fluid_diffuse", fields.data_ptr(), out.data_ptr(),
            scratch.data_ptr() if scratch is not None else None,
            c, h, w, *plan.tile, depths_ptr, nbursts,
            *[a.ctypes.data if a is not None else None for a in host],
            lx, ly, radius, int(splat is not None), None, 0, c, stream_of(fields))
    return out


def _diffuse_rows(fields, iters: int, splat: bool, radius, params,
                  plan: Optional[BurstPlan] = None, kern: Kernel = DIFFUSE):
    """H3 over (B, C, H, W) ``fields``, B*C planes a launch a burst, each
    plane's alpha, 1/beta and amp and its member's splat centre from the
    device rows ``params`` (``member_params.diffuse_cols``'s layout)."""
    if fields.dim() != 4:
        raise ValueError(f"fields: expected (B, C, H, W), got {tuple(fields.shape)}")
    n, c, h, w = fields.shape
    check_f32("fields", fields, (n, c, h, w))
    if iters < 0:
        raise ValueError("iters must be >= 0")
    member_params.check(params, n, 3 * c + 2, fields.device)
    plan = plan or plan_bursts(h, w, iters, "diffuse")
    if plan.iters != iters:
        raise ValueError(f"plan runs {plan.iters} sweeps, not {iters}")
    depths, depths_ptr, nbursts = _depths(plan)
    out = torch.empty_like(fields)
    scratch = torch.empty_like(fields) if nbursts >= 2 else None
    with torch.cuda.device(fields.device):
        kern.launch(
            "fluid_diffuse", fields.data_ptr(), out.data_ptr(),
            scratch.data_ptr() if scratch is not None else None,
            n * c, h, w, *plan.tile, depths_ptr, nbursts, None, None, None,
            0.0, 0.0, float(ref.f32(radius)), int(splat), params.data_ptr(),
            params.stride(0), c, stream_of(fields))
    return out


def diffuse(fields, dt, diffusion, iters: int):
    """``iters`` Jacobi sweeps of (C, H, W) fields with one coefficient;
    ``ops.ref.diffuse`` semantics."""
    if not on_card(fields):
        return ref.diffuse(fields, dt, diffusion, iters)
    if iters == 0:
        return fields
    return _diffuse(fields, dt, [ref.f32(diffusion)] * fields.shape[0], iters)


def diffuse_multi(fields, dt, coeffs, iters: int):
    """Per-channel-coefficient sweeps; ``ops.ref.diffuse_multi``."""
    if not on_card(fields):
        return ref.diffuse_multi(fields, dt, coeffs, iters)
    if iters == 0:
        return fields
    return _diffuse(fields, dt, coeffs, iters)


def diffuse_multi_splat(fields, dt, coeffs, iters: int, amps, last, radius):
    """Per-channel sweeps with the gpu-variant splat tail folded into the
    last one; ``ops.ref.diffuse_multi_splat``."""
    if not on_card(fields):
        return ref.diffuse_multi_splat(fields, dt, coeffs, iters, amps, last,
                                       radius)
    return _diffuse(fields, dt, coeffs, iters, splat=(amps, last, radius))


def _pressure_project(u, v, iters: int, half: bool,
                      plan: Optional[BurstPlan] = None):
    """Launcher of H4's projection on the card: (u', v', p, vel_stats)."""
    h, w = u.shape
    check_f32("u", u, (h, w))
    check_f32("v", v, (h, w))
    plan = plan or plan_bursts(h, w, iters, "project")
    if plan.iters != iters:
        raise ValueError(f"plan runs {plan.iters} sweeps, not {iters}")
    depths, depths_ptr, nbursts = _depths(plan)
    dev = u.device
    uv2 = torch.empty((2, h, w), dtype=torch.float32, device=dev)
    p = torch.empty((h, w), dtype=torch.float32, device=dev)
    div, scratch = (torch.empty((2, h, w), dtype=torch.float32, device=dev)
                    if nbursts >= 2 else (None, None))
    stats = torch.empty((2,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        PRESSURE.launch(
            "fluid_pressure_project", u.data_ptr(), v.data_ptr(),
            uv2[0].data_ptr(), uv2[1].data_ptr(), p.data_ptr(),
            div.data_ptr() if div is not None else None,
            scratch.data_ptr() if scratch is not None else None,
            stats.data_ptr(), h, w, *plan.tile, depths_ptr, nbursts,
            int(bool(half)), 1, 0, 0, stream_of(u))
    return uv2[0], uv2[1], p, stats


def pressure_project(u, v, iters: int, half: bool, *,
                     return_stats: bool = False):
    """Divergence → ``iters`` Jacobi sweeps from p = 0 → gradient
    subtraction, returning (u', v', p[, vel_stats]);
    ``ops.ref.pressure_project`` semantics."""
    if not on_card(u, v):
        return ref.pressure_project(u, v, iters, half, return_stats=return_stats)
    out = _pressure_project(u, v, iters, half)
    return out if return_stats else out[:3]


def pressure_solve(div, iters: int, init=None):
    """``iters`` Jacobi sweeps from p = 0, or from the (H, W) iterate
    ``init`` (the sharded rollout's later bursts); ``ops.ref.pressure_solve``."""
    if not on_card(*[t for t in (div, init) if t is not None]):
        return ref.pressure_solve(div, iters, init=init)
    h, w = div.shape
    check_f32("div", div, (h, w))
    if init is not None:
        check_f32("init", init, (h, w))
    plan = plan_bursts(h, w, iters, "solve")
    depths, depths_ptr, nbursts = _depths(plan)
    p = torch.empty_like(div)
    scratch = torch.empty_like(div) if nbursts >= 2 else None
    with torch.cuda.device(div.device):
        PRESSURE_SOLVE.launch(
            "fluid_pressure_solve", div.data_ptr(), p.data_ptr(),
            scratch.data_ptr() if scratch is not None else None,
            h, w, *plan.tile, depths_ptr, nbursts,
            init.data_ptr() if init is not None else None, stream_of(div))
    return p


def divergence(u, v, half: bool):
    """Central-difference divergence; ``ops.ref.divergence``."""
    if not on_card(u, v):
        return ref.divergence(u, v, half)
    h, w = u.shape
    check_f32("u", u, (h, w))
    check_f32("v", v, (h, w))
    div = torch.empty_like(u)
    with torch.cuda.device(u.device):
        STENCIL.launch("fluid_divergence", u.data_ptr(), v.data_ptr(),
                       div.data_ptr(), h, w, int(bool(half)), 1, 0, 0, stream_of(u))
    return div


def project(u, v, p, *, return_stats: bool = False):
    """Gradient subtraction, returning (u', v'[, vel_stats]);
    ``ops.ref.project``."""
    if not on_card(u, v, p):
        return ref.project(u, v, p, return_stats=return_stats)
    h, w = u.shape
    for name, t in (("u", u), ("v", v), ("p", p)):
        check_f32(name, t, (h, w))
    uv2 = torch.empty((2, h, w), dtype=torch.float32, device=u.device)
    stats = (torch.empty((2,), dtype=torch.float32, device=u.device)
             if return_stats else None)
    with torch.cuda.device(u.device):
        STENCIL.launch(
            "fluid_project", p.data_ptr(), u.data_ptr(), v.data_ptr(),
            uv2[0].data_ptr(), uv2[1].data_ptr(),
            stats.data_ptr() if stats is not None else None, h, w, 1, 0, 0,
            stream_of(u))
    if return_stats:
        return uv2[0], uv2[1], stats
    return uv2[0], uv2[1]


# -- B members a launch (ensembles) --------------------------------------------


def vorticity_confinement_batched(u, v, dt, vorticity, variant: str = "gpu", *,
                                  params=None, out=None):
    """H2 over B members: u, v (B, H, W) (each plane contiguous), dt (B,);
    ``ops.ref.vorticity_confinement_{gpu,cpu}_batched`` semantics.
    ``params``: device rows whose column 0 is dt (``ops/member_params.py``;
    uploaded here when None).  ``out`` (B, 2, H, W) with contiguous planes
    receives u' and v' (the step's ``pack[:, 0:2]``); returns ``out[:, 0]``,
    ``out[:, 1]``."""
    if variant not in ("gpu", "cpu"):
        raise ValueError(f"variant must be 'gpu' or 'cpu', got {variant!r}")
    n = u.shape[0]
    if out is not None:
        ref.check_out_planes(out, (n, 2) + tuple(u.shape[1:]), u, v)
    if not on_card(*[t for t in (u, v, out) if t is not None]):
        fn = (ref.vorticity_confinement_gpu_batched if variant == "gpu"
              else ref.vorticity_confinement_cpu_batched)
        return fn(u, v, dt, vorticity, out=out)
    _, h, w = u.shape
    check_planes("u", u, (n, h, w))
    check_planes("v", v, (n, h, w))
    if params is None:
        params = member_params.upload(ref.member_vec(dt, n)[:, None], u.device)
    member_params.check(params, n, 1, u.device)
    if out is None:
        out = torch.empty((n, 2, h, w), dtype=torch.float32, device=u.device)
    u2, v2 = out[:, 0], out[:, 1]
    with torch.cuda.device(u.device):
        VORTICITY_BATCHED.launch(
            "fluid_vorticity", u.data_ptr(), v.data_ptr(), u2.data_ptr(), v2.data_ptr(),
            h, w, int(variant == "cpu"), 0.0, float(ref.f32(vorticity)), n,
            u.stride(0), v.stride(0), u2.stride(0), v2.stride(0),
            params.data_ptr(), params.stride(0), stream_of(u))
    return u2, v2


def _diffuse_batched(fields, dt, coeffs, iters: int, splat, params):
    n, c = fields.shape[:2]
    if params is None:
        amps, last = (None, None) if splat is None else splat[:2]
        params = member_params.upload(member_params.diffuse_cols(
            ref.member_vec(dt, n), ref.member_rows(coeffs, n, c),
            None if amps is None else ref.member_rows(amps, n, c),
            None if last is None else ref.member_rows(last, n, 2)), fields.device)
    return _diffuse_rows(fields, iters, splat is not None,
                         1.0 if splat is None else splat[2], params,
                         kern=DIFFUSE_BATCHED)


def diffuse_batched(fields, dt, diffusion, iters: int, *, params=None):
    """H3 over B members' (C, H, W) fields, one coefficient a member
    (``diffusion`` (B,)); ``ops.ref.diffuse_batched`` semantics.
    ``params``: the step's device rows (``member_params.diffuse_cols``'s
    layout), built and uploaded here when None."""
    if not on_card(fields):
        return ref.diffuse_batched(fields, dt, diffusion, iters)
    if iters == 0:
        return fields
    n, c = fields.shape[:2]
    k = ref.member_vec(diffusion, n)
    return _diffuse_batched(fields, dt, np.repeat(k[:, None], c, axis=1), iters, None,
                            params)


def diffuse_multi_batched(fields, dt, coeffs, iters: int, *, params=None):
    """H3 over B members, a coefficient per plane (``coeffs`` (B, C));
    ``ops.ref.diffuse_multi_batched``."""
    if not on_card(fields):
        return ref.diffuse_multi_batched(fields, dt, coeffs, iters)
    if iters == 0:
        return fields
    return _diffuse_batched(fields, dt, coeffs, iters, None, params)


def diffuse_multi_splat_batched(fields, dt, coeffs, iters: int, amps, last, radius, *,
                                params=None):
    """H3 over B members with each member's gpu-variant splat (``amps``
    (B, C), ``last`` (B, 2)) on the last sweep;
    ``ops.ref.diffuse_multi_splat_batched``."""
    if not on_card(fields):
        return ref.diffuse_multi_splat_batched(fields, dt, coeffs, iters, amps, last,
                                               radius)
    return _diffuse_batched(fields, dt, coeffs, iters, (amps, last, radius), params)


def pressure_project_batched(u, v, iters: int, half: bool, *, return_stats: bool = False):
    """H4 over B members: u, v (B, H, W), each plane contiguous at any
    member stride (``pack[:, 0]``); ``ops.ref.pressure_project_batched``
    semantics, returning (u', v', p[, vel_stats (B, 2)])."""
    if not on_card(u, v):
        return ref.pressure_project_batched(u, v, iters, half, return_stats=return_stats)
    n, h, w = u.shape
    check_planes("u", u, (n, h, w))
    check_planes("v", v, (n, h, w))
    plan = plan_bursts(h, w, iters, "project")
    depths, depths_ptr, nbursts = _depths(plan)
    dev = u.device
    uv2 = torch.empty((2, n, h, w), dtype=torch.float32, device=dev)
    p = torch.empty((n, h, w), dtype=torch.float32, device=dev)
    div, scratch = (torch.empty((2, n, h, w), dtype=torch.float32, device=dev)
                    if nbursts >= 2 else (None, None))
    stats = torch.empty((n, 2), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        PRESSURE_BATCHED.launch(
            "fluid_pressure_project", u.data_ptr(), v.data_ptr(),
            uv2[0].data_ptr(), uv2[1].data_ptr(), p.data_ptr(),
            div.data_ptr() if div is not None else None,
            scratch.data_ptr() if scratch is not None else None,
            stats.data_ptr(), h, w, *plan.tile, depths_ptr, nbursts,
            int(bool(half)), n, u.stride(0), v.stride(0), stream_of(u))
    out = (uv2[0], uv2[1], p, stats)
    return out if return_stats else out[:3]


def divergence_batched(u, v, half: bool):
    """H5's divergence over B members: u, v (B, H, W), each plane
    contiguous at any member stride; ``ops.ref.divergence_batched``."""
    if not on_card(u, v):
        return ref.divergence_batched(u, v, half)
    n, h, w = u.shape
    check_planes("u", u, (n, h, w))
    check_planes("v", v, (n, h, w))
    div = torch.empty((n, h, w), dtype=torch.float32, device=u.device)
    with torch.cuda.device(u.device):
        STENCIL_BATCHED.launch("fluid_divergence", u.data_ptr(), v.data_ptr(), div.data_ptr(),
                               h, w, int(bool(half)), n, u.stride(0), v.stride(0),
                               stream_of(u))
    return div


def project_batched(u, v, p, *, return_stats: bool = False):
    """H5's gradient subtraction over B members: u, v (B, H, W) with
    contiguous planes, p (B, H, W) contiguous; returns (u', v'[, vel_stats
    (B, 2)]); ``ops.ref.project_batched``."""
    if not on_card(u, v, p):
        return ref.project_batched(u, v, p, return_stats=return_stats)
    n, h, w = u.shape
    check_planes("u", u, (n, h, w))
    check_planes("v", v, (n, h, w))
    check_f32("p", p, (n, h, w))
    uv2 = torch.empty((2, n, h, w), dtype=torch.float32, device=u.device)
    stats = (torch.empty((n, 2), dtype=torch.float32, device=u.device)
             if return_stats else None)
    with torch.cuda.device(u.device):
        STENCIL_BATCHED.launch(
            "fluid_project", p.data_ptr(), u.data_ptr(), v.data_ptr(), uv2[0].data_ptr(),
            uv2[1].data_ptr(), stats.data_ptr() if stats is not None else None, h, w, n,
            u.stride(0), v.stride(0), stream_of(u))
    return (uv2[0], uv2[1], stats) if return_stats else (uv2[0], uv2[1])
