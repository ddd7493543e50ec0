"""H2–H5: the stencil kernels on the card.

Each wrapper takes the plain version (``ops.ref``) for CPU tensors and
launches its kernel or raises for CUDA tensors.  Byte counts below are for
the 2048² main path (one float32 plane is 16 MiB).

**H2 vorticity** (``csrc/vorticity.cu``) replaces
``cudafluidsimulation_tpu/ops/jacobi_pallas.py`` ``vorticity_confinement``
→ ``_vorticity_kernel`` (``_curl_taps``, ``_confinement``).  Bound by bytes:
read u, v and write u', v' (64 MiB).  One kernel: each block computes the
curl of its tile plus a one-cell ring into shared memory (the ring cells at
a physical edge hold the curl of the clamped cell, as ``ops.ref`` clamps
the curl field), then the confinement force from the tile, so the curl
never goes to device memory.

**H3 diffusion** (``csrc/diffuse.cu``) replaces ``_diffuse_bursts`` →
``_diffuse_kernel`` and ``_diffuse_kernel_tiled`` (entries ``diffuse``,
``diffuse_multi``, ``diffuse_multi_splat``).  Bound by bytes: each sweep
reads and writes every channel (5 channels: 160 MiB a sweep, 20 sweeps).
This first design is one launch per sweep over all channels, ping-ponging
two buffers (the centre term is the current iterate), with the splat tail
folded into the last sweep.  Temporal blocking, which the TPU kernel uses
to cut the trips to memory, is later work.

**H4 pressure** (``csrc/pressure.cu``) replaces ``pressure_project`` →
``_single_pressure_kernel``, ``_first_pressure_kernel``,
``_pressure_kernel``, ``_last_pressure_kernel`` (and the tiled twins).
Bound by bytes: each sweep reads p and div and writes p (48 MiB, 40
sweeps).  The divergence kernel also writes the first sweep's p (from
p = 0 it is -div/4), ``iters - 1`` sweep launches follow, and the
projection kernel subtracts the gradient and emits [max|u'|, max|v'|].
Its standalone entry ``pressure_solve`` (``PRESSURE_SOLVE``, its own launch
count) replaces ``jacobi_pallas.pressure_solve`` → ``_pressure_kernel``:
the first sweep from zero, then the same sweep launches over ``div``.

**H5 divergence and projection** (``csrc/pressure.cu``, ``STENCIL``)
replaces ``divergence`` → ``_divergence_kernel`` and ``project`` →
``_project_kernel``: one launch each.  Bound by bytes: the divergence
reads u, v and writes div (48 MiB); the projection reads p, u, v and
writes u', v' (80 MiB), with the velocity bound as a block max and an
atomic max (zeroed on the stream first).  The multigrid projection
(``ops/multigrid.py``) ends on ``project``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from cudafluidsimulation_tpu_torch.ops import ref
from cudafluidsimulation_tpu_torch.ops._build import (
    Kernel, check_f32, on_card, stream_of)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# fluid_vorticity(u, v, u2, v2, h, w, cpu_variant, dt, vorticity, stream)
VORTICITY = Kernel("vorticity", {
    "fluid_vorticity": [_P] * 4 + [_I] * 3 + [_F, _F, _P],
})
# fluid_diffuse(in, out, scratch, c, h, w, iters, alpha*, inv_beta*, amp*,
#               lx, ly, radius, stream); the three arrays are host pointers
DIFFUSE = Kernel("diffuse", {
    "fluid_diffuse": [_P] * 3 + [_I] * 4 + [_P] * 3 + [_F] * 3 + [_P],
})
# fluid_pressure_project(u, v, u2, v2, p, div, scratch, stats, h, w, iters,
#                        half, stream)
PRESSURE = Kernel("pressure", {
    "fluid_pressure_project": [_P] * 8 + [_I] * 4 + [_P],
})
# fluid_pressure_solve(div, p, scratch, h, w, iters, stream)
PRESSURE_SOLVE = Kernel("pressure", {
    "fluid_pressure_solve": [_P] * 3 + [_I] * 3 + [_P],
})
# fluid_divergence(u, v, div, h, w, half, stream);
# fluid_project(p, u, v, u2, v2, stats, h, w, stream), stats may be null
STENCIL = Kernel("pressure", {
    "fluid_divergence": [_P] * 3 + [_I] * 3 + [_P],
    "fluid_project": [_P] * 6 + [_I] * 2 + [_P],
})

MAX_CHANNELS = 8  # csrc/diffuse.cu FLUID_MAX_CHANNELS


def vorticity_confinement(u, v, dt, vorticity, variant: str = "gpu"):
    """Curl + confinement force; ``ops.ref.vorticity_confinement_{gpu,cpu}``
    semantics."""
    if variant not in ("gpu", "cpu"):
        raise ValueError(f"variant must be 'gpu' or 'cpu', got {variant!r}")
    if not on_card(u, v):
        fn = (ref.vorticity_confinement_gpu if variant == "gpu"
              else ref.vorticity_confinement_cpu)
        return fn(u, v, dt, vorticity)
    h, w = u.shape
    check_f32("u", u, (h, w))
    check_f32("v", v, (h, w))
    out = torch.empty((2, h, w), dtype=torch.float32, device=u.device)
    with torch.cuda.device(u.device):
        VORTICITY.launch(
            "fluid_vorticity", u.data_ptr(), v.data_ptr(), out[0].data_ptr(),
            out[1].data_ptr(), h, w, int(variant == "cpu"),
            float(ref.f32(dt)), float(ref.f32(vorticity)), stream_of(u))
    return out[0], out[1]


def _diffuse(fields, dt, coeffs, iters: int, splat=None):
    """Shared launcher: ``fields`` (C, H, W) on the card, ``coeffs`` one per
    channel, ``splat`` = (amps, last, radius) or None."""
    if fields.dim() != 3:
        raise ValueError(f"fields: expected (C, H, W), got {tuple(fields.shape)}")
    c, h, w = fields.shape
    if not 1 <= c <= MAX_CHANNELS:
        raise ValueError(f"fields: 1..{MAX_CHANNELS} channels, got {c}")
    check_f32("fields", fields, (c, h, w))
    if iters < 0:
        raise ValueError("iters must be >= 0")
    alpha, inv_beta = ref.diffusion_alphas(dt, coeffs)
    if alpha.shape[0] != c:
        raise ValueError(f"coeffs: expected {c} values, got {alpha.shape[0]}")
    if splat is None:
        amps, lx, ly, radius = None, 0.0, 0.0, 1.0
    else:
        amps = ref.f32_vec(splat[0])
        if amps.shape[0] != c:
            raise ValueError(f"amps: expected {c} values, got {amps.shape[0]}")
        last = ref.f32_vec(splat[1])
        lx, ly, radius = float(last[0]), float(last[1]), float(ref.f32(splat[2]))
    out = torch.empty_like(fields)
    scratch = torch.empty_like(fields) if iters >= 2 else None
    host = [np.ascontiguousarray(a, np.float32) if a is not None else None
            for a in (alpha, inv_beta, amps)]
    with torch.cuda.device(fields.device):
        DIFFUSE.launch(
            "fluid_diffuse", fields.data_ptr(), out.data_ptr(),
            scratch.data_ptr() if scratch is not None else None,
            c, h, w, int(iters),
            *[a.ctypes.data if a is not None else None for a in host],
            lx, ly, radius, stream_of(fields))
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


def pressure_project(u, v, iters: int, half: bool, *,
                     return_stats: bool = False):
    """Divergence → ``iters`` Jacobi sweeps from p = 0 → gradient
    subtraction, returning (u', v', p[, vel_stats]);
    ``ops.ref.pressure_project`` semantics."""
    if not on_card(u, v):
        return ref.pressure_project(u, v, iters, half, return_stats=return_stats)
    if iters < 0:
        raise ValueError("iters must be >= 0")
    h, w = u.shape
    check_f32("u", u, (h, w))
    check_f32("v", v, (h, w))
    dev = u.device
    uv2 = torch.empty((2, h, w), dtype=torch.float32, device=dev)
    p = torch.empty((h, w), dtype=torch.float32, device=dev)
    div, scratch = torch.empty((2, h, w), dtype=torch.float32, device=dev)
    stats = torch.empty((2,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        PRESSURE.launch(
            "fluid_pressure_project", u.data_ptr(), v.data_ptr(),
            uv2[0].data_ptr(), uv2[1].data_ptr(), p.data_ptr(),
            div.data_ptr(), scratch.data_ptr(), stats.data_ptr(),
            h, w, int(iters), int(bool(half)), stream_of(u))
    if return_stats:
        return uv2[0], uv2[1], p, stats
    return uv2[0], uv2[1], p


def pressure_solve(div, iters: int):
    """``iters`` Jacobi sweeps from p = 0; ``ops.ref.pressure_solve``."""
    if not on_card(div):
        return ref.pressure_solve(div, iters)
    if iters < 0:
        raise ValueError("iters must be >= 0")
    h, w = div.shape
    check_f32("div", div, (h, w))
    p = torch.empty_like(div)
    scratch = torch.empty_like(div) if iters >= 2 else None
    with torch.cuda.device(div.device):
        PRESSURE_SOLVE.launch(
            "fluid_pressure_solve", div.data_ptr(), p.data_ptr(),
            scratch.data_ptr() if scratch is not None else None,
            h, w, int(iters), stream_of(div))
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
                       div.data_ptr(), h, w, int(bool(half)), stream_of(u))
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
            stats.data_ptr() if stats is not None else None, h, w,
            stream_of(u))
    if return_stats:
        return uv2[0], uv2[1], stats
    return uv2[0], uv2[1]
