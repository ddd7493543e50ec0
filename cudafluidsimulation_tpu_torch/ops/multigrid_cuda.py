"""H6: the multigrid smoother ends on the card (``csrc/multigrid.cu``).

Replaces ``cudafluidsimulation_tpu/ops/jacobi_pallas.py``:

- ``smooth_damped`` → ``_smooth_kernel``, ``_smooth_kernel_tiled``;
- ``smooth_res`` → ``_smooth_res_kernel``, ``_smooth_res_kernel_tiled``;
- ``first_smooth_res`` → ``_first_smooth_res_kernel``;
- ``last_smooth_project`` → ``_last_smooth_project_kernel``.

Each wrapper takes its plain version (``ops/multigrid.py``) for CPU
tensors and launches its kernel or raises for CUDA tensors; each entry has
its own launch count.  The TPU kernels run k sweeps per trip to VMEM over
row strips with mirror halos; here a sweep is one launch over the whole
level, ping-ponging two planes so the last sweep lands in the output (the
centre term is the current iterate), and the residual or the projection is
one more launch reading the final p.

Bound by bytes.  At the 2048² fine level (one plane is 16 MiB) a sweep
reads p and rhs and writes p (48 MiB), and so does the residual, so the
pre-smooth ``smooth_res`` (2 sweeps + residual) moves 144 MiB, 128 MiB
from zero (the first sweep reads only rhs); ``first_smooth_res`` reads u,
v and writes rhs and p in its first launch (64 MiB), then one sweep and
the residual (96 MiB); ``last_smooth_project`` moves 2 × 48 MiB of sweeps
and the projection's 80 MiB.  Levels at or below 1024² (4 MiB a plane)
stay in the 50 MB L2; the 16² bottom (20 sweeps) is bound by launch
latency.  Fusing the residual into the last sweep and temporal blocking
are later work.

``ENDS`` is the namespace of these wrappers, with H5's ``divergence`` and
``project``, that ``ops/multigrid.py`` runs its V-cycles over.
"""

from __future__ import annotations

import ctypes
import types

import torch

from cudafluidsimulation_tpu_torch.ops import jacobi_cuda, multigrid, ref
from cudafluidsimulation_tpu_torch.ops._build import (
    Kernel, check_f32, on_card, stream_of)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
OMEGA = multigrid.OMEGA

# fluid_smooth_damped(p, rhs, out, scratch, h, w, sweeps, omega, stream)
SMOOTH = Kernel("multigrid", {
    "fluid_smooth_damped": [_P] * 4 + [_I] * 3 + [_F, _P],
})
# fluid_smooth_res(p, rhs, out, res, scratch, h, w, sweeps, omega,
#                  from_zero, stream)
SMOOTH_RES = Kernel("multigrid", {
    "fluid_smooth_res": [_P] * 5 + [_I] * 3 + [_F, _I, _P],
})
# fluid_first_smooth_res(u, v, p, rhs, res, scratch, h, w, sweeps, half,
#                        omega, stream)
FIRST = Kernel("multigrid", {
    "fluid_first_smooth_res": [_P] * 6 + [_I] * 4 + [_F, _P],
})
# fluid_last_smooth_project(p, rhs, u, v, u2, v2, p2, scratch, stats, h, w,
#                           sweeps, omega, stream), stats may be null
LAST = Kernel("multigrid", {
    "fluid_last_smooth_project": [_P] * 9 + [_I] * 3 + [_F, _P],
})
KERNELS = (SMOOTH, SMOOTH_RES, FIRST, LAST)


def _planes(**named):
    """(h, w) of the first plane; raise unless every one is a contiguous
    float32 plane of that shape."""
    first = next(iter(named.values()))
    if first.dim() != 2:
        raise ValueError(f"expected (H, W) planes, got {tuple(first.shape)}")
    for name, t in named.items():
        check_f32(name, t, first.shape)
    return first.shape


def _check_sweeps(sweeps: int, least: int) -> None:
    if sweeps < least:
        raise ValueError(f"sweeps must be >= {least}, got {sweeps}")


def _scratch(like, sweeps: int):
    return torch.empty_like(like) if sweeps >= 2 else None


def _ptr(t) -> int | None:
    return t.data_ptr() if t is not None else None


def smooth_damped(p, rhs, sweeps: int, omega: float = OMEGA):
    """``sweeps`` damped-Jacobi sweeps; ``multigrid.smooth_damped``."""
    _check_sweeps(sweeps, 0)
    if not on_card(p, rhs):
        return multigrid.smooth_damped(p, rhs, sweeps, omega)
    if sweeps == 0:
        return p
    h, w = _planes(p=p, rhs=rhs)
    out, scratch = torch.empty_like(p), _scratch(p, sweeps)
    with torch.cuda.device(p.device):
        SMOOTH.launch("fluid_smooth_damped", p.data_ptr(), rhs.data_ptr(),
                      out.data_ptr(), _ptr(scratch), h, w,
                      int(sweeps), float(ref.f32(omega)), stream_of(p))
    return out


def smooth_res(p, rhs, sweeps: int, omega: float = OMEGA, *,
               from_zero: bool = False):
    """``sweeps`` >= 1 sweeps and the residual, (p', rhs - A p');
    ``from_zero`` starts from p = 0 without reading ``p``;
    ``multigrid.smooth_res``."""
    _check_sweeps(sweeps, 1)
    if not on_card(p, rhs):
        return multigrid.smooth_res(p, rhs, sweeps, omega, from_zero=from_zero)
    h, w = _planes(rhs=rhs, p=p)
    out, res = torch.empty_like(rhs), torch.empty_like(rhs)
    scratch = _scratch(rhs, sweeps)
    with torch.cuda.device(rhs.device):
        SMOOTH_RES.launch(
            "fluid_smooth_res", None if from_zero else p.data_ptr(),
            rhs.data_ptr(), out.data_ptr(), res.data_ptr(),
            _ptr(scratch), h, w, int(sweeps),
            float(ref.f32(omega)), int(bool(from_zero)), stream_of(rhs))
    return out, res


def first_smooth_res(u, v, sweeps: int, half: bool, omega: float = OMEGA):
    """Divergence, ``sweeps`` >= 1 sweeps from zero and the residual:
    (p, rhs, res) with rhs = -div; ``multigrid.first_smooth_res``."""
    _check_sweeps(sweeps, 1)
    if not on_card(u, v):
        return multigrid.first_smooth_res(u, v, sweeps, half, omega)
    h, w = _planes(u=u, v=v)
    p, rhs, res = (torch.empty_like(u) for _ in range(3))
    scratch = _scratch(u, sweeps)
    with torch.cuda.device(u.device):
        FIRST.launch(
            "fluid_first_smooth_res", u.data_ptr(), v.data_ptr(),
            p.data_ptr(), rhs.data_ptr(), res.data_ptr(),
            _ptr(scratch), h, w, int(sweeps), int(bool(half)),
            float(ref.f32(omega)), stream_of(u))
    return p, rhs, res


def last_smooth_project(p, rhs, u, v, sweeps: int, omega: float = OMEGA, *,
                        return_stats: bool = False):
    """``sweeps`` >= 1 sweeps, then the gradient subtraction: (u', v',
    p'[, vel_stats]); ``multigrid.last_smooth_project``."""
    _check_sweeps(sweeps, 1)
    if not on_card(p, rhs, u, v):
        return multigrid.last_smooth_project(p, rhs, u, v, sweeps, omega,
                                             return_stats=return_stats)
    h, w = _planes(p=p, rhs=rhs, u=u, v=v)
    dev = p.device
    uv2 = torch.empty((2, h, w), dtype=torch.float32, device=dev)
    p2, scratch = torch.empty_like(p), _scratch(p, sweeps)
    stats = (torch.empty((2,), dtype=torch.float32, device=dev)
             if return_stats else None)
    with torch.cuda.device(dev):
        LAST.launch(
            "fluid_last_smooth_project", p.data_ptr(), rhs.data_ptr(),
            u.data_ptr(), v.data_ptr(), uv2[0].data_ptr(), uv2[1].data_ptr(),
            p2.data_ptr(), _ptr(scratch), _ptr(stats), h, w,
            int(sweeps), float(ref.f32(omega)), stream_of(p))
    if return_stats:
        return uv2[0], uv2[1], p2, stats
    return uv2[0], uv2[1], p2


ENDS = types.SimpleNamespace(
    smooth_damped=smooth_damped,
    smooth_res=smooth_res,
    first_smooth_res=first_smooth_res,
    last_smooth_project=last_smooth_project,
    divergence=jacobi_cuda.divergence,
    project=jacobi_cuda.project,
)
