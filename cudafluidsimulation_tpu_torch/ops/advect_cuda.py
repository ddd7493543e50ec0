"""H1: semi-Lagrangian advection on the card (``csrc/advect.cu``).

Replaces ``cudafluidsimulation_tpu/ops/advect_pallas.py``: ``_advect_kernel``
(via ``_advect_flat``) and ``_advect_kernel_tiled`` (via ``_advect_tiled``),
their cores ``_advect_core`` and ``_advect_core_static``, and
``_emit_stats``.  The TPU has no fast gather, so the Pallas kernel turns
the bilinear gather into a shift-accumulation over a bounded displacement
window.  The card gathers natively: one thread per cell backtraces,
truncates the corner, clamps four taps and blends them, as ``ops/ref.py``
does.  The backtrace is unbounded, like the ref backend; the Pallas
kernel's ``max_displacement`` clamp is not copied.

What bounds it: bytes.  At 2048² the velocity pass reads u, v and writes
u', v' (4 planes, 64 MiB); the dye pass reads u', v' and 3 dye planes and
writes 3 (8 planes, 128 MiB).  The taps are near the cell, so they hit L1
and L2.  The velocity pass also emits [max|u'|, max|v'|] (a block
reduction and one atomic per block), so no later pass re-reads the
velocity to bound it.

The wrappers take the plain version (``ops.ref``) for CPU tensors and
launch the kernel or raise for CUDA tensors.
"""

from __future__ import annotations

import ctypes

import torch

from cudafluidsimulation_tpu_torch.ops import ref
from cudafluidsimulation_tpu_torch.ops._build import (
    Kernel, check_f32, on_card, stream_of)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# fluid_advect(f0, f1, f2, o0, o1, o2, u, v, stats, c, h, w, dye, dt, decay, stream)
KERNEL = Kernel("advect", {
    "fluid_advect": [_P] * 9 + [_I] * 4 + [_F, _F, _P],
})


def _launch(planes, outs, u, v, stats, dt, decay_rate, dye: bool):
    c = len(planes)
    h, w = u.shape
    ptrs = [p.data_ptr() for p in planes] + [None] * (3 - c)
    optrs = [o.data_ptr() for o in outs] + [None] * (3 - c)
    with torch.cuda.device(u.device):
        KERNEL.launch(
            "fluid_advect", *ptrs, *optrs, u.data_ptr(), v.data_ptr(),
            stats.data_ptr() if stats is not None else None,
            c, h, w, int(dye), float(ref.f32(dt)), ref.decay_factor(dt, decay_rate),
            stream_of(u))


def advect_velocity(u, v, dt, decay_rate, *, vel_stats=None,
                    return_stats: bool = False):
    """Self-advection of (u, v) with decay; ``ops.ref.advect_velocity``
    semantics.  ``return_stats`` also returns the kernel-emitted
    [max|u'|, max|v'|]."""
    if not on_card(u, v):
        return ref.advect_velocity(u, v, dt, decay_rate, vel_stats=vel_stats,
                                   return_stats=return_stats)
    check_f32("u", u, u.shape)
    check_f32("v", v, u.shape)
    out = torch.empty((2,) + tuple(u.shape), dtype=torch.float32, device=u.device)
    stats = torch.empty((2,), dtype=torch.float32, device=u.device)
    _launch([u, v], [out[0], out[1]], u, v, stats, dt, decay_rate, dye=False)
    if return_stats:
        return out[0], out[1], stats
    return out[0], out[1]


def advect_dye(dye, u, v, dt, decay_rate, *, vel_stats=None):
    """Dye advection through the advected velocity with the fade
    fmin(1, c^1.005 * decay); ``ops.ref.advect_dye`` semantics."""
    if not on_card(dye, u, v):
        return ref.advect_dye(dye, u, v, dt, decay_rate, vel_stats=vel_stats)
    h, w = u.shape
    check_f32("u", u, (h, w))
    check_f32("v", v, (h, w))
    if dye.dim() != 3 or not 1 <= dye.shape[0] <= 3:
        raise ValueError(f"dye: expected (C<=3, H, W), got {tuple(dye.shape)}")
    check_f32("dye", dye, (dye.shape[0], h, w))
    out = torch.empty_like(dye)
    _launch(list(dye), list(out), u, v, None, dt, decay_rate, dye=True)
    return out
