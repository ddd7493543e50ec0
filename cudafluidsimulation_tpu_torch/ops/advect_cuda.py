"""H1 and H8: semi-Lagrangian advection on the card (``csrc/advect.cu``).

**H1** replaces ``cudafluidsimulation_tpu/ops/advect_pallas.py``:
``_advect_kernel`` (via ``_advect_flat``) and ``_advect_kernel_tiled`` (via
``_advect_tiled``), their cores ``_advect_core`` and
``_advect_core_static``, and ``_emit_stats``.  The TPU has no fast gather,
so the Pallas kernel turns the bilinear gather into a shift-accumulation
over a bounded displacement window.  The card gathers natively: one thread
per cell backtraces, truncates the corner, clamps four taps and blends
them, as ``ops/ref.py`` does.  The backtrace is unbounded, like the ref
backend; the Pallas kernel's ``max_displacement`` clamp is not copied.

**H8** (``packed=True``, the ``fast_velocity`` and ``fast_dye`` modes)
replaces the bf16-tap cores ``_advect_core_packed`` and
``_advect_core_packed_vel``: the same gather over taps rounded as the TPU
kernels pack them, the dye clamped to >= 0 before the pow, and, with
``fast_path``, the exact H1 arithmetic on a quiet step, decided on the
device from ``vel_stats`` (or from max|u|, max|v| reduced first when it is
None), so the step reads nothing back.  Plain version:
``ops/advect_packed.py``.

What bounds both: bytes.  At 2048² the velocity pass reads u, v and writes
u', v' (4 planes, 64 MiB); the dye pass reads u', v' and 3 dye planes and
writes 3 (8 planes, 128 MiB).  The taps are near the cell, so they hit L1
and L2.  The velocity pass also emits [max|u'|, max|v'|] (a block
reduction and one atomic per block), so no later pass re-reads the
velocity to bound it.

**H1 batched** (``advect_velocity_batched``, ``advect_dye_batched``): B
independent members (ensembles, the analog of vmap over the JAX step) in
one launch of the same kernel, member b on grid z; each member's dt and
decay come from its row of the step's device parameters
(``ops/member_params.py``) and its bound goes to row b of ``stats``
(B, 2).  The single entries are the case B = 1, with dt and decay by value.
**H8 batched** (the same functions with ``packed=True``): the same over
bf16-rounded taps, each member's quiet branch decided on the device from
its own row of ``vel_stats`` (B, 2) and its own dt, so a batch may mix
quiet and driven members and the step still reads nothing back.

The wrappers take the plain versions (``ops.ref``, ``ops.advect_packed``)
for CPU tensors and launch the kernel or raise for CUDA tensors.
"""

from __future__ import annotations

import ctypes

import torch

from cudafluidsimulation_tpu_torch.ops import advect_packed, member_params, ref
from cudafluidsimulation_tpu_torch.ops._build import (
    Kernel, check_f32, check_planes, on_card, stream_of)

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong

# fluid_advect(f0, f1, f2, o0, o1, o2, u, v, stats, c, h, w, dye, dt, decay,
#              nb, in_ms, out_ms, u_ms, v_ms, prm, prm_stride, stream)
_ADVECT = {"fluid_advect": [_P] * 9 + [_I] * 4 + [_F, _F, _I] + [_L] * 4 + [_P, _I, _P]}
KERNEL = Kernel("advect", _ADVECT)
# the same entry, B members a launch (its own launch count)
BATCHED = Kernel("advect", _ADVECT)
# fluid_advect_packed(f0, f1, f2, o0, o1, o2, u, v, bound, scratch, stats,
#                     c, h, w, dye, fast_path, dt, decay, nb, in_ms, out_ms,
#                     u_ms, v_ms, prm, prm_stride, stream)
_PACKED = {"fluid_advect_packed": [_P] * 11 + [_I] * 5 + [_F, _F, _I] + [_L] * 4
           + [_P, _I, _P]}
PACKED = Kernel("advect", _PACKED)
# the same entry, B members a launch (its own launch count)
PACKED_BATCHED = Kernel("advect", _PACKED)


def _ptrs(tensors):
    return [t.data_ptr() for t in tensors] + [None] * (3 - len(tensors))


def _launch(planes, outs, u, v, stats, dt, decay_rate, dye: bool):
    h, w = u.shape
    with torch.cuda.device(u.device):
        KERNEL.launch(
            "fluid_advect", *_ptrs(planes), *_ptrs(outs), u.data_ptr(),
            v.data_ptr(), stats.data_ptr() if stats is not None else None,
            len(planes), h, w, int(dye), float(ref.f32(dt)),
            ref.decay_factor(dt, decay_rate), 1, 0, 0, 0, 0, None, 0, stream_of(u))


def _launch_batched(planes, outs, in_ms, out_ms, u, v, stats, params, dye: bool):
    """One launch over the B members: ``planes``/``outs`` member 0's
    planes, each array ``*_ms`` floats from one member to the next."""
    n, h, w = u.shape
    member_params.check(params, n, member_params.ADVECT_COLS, u.device)
    with torch.cuda.device(u.device):
        BATCHED.launch(
            "fluid_advect", *_ptrs(planes), *_ptrs(outs), u.data_ptr(), v.data_ptr(),
            stats.data_ptr() if stats is not None else None, len(planes), h, w,
            int(dye), 0.0, 0.0, n, in_ms, out_ms, u.stride(0), v.stride(0),
            params.data_ptr(), params.stride(0), stream_of(u))


def _launch_packed(planes, outs, u, v, vel_stats, stats, dt, decay_rate,
                   dye: bool, fast_path: bool):
    h, w = u.shape
    if vel_stats is not None:
        check_f32("vel_stats", vel_stats, (2,))
    # the kernel reduces max|u|, max|v| here when no bound is given
    scratch = (torch.empty((2,), dtype=torch.float32, device=u.device)
               if fast_path and vel_stats is None else None)
    with torch.cuda.device(u.device):
        PACKED.launch(
            "fluid_advect_packed", *_ptrs(planes), *_ptrs(outs),
            u.data_ptr(), v.data_ptr(),
            vel_stats.data_ptr() if vel_stats is not None else None,
            scratch.data_ptr() if scratch is not None else None,
            stats.data_ptr() if stats is not None else None,
            len(planes), h, w, int(dye), int(bool(fast_path)),
            float(ref.f32(dt)), ref.decay_factor(dt, decay_rate), 1, 0, 0, 0, 0, None, 0,
            stream_of(u))


def _launch_packed_batched(planes, outs, in_ms, out_ms, u, v, vel_stats, stats, params,
                           dye: bool, fast_path: bool):
    """H8 over the B members: as :func:`_launch_batched`, with each member's
    quiet branch decided from its row of ``vel_stats`` (B, 2), or from its
    maxima reduced first when ``vel_stats`` is None."""
    n, h, w = u.shape
    member_params.check(params, n, member_params.ADVECT_COLS, u.device)
    if vel_stats is not None:
        check_f32("vel_stats", vel_stats, (n, 2))
    scratch = (torch.empty((n, 2), dtype=torch.float32, device=u.device)
               if fast_path and vel_stats is None else None)
    with torch.cuda.device(u.device):
        PACKED_BATCHED.launch(
            "fluid_advect_packed", *_ptrs(planes), *_ptrs(outs), u.data_ptr(), v.data_ptr(),
            vel_stats.data_ptr() if vel_stats is not None else None,
            scratch.data_ptr() if scratch is not None else None,
            stats.data_ptr() if stats is not None else None,
            len(planes), h, w, int(dye), int(bool(fast_path)), 0.0, 0.0, n, in_ms, out_ms,
            u.stride(0), v.stride(0), params.data_ptr(), params.stride(0), stream_of(u))


def _given(*tensors):
    return [t for t in tensors if t is not None]


def advect_velocity(u, v, dt, decay_rate, *, vel_stats=None,
                    return_stats: bool = False, packed: bool = False,
                    fast_path: bool = True):
    """Self-advection of (u, v) with decay; ``ops.ref.advect_velocity``
    semantics, or ``ops.advect_packed.advect_velocity``'s with ``packed``
    (kernel H8; ``fast_path`` and ``vel_stats`` steer its quiet branch).
    ``return_stats`` also returns the kernel-emitted [max|u'|, max|v'|]."""
    if not on_card(*_given(u, v, vel_stats)):
        if packed:
            return advect_packed.advect_velocity(
                u, v, dt, decay_rate, vel_stats=vel_stats,
                return_stats=return_stats, fast_path=fast_path)
        return ref.advect_velocity(u, v, dt, decay_rate, vel_stats=vel_stats,
                                   return_stats=return_stats)
    check_f32("u", u, u.shape)
    check_f32("v", v, u.shape)
    out = torch.empty((2,) + tuple(u.shape), dtype=torch.float32, device=u.device)
    stats = torch.empty((2,), dtype=torch.float32, device=u.device)
    if packed:
        _launch_packed([u, v], [out[0], out[1]], u, v, vel_stats, stats, dt,
                       decay_rate, dye=False, fast_path=fast_path)
    else:
        _launch([u, v], [out[0], out[1]], u, v, stats, dt, decay_rate, dye=False)
    if return_stats:
        return out[0], out[1], stats
    return out[0], out[1]


def advect_dye(dye, u, v, dt, decay_rate, *, vel_stats=None,
               packed: bool = False, fast_path: bool = True, out=None):
    """Dye advection through the advected velocity with the fade
    fmin(1, c^1.005 * decay); ``ops.ref.advect_dye`` semantics, or
    ``ops.advect_packed.advect_dye``'s with ``packed`` (kernel H8).  The
    kernel writes each channel through its own pointer, so ``out`` may be
    channels 2-4 of the step's 5-channel pack (``ref.check_out``)."""
    if out is not None:
        ref.check_out(out, dye.shape, dye, u, v, vel_stats)
    if not on_card(*_given(dye, u, v, vel_stats, out)):
        if packed:
            return advect_packed.advect_dye(dye, u, v, dt, decay_rate,
                                            vel_stats=vel_stats,
                                            fast_path=fast_path, out=out)
        return ref.advect_dye(dye, u, v, dt, decay_rate, vel_stats=vel_stats,
                              out=out)
    h, w = u.shape
    check_f32("u", u, (h, w))
    check_f32("v", v, (h, w))
    if dye.dim() != 3 or not 1 <= dye.shape[0] <= 3:
        raise ValueError(f"dye: expected (C<=3, H, W), got {tuple(dye.shape)}")
    check_f32("dye", dye, (dye.shape[0], h, w))
    out = torch.empty_like(dye) if out is None else out
    if packed:
        _launch_packed(list(dye), list(out), u, v, vel_stats, None, dt,
                       decay_rate, dye=True, fast_path=fast_path)
    else:
        _launch(list(dye), list(out), u, v, None, dt, decay_rate, dye=True)
    return out


def _params(params, dt, decay_rate, device):
    return (member_params.upload(member_params.advect_cols(dt, decay_rate), device)
            if params is None else params)


def advect_velocity_batched(u, v, dt, decay_rate, *, vel_stats=None,
                            return_stats: bool = False, params=None, packed: bool = False,
                            fast_path: bool = True):
    """H1 over B members: u, v (B, H, W) (each plane contiguous), dt (B,);
    ``ops.ref.advect_velocity_batched`` semantics, or with ``packed`` H8's,
    ``ops.advect_packed.advect_velocity_batched`` (``fast_path`` and each
    member's row of ``vel_stats`` (B, 2) steer its quiet branch).
    ``params``: the step's (B, >= 2) device rows [dt, decay]
    (``ops/member_params.py``), uploaded here when None.  Returns u', v'
    (B, H, W) [and stats (B, 2)]."""
    if not on_card(*_given(u, v, vel_stats)):
        if packed:
            return advect_packed.advect_velocity_batched(
                u, v, dt, decay_rate, vel_stats=vel_stats, return_stats=return_stats,
                fast_path=fast_path)
        return ref.advect_velocity_batched(u, v, dt, decay_rate,
                                           return_stats=return_stats)
    n, h, w = u.shape
    check_planes("u", u, (n, h, w))
    check_planes("v", v, (n, h, w))
    params = _params(params, ref.member_vec(dt, n), decay_rate, u.device)
    out = torch.empty((2, n, h, w), dtype=torch.float32, device=u.device)
    stats = torch.empty((n, 2), dtype=torch.float32, device=u.device)
    if u.stride(0) != v.stride(0):
        raise ValueError(f"u, v: member strides differ ({u.stride(0)}, {v.stride(0)})")
    planes, outs = [u[0], v[0]], [out[0, 0], out[1, 0]]
    if packed:
        _launch_packed_batched(planes, outs, u.stride(0), h * w, u, v, vel_stats, stats,
                               params, dye=False, fast_path=fast_path)
    else:
        _launch_batched(planes, outs, u.stride(0), h * w, u, v, stats, params, dye=False)
    return (out[0], out[1], stats) if return_stats else (out[0], out[1])


def advect_dye_batched(dye, u, v, dt, decay_rate, *, vel_stats=None, params=None, out=None,
                       packed: bool = False, fast_path: bool = True):
    """H1's dye fade over B members: dye (B, C, H, W) and u, v (B, H, W),
    each plane contiguous (the dye of a step is channels 2-4 of the last
    one's pack); ``ops.ref.advect_dye_batched`` semantics, or with
    ``packed`` H8's (``ops.advect_packed.advect_dye_batched``, each
    member's quiet branch from its row of ``vel_stats``).  ``out``
    (B, C, H, W) with contiguous planes (``ref.check_out_planes``), for
    example channels 2-4 of the step's (B, 5, H, W) pack."""
    if out is not None:
        ref.check_out_planes(out, dye.shape, dye, u, v, vel_stats)
    if not on_card(*_given(dye, u, v, vel_stats, out)):
        if packed:
            return advect_packed.advect_dye_batched(dye, u, v, dt, decay_rate,
                                                    vel_stats=vel_stats,
                                                    fast_path=fast_path, out=out)
        return ref.advect_dye_batched(dye, u, v, dt, decay_rate, out=out)
    n, h, w = u.shape
    check_planes("u", u, (n, h, w))
    check_planes("v", v, (n, h, w))
    if dye.dim() != 4 or dye.shape[0] != n or not 1 <= dye.shape[1] <= 3:
        raise ValueError(f"dye: expected ({n}, C<=3, H, W), got {tuple(dye.shape)}")
    check_planes("dye", dye, (n, dye.shape[1], h, w))
    params = _params(params, ref.member_vec(dt, n), decay_rate, u.device)
    out = torch.empty_like(dye) if out is None else out
    if packed:
        _launch_packed_batched(list(dye[0]), list(out[0]), dye.stride(0), out.stride(0), u, v,
                               vel_stats, None, params, dye=True, fast_path=fast_path)
    else:
        _launch_batched(list(dye[0]), list(out[0]), dye.stride(0), out.stride(0), u, v,
                        None, params, dye=True)
    return out
