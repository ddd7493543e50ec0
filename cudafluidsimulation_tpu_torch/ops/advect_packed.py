"""Plain PyTorch version of kernel H8: advection over bf16-rounded taps.

The counterpart of the JAX package's ``advect_pallas._advect_core_packed``
(dye, ``fast_dye``) and ``_advect_core_packed_vel`` (velocity,
``fast_velocity``) and the dispatch around them (``_fast_path_ok`` and the
``lax.cond`` of ``_advect_flat``/``_advect_tiled``).  It is
``ops.ref``'s bilerp advection, except that:

- each tap value is first rounded as the TPU kernels pack it,
  bits(x) + 0x8000 masked to the top 16 bits (:func:`bf16_round`: round
  half up in magnitude, not to nearest even, so neither
  ``.to(torch.bfloat16)`` nor ``__float2bfloat16`` gives it).  Velocity
  rounds u and v; dye rounds channels 0 and 1 and keeps channel 2 in f32.
  Rounding a whole plane before the gather equals rounding each tap;
- the dye blend is clamped to >= 0 before the pow (``torch.where(c < 0,
  0, c)``, which lets a NaN through to ``fmin``'s saturation to 1, as
  ``jnp.maximum`` does);
- with ``fast_path`` a quiet step, one whose realized displacement is
  under one cell on both axes (``vel_stats[i]·dt < 1`` in float32, or the
  same test on max|u| and max|v| when ``vel_stats`` is None), takes the
  exact f32 result, ``ops.ref``'s.  The predicate stays a 0-d device
  tensor and selects with ``torch.where``: nothing is read back.

The JAX package's fallback to the f32 core when its VMEM plan splits the
channels, and its ``max_displacement`` clamp, are TPU artifacts and are
not copied: the port's backtrace is unbounded.

The ``*_batched`` functions are the plain versions of batched H8 (B
independent members, ``models/ensemble.py``): the single op on each member,
with the member's own dt and ``vel_stats`` row, so each member takes the
exact or the rounded branch from its own bound, as a vmapped ``lax.cond``
selects per member.
"""

from __future__ import annotations

import torch

from cudafluidsimulation_tpu_torch.ops import ref

Tensor = torch.Tensor


def bf16_round(x: Tensor) -> Tensor:
    """float32 -> float32 with the low 16 bits cleared after adding 0x8000
    to the bit pattern, with 32-bit wrap-around (the JAX packed cores'
    ``(bits + 0x8000) & 0xFFFF0000``).  The integer arithmetic runs in
    int64 on the unsigned pattern, so no signed overflow occurs."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    r = (bits + 0x8000) & 0xFFFF0000
    r = torch.where(r >= 2 ** 31, r - 2 ** 32, r)
    return r.to(torch.int32).view(torch.float32)


def quiet(u: Tensor, v: Tensor, dt, vel_stats=None) -> Tensor:
    """0-d bool tensor on the velocity's device: True when the bound
    [max|u|, max|v|] (``vel_stats``, or the maxima of ``u`` and ``v``)
    times dt is under one cell on both axes.  A NaN bound is not quiet."""
    bound = ref.vel_max(u, v) if vel_stats is None else vel_stats
    return (bound * float(ref.f32(dt)) < 1.0).all()


def advect_velocity(u: Tensor, v: Tensor, dt, decay_rate, *, vel_stats=None,
                    return_stats: bool = False, fast_path: bool = True):
    """Self-advection of (u, v) over bf16-rounded taps, with decay;
    ``return_stats`` also returns ``ref.vel_max`` of the output."""
    decay = ref.decay_factor(dt, decay_rate)
    px, py = ref._backtrace(u, v, dt)
    out = ref.bilerp(bf16_round(torch.stack([u, v])), px, py) * decay
    if fast_path:
        exact = torch.stack(ref.advect_velocity(u, v, dt, decay_rate))
        out = torch.where(quiet(u, v, dt, vel_stats), exact, out)
    u2, v2 = out[0], out[1]
    if return_stats:
        return u2, v2, ref.vel_max(u2, v2)
    return u2, v2


def advect_dye(dye: Tensor, u: Tensor, v: Tensor, dt, decay_rate, *,
               vel_stats=None, fast_path: bool = True, out=None) -> Tensor:
    """Dye advection over taps with channels 0 and 1 bf16-rounded, the
    blend clamped to >= 0, then the fade fmin(1, c^1.005 * decay).
    ``out`` as in ``ref.advect_dye``."""
    if out is not None:
        ref.check_out(out, dye.shape, dye, u, v, vel_stats)
    decay = ref.decay_factor(dt, decay_rate)
    px, py = ref._backtrace(u, v, dt)
    taps = torch.cat([bf16_round(dye[:2]), dye[2:]])
    c = ref.bilerp(taps, px, py)
    c = torch.where(c < 0, 0.0, c)
    res = torch.fmin(torch.pow(c, 1.005) * decay, c.new_ones(()))
    if fast_path:
        exact = ref.advect_dye(dye, u, v, dt, decay_rate)
        res = torch.where(quiet(u, v, dt, vel_stats), exact, res)
    return ref._into(out, res)


def _member_stats(vel_stats, i):
    return None if vel_stats is None else vel_stats[i]


def advect_velocity_batched(u: Tensor, v: Tensor, dt, decay_rate, *, vel_stats=None,
                            return_stats: bool = False, fast_path: bool = True,
                            params=None):
    """:func:`advect_velocity` of each member: u, v (B, H, W), dt (B,),
    ``vel_stats`` (B, 2) or None; stats (B, 2).  ``params`` (the kernel's
    device rows) is accepted and unused."""
    del params
    dt = ref.member_vec(dt, u.shape[0])
    out = ref._stacked(advect_velocity(u[i], v[i], dt[i], decay_rate, return_stats=True,
                                       vel_stats=_member_stats(vel_stats, i),
                                       fast_path=fast_path)
                       for i in range(u.shape[0]))
    return out if return_stats else out[:2]


def advect_dye_batched(dye: Tensor, u: Tensor, v: Tensor, dt, decay_rate, *,
                       vel_stats=None, fast_path: bool = True, params=None,
                       out=None) -> Tensor:
    """:func:`advect_dye` of each member: dye (B, C, H, W); ``out`` as in
    ``ref.advect_dye_batched``."""
    del params
    if out is not None:
        ref.check_out_planes(out, dye.shape, dye, u, v, vel_stats)
    dt = ref.member_vec(dt, u.shape[0])
    res = torch.stack([advect_dye(dye[i], u[i], v[i], dt[i], decay_rate,
                                  vel_stats=_member_stats(vel_stats, i), fast_path=fast_path)
                       for i in range(u.shape[0])])
    return res if out is None else out.copy_(res)


def advect_window(fields: Tensor, u: Tensor, v: Tensor, dt, decay_rate, mode: str,
                  window: ref.Window, *, vel_stats=None, return_stats: bool = False,
                  fast_path: bool = True, out=None):
    """Kernel H8's window entry, plain: ``ref.advect_window`` (the sharded
    rollout's padded view, ``ref.Window``) over bf16-rounded taps, rounded
    as :func:`advect_velocity` and :func:`advect_dye` round them ("field":
    both channels; "dye": channels 0 and 1, the blend clamped to >= 0),
    and with ``fast_path`` the exact result on a quiet step, decided from
    ``vel_stats`` or from the maxima of the cells' (u, v)."""
    if return_stats and mode != "field":
        raise ValueError("return_stats: the velocity bound is the 'field' mode's")
    if mode == "dye":
        taps = torch.cat([bf16_round(fields[:2]), fields[2:]])
    else:
        taps = bf16_round(fields)
    s = ref.window_bilerp(taps, u, v, dt, window)
    if mode == "dye":
        s = torch.where(s < 0, 0.0, s)
    res = ref.finish_advect(s, dt, decay_rate, mode)
    if fast_path:
        exact = ref.advect_window(fields, u, v, dt, decay_rate, mode, window)
        res = torch.where(quiet(u, v, dt, vel_stats), exact, res)
    res = ref._into(out, res)
    if return_stats:
        return res, ref.vel_max(res[0], res[1])
    return res


def window_plain(fields, u, v, dt, decay_rate, mode, window, *, vel_stats=None,
                 return_stats: bool = False, packed: bool = False,
                 fast_path: bool = True, out=None):
    """The plain version of the window entries of H1 (``ref.advect_window``)
    and, with ``packed``, of H8 (:func:`advect_window`)."""
    if packed:
        return advect_window(fields, u, v, dt, decay_rate, mode, window,
                             vel_stats=vel_stats, return_stats=return_stats,
                             fast_path=fast_path, out=out)
    return ref.advect_window(fields, u, v, dt, decay_rate, mode, window,
                             return_stats=return_stats, out=out)
