"""H6: the multigrid smoother ends on the card (``csrc/multigrid.cu``).

Replaces ``cudafluidsimulation_tpu/ops/jacobi_pallas.py``:

- ``smooth_damped`` → ``_smooth_kernel``, ``_smooth_kernel_tiled``;
- ``smooth_res`` → ``_smooth_res_kernel``, ``_smooth_res_kernel_tiled``;
- ``first_smooth_res`` → ``_first_smooth_res_kernel``;
- ``last_smooth_project`` → ``_last_smooth_project_kernel``;

and, with the restriction and prolongation that the JAX package leaves to
XLA fused in, the ends that ``ops/multigrid.py`` runs its V-cycles over:
``smooth_res_restrict``, ``first_smooth_res_restrict`` (pre-smooths that
write the next level's right-hand side), ``prolong_smooth`` and
``prolong_smooth_project`` (post-smooths that start from p plus the
prolonged coarse correction).

Each wrapper takes its plain version (``ops/multigrid.py``) for CPU
tensors and launches the kernel or raises for CUDA tensors; each entry has
its own launch count.  Every entry runs one kernel, temporally blocked as
H4's solve is (``csrc/burst.cuh``): a launch is a burst of sweeps on a tile
plus a halo in shared memory, planned by ``jacobi_cuda.plan_bursts`` (kind
"smooth", or "smooth_res" when the tail reads p beyond the tile).  At the
quality path's shapes (2 sweeps, or 20 at the 16² bottom) every call is one
launch; ``prolong_smooth_project`` with the velocity bound adds the memset
of its two floats.

Bound by bytes: at the 2048² fine level (16 MiB a plane) the pre-smooth
with restriction reads p and rhs and writes p, res and rhs_c (68 MiB);
the post-smooth reads p, rhs and e_c and writes p (52 MiB);
``first_smooth_res_restrict`` reads u and v and writes p, rhs, res and
rhs_c (84 MiB).  The levels at or below 1024² sit in the 50 MB L2.

``ENDS`` is the namespace of these wrappers, with H5's ``divergence`` and
``project``, that ``ops/multigrid.py`` runs its V-cycles over.

``mean_square`` is the stopping test of the residual-targeted loop: the
mean of a residual's squares, by ``fluid_mean_square`` in an order that
depends on the plane's size alone (``multigrid.mean_square`` is its plain
version, the same additions), so a batch's member and a single plane of the
same values get the same bits.

``ENDS_BATCHED`` is the same over B independent members (ensembles): the
``*_batched`` wrappers launch the same kernel once a call for all members,
member b on grid z (``KERNELS_BATCHED``, their own launch counts); u and v
may be the planes of a (B, 5, H, W) pack (any member stride), every other
plane is a contiguous (B, H, W) or (B, H/2, W/2) array.  Their plain
versions are ``multigrid.PLAIN_BATCHED``'s.
"""

from __future__ import annotations

import ctypes
import functools
import types

import torch

from cudafluidsimulation_tpu_torch.ops import jacobi_cuda, multigrid, ref
from cudafluidsimulation_tpu_torch.ops._build import (
    Kernel, check_f32, check_planes, on_card, stream_of)

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
OMEGA = multigrid.OMEGA

# fluid_mg_smooth(u, v, p_in, e_c, rhs_in, rhs_out, p_out, res_out, rhs_c,
#                 u2, v2, stats, scratch, h, w, tile_h, tile_w, depths*,
#                 nbursts, start, tail, half, omega, nb, u_ms, v_ms, stream);
#                 depths is a host pointer, every other pointer may be null
#                 where unused
_ENTRY = {"fluid_mg_smooth": [_P] * 13 + [_I] * 4 + [_P] + [_I] * 4 + [_F, _I, _L, _L, _P]}
# one counter per entry, all over the one C entry
SMOOTH = Kernel("multigrid", _ENTRY)
SMOOTH_RES = Kernel("multigrid", _ENTRY)
FIRST = Kernel("multigrid", _ENTRY)
LAST = Kernel("multigrid", _ENTRY)
SMOOTH_RES_RESTRICT = Kernel("multigrid", _ENTRY)
FIRST_RESTRICT = Kernel("multigrid", _ENTRY)
PROLONG_SMOOTH = Kernel("multigrid", _ENTRY)
PROLONG_SMOOTH_PROJECT = Kernel("multigrid", _ENTRY)
KERNELS = (SMOOTH, SMOOTH_RES, FIRST, LAST, SMOOTH_RES_RESTRICT, FIRST_RESTRICT,
           PROLONG_SMOOTH, PROLONG_SMOOTH_PROJECT)
# the same entries, B members a launch
SMOOTH_BATCHED = Kernel("multigrid", _ENTRY)
SMOOTH_RES_BATCHED = Kernel("multigrid", _ENTRY)
FIRST_BATCHED = Kernel("multigrid", _ENTRY)
LAST_BATCHED = Kernel("multigrid", _ENTRY)
SMOOTH_RES_RESTRICT_BATCHED = Kernel("multigrid", _ENTRY)
FIRST_RESTRICT_BATCHED = Kernel("multigrid", _ENTRY)
PROLONG_SMOOTH_BATCHED = Kernel("multigrid", _ENTRY)
PROLONG_SMOOTH_PROJECT_BATCHED = Kernel("multigrid", _ENTRY)
KERNELS_BATCHED = (SMOOTH_BATCHED, SMOOTH_RES_BATCHED, FIRST_BATCHED, LAST_BATCHED,
                   SMOOTH_RES_RESTRICT_BATCHED, FIRST_RESTRICT_BATCHED,
                   PROLONG_SMOOTH_BATCHED, PROLONG_SMOOTH_PROJECT_BATCHED)
# fluid_mean_square(r, part, out, nb, n, ms, stream): the stopping test's
# reduction, single planes and batches
_MEAN_SQUARE = {"fluid_mean_square": [_P, _P, _P, _I, _L, _L, _P]}
MEAN_SQUARE = Kernel("multigrid", _MEAN_SQUARE)
MEAN_SQUARE_BATCHED = Kernel("multigrid", _MEAN_SQUARE)

# csrc/multigrid.cu MgStart and MgTail
LOAD, ZERO_PLANE, FROM_ZERO, FROM_UV = range(4)
STORE, RESIDUAL, PROJECT = range(3)


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


def _check_even(h: int, w: int) -> None:
    if h % 2 or w % 2:
        raise ValueError(f"restriction and prolongation need even extents, got {h}x{w}")


def _ptr(t) -> int | None:
    return t.data_ptr() if t is not None else None


def _given(*tensors):
    """The tensors that are not None, for ``on_card``."""
    return [t for t in tensors if t is not None]


@functools.lru_cache(maxsize=256)
def _plan(h: int, w: int, sweeps: int, kind: str):
    """(tile, host depths array, its pointer, bursts) of a call; cached, as
    a V-cycle asks for the same few plans every step (the array lives in
    the cache, so its pointer stays valid)."""
    plan = jacobi_cuda.plan_bursts(h, w, sweeps, kind)
    return (plan.tile,) + jacobi_cuda._depths(plan)


def _launch(kernel, like, sweeps, start, tail, *, u=None, v=None, p=None,
            e_c=None, rhs=None, rhs_out=None, res=None, rhs_c=None,
            uv2=None, stats=None, half=True, omega=OMEGA):
    """Allocate p' and launch ``fluid_mg_smooth`` on ``like``'s stream,
    ``like`` an (H, W) plane or (B, H, W) members (then u and v at their
    member strides); the caller allocates the other outputs it asks for."""
    h, w = like.shape[-2:]
    nb = like.shape[0] if like.dim() == 3 else 1
    tile, _, depths_ptr, nbursts = _plan(h, w, int(sweeps),
                                         "smooth" if tail == STORE else "smooth_res")
    p_out = torch.empty_like(like)
    scratch = torch.empty_like(like) if nbursts >= 2 else None
    u2, v2 = (None, None) if uv2 is None else (uv2[0], uv2[1])
    u_ms = u.stride(0) if u is not None and nb > 1 else 0
    v_ms = v.stride(0) if v is not None and nb > 1 else 0
    with torch.cuda.device(like.device):
        kernel.launch(
            "fluid_mg_smooth", _ptr(u), _ptr(v), _ptr(p), _ptr(e_c), _ptr(rhs),
            _ptr(rhs_out), p_out.data_ptr(), _ptr(res), _ptr(rhs_c), _ptr(u2),
            _ptr(v2), _ptr(stats), _ptr(scratch), h, w, *tile, depths_ptr,
            nbursts, start, tail, int(bool(half)), float(ref.f32(omega)), nb, u_ms, v_ms,
            stream_of(like))
    return p_out


def _coarse(like):
    h, w = like.shape[-2:]
    return torch.empty(tuple(like.shape[:-2]) + (h // 2, w // 2), dtype=torch.float32,
                       device=like.device)


# -- the ends the V-cycle runs over ------------------------------------------------


def smooth_damped(p, rhs, sweeps: int, omega: float = OMEGA):
    """``sweeps`` damped-Jacobi sweeps, ``p`` None a plane of zeros (the
    kernel starts from zeros in shared memory; no plane is written);
    ``multigrid.smooth_damped``."""
    _check_sweeps(sweeps, 0)
    if not on_card(*_given(p, rhs)):
        return multigrid.smooth_damped(p, rhs, sweeps, omega)
    _planes(rhs=rhs, **({} if p is None else {"p": p}))
    if sweeps == 0:
        return torch.zeros_like(rhs) if p is None else p
    return _launch(SMOOTH, rhs, sweeps, LOAD if p is not None else ZERO_PLANE, STORE,
                   p=p, rhs=rhs, omega=omega)


def smooth_res_restrict(p, rhs, sweeps: int, omega: float = OMEGA, *,
                        from_zero: bool = False, return_res: bool = False):
    """``sweeps`` >= 1 sweeps, the residual and its restriction, (p', rhs_c
    [, res]) with rhs_c = 4 * restrict(rhs - A p'); ``from_zero`` starts
    from p = 0 without reading ``p`` (None allowed);
    ``multigrid.smooth_res_restrict``."""
    _check_sweeps(sweeps, 1)
    if p is None and not from_zero:
        raise ValueError("p is None: only a from_zero pre-smooth reads no p")
    if not on_card(*_given(None if from_zero else p, rhs)):
        return multigrid.smooth_res_restrict(p, rhs, sweeps, omega, from_zero=from_zero,
                                             return_res=return_res)
    h, w = _planes(rhs=rhs, **({} if from_zero else {"p": p}))
    _check_even(h, w)
    rhs_c = _coarse(rhs)
    res = torch.empty_like(rhs) if return_res else None
    out = _launch(SMOOTH_RES_RESTRICT, rhs, sweeps, FROM_ZERO if from_zero else LOAD,
                  RESIDUAL, p=None if from_zero else p, rhs=rhs, res=res,
                  rhs_c=rhs_c, omega=omega)
    return (out, rhs_c, res) if return_res else (out, rhs_c)


def first_smooth_res_restrict(u, v, sweeps: int, half: bool, omega: float = OMEGA):
    """Divergence, ``sweeps`` >= 1 sweeps from zero, the residual and its
    restriction: (p, rhs, res, rhs_c) with rhs = -div;
    ``multigrid.first_smooth_res_restrict``."""
    _check_sweeps(sweeps, 1)
    if not on_card(u, v):
        return multigrid.first_smooth_res_restrict(u, v, sweeps, half, omega)
    h, w = _planes(u=u, v=v)
    _check_even(h, w)
    rhs, res, rhs_c = torch.empty_like(u), torch.empty_like(u), _coarse(u)
    p = _launch(FIRST_RESTRICT, u, sweeps, FROM_UV, RESIDUAL, u=u, v=v,
                rhs_out=rhs, res=res, rhs_c=rhs_c, half=half, omega=omega)
    return p, rhs, res, rhs_c


def prolong_smooth(p, e_c, rhs, sweeps: int, omega: float = OMEGA):
    """``sweeps`` >= 1 sweeps from p plus the prolonged correction ``e_c``
    (half the extents of p); ``multigrid.prolong_smooth``."""
    _check_sweeps(sweeps, 1)
    if not on_card(p, e_c, rhs):
        return multigrid.prolong_smooth(p, e_c, rhs, sweeps, omega)
    h, w = _planes(p=p, rhs=rhs)
    _check_even(h, w)
    check_f32("e_c", e_c, (h // 2, w // 2))
    return _launch(PROLONG_SMOOTH, p, sweeps, LOAD, STORE, p=p, e_c=e_c, rhs=rhs,
                   omega=omega)


def prolong_smooth_project(p, e_c, rhs, u, v, sweeps: int, omega: float = OMEGA, *,
                           return_stats: bool = False):
    """``prolong_smooth`` then the gradient subtraction: (u', v', p'[,
    vel_stats]); ``multigrid.prolong_smooth_project``."""
    _check_sweeps(sweeps, 1)
    if not on_card(p, e_c, rhs, u, v):
        return multigrid.prolong_smooth_project(p, e_c, rhs, u, v, sweeps, omega,
                                                return_stats=return_stats)
    h, w = _planes(p=p, rhs=rhs, u=u, v=v)
    _check_even(h, w)
    check_f32("e_c", e_c, (h // 2, w // 2))
    return _project(PROLONG_SMOOTH_PROJECT, p, e_c, rhs, u, v, sweeps, omega,
                    return_stats)


def _project(kernel, p, e_c, rhs, u, v, sweeps, omega, return_stats):
    uv2 = torch.empty((2,) + tuple(p.shape), dtype=torch.float32, device=p.device)
    stats = (torch.empty(tuple(p.shape[:-2]) + (2,), dtype=torch.float32, device=p.device)
             if return_stats else None)
    p2 = _launch(kernel, p, sweeps, LOAD, PROJECT, u=u, v=v, p=p, e_c=e_c, rhs=rhs,
                 uv2=uv2, stats=stats, omega=omega)
    return (uv2[0], uv2[1], p2) + ((stats,) if return_stats else ())


# -- the ends without the grid transfers (pressure_solve_mg, one-level grids) -------


def smooth_res(p, rhs, sweeps: int, omega: float = OMEGA, *,
               from_zero: bool = False):
    """``sweeps`` >= 1 sweeps and the residual, (p', rhs - A p');
    ``from_zero`` starts from p = 0 without reading ``p``;
    ``multigrid.smooth_res``."""
    _check_sweeps(sweeps, 1)
    if not on_card(p, rhs):
        return multigrid.smooth_res(p, rhs, sweeps, omega, from_zero=from_zero)
    _planes(rhs=rhs, p=p)
    res = torch.empty_like(rhs)
    out = _launch(SMOOTH_RES, rhs, sweeps, FROM_ZERO if from_zero else LOAD, RESIDUAL,
                  p=None if from_zero else p, rhs=rhs, res=res, omega=omega)
    return out, res


def first_smooth_res(u, v, sweeps: int, half: bool, omega: float = OMEGA):
    """Divergence, ``sweeps`` >= 1 sweeps from zero and the residual:
    (p, rhs, res) with rhs = -div; ``multigrid.first_smooth_res``."""
    _check_sweeps(sweeps, 1)
    if not on_card(u, v):
        return multigrid.first_smooth_res(u, v, sweeps, half, omega)
    _planes(u=u, v=v)
    rhs, res = torch.empty_like(u), torch.empty_like(u)
    p = _launch(FIRST, u, sweeps, FROM_UV, RESIDUAL, u=u, v=v, rhs_out=rhs,
                res=res, half=half, omega=omega)
    return p, rhs, res


def last_smooth_project(p, rhs, u, v, sweeps: int, omega: float = OMEGA, *,
                        return_stats: bool = False):
    """``sweeps`` >= 1 sweeps, then the gradient subtraction: (u', v',
    p'[, vel_stats]); ``multigrid.last_smooth_project``."""
    _check_sweeps(sweeps, 1)
    if not on_card(p, rhs, u, v):
        return multigrid.last_smooth_project(p, rhs, u, v, sweeps, omega,
                                             return_stats=return_stats)
    _planes(p=p, rhs=rhs, u=u, v=v)
    return _project(LAST, p, None, rhs, u, v, sweeps, omega, return_stats)


# -- the stopping test --------------------------------------------------------------


def _mean_square(kernel, r):
    n = r.shape[-2] * r.shape[-1]
    nb = r.shape[0] if r.dim() == 3 else 1
    chunks = -(-n // (multigrid.MS_THREADS * multigrid.MS_PER_THREAD))
    part = torch.empty((nb, chunks), dtype=torch.float32, device=r.device)
    out = torch.empty(tuple(r.shape[:-2]), dtype=torch.float32, device=r.device)
    with torch.cuda.device(r.device):
        kernel.launch("fluid_mean_square", r.data_ptr(), part.data_ptr(), out.data_ptr(), nb,
                      n, n, stream_of(r))
    return out


def mean_square(r):
    """mean(r**2) of an (H, W) plane, a 0-d tensor on its device;
    ``multigrid.mean_square``'s order."""
    if not on_card(r):
        return multigrid.mean_square(r)
    _planes(r=r)
    return _mean_square(MEAN_SQUARE, r)


def mean_square_batched(r):
    """(B,) mean(r**2) of each member of (B, H, W) ``r``, one launch a pass
    for all members; ``multigrid.mean_square``'s order."""
    if not on_card(r):
        return multigrid.mean_square(r)
    _members(r=r)
    return _mean_square(MEAN_SQUARE_BATCHED, r)


# -- B members a launch (ensembles) ---------------------------------------------------


def _members(**named):
    """(n, h, w) of the first (B, H, W) array; raise unless every one is a
    contiguous float32 array of that shape."""
    first = next(iter(named.values()))
    if first.dim() != 3:
        raise ValueError(f"expected (B, H, W) members, got {tuple(first.shape)}")
    for name, t in named.items():
        check_f32(name, t, first.shape)
    return first.shape


def _velocity(u, v, shape):
    """u, v: (B, H, W) with contiguous planes at any member stride."""
    check_planes("u", u, shape)
    check_planes("v", v, shape)


def _coarse_of(name, e_c, shape):
    n, h, w = shape
    check_f32(name, e_c, (n, h // 2, w // 2))


def smooth_damped_batched(p, rhs, sweeps: int, omega: float = OMEGA):
    """:func:`smooth_damped` over B members (p None: zeros for each)."""
    _check_sweeps(sweeps, 0)
    if not on_card(*_given(p, rhs)):
        return multigrid.PLAIN_BATCHED.smooth_damped(p, rhs, sweeps, omega)
    _members(rhs=rhs, **({} if p is None else {"p": p}))
    if sweeps == 0:
        return torch.zeros_like(rhs) if p is None else p
    return _launch(SMOOTH_BATCHED, rhs, sweeps, LOAD if p is not None else ZERO_PLANE, STORE,
                   p=p, rhs=rhs, omega=omega)


def smooth_res_restrict_batched(p, rhs, sweeps: int, omega: float = OMEGA, *,
                                from_zero: bool = False, return_res: bool = False):
    """:func:`smooth_res_restrict` over B members: rhs_c (B, H/2, W/2)."""
    _check_sweeps(sweeps, 1)
    if p is None and not from_zero:
        raise ValueError("p is None: only a from_zero pre-smooth reads no p")
    if not on_card(*_given(None if from_zero else p, rhs)):
        return multigrid.PLAIN_BATCHED.smooth_res_restrict(
            p, rhs, sweeps, omega, from_zero=from_zero, return_res=return_res)
    _, h, w = _members(rhs=rhs, **({} if from_zero else {"p": p}))
    _check_even(h, w)
    rhs_c = _coarse(rhs)
    res = torch.empty_like(rhs) if return_res else None
    out = _launch(SMOOTH_RES_RESTRICT_BATCHED, rhs, sweeps, FROM_ZERO if from_zero else LOAD,
                  RESIDUAL, p=None if from_zero else p, rhs=rhs, res=res, rhs_c=rhs_c,
                  omega=omega)
    return (out, rhs_c, res) if return_res else (out, rhs_c)


def first_smooth_res_restrict_batched(u, v, sweeps: int, half: bool, omega: float = OMEGA):
    """:func:`first_smooth_res_restrict` over B members, u and v at any
    member stride: (p, rhs, res, rhs_c)."""
    _check_sweeps(sweeps, 1)
    if not on_card(u, v):
        return multigrid.PLAIN_BATCHED.first_smooth_res_restrict(u, v, sweeps, half, omega)
    shape = u.shape
    if u.dim() != 3:
        raise ValueError(f"expected (B, H, W) members, got {tuple(shape)}")
    _velocity(u, v, shape)
    _check_even(*shape[1:])
    rhs = torch.empty(shape, dtype=torch.float32, device=u.device)
    res, rhs_c = torch.empty_like(rhs), _coarse(rhs)
    p = _launch(FIRST_RESTRICT_BATCHED, rhs, sweeps, FROM_UV, RESIDUAL, u=u, v=v,
                rhs_out=rhs, res=res, rhs_c=rhs_c, half=half, omega=omega)
    return p, rhs, res, rhs_c


def prolong_smooth_batched(p, e_c, rhs, sweeps: int, omega: float = OMEGA):
    """:func:`prolong_smooth` over B members, e_c (B, H/2, W/2)."""
    _check_sweeps(sweeps, 1)
    if not on_card(p, e_c, rhs):
        return multigrid.PLAIN_BATCHED.prolong_smooth(p, e_c, rhs, sweeps, omega)
    shape = _members(p=p, rhs=rhs)
    _check_even(*shape[1:])
    _coarse_of("e_c", e_c, shape)
    return _launch(PROLONG_SMOOTH_BATCHED, p, sweeps, LOAD, STORE, p=p, e_c=e_c, rhs=rhs,
                   omega=omega)


def prolong_smooth_project_batched(p, e_c, rhs, u, v, sweeps: int, omega: float = OMEGA, *,
                                   return_stats: bool = False):
    """:func:`prolong_smooth_project` over B members: (u', v', p'[,
    vel_stats (B, 2)])."""
    _check_sweeps(sweeps, 1)
    if not on_card(p, e_c, rhs, u, v):
        return multigrid.PLAIN_BATCHED.prolong_smooth_project(
            p, e_c, rhs, u, v, sweeps, omega, return_stats=return_stats)
    shape = _members(p=p, rhs=rhs)
    _velocity(u, v, shape)
    _check_even(*shape[1:])
    _coarse_of("e_c", e_c, shape)
    return _project(PROLONG_SMOOTH_PROJECT_BATCHED, p, e_c, rhs, u, v, sweeps, omega,
                    return_stats)


def smooth_res_batched(p, rhs, sweeps: int, omega: float = OMEGA, *, from_zero: bool = False):
    """:func:`smooth_res` over B members."""
    _check_sweeps(sweeps, 1)
    if not on_card(p, rhs):
        return multigrid.PLAIN_BATCHED.smooth_res(p, rhs, sweeps, omega, from_zero=from_zero)
    _members(rhs=rhs, p=p)
    res = torch.empty_like(rhs)
    out = _launch(SMOOTH_RES_BATCHED, rhs, sweeps, FROM_ZERO if from_zero else LOAD, RESIDUAL,
                  p=None if from_zero else p, rhs=rhs, res=res, omega=omega)
    return out, res


def first_smooth_res_batched(u, v, sweeps: int, half: bool, omega: float = OMEGA):
    """:func:`first_smooth_res` over B members: (p, rhs, res)."""
    _check_sweeps(sweeps, 1)
    if not on_card(u, v):
        return multigrid.PLAIN_BATCHED.first_smooth_res(u, v, sweeps, half, omega)
    if u.dim() != 3:
        raise ValueError(f"expected (B, H, W) members, got {tuple(u.shape)}")
    _velocity(u, v, u.shape)
    rhs = torch.empty(u.shape, dtype=torch.float32, device=u.device)
    res = torch.empty_like(rhs)
    p = _launch(FIRST_BATCHED, rhs, sweeps, FROM_UV, RESIDUAL, u=u, v=v, rhs_out=rhs,
                res=res, half=half, omega=omega)
    return p, rhs, res


def last_smooth_project_batched(p, rhs, u, v, sweeps: int, omega: float = OMEGA, *,
                                return_stats: bool = False):
    """:func:`last_smooth_project` over B members."""
    _check_sweeps(sweeps, 1)
    if not on_card(p, rhs, u, v):
        return multigrid.PLAIN_BATCHED.last_smooth_project(p, rhs, u, v, sweeps, omega,
                                                           return_stats=return_stats)
    shape = _members(p=p, rhs=rhs)
    _velocity(u, v, shape)
    return _project(LAST_BATCHED, p, None, rhs, u, v, sweeps, omega, return_stats)


ENDS = types.SimpleNamespace(
    smooth_damped=smooth_damped,
    smooth_res=smooth_res,
    first_smooth_res=first_smooth_res,
    last_smooth_project=last_smooth_project,
    smooth_res_restrict=smooth_res_restrict,
    first_smooth_res_restrict=first_smooth_res_restrict,
    prolong_smooth=prolong_smooth,
    prolong_smooth_project=prolong_smooth_project,
    divergence=jacobi_cuda.divergence,
    project=jacobi_cuda.project,
    res_mean=mean_square,
)

ENDS_BATCHED = types.SimpleNamespace(
    smooth_damped=smooth_damped_batched,
    smooth_res=smooth_res_batched,
    first_smooth_res=first_smooth_res_batched,
    last_smooth_project=last_smooth_project_batched,
    smooth_res_restrict=smooth_res_restrict_batched,
    first_smooth_res_restrict=first_smooth_res_restrict_batched,
    prolong_smooth=prolong_smooth_batched,
    prolong_smooth_project=prolong_smooth_project_batched,
    divergence=jacobi_cuda.divergence_batched,
    project=jacobi_cuda.project_batched,
    res_mean=mean_square_batched,
)
