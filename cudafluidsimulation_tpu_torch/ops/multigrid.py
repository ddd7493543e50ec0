"""Geometric multigrid pressure solver, plain PyTorch on any device.

The port of ``cudafluidsimulation_tpu/ops/multigrid.py``: the same V-cycle
on the same system the Jacobi solver iterates,
    (4 p - pL - pR - pB - pT) = -div     (clamped / Neumann edges),
with damped-Jacobi smoothing (omega = 0.8), 2x2-average restriction, the
coarse right-hand side scaled by 4, and cell-centred bilinear (9-3-3-1)
prolongation.  Every expression keeps the JAX package's float32
association order, so the two agree to rounding (tests/test_torch_multigrid.py).

Two entry points:

- :func:`pressure_solve_mg` (the ``ref`` backend's op): ``div -> p`` over
  :func:`make_vcycle`, smoothing with plain sweeps or, given ``smoother``,
  with a namespace of smoother ends (the H6 kernel wrappers,
  ``ops.multigrid_cuda.ENDS``).
- :func:`pressure_project_mg` (the ``cuda`` backend's hook): divergence,
  V-cycles and projection over a namespace of smoother ends, one end call
  per level on the way down and one on the way up.  Every pre-smooth
  restricts its residual into the next level's right-hand side
  (``smooth_res_restrict``; cycle 1's fine one also computes the
  divergence, ``first_smooth_res_restrict``), every post-smooth starts from
  p plus the prolonged coarse correction (``prolong_smooth``; for a fixed
  cycle count the last one also projects, ``prolong_smooth_project``), and
  the coarsest level sweeps from a zero plane (``smooth_damped(None, ...)``).
  :data:`PLAIN` holds the ends' plain versions, compositions of the sweeps,
  :func:`_restrict` and :func:`_prolong`; the ``cuda`` backend passes the
  kernel wrappers, which run the same plain versions for CPU tensors, so on
  the card no restriction, prolongation or zero plane runs outside H6.

Residual-targeted stopping (``tol > 0``) needs the residual's value on the
host: :func:`probed_tol_loop` reads ``mean(res**2)`` once per loop test, so
a step that completes k cycles waits on the device k + 1 times.

Tracing (``utils/trace.py``): each completed cycle runs inside a
``fluid.mg.cycle`` span (ident: the cycle's number within the solve, from
1), the work from the end of one fine pre-smooth to the end of the next
(the coarse correction, the fine post-smooth and the next pre-smooth with
its residual; on the fixed-count path the last one ends in the
projection); each stopping read inside a ``fluid.mg.stopping_read`` span.
:data:`MG_STATS` counts ``mg_solves`` (solves: one a call of a solve entry,
single or batched; the plain batched op solves each member apart, and a
sharded step's shards count theirs), ``mg_cycles`` (their completed
V-cycles) and ``mg_reads`` (their stopping reads, k + 1 for k cycles).

Ensembles (B independent members, ``models/ensemble.py``):
:func:`pressure_project_mg_batched` is :func:`pressure_project_mg` over a
namespace of batched ends (:data:`PLAIN_BATCHED`, the plain ends of each
member, or the H6 wrappers' ``ops.multigrid_cuda.ENDS_BATCHED``), one end
call a level each way for all members.  Its residual-targeted loop is
:func:`probed_tol_loop` on (B,) tests, what a vmapped ``lax.while_loop``
does: it runs until every member has stopped, a stopped member keeps its carry,
and each member returns its own probed or completed iterate; so each member
stops at its own cycle count and equals its single run.  It reads one (B,)
vector a test: k + 1 reads for a step whose members complete at most k
cycles.
"""

from __future__ import annotations

import threading
import types

import numpy as np
import torch
import torch.nn.functional as F

from cudafluidsimulation_tpu_torch.ops import ref
from cudafluidsimulation_tpu_torch.ops.stencil import neighbors
from cudafluidsimulation_tpu_torch.utils.trace import span

OMEGA = 0.8  # damped-Jacobi smoothing weight

MG_STATS = {"mg_solves": 0, "mg_cycles": 0, "mg_reads": 0}
_STATS_LOCK = threading.Lock()


def _count(cycles: int, reads: int = 0) -> None:
    """One solve of ``cycles`` completed V-cycles and ``reads`` stopping
    reads, in :data:`MG_STATS`."""
    with _STATS_LOCK:
        MG_STATS["mg_solves"] += 1
        MG_STATS["mg_cycles"] += cycles
        MG_STATS["mg_reads"] += reads


# ---------------------------------------------------------------------------
# Grid transfer and level geometry
# ---------------------------------------------------------------------------


def _restrict(x: torch.Tensor) -> torch.Tensor:
    """2x2 average: strided adds, rows first, then columns (of the last two
    axes; leading member axes broadcast)."""
    r = x[..., 0::2, :] + x[..., 1::2, :]
    return (r[..., 0::2] + r[..., 1::2]) * 0.25


def bilinear_from_padded(xp: torch.Tensor) -> torch.Tensor:
    """Cell-centred bilinear (9-3-3-1) prolongation from a one-cell-padded
    coarse plane (the caller supplies the padding: clamped edges on one
    device, exchanged halos on a sharded one); leading member axes
    broadcast."""
    c = xp[..., 1:-1, 1:-1]
    u, d = xp[..., :-2, 1:-1], xp[..., 2:, 1:-1]
    l, r = xp[..., 1:-1, :-2], xp[..., 1:-1, 2:]
    ul, ur = xp[..., :-2, :-2], xp[..., :-2, 2:]
    dl, dr = xp[..., 2:, :-2], xp[..., 2:, 2:]
    s = 1.0 / 16.0
    f00 = (9.0 * c + 3.0 * u + 3.0 * l + ul) * s  # fine (2i, 2j)
    f01 = (9.0 * c + 3.0 * u + 3.0 * r + ur) * s
    f10 = (9.0 * c + 3.0 * d + 3.0 * l + dl) * s
    f11 = (9.0 * c + 3.0 * d + 3.0 * r + dr) * s
    lead, (h, w) = tuple(c.shape[:-2]), c.shape[-2:]
    top = torch.stack([f00, f01], dim=-1).reshape(lead + (h, 2 * w))
    bot = torch.stack([f10, f11], dim=-1).reshape(lead + (h, 2 * w))
    return torch.stack([top, bot], dim=-2).reshape(lead + (2 * h, 2 * w))


def _prolong(x: torch.Tensor) -> torch.Tensor:
    return bilinear_from_padded(F.pad(x[None], (1, 1, 1, 1), mode="replicate")[0])


def local_levels(n: int) -> int:
    """V-cycle levels an extent of ``n`` cells supports before it stops
    halving cleanly (1 + the 2-adic valuation, clamped at n >= 2)."""
    c = 1
    while n % 2 == 0 and n >= 2:
        n //= 2
        c += 1
    return c


def _levels(h: int, w: int, max_levels: int = 8, min_size: int = 16) -> int:
    n = 0
    while (
        n < max_levels - 1
        and h % 2 == 0 and w % 2 == 0
        and h // 2 >= min_size and w // 2 >= min_size
    ):
        h //= 2
        w //= 2
        n += 1
    return n + 1


# ---------------------------------------------------------------------------
# The smoother ends' plain versions (the H6 kernels' arithmetic)
# ---------------------------------------------------------------------------


def apply_a(p: torch.Tensor) -> torch.Tensor:
    """The 5-point operator 4p - (L + R + B + T), clamped edges."""
    l, r, b, t = neighbors(p)
    return 4.0 * p - (l + r + b + t)


def smooth_damped(p, rhs, sweeps: int, omega: float = OMEGA):
    """``sweeps`` damped-Jacobi sweeps p + omega*((L+R+B+T+rhs)*0.25 - p);
    the centre term is the current iterate.  ``p`` None is a plane of
    zeros (the coarsest level's start), swept as given."""
    if p is None:
        p = torch.zeros_like(rhs)
    for _ in range(sweeps):
        l, r, b, t = neighbors(p)
        p = p + omega * ((l + r + b + t + rhs) * 0.25 - p)
    return p


def smooth_res(p, rhs, sweeps: int, omega: float = OMEGA, *,
               from_zero: bool = False):
    """``sweeps`` damped sweeps, then the residual: (p', rhs - A p').  With
    ``from_zero`` the sweeps start from p = 0 and ``p`` is not read: the
    first sweep is omega*(rhs*0.25), its neighbour taps being zero."""
    if from_zero:
        p = omega * (rhs * 0.25)
        sweeps -= 1
    p = smooth_damped(p, rhs, sweeps, omega)
    return p, rhs - apply_a(p)


def first_smooth_res(u, v, sweeps: int, half: bool, omega: float = OMEGA):
    """Cycle 1's fine pre-smooth with the divergence folded in: returns
    (p, rhs, res) with rhs = -divergence(u, v, half) and ``sweeps`` sweeps
    from p = 0."""
    rhs = -ref.divergence(u, v, half)
    p, res = smooth_res(rhs, rhs, sweeps, omega, from_zero=True)
    return p, rhs, res


def last_smooth_project(p, rhs, u, v, sweeps: int, omega: float = OMEGA, *,
                        return_stats: bool = False):
    """The last post-smooth with the projection folded in: returns
    (u', v', p'[, vel_stats])."""
    p = smooth_damped(p, rhs, sweeps, omega)
    out = ref.project(u, v, p, return_stats=return_stats)
    return (out[0], out[1], p) + tuple(out[2:])


# The ends with the grid transfers folded in: a pre-smooth hands the level
# below its right-hand side, a post-smooth takes the level below's
# correction.  Each is one H6 launch on the card.


def smooth_res_restrict(p, rhs, sweeps: int, omega: float = OMEGA, *,
                        from_zero: bool = False, return_res: bool = False):
    """A pre-smooth and its residual, restricted: (p', rhs_c[, res]) with
    rhs_c = 4 * restrict(rhs - A p'), the next level's right-hand side.
    With ``from_zero`` ``p`` is not read (it may be None)."""
    p, res = smooth_res(p, rhs, sweeps, omega, from_zero=from_zero)
    rhs_c = 4.0 * _restrict(res)
    return (p, rhs_c, res) if return_res else (p, rhs_c)


def first_smooth_res_restrict(u, v, sweeps: int, half: bool,
                              omega: float = OMEGA):
    """Cycle 1's fine pre-smooth, divergence folded in and residual
    restricted: (p, rhs, res, rhs_c)."""
    p, rhs, res = first_smooth_res(u, v, sweeps, half, omega)
    return p, rhs, res, 4.0 * _restrict(res)


def prolong_smooth(p, e_c, rhs, sweeps: int, omega: float = OMEGA):
    """A post-smooth of p plus the prolonged coarse correction ``e_c``."""
    return smooth_damped(p + _prolong(e_c), rhs, sweeps, omega)


def prolong_smooth_project(p, e_c, rhs, u, v, sweeps: int,
                           omega: float = OMEGA, *, return_stats: bool = False):
    """The fixed-cycle path's last post-smooth: the prolonged correction,
    the sweeps and the projection, (u', v', p'[, vel_stats])."""
    return last_smooth_project(p + _prolong(e_c), rhs, u, v, sweeps, omega,
                               return_stats=return_stats)


PLAIN = types.SimpleNamespace(
    smooth_damped=smooth_damped,
    smooth_res=smooth_res,
    first_smooth_res=first_smooth_res,
    last_smooth_project=last_smooth_project,
    smooth_res_restrict=smooth_res_restrict,
    first_smooth_res_restrict=first_smooth_res_restrict,
    prolong_smooth=prolong_smooth,
    prolong_smooth_project=prolong_smooth_project,
    divergence=ref.divergence,
    project=ref.project,
)


def _per_member(fn):
    """``fn`` over a leading member axis: each tensor argument's member i
    (None stays None), the other arguments as given, results stacked."""
    def batched(*args, **kw):
        n = next(a.shape[0] for a in args if isinstance(a, torch.Tensor))
        pick = lambda a, i: a[i] if isinstance(a, torch.Tensor) else a  # noqa: E731
        outs = [fn(*(pick(a, i) for a in args), **kw) for i in range(n)]
        if isinstance(outs[0], torch.Tensor):
            return torch.stack(outs)
        return tuple(torch.stack(list(parts)) for parts in zip(*outs))

    batched.__doc__ = f"``{fn.__name__}`` of each member, stacked."
    return batched


# ---------------------------------------------------------------------------
# The V-cycle and the solves built on it
# ---------------------------------------------------------------------------


def make_vcycle(neighbors_fn, smooth_fn=None, bottom_fn=None,
                prolong_fn=None, smooth_res_fn=None, parts: bool = False):
    """Build the V-cycle from a clamped-neighbourhood function, with the JAX
    package's hooks: ``smooth_fn(p, rhs, sweeps)`` replaces the damped
    sweeps, ``bottom_fn(p, rhs, nu1, nu2, coarse_sweeps)`` the coarsest
    level, ``prolong_fn(e_c)`` the prolongation, and
    ``smooth_res_fn(p, rhs, nu1) -> (p', rhs - A p')`` the pre-smooth with
    its residual.  ``parts=True`` also returns the fine level's
    ``probe`` (pre-smooth + residual) and ``finish`` (coarse correction +
    post-smooth), with ``vcycle == finish . probe``."""

    def apply(p):
        l, r, b, t = neighbors_fn(p)
        return 4.0 * p - (l + r + b + t)

    def default_smooth(p, rhs, sweeps: int):
        for _ in range(sweeps):
            l, r, b, t = neighbors_fn(p)
            p = p + OMEGA * ((l + r + b + t + rhs) * 0.25 - p)
        return p

    smooth = smooth_fn or default_smooth
    prolong = prolong_fn or _prolong

    def bottom(p, rhs, nu1, nu2, coarse_sweeps):
        if bottom_fn is not None:
            return bottom_fn(p, rhs, nu1, nu2, coarse_sweeps)
        return smooth(p, rhs, coarse_sweeps)

    def probe(p, rhs, nu1, level, nu2=None, coarse_sweeps=None):
        """Top-level pre-smooth + its residual; at level 1 the whole
        (bottom) cycle runs here and finish() is the identity."""
        if level == 1:
            p = bottom(p, rhs, nu1, nu2, coarse_sweeps)
        elif smooth_res_fn is not None:
            return smooth_res_fn(p, rhs, nu1)
        else:
            p = smooth(p, rhs, nu1)
        return p, rhs - apply(p)

    def finish(p, res, rhs, level, nu1, nu2, coarse_sweeps):
        if level == 1:
            return p
        # the coarse grid doubles the mesh width of the h²-absorbed
        # operator, so the restricted residual gains a factor 4
        rhs_c = 4.0 * _restrict(res)
        e_c = vcycle(torch.zeros_like(rhs_c), rhs_c, level - 1, nu1, nu2,
                     coarse_sweeps)
        p = p + prolong(e_c)
        return smooth(p, rhs, nu2)

    def vcycle(p, rhs, level: int, nu1: int, nu2: int, coarse_sweeps: int):
        if level == 1:
            return bottom(p, rhs, nu1, nu2, coarse_sweeps)
        if smooth_res_fn is not None:
            p, res = smooth_res_fn(p, rhs, nu1)
        else:
            p = smooth(p, rhs, nu1)
            res = rhs - apply(p)
        return finish(p, res, rhs, level, nu1, nu2, coarse_sweeps)

    if parts:
        return vcycle, apply, probe, finish
    return vcycle, apply


_vcycle, _, _probe, _finish = make_vcycle(neighbors, parts=True)


# The stopping test's reduction, in the fixed order of the card's
# ``fluid_mean_square`` (csrc/multigrid.cu): a chunk of MS_THREADS x
# MS_PER_THREAD cells of a plane, thread t adding the squares of cells t,
# t + MS_THREADS, ... in turn, the threads' sums meeting in a tree; then the
# plane's chunk sums the same way, divided by the plane's cells.  The order
# depends on nothing but the plane's size, so a member of a batch sees the
# value of its single plane; torch.mean's own order depends on the shape of
# the whole call.
MS_THREADS, MS_PER_THREAD = 256, 32


def _tree(x: torch.Tensor) -> torch.Tensor:
    """(..., T) -> (...): s[t] += s[t + off] for off = T/2, T/4, ..., 1."""
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        x = x[..., :half] + x[..., half:]
    return x[..., 0]


def _chunk_sums(x: torch.Tensor, per_thread: int) -> torch.Tensor:
    """(..., n) -> (..., chunks): each chunk's threads' sums, from 0 in
    turn, then their tree (cells past n add nothing: zeros)."""
    chunk = MS_THREADS * per_thread
    n = x.shape[-1]
    chunks = -(-n // chunk)
    x = F.pad(x, (0, chunks * chunk - n)).reshape(
        tuple(x.shape[:-1]) + (chunks, per_thread, MS_THREADS))
    acc = torch.zeros_like(x[..., 0, :])
    for j in range(per_thread):
        acc = acc + x[..., j, :]
    return _tree(acc)


def mean_square(r: torch.Tensor) -> torch.Tensor:
    """mean(r**2) over the last two axes ((...) for (..., H, W)), summed in
    the order of kernel ``fluid_mean_square`` (its plain version): the
    residual-targeted loop's stopping test on every path."""
    n = r.shape[-2] * r.shape[-1]
    sq = (r * r).reshape(tuple(r.shape[:-2]) + (n,))
    part = _chunk_sums(sq, MS_PER_THREAD)
    total = _chunk_sums(part, -(-part.shape[-1] // MS_THREADS))[..., 0]
    return total / torch.full_like(total, float(n))


def probed_tol_loop(probe, finish, res_mean_fn, p0, first, tol, max_cycles):
    """Residual-targeted cycle loop: each iteration completes the pending
    cycle (``finish``) and runs the next cycle's pre-smooth
    (``probe(p) -> (p', res')``), whose residual is the stopping test.
    ``first`` is the probe of ``p0``.  Stops once mean(res**2) <
    float32(tol)**2 or after ``max_cycles`` completed cycles; returns the
    probed iterate when converged, else the last completed cycle's, so a
    capped run equals the fixed-count run.  Each loop test reads the
    residual's mean on the host, one copy (a ``fluid.mg.stopping_read``
    span); each iteration is a ``fluid.mg.cycle`` span, and the solve is
    counted in :data:`MG_STATS`.

    ``res_mean_fn`` gives a 0-d tensor for one plane, or (B,) for B
    members (iterates (B, H, W)), which the loop treats as a vmapped
    while-loop does: it goes on while any member's test fails, a member
    whose test has passed keeps its carry (its later cycles are computed
    for the batch and selected away by ``torch.where`` with a mask made on
    the device, only while the members disagree), and each member returns
    its own probed or completed iterate."""
    p1, r1 = first
    tol2 = float(np.float32(tol) ** 2)
    pf = p0
    rsq_dev = res_mean_fn(r1)  # each member's test, kept from where it stopped
    with span("fluid.mg.stopping_read"):
        rsq = rsq_dev.cpu().numpy()
    i = 0
    while i < max_cycles and (rsq >= tol2).any():
        with span("fluid.mg.cycle", i + 1):
            pf_next = finish(p1, r1)
            p_next, r1 = probe(pf_next)  # a stopped member's residual is never read
            rsq_next = res_mean_fn(r1)
            if (rsq >= tol2).all():
                pf, p1, rsq_dev = pf_next, p_next, rsq_next
            else:
                active = rsq_dev >= tol2
                m = active[:, None, None]
                pf = pf_next if pf is None else torch.where(m, pf_next, pf)
                p1 = torch.where(m, p_next, p1)
                rsq_dev = torch.where(active, rsq_next, rsq_dev)
        with span("fluid.mg.stopping_read"):
            rsq = rsq_dev.cpu().numpy()
        i += 1
    _count(i, i + 1)
    done = rsq < tol2
    if done.all():
        return p1
    if not done.any():
        return pf
    return torch.where((rsq_dev < tol2)[:, None, None], p1, pf)


def run_cycles(vcycle, probe_fn, finish_fn, res_mean_fn, p, rhs, level,
               cycles, tol, max_cycles, nu1, nu2, coarse_sweeps):
    """A fixed ``cycles`` count (``tol <= 0``), or cycles until the rms
    residual drops below ``tol`` (at most ``max_cycles``), by
    :func:`probed_tol_loop`."""
    if tol <= 0:
        for i in range(cycles):
            with span("fluid.mg.cycle", i + 1):
                p = vcycle(p, rhs, level, nu1, nu2, coarse_sweeps)
        _count(cycles)
        return p

    def probe(q):
        return probe_fn(q, rhs, nu1, level, nu2, coarse_sweeps)

    def finish(q, res):
        return finish_fn(q, res, rhs, level, nu1, nu2, coarse_sweeps)

    return probed_tol_loop(probe, finish, res_mean_fn, p, probe(p), tol, max_cycles)


def pressure_solve_mg(div, cycles: int = 2, nu1: int = 2, nu2: int = 2,
                      coarse_sweeps: int = 20, tol: float = 0.0,
                      max_cycles: int = 8, smoother=None):
    """Multigrid solve of the pressure system from p = 0.  ``tol > 0``
    switches from ``cycles`` V-cycles to residual-targeted stopping
    (rms(A p + div) < tol, at most ``max_cycles`` cycles).

    ``smoother`` None smooths with plain sweeps (the ``ref`` op); a
    namespace with ``smooth_damped`` and ``smooth_res`` (:data:`PLAIN`, or
    the H6 wrappers ``ops.multigrid_cuda.ENDS``) takes over the sweeps and
    the pre-smooth with its residual: the same arithmetic.  A batched
    namespace (:data:`PLAIN_BATCHED`, ``ENDS_BATCHED``) solves (B, H, W)
    members, each stopping at its own cycle count.  The stopping test is
    the namespace's ``res_mean`` (the kernel's), else :func:`mean_square`."""
    h, w = div.shape[-2:]
    lv = _levels(h, w)
    rhs = -div
    if smoother is None:
        vc, probe, fin = _vcycle, _probe, _finish
    else:
        vc, _, probe, fin = make_vcycle(
            neighbors,
            smooth_fn=lambda p, r, n: smoother.smooth_damped(p, r, n, OMEGA),
            smooth_res_fn=lambda p, r, n: smoother.smooth_res(p, r, n, OMEGA),
            parts=True)
    return run_cycles(vc, probe, fin, getattr(smoother, "res_mean", mean_square),
                      torch.zeros_like(div), rhs, lv, cycles, tol, max_cycles, nu1, nu2,
                      coarse_sweeps)


def residual_norm(p, div) -> torch.Tensor:
    """||A p + div||_rms, the convergence diagnostic."""
    r = apply_a(p) + div
    return torch.sqrt(torch.mean(r * r))


# ---------------------------------------------------------------------------
# Divergence -> V-cycles -> projection over the smoother ends
# ---------------------------------------------------------------------------


def _coarse_solve(ends, rhs, level, nu1, nu2, coarse_sweeps):
    """The zero-start V-cycle of a coarse level: its correction e, one end
    call a level on the way down and one on the way up.  The pre-smooth
    restricts its residual into the level below's right-hand side; the
    post-smooth adds the prolonged correction of the level below."""
    if level == 1:
        return ends.smooth_damped(None, rhs, coarse_sweeps, OMEGA)
    e, rhs_c = ends.smooth_res_restrict(None, rhs, nu1, OMEGA, from_zero=True)
    e_c = _coarse_solve(ends, rhs_c, level - 1, nu1, nu2, coarse_sweeps)
    return ends.prolong_smooth(e, e_c, rhs, nu2, OMEGA)


def pressure_project_mg(u, v, cycles: int = 2, nu1: int = 2, nu2: int = 2,
                        coarse_sweeps: int = 20, tol: float = 0.0,
                        max_cycles: int = 8, half: bool = True,
                        return_stats: bool = False, ends=None):
    """Divergence -> multigrid V-cycles -> projection: returns
    (u', v', p[, vel_stats]).  The same solve as
    ``divergence -> pressure_solve_mg(smoother=ends) -> project``, op for op.

    ``ends`` is a namespace of the smoother ends (:data:`PLAIN` when None).
    Cycle 1's fine pre-smooth computes the divergence; with ``tol <= 0``
    the last cycle's fine post-smooth subtracts the gradient; with
    ``tol > 0`` the cycles run under :func:`probed_tol_loop` and the
    standalone ``project`` follows.  A grid with a single level has no
    coarse correction and runs the composition."""
    ends = PLAIN if ends is None else ends
    h, w = u.shape[-2:]
    lv = _levels(h, w)
    if lv == 1:
        p = pressure_solve_mg(ends.divergence(u, v, half), cycles, nu1, nu2,
                              coarse_sweeps, tol, max_cycles, smoother=ends)
        out = ends.project(u, v, p, return_stats=return_stats)
        return (out[0], out[1], p) + tuple(out[2:])

    p, rhs, res, rhs_c = ends.first_smooth_res_restrict(u, v, nu1, half, OMEGA)

    def coarse(rhs_c):
        return _coarse_solve(ends, rhs_c, lv - 1, nu1, nu2, coarse_sweeps)

    if tol <= 0:
        for i in range(cycles - 1):
            with span("fluid.mg.cycle", i + 1):
                p = ends.prolong_smooth(p, coarse(rhs_c), rhs, nu2, OMEGA)
                p, rhs_c = ends.smooth_res_restrict(p, rhs, nu1, OMEGA)
        last = max(cycles, 1)  # the projection completes one cycle at least
        with span("fluid.mg.cycle", last):
            out = ends.prolong_smooth_project(p, coarse(rhs_c), rhs, u, v, nu2,
                                              OMEGA, return_stats=return_stats)
        _count(last)
        return out

    # a probe's "residual" is (res, rhs_c): the test reads res, the cycle
    # it completes goes on from rhs_c
    def probe(q):
        q, rhs_c, res = ends.smooth_res_restrict(q, rhs, nu1, OMEGA,
                                                 return_res=True)
        return q, (res, rhs_c)

    def finish(q, pending):
        return ends.prolong_smooth(q, coarse(pending[1]), rhs, nu2, OMEGA)

    # the loop returns p0 only when it may complete no cycle
    p0 = torch.zeros_like(rhs) if max_cycles < 1 else None
    res_mean = getattr(ends, "res_mean", mean_square)
    p = probed_tol_loop(probe, finish, lambda pending: res_mean(pending[0]),
                        p0, (p, (res, rhs_c)), tol, max_cycles)
    out = ends.project(u, v, p, return_stats=return_stats)
    return (out[0], out[1], p) + tuple(out[2:])


PLAIN_BATCHED = types.SimpleNamespace(
    **{name: _per_member(fn) for name, fn in vars(PLAIN).items()})


def pressure_project_mg_batched(u, v, cycles: int = 2, nu1: int = 2, nu2: int = 2,
                                coarse_sweeps: int = 20, tol: float = 0.0,
                                max_cycles: int = 8, half: bool = True,
                                return_stats: bool = False, ends=None):
    """:func:`pressure_project_mg` of B members, u and v (B, H, W), over a
    namespace of batched ends (:data:`PLAIN_BATCHED` when None, or
    ``ops.multigrid_cuda.ENDS_BATCHED``): returns (u', v', p[, vel_stats
    (B, 2)]).  The fixed-cycle path is the single one's end calls on all
    members at once; with ``tol > 0`` each member stops at its own cycle
    count (:func:`probed_tol_loop`)."""
    return pressure_project_mg(u, v, cycles, nu1, nu2, coarse_sweeps, tol, max_cycles,
                               half, return_stats,
                               ends=PLAIN_BATCHED if ends is None else ends)
