"""H6's blocked smoother ends with the grid transfers fused in, on the CPU.

``csrc/multigrid.cu`` runs every smoother end as bursts of sweeps on a
tile plus a halo in shared memory (``csrc/burst.cuh``); the pre-smooths
restrict their residual into the next level's right-hand side in their
epilogue, and the post-smooths add the prolonged coarse correction while
loading.  The CUDA kernel runs only on the card (``chip_smoke.py`` holds
it there bit for bit against the plain ends); here:

- the plain ends (``ops/multigrid.py``) are ``torch.equal`` to their
  compositions of the older plain ops;
- ``emulate`` runs the kernel's schedule in plain torch on the planner's
  geometry (cut-outs of tile +- halo, the prolongation read from the coarse
  ring around the region, clamped to the coarse grid, the restriction of
  each tile's residual), and it must be bit-equal to the plain ends, with a
  no-halo control that must differ;
- ``pressure_project_mg`` over the ends matches the JAX package's
  multigrid projection (``tests/test_torch_multigrid.py``'s bounds: atol
  5e-3, rtol 1e-5, stats rtol 1e-4) and takes as many V-cycles;
- one V-cycle calls one end a level on the way down and one on the way up.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cudafluidsimulation_tpu.ops import multigrid as jmg

from cudafluidsimulation_tpu_torch.ops import jacobi_cuda, multigrid, multigrid_cuda, ref

torch.set_num_threads(1)

OMEGA = multigrid.OMEGA
SHAPES = ((16, 16), (32, 48), (96, 64))
SWEEPS = (1, 2, 3)
LOAD, ZERO_PLANE, FROM_ZERO, FROM_UV = (multigrid_cuda.LOAD, multigrid_cuda.ZERO_PLANE,
                                        multigrid_cuda.FROM_ZERO, multigrid_cuda.FROM_UV)
STORE, RESIDUAL, PROJECT = multigrid_cuda.STORE, multigrid_cuda.RESIDUAL, multigrid_cuda.PROJECT


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _inputs(rng, h, w):
    p, rhs = _t(rng.standard_normal((h, w)) * 5.0), _t(rng.standard_normal((h, w)))
    u, v = (_t(rng.standard_normal((h, w)) * 20.0) for _ in range(2))
    return p, rhs, u, v, _t(rng.standard_normal((h // 2, w // 2)) * 3.0)


def _equal(got, exp):
    assert len(got) == len(exp)
    for g, e in zip(got, exp):
        assert g.shape == e.shape
        assert torch.equal(g, e)


def _prolong(e):
    """The prolongation as the JAX package writes it: replicate padding,
    then the 9-3-3-1 stencil."""
    return multigrid.bilinear_from_padded(F.pad(e[None], (1, 1, 1, 1), mode="replicate")[0])


# -- the plain ends against their compositions --------------------------------------


def _compositions(p, rhs, u, v, e, s):
    """(end's plain call, the same from the older plain ops), by name."""
    r4 = lambda res: 4.0 * multigrid._restrict(res)  # noqa: E731
    sp, sres = multigrid.smooth_res(p, rhs, s)
    zp, zres = multigrid.smooth_res(rhs, rhs, s, from_zero=True)
    fp, frhs, fres = multigrid.first_smooth_res(u, v, s, True)
    return {
        "smooth_res_restrict": (lambda: multigrid.smooth_res_restrict(p, rhs, s, return_res=True),
                                (sp, r4(sres), sres)),
        "smooth_res_restrict_from_zero": (
            lambda: multigrid.smooth_res_restrict(None, rhs, s, from_zero=True), (zp, r4(zres))),
        "first_smooth_res_restrict": (lambda: multigrid.first_smooth_res_restrict(u, v, s, True),
                                      (fp, frhs, fres, r4(fres))),
        "prolong_smooth": (lambda: (multigrid.prolong_smooth(p, e, rhs, s),),
                           (multigrid.smooth_damped(p + _prolong(e), rhs, s),)),
        "prolong_smooth_project": (
            lambda: multigrid.prolong_smooth_project(p, e, rhs, u, v, s, return_stats=True),
            multigrid.last_smooth_project(p + _prolong(e), rhs, u, v, s, return_stats=True)),
        "bottom": (lambda: (multigrid.smooth_damped(None, rhs, s),),
                   (multigrid.smooth_damped(torch.zeros_like(rhs), rhs, s),)),
    }


ENDS = ("smooth_res_restrict", "smooth_res_restrict_from_zero", "first_smooth_res_restrict",
        "prolong_smooth", "prolong_smooth_project", "bottom")


@pytest.mark.parametrize("sweeps", SWEEPS)
@pytest.mark.parametrize("shape", SHAPES, ids=[f"{h}x{w}" for h, w in SHAPES])
@pytest.mark.parametrize("end", ENDS)
def test_plain_end_equals_composition(rng, end, shape, sweeps):
    p, rhs, u, v, e = _inputs(rng, *shape)
    call, exp = _compositions(p, rhs, u, v, e, sweeps)[end]
    _equal(call(), exp)


@pytest.mark.parametrize("shape", SHAPES, ids=[f"{h}x{w}" for h, w in SHAPES])
def test_wrappers_on_cpu_tensors_run_the_plain_ends(rng, shape):
    p, rhs, u, v, e = _inputs(rng, *shape)
    before = [k.launches for k in multigrid_cuda.KERNELS]
    mc = multigrid_cuda
    _equal(mc.smooth_res_restrict(p, rhs, 2, return_res=True),
           multigrid.smooth_res_restrict(p, rhs, 2, return_res=True))
    _equal(mc.smooth_res_restrict(None, rhs, 2, from_zero=True),
           multigrid.smooth_res_restrict(None, rhs, 2, from_zero=True))
    _equal(mc.first_smooth_res_restrict(u, v, 2, False),
           multigrid.first_smooth_res_restrict(u, v, 2, False))
    _equal([mc.prolong_smooth(p, e, rhs, 2)], [multigrid.prolong_smooth(p, e, rhs, 2)])
    _equal(mc.prolong_smooth_project(p, e, rhs, u, v, 2),
           multigrid.prolong_smooth_project(p, e, rhs, u, v, 2))
    _equal([mc.smooth_damped(None, rhs, 3)], [multigrid.smooth_damped(None, rhs, 3)])
    assert [k.launches for k in multigrid_cuda.KERNELS] == before


@pytest.mark.parametrize("call", [
    lambda: multigrid_cuda.smooth_res_restrict(None, torch.zeros(8, 8), 2),
    lambda: multigrid_cuda.prolong_smooth(torch.zeros(8, 8), torch.zeros(4, 4),
                                          torch.zeros(8, 8), 0),
    lambda: multigrid_cuda.smooth_res_restrict(
        torch.empty((9, 8), device="meta"), torch.empty((9, 8), device="meta"), 2),
], ids=["p_none_not_from_zero", "no_sweeps", "meta"])
def test_fused_wrappers_refuse(call):
    with pytest.raises(ValueError):
        call()


# -- the planner's H6 kinds ---------------------------------------------------------


@pytest.mark.parametrize("kind", ["smooth", "smooth_res"])
@pytest.mark.parametrize("shape", [(16, 16), (32, 32), (1024, 1024), (2048, 2048),
                                   (2050, 2046)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_plan_h6_kinds(shape, kind):
    h, w = shape
    for sweeps in (1, 2, 3, 8, 9, 20):
        plan = jacobi_cuda.plan_bursts(h, w, sweeps, kind)
        assert plan.iters == sweeps and min(plan.depths) >= 1
        n = len(plan.depths)
        assert plan.halos == tuple(d + (kind == "smooth_res" and j == n - 1)
                                   for j, d in enumerate(plan.depths))
        assert plan.smem == tuple(jacobi_cuda.burst_smem(kind, h, w, plan.tile, a)
                                  for a in plan.halos)
        assert max(plan.smem) <= jacobi_cuda.SMEM_LIMIT
        # the quality path's calls are one launch each: 2 sweeps at any
        # level, 20 at the 16² bottom
        if sweeps <= jacobi_cuda.DEPTH or max(h, w) <= 32:
            assert n == 1
    assert jacobi_cuda.plan_bursts(h, w, 0, kind).depths == ()
    # tiles of even height and width: every 2x2 block lies in one tile
    assert all(t % 2 == 0 for t in jacobi_cuda.TILE)


# -- the schedule, emulated in plain torch ------------------------------------------


def _tiles(plan, h, w):
    th, tw = plan.tile
    for ty0 in range(0, h, th):
        for tx0 in range(0, w, tw):
            yield ty0, min(ty0 + th, h), tx0, min(tx0 + tw, w)


def prolong_region(e, box, tile):
    """p's correction over the region ``box``, computed as the kernel's
    load computes it: from the coarse ring around the region, each coarse
    index clamped to the coarse grid.  Fine ring k around the tile needs
    coarse ring ceil(k / 2) + 1."""
    y0, y1, x0, x1 = box
    hc, wc = e.shape
    for a0, t0 in ((y0, tile[0]), (x0, tile[2])):
        k = t0 - a0
        assert t0 // 2 - (a0 // 2 - 1) == -(-k // 2) + 1
    rows = torch.arange(y0 // 2 - 1, (y1 - 1) // 2 + 2).clamp(0, hc - 1)
    cols = torch.arange(x0 // 2 - 1, (x1 - 1) // 2 + 2).clamp(0, wc - 1)
    f = multigrid.bilinear_from_padded(e[rows][:, cols])
    oy, ox = y0 % 2, x0 % 2
    return f[oy:oy + y1 - y0, ox:ox + x1 - x0]


def _sweep(a, f):
    l, r, b, t = ref.neighbors(a)
    return a + OMEGA * ((l + r + b + t + f) * 0.25 - a)


def emulate(plan, start, tail, *, p=None, e=None, rhs=None, u=None, v=None,
            half=True, want_res=True, want_rhs_c=False, halos=None):
    """``fluid_mg_smooth``'s bursts on the CPU: for each burst and tile, cut
    out tile +- halo (clipped to the grid), start there (load p, plus the
    correction prolonged from the coarse ring; zeros; the from-zero sweep;
    rhs = -div of the cut-out first), sweep the cut-out with taps clamped at
    its edges, and write back the tile, with the last burst's tail.
    Returns the outputs the entry returns, in its order."""
    h, w = (u if start == FROM_UV else rhs).shape
    # the kernel's halos: the depth, one ring more for a tail that reads p
    # beyond the tile; the planner must agree
    kernel_halos = tuple(d + (tail != STORE and j == len(plan.depths) - 1)
                         for j, d in enumerate(plan.depths))
    assert plan.halos == kernel_halos
    halos = kernel_halos if halos is None else halos
    rhs_out = torch.empty((h, w)) if start == FROM_UV else None
    res = torch.empty((h, w))
    rhs_c = torch.empty((h // 2, w // 2))
    u2, v2, maxima = torch.empty((h, w)), torch.empty((h, w)), []
    cur_p, cur_rhs = p, rhs
    for j, (depth, halo) in enumerate(zip(plan.depths, halos)):
        first, last = j == 0, j == len(plan.depths) - 1
        b_start = start if first else LOAD
        b_tail = tail if last else STORE
        new_p = torch.empty((h, w))
        for tile in _tiles(plan, h, w):
            ty0, ty1, tx0, tx1 = tile
            box = (max(ty0 - halo, 0), min(ty1 + halo, h), max(tx0 - halo, 0), min(tx1 + halo, w))
            cut = (slice(box[0], box[1]), slice(box[2], box[3]))
            inner = (slice(ty0 - box[0], ty1 - box[0]), slice(tx0 - box[2], tx1 - box[2]))
            sweeps = depth
            if b_start == FROM_UV:
                f = -ref.divergence(u[cut], v[cut], half)
                rhs_out[ty0:ty1, tx0:tx1] = f[inner]
            else:
                f = cur_rhs[cut]
            if b_start in (FROM_UV, FROM_ZERO):
                a, sweeps = OMEGA * (f * 0.25), depth - 1
            elif b_start == ZERO_PLANE:
                a = torch.zeros_like(f)
            elif e is not None and first:
                a = cur_p[cut] + prolong_region(e, box, tile)
            else:
                a = cur_p[cut]
            for _ in range(sweeps):
                a = _sweep(a, f)
            new_p[ty0:ty1, tx0:tx1] = a[inner]
            if b_tail == RESIDUAL:
                r = f - multigrid.apply_a(a)
                res[ty0:ty1, tx0:tx1] = r[inner]
                rhs_c[ty0 // 2:ty1 // 2, tx0 // 2:tx1 // 2] = 4.0 * multigrid._restrict(r[inner])
            elif b_tail == PROJECT:
                cu, cv = ref.project(u[cut], v[cut], a)
                u2[ty0:ty1, tx0:tx1], v2[ty0:ty1, tx0:tx1] = cu[inner], cv[inner]
                maxima.append(ref.vel_max(cu[inner], cv[inner]))
        cur_p = new_p
        if b_start == FROM_UV:
            cur_rhs = rhs_out
    if tail == PROJECT:
        return u2, v2, cur_p, torch.stack(maxima).max(dim=0).values
    if tail == STORE:
        return (cur_p,)
    out = (cur_p,) if start != FROM_UV else (cur_p, rhs_out)
    out += (res,) if want_res else ()
    return out + ((rhs_c,) if want_rhs_c else ())


def _emulated_and_plain(name, plan_kw, shape, s, rng):
    h, w = shape
    p, rhs, u, v, e = _inputs(rng, h, w)
    plan = lambda kind: jacobi_cuda.plan_bursts(h, w, s, kind, **plan_kw)  # noqa: E731
    m = multigrid
    return {
        "smooth_damped": (emulate(plan("smooth"), LOAD, STORE, p=p, rhs=rhs),
                          (m.smooth_damped(p, rhs, s),)),
        "smooth_damped_zero_plane": (emulate(plan("smooth"), ZERO_PLANE, STORE, rhs=rhs),
                                     (m.smooth_damped(None, rhs, s),)),
        "smooth_res": (emulate(plan("smooth_res"), LOAD, RESIDUAL, p=p, rhs=rhs),
                       m.smooth_res(p, rhs, s)),
        "smooth_res_from_zero": (emulate(plan("smooth_res"), FROM_ZERO, RESIDUAL, rhs=rhs),
                                 m.smooth_res(rhs, rhs, s, from_zero=True)),
        "first_smooth_res": (emulate(plan("smooth_res"), FROM_UV, RESIDUAL, u=u, v=v, half=False),
                             m.first_smooth_res(u, v, s, False)),
        "last_smooth_project": (emulate(plan("smooth_res"), LOAD, PROJECT, p=p, rhs=rhs, u=u, v=v),
                                m.last_smooth_project(p, rhs, u, v, s, return_stats=True)),
        "smooth_res_restrict": (emulate(plan("smooth_res"), LOAD, RESIDUAL, p=p, rhs=rhs,
                                        want_rhs_c=True),
                                m.smooth_res_restrict(p, rhs, s, return_res=True)),
        "smooth_res_restrict_from_zero": (
            emulate(plan("smooth_res"), FROM_ZERO, RESIDUAL, rhs=rhs, want_res=False,
                    want_rhs_c=True),
            m.smooth_res_restrict(None, rhs, s, from_zero=True)),
        "first_smooth_res_restrict": (
            emulate(plan("smooth_res"), FROM_UV, RESIDUAL, u=u, v=v, want_rhs_c=True),
            m.first_smooth_res_restrict(u, v, s, True)),
        "prolong_smooth": (emulate(plan("smooth"), LOAD, STORE, p=p, e=e, rhs=rhs),
                           (m.prolong_smooth(p, e, rhs, s),)),
        "prolong_smooth_project": (
            emulate(plan("smooth_res"), LOAD, PROJECT, p=p, e=e, rhs=rhs, u=u, v=v),
            m.prolong_smooth_project(p, e, rhs, u, v, s, return_stats=True)),
    }[name]


EMULATED = ("smooth_damped", "smooth_damped_zero_plane", "smooth_res", "smooth_res_from_zero",
            "first_smooth_res", "last_smooth_project", "smooth_res_restrict",
            "smooth_res_restrict_from_zero", "first_smooth_res_restrict", "prolong_smooth",
            "prolong_smooth_project")
# small even tiles whose edges split coarse cells' neighbourhoods, bursts of
# 2 or 3 sweeps; and the default plan (one tile at these shapes)
PLANS = {"4x6_d2": dict(tile=(4, 6), depth=2), "6x10_d3": dict(tile=(6, 10), depth=3),
         "default": {}}
EMU_SHAPES = ((16, 16), (22, 38), (32, 48))


@pytest.mark.parametrize("plan_name", PLANS)
@pytest.mark.parametrize("shape", EMU_SHAPES, ids=[f"{h}x{w}" for h, w in EMU_SHAPES])
@pytest.mark.parametrize("name", EMULATED)
def test_blocked_schedule_is_bit_equal(rng, name, shape, plan_name):
    for s in (1, 2, 3, 5):
        got, exp = _emulated_and_plain(name, PLANS[plan_name], shape, s, rng)
        if name == "smooth_res_restrict":
            exp = (exp[0], exp[2], exp[1])  # (p, rhs_c, res) -> emulate's (p, res, rhs_c)
        _equal(got, exp)


def test_blocked_schedule_without_the_halo_is_wrong(rng):
    # the control: the same cut-outs without their halo give other values,
    # so the tests above see the halo (and the coarse ring) at work
    h, w = 22, 38
    p, rhs, u, v, e = _inputs(rng, h, w)
    for kind, start, tail, kw, exp in (
            ("smooth", LOAD, STORE, dict(p=p, e=e, rhs=rhs),
             (multigrid.prolong_smooth(p, e, rhs, 3),)),
            ("smooth_res", LOAD, RESIDUAL, dict(p=p, rhs=rhs, want_rhs_c=True),
             multigrid.smooth_res_restrict(p, rhs, 3, return_res=True))):
        plan = jacobi_cuda.plan_bursts(h, w, 3, kind, tile=(4, 6), depth=3)
        got = emulate(plan, start, tail, halos=(0,) * len(plan.depths), **kw)
        assert not torch.equal(got[0], exp[0])


# -- the V-cycle over the ends ------------------------------------------------------


def _counting(ends, calls):
    """A namespace over ``ends`` that records (end, shape) of each call."""
    def wrap(name, fn):
        def call(*args, **kw):
            plane = next(a for a in args if isinstance(a, torch.Tensor))
            calls.append((name, tuple(plane.shape)))
            return fn(*args, **kw)
        return call
    return types.SimpleNamespace(**{k: wrap(k, f) for k, f in vars(ends).items()})


@pytest.mark.parametrize("kw", [dict(cycles=1), dict(cycles=2), dict(cycles=2, tol=0.05)])
def test_vcycle_calls_one_end_a_level_each_way(rng, kw):
    h = w = 128
    u, v = (_t(rng.standard_normal((h, w)) * 20.0) for _ in range(2))
    calls = []
    multigrid.pressure_project_mg(u, v, half=True, ends=_counting(multigrid_cuda.ENDS, calls),
                                  **kw)
    lv = multigrid._levels(h, w)
    names = [n for n, _ in calls]
    finishes = names.count("prolong_smooth") // (lv - 1) + names.count("prolong_smooth_project")
    # per cycle: levels - 2 zero-start pre-smooths, the bottom, levels - 1
    # post-smooths; per step: cycle 1's fine pre-smooth (and the fine
    # probes of the tol loop, one per completed cycle)
    assert names.count("first_smooth_res_restrict") == 1
    assert names.count("smooth_damped") == finishes
    coarse_pre = [s for n, s in calls if n == "smooth_res_restrict" and s != (h, w)]
    assert len(coarse_pre) == (lv - 2) * finishes
    assert [s for n, s in calls if n == "smooth_damped"] == [(16, 16)] * finishes
    # and the residual-targeted loop's stopping test, the ends' res_mean
    assert set(names) <= {"first_smooth_res_restrict", "smooth_res_restrict", "smooth_damped",
                          "prolong_smooth", "prolong_smooth_project", "project", "res_mean"}
    if kw.get("tol", 0) <= 0:
        assert finishes == kw["cycles"] and names[-1] == "prolong_smooth_project"
    else:
        assert names[-1] == "project"


def _jax_cycles(u, v, tol):
    """The V-cycles JAX's residual-targeted projection completes: capped at
    m cycles it returns the fixed m-cycle iterate until m reaches the count
    it converges at, and the same probed iterate for every m from there."""
    outs = [np.asarray(jmg.pressure_project_mg(jnp.asarray(u), jnp.asarray(v), 2, tol=tol,
                                               max_cycles=m, half=True)[2]) for m in (1, 2, 3, 4)]
    for m in range(3):
        if np.array_equal(outs[m], outs[m + 1]):
            return m + 1
    return None


def test_pressure_project_mg_takes_jax_cycle_count(rng):
    h = w = 128
    u, v = (rng.standard_normal((h, w)) * 20.0 for _ in range(2))
    u, v = u.astype(np.float32), v.astype(np.float32)
    div = ref.divergence(_t(u), _t(v), True)
    # rms residuals after 1 and 2 fixed cycles; a tol halfway between them
    # cannot be flipped by a last-bit difference in mean(res**2)
    r1, r2 = (float(multigrid.residual_norm(
        multigrid.pressure_project_mg(_t(u), _t(v), c, half=True)[2], div)) for c in (1, 2))
    tol = 0.5 * (r1 + r2)
    calls = []
    got = multigrid.pressure_project_mg(_t(u), _t(v), 2, tol=tol, max_cycles=8, half=True,
                                        return_stats=True,
                                        ends=_counting(multigrid_cuda.ENDS, calls))
    port_cycles = sum(1 for n, s in calls if n == "prolong_smooth" and s == (h, w))
    assert 1 <= port_cycles < 4
    assert _jax_cycles(u, v, tol) == port_cycles
    exp = jmg.pressure_project_mg(jnp.asarray(u), jnp.asarray(v), 2, tol=tol, max_cycles=8,
                                  half=True, return_stats=True)
    for g, e in zip(got[:3], exp[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), atol=5e-3, rtol=1e-5)
    np.testing.assert_allclose(got[3].numpy(), np.asarray(exp[3]), rtol=1e-4)


@pytest.mark.parametrize("kw", [dict(cycles=1), dict(cycles=3), dict(cycles=2, tol=0.05)])
def test_pressure_project_mg_over_fused_ends_vs_jax(rng, kw):
    u, v = (rng.standard_normal((128, 128)).astype(np.float32) * 20.0 for _ in range(2))
    got = multigrid.pressure_project_mg(_t(u), _t(v), half=True, return_stats=True,
                                        ends=multigrid_cuda.ENDS, **kw)
    exp = jmg.pressure_project_mg(jnp.asarray(u), jnp.asarray(v), half=True,
                                  return_stats=True, **kw)
    for g, e in zip(got[:3], exp[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), atol=5e-3, rtol=1e-5)
    np.testing.assert_allclose(got[3].numpy(), np.asarray(exp[3]), rtol=1e-4)
