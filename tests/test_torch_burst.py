"""The burst planner of H3 and H4 and the tiled trapezoid schedule, on the
CPU.

H3 (``csrc/diffuse.cu``) and H4 (``csrc/pressure.cu``) run their sweeps in
bursts: a block cuts its tile plus a halo as deep as the burst out of the
field, sweeps the cut-out with clamped taps, and writes back the tile
(``csrc/burst.cuh``).  The CUDA kernels run only on the card
(``chip_smoke.py`` holds them there bit for bit against the plain ops);
here ``emulate`` runs the same schedule in plain torch on the planner's
geometry, and it must be bit-equal to the plain ops (``ops/ref.py``),
since each cell of the tile is computed by the same float32 operations in
the same order as a global sweep computes it.  The clamp at a cut-out's
inner edges is wrong, but it travels one ring a sweep and never reaches
the tile: that is what the halo buys.  One case holds the emulation
against the JAX Pallas kernels in interpret mode, at the tolerances of
``tests/test_torch_kernels_vs_pallas.py`` (1e-5 of scale: 20 or 40 sweeps
carry last-ulp differences along).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudafluidsimulation_tpu.ops import jacobi_pallas

from cudafluidsimulation_tpu_torch.ops import jacobi_cuda, ref

torch.set_num_threads(1)

DT = np.float32(1 / 60)
K = jacobi_cuda.DEPTH
SHAPES = ((1, 5), (4, 8), (16, 16), (37, 53), (135, 240), (540, 960), (2048, 2048))
SMALL_SHAPES = SHAPES[:5]
KINDS = ("diffuse", "project", "solve")
# the default plan, and a small one so that the small grids hold many
# tiles, ragged on both axes, and many bursts
PLANS = {"default": {}, "small": {"tile": (8, 16), "depth": 3}}


def _iters(depth):
    return sorted({0, 1, 2, depth - 1, depth, depth + 1, 2 * depth + 1, 20, 40})


def _tiles(plan, h, w):
    th, tw = plan.tile
    for ty0 in range(0, h, th):
        for tx0 in range(0, w, tw):
            yield ty0, min(ty0 + th, h), tx0, min(tx0 + tw, w)


# -- the planner --------------------------------------------------------------------


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", SHAPES, ids=[f"{h}x{w}" for h, w in SHAPES])
def test_plan_bursts(shape, kind):
    h, w = shape
    for iters in _iters(K):
        plan = jacobi_cuda.plan_bursts(h, w, iters, kind)
        n = len(plan.depths)
        assert plan.iters == iters
        one_tile = h <= plan.tile[0] and w <= plan.tile[1]
        if iters == 0:
            assert plan.depths == (() if kind == "solve" else (0,))
        elif one_tile:
            assert plan.depths == (iters,)  # every sweep in one launch
        else:
            assert n == math.ceil(iters / K) and max(plan.depths) <= K
            assert max(plan.depths) - min(plan.depths) <= 1  # as even as they come
        assert plan.halos == tuple(d + (kind == "project" and j == n - 1)
                                   for j, d in enumerate(plan.depths))
        assert all(b <= jacobi_cuda.SMEM_LIMIT <= 227 * 1024 for b in plan.smem)
        assert plan.smem == tuple(
            0 if kind == "diffuse" and d == 0 else
            jacobi_cuda.burst_smem(kind, h, w, plan.tile, a)
            for d, a in zip(plan.depths, plan.halos))


@pytest.mark.parametrize("shape", SHAPES, ids=[f"{h}x{w}" for h, w in SHAPES])
def test_tiles_cover_the_grid(shape):
    h, w = shape
    plan = jacobi_cuda.plan_bursts(h, w, 40, "project")
    th, tw = plan.tile
    if h * w <= 540 * 960:
        seen = np.zeros((h, w), np.int32)
        for ty0, ty1, tx0, tx1 in _tiles(plan, h, w):
            seen[ty0:ty1, tx0:tx1] += 1
        assert (seen == 1).all()
    # tiles abut: the last of each axis ends on the grid's edge
    assert math.ceil(h / th) * th >= h > (math.ceil(h / th) - 1) * th
    assert math.ceil(w / tw) * tw >= w > (math.ceil(w / tw) - 1) * tw


def test_shared_memory_bytes():
    # csrc/burst.cuh: rows of tile +- halo (clipped), the tile's width
    # (clipped, to 4 floats) plus the halo to 4 floats on each side
    assert jacobi_cuda.burst_smem("diffuse", 2048, 2048, (48, 112), 7) == 2 * 62 * 128 * 4
    assert jacobi_cuda.burst_smem("project", 2048, 2048, (48, 112), 9) == 3 * 66 * 136 * 4
    assert jacobi_cuda.burst_smem("solve", 16, 16, (48, 112), 40) == 3 * 16 * 48 * 4


def test_depth_lowered_until_it_fits():
    plan = jacobi_cuda.plan_bursts(4096, 4096, 40, "project", tile=(64, 256), depth=16)
    assert max(plan.smem) <= jacobi_cuda.SMEM_LIMIT
    assert max(plan.depths) < 16 and plan.iters == 40
    with pytest.raises(ValueError):
        jacobi_cuda.plan_bursts(4096, 4096, 40, "project", tile=(512, 512))


@pytest.mark.parametrize("args", [(0, 8, 1, "diffuse"), (8, 8, -1, "solve"),
                                  (8, 8, 4, "sweep")])
def test_plan_rejects_bad_arguments(args):
    with pytest.raises(ValueError):
        jacobi_cuda.plan_bursts(*args)


def test_launchers_reject_a_plan_for_other_iters():
    f = torch.zeros((2, 8, 8))
    plan = jacobi_cuda.plan_bursts(8, 8, 4, "diffuse")
    with pytest.raises(ValueError, match="sweeps"):
        jacobi_cuda._diffuse(f, DT, [0.8, 0.8], 5, plan=plan)
    with pytest.raises(ValueError, match="sweeps"):
        jacobi_cuda._pressure_project(f[0], f[1], 5, True,
                                      plan=jacobi_cuda.plan_bursts(8, 8, 4, "project"))


# -- the schedule, emulated in plain torch ------------------------------------------


def emulate(x, plan, sweep, last=None):
    """Run ``plan``'s bursts on the (..., H, W) field ``x``: for each tile,
    cut out tile +- halo (clipped to the grid), run the burst's sweeps on
    the cut-out (``sweep(cut, (y0, y1, x0, x1))``, clamped at its edges),
    and write the tile back; ``last(cut, box, tile)``, when given, is also
    called on each cut-out of the last burst."""
    h, w = x.shape[-2:]
    for j, (depth, halo) in enumerate(zip(plan.depths, plan.halos)):
        out = torch.empty_like(x)
        for ty0, ty1, tx0, tx1 in _tiles(plan, h, w):
            box = (max(ty0 - halo, 0), min(ty1 + halo, h), max(tx0 - halo, 0), min(tx1 + halo, w))
            cut = x[..., box[0]:box[1], box[2]:box[3]]
            for _ in range(depth):
                cut = sweep(cut, box)
            inner = (slice(ty0 - box[0], ty1 - box[0]), slice(tx0 - box[2], tx1 - box[2]))
            if last is not None and j == len(plan.depths) - 1:
                last(cut, box, (ty0, ty1, tx0, tx1))
            out[..., ty0:ty1, tx0:tx1] = cut[(Ellipsis,) + inner]
        x = out
    return x


def emulate_diffuse(f, coeffs, plan, splat=None):
    alpha, inv_beta = ref.diffusion_alphas(DT, coeffs)
    a, b = ref._per_channel(alpha, f), ref._per_channel(inv_beta, f)
    out = emulate(f, plan, lambda cut, box: ref._sweeps(cut, a, b, 1))
    return out if splat is None else ref.splat_tail(out, *splat)


def _pressure_sweep(div):
    def sweep(cut, box):
        l, r, b, t = ref.neighbors(cut)
        return (l + r + b + t - div[box[0]:box[1], box[2]:box[3]]) * 0.25
    return sweep


def emulate_solve(div, plan):
    return emulate(torch.zeros_like(div), plan, _pressure_sweep(div))


def emulate_project(u, v, half, plan):
    """H4's schedule: sweeps from p = 0 over the divergence, the last burst
    one ring deeper, then the projection of each tile from its cut-out and
    the block maxima."""
    div = ref.divergence(u, v, half)
    u2, v2 = torch.empty_like(u), torch.empty_like(v)
    maxima = []

    def last(cut, box, tile):
        ty0, ty1, tx0, tx1 = tile
        y0, y1, x0, x1 = box
        cu, cv = ref.project(u[y0:y1, x0:x1], v[y0:y1, x0:x1], cut)
        inner = (slice(ty0 - y0, ty1 - y0), slice(tx0 - x0, tx1 - x0))
        u2[ty0:ty1, tx0:tx1], v2[ty0:ty1, tx0:tx1] = cu[inner], cv[inner]
        maxima.append(ref.vel_max(cu[inner], cv[inner]))

    p = emulate(torch.zeros_like(div), plan, _pressure_sweep(div), last=last)
    return u2, v2, p, torch.stack(maxima).max(dim=0).values


def _fields(rng, h, w):
    f = torch.from_numpy(rng.standard_normal((3, h, w)).astype(np.float32))
    u, v = (torch.from_numpy((rng.standard_normal((h, w)) * 10).astype(np.float32))
            for _ in range(2))
    return f, u, v


def _equal(got, exp):
    for g, e in zip(got, exp):
        assert torch.equal(g, e)


COEFFS = [0.8, 0.5, 1.1]


def _splat(h, w):
    return ([-3.5, 2.25, 1.0], (w * 0.4, h * 0.6), 400.0)


def _cases(plan_name):
    kw = PLANS[plan_name]
    return kw, _iters(kw.get("depth", K))


@pytest.mark.parametrize("plan_name", PLANS)
@pytest.mark.parametrize("shape", SMALL_SHAPES, ids=[f"{h}x{w}" for h, w in SMALL_SHAPES])
def test_diffuse_schedule_is_bit_equal(rng, shape, plan_name):
    h, w = shape
    kw, iters_list = _cases(plan_name)
    f, _, _ = _fields(rng, h, w)
    for iters in iters_list:
        plan = jacobi_cuda.plan_bursts(h, w, iters, "diffuse", **kw)
        if iters > 0:
            assert torch.equal(emulate_diffuse(f, COEFFS, plan),
                               ref.diffuse_multi(f, DT, COEFFS, iters))
        assert torch.equal(emulate_diffuse(f, COEFFS, plan, _splat(h, w)),
                           ref.diffuse_multi_splat(f, DT, COEFFS, iters, *_splat(h, w)))


@pytest.mark.parametrize("half", [True, False], ids=["half", "full"])
@pytest.mark.parametrize("plan_name", PLANS)
@pytest.mark.parametrize("shape", SMALL_SHAPES, ids=[f"{h}x{w}" for h, w in SMALL_SHAPES])
def test_pressure_project_schedule_is_bit_equal(rng, shape, plan_name, half):
    h, w = shape
    kw, iters_list = _cases(plan_name)
    _, u, v = _fields(rng, h, w)
    for iters in iters_list:
        plan = jacobi_cuda.plan_bursts(h, w, iters, "project", **kw)
        _equal(emulate_project(u, v, half, plan),
               ref.pressure_project(u, v, iters, half, return_stats=True))


@pytest.mark.parametrize("plan_name", PLANS)
@pytest.mark.parametrize("shape", SMALL_SHAPES, ids=[f"{h}x{w}" for h, w in SMALL_SHAPES])
def test_pressure_solve_schedule_is_bit_equal(rng, shape, plan_name):
    h, w = shape
    kw, iters_list = _cases(plan_name)
    _, u, v = _fields(rng, h, w)
    div = ref.divergence(u, v, True)
    for iters in iters_list:
        plan = jacobi_cuda.plan_bursts(h, w, iters, "solve", **kw)
        assert torch.equal(emulate_solve(div, plan), ref.pressure_solve(div, iters))


def test_schedule_without_the_halo_is_wrong(rng):
    # the control: the same cut-outs without their halo give other values,
    # so the tests above see the halo at work
    f, u, v = _fields(rng, 37, 53)
    plan = jacobi_cuda.plan_bursts(37, 53, 9, "diffuse", tile=(8, 16), depth=3)
    thin = jacobi_cuda.BurstPlan(plan.tile, plan.depths, (0,) * len(plan.depths), plan.smem)
    assert not torch.equal(emulate_diffuse(f, COEFFS, thin),
                           ref.diffuse_multi(f, DT, COEFFS, 9))


# -- against the JAX Pallas kernels (interpret mode) ------------------------------------


def _close(got, exp, rtol=1e-5):
    got, exp = got.numpy(), np.asarray(exp)
    assert got.shape == exp.shape
    np.testing.assert_allclose(got, exp, rtol=0,
                               atol=rtol * max(float(np.max(np.abs(exp))), 1.0))


@pytest.mark.parametrize("plan_name", PLANS)
def test_schedule_vs_pallas(rng, plan_name):
    h, w = 64, 128
    kw = PLANS[plan_name]
    f = torch.from_numpy(rng.standard_normal((5, h, w)).astype(np.float32))
    coeffs = [0.8] * 5
    amps = np.asarray([-3.5, 2.25, 1.0, 0.5, 0.3], np.float32)
    last = np.asarray([70.5, 30.25], np.float32)
    got = emulate_diffuse(f, coeffs, jacobi_cuda.plan_bursts(h, w, 20, "diffuse", **kw),
                          (amps, last, 400.0))
    exp = jacobi_pallas.diffuse_multi_splat(
        jnp.asarray(f.numpy()), DT, jnp.asarray(coeffs, jnp.float32), 20,
        jnp.asarray(amps), jnp.asarray(last), 400.0)
    _close(got, exp)
    u, v = (torch.from_numpy((rng.standard_normal((h, w)) * 10).astype(np.float32))
            for _ in range(2))
    got = emulate_project(u, v, True, jacobi_cuda.plan_bursts(h, w, 40, "project", **kw))
    exp = jacobi_pallas.pressure_project(jnp.asarray(u.numpy()), jnp.asarray(v.numpy()),
                                         40, True, return_stats=True)
    for g, e in zip(got, exp):
        _close(g, e)
