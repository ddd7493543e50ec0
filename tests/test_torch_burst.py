"""H4's solve planner and tiled trapezoid schedule, and the row-streaming
wavefront of H3 and of H4's projection, on the CPU.

H4's standalone solve (``csrc/pressure.cu`` ``fluid_pressure_solve``) runs
its sweeps in bursts: a block cuts its tile plus a halo as deep as the
burst out of the field, sweeps the cut-out with clamped taps, and writes
back the tile (``csrc/burst.cuh``).  H3 (``csrc/diffuse.cu``) and H4's
projection (``fluid_pressure_project``) run passes of up to
``DIFFUSE_DEPTH`` / ``PRESSURE_DEPTH`` sweeps as a row-streaming wavefront:
a warp holds a strip of columns, streams a chunk of rows from ``reach``
rows above it to ``reach`` rows below it, and keeps the strip's middle
columns and the chunk's rows; H4's first pass computes the divergence as
the rows stream in and its last pass the gradient subtraction, one row and
one column further in.  The CUDA kernels run only on the card
(``chip_smoke.py`` holds them there bit for bit against the plain ops);
here ``emulate``, ``emulate_wave`` and ``emulate_pressure`` run the same
schedules in plain torch on the planners' geometry, and they must be
bit-equal to the plain ops (``ops/ref.py``), since each cell kept is
computed by the same float32 operations in the same order as a global
sweep computes it.  The clamp at a cut-out's inner edges is wrong (the
wavefront's region takes NaN there, as the kernel takes a neighbour's stale
column or a row it never loaded), but it travels one cell a sweep and never
reaches the cells kept: that is what the halo buys.  One case holds the
emulations against the JAX Pallas kernels in interpret mode, at the
tolerances of ``tests/test_torch_kernels_vs_pallas.py`` (1e-5 of scale: 20
or 40 sweeps carry last-ulp differences along).
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
# the default plan, and a small one so that the small grids hold many
# tiles, ragged on both axes, and many bursts
PLANS = {"default": {}, "small": {"tile": (8, 16), "depth": 3}}
# H3's: the default, and strips of 8 lanes of one cell, passes of 3 sweeps
# and chunks of 7 rows, so the small grids hold many strips and chunks,
# ragged on both axes, and many passes
WAVE_PLANS = {"default": {}, "small": {"cells": 1, "lanes": 8, "depth": 3, "chunk": 7}}
D = jacobi_cuda.DIFFUSE_DEPTH
# H3's emulated grids: SHAPES' small ones, a 512² whose strips and chunks
# are ragged, and a rows shard of 40 padded by 8 rows a side (as
# parallel/ pads it for 8 sweeps)
WAVE_SHAPES = SMALL_SHAPES + ((512, 512), (40 + 16, 96))


def _iters(depth):
    return sorted({0, 1, 2, depth - 1, depth, depth + 1, 2 * depth + 1, 20, 40})


def _tiles(plan, h, w):
    th, tw = plan.tile
    for ty0 in range(0, h, th):
        for tx0 in range(0, w, tw):
            yield ty0, min(ty0 + th, h), tx0, min(tx0 + tw, w)


# -- the solve's planner --------------------------------------------------------------


# H4's projection plans its wavefront passes apart (plan_pressure, below)
@pytest.mark.parametrize("kind", ["solve"])
@pytest.mark.parametrize("shape", SHAPES, ids=[f"{h}x{w}" for h, w in SHAPES])
def test_plan_bursts(shape, kind):
    h, w = shape
    for iters in _iters(K):
        plan = jacobi_cuda.plan_bursts(h, w, iters, kind)
        assert plan.iters == iters
        one_tile = h <= plan.tile[0] and w <= plan.tile[1]
        if iters == 0:
            assert plan.depths == ()
        elif one_tile:
            assert plan.depths == (iters,)  # every sweep in one launch
        else:
            assert len(plan.depths) == math.ceil(iters / K) and max(plan.depths) <= K
            assert max(plan.depths) - min(plan.depths) <= 1  # as even as they come
        assert plan.halos == plan.depths
        assert all(b <= jacobi_cuda.SMEM_LIMIT <= 227 * 1024 for b in plan.smem)
        assert plan.smem == tuple(jacobi_cuda.burst_smem(kind, h, w, plan.tile, a)
                                  for a in plan.halos)


@pytest.mark.parametrize("shape", SHAPES, ids=[f"{h}x{w}" for h, w in SHAPES])
def test_tiles_cover_the_grid(shape):
    h, w = shape
    plan = jacobi_cuda.plan_bursts(h, w, 40, "solve")
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
    assert jacobi_cuda.burst_smem("smooth_res", 2048, 2048, (48, 112), 9) == 3 * 66 * 136 * 4
    assert jacobi_cuda.burst_smem("solve", 16, 16, (48, 112), 40) == 3 * 16 * 48 * 4


def test_depth_lowered_until_it_fits():
    plan = jacobi_cuda.plan_bursts(4096, 4096, 40, "solve", tile=(64, 256), depth=16)
    assert max(plan.smem) <= jacobi_cuda.SMEM_LIMIT
    assert max(plan.depths) < 16 and plan.iters == 40
    with pytest.raises(ValueError):
        jacobi_cuda.plan_bursts(4096, 4096, 40, "solve", tile=(512, 512))


# "project" is no kind of burst since H4's projection is a wavefront
@pytest.mark.parametrize("args", [(0, 8, 1, "solve"), (8, 8, -1, "solve"),
                                  (8, 8, 4, "sweep"), (8, 8, 4, "project")])
def test_plan_rejects_bad_arguments(args):
    with pytest.raises(ValueError):
        jacobi_cuda.plan_bursts(*args)


def test_launchers_reject_a_plan_for_other_iters():
    f = torch.zeros((2, 8, 8))
    plan = jacobi_cuda.plan_diffuse(8, 8, 4, 2)
    with pytest.raises(ValueError, match="sweeps"):
        jacobi_cuda._diffuse(f, DT, [0.8, 0.8], 5, plan=plan)
    with pytest.raises(ValueError, match="sweeps"):
        jacobi_cuda._pressure_project(f[0], f[1], 5, True,
                                      plan=jacobi_cuda.plan_pressure(8, 8, 4))


# -- the schedule, emulated in plain torch ------------------------------------------


def emulate(x, plan, sweep):
    """Run ``plan``'s bursts on the (..., H, W) field ``x``: for each tile,
    cut out tile +- halo (clipped to the grid), run the burst's sweeps on
    the cut-out (``sweep(cut, (y0, y1, x0, x1))``, clamped at its edges),
    and write the tile back."""
    h, w = x.shape[-2:]
    for depth, halo in zip(plan.depths, plan.halos):
        out = torch.empty_like(x)
        for ty0, ty1, tx0, tx1 in _tiles(plan, h, w):
            box = (max(ty0 - halo, 0), min(ty1 + halo, h), max(tx0 - halo, 0), min(tx1 + halo, w))
            cut = x[..., box[0]:box[1], box[2]:box[3]]
            for _ in range(depth):
                cut = sweep(cut, box)
            inner = (slice(ty0 - box[0], ty1 - box[0]), slice(tx0 - box[2], tx1 - box[2]))
            out[..., ty0:ty1, tx0:tx1] = cut[(Ellipsis,) + inner]
        x = out
    return x


def _pressure_sweep(div):
    def sweep(cut, box):
        l, r, b, t = ref.neighbors(cut)
        return (l + r + b + t - div[box[0]:box[1], box[2]:box[3]]) * 0.25
    return sweep


def emulate_solve(div, plan):
    return emulate(torch.zeros_like(div), plan, _pressure_sweep(div))


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
def test_pressure_solve_schedule_is_bit_equal(rng, shape, plan_name):
    h, w = shape
    kw, iters_list = _cases(plan_name)
    _, u, v = _fields(rng, h, w)
    div = ref.divergence(u, v, True)
    for iters in iters_list:
        plan = jacobi_cuda.plan_bursts(h, w, iters, "solve", **kw)
        assert torch.equal(emulate_solve(div, plan), ref.pressure_solve(div, iters))


# -- H3's wavefront: the planner ------------------------------------------------------


def _wave_iters(depth):
    return sorted({0, 1, depth - 1, depth, depth + 1, 2 * depth + 1, 20, 40} - {-1})


def _kept(plan, w, d, n):
    return jacobi_cuda.strip_spans(w, plan.width, plan.cells, d, n)


@pytest.mark.parametrize("shape", SHAPES, ids=[f"{h}x{w}" for h, w in SHAPES])
def test_plan_diffuse(shape):
    h, w = shape
    for planes in (1, 5, 320):
        for iters in _wave_iters(D):
            plan = jacobi_cuda.plan_diffuse(h, w, iters, planes)
            assert plan.iters == iters and plan.lanes == jacobi_cuda.LANES
            if iters == 0:
                # one pass, the splat alone
                assert plan.depths == (0,) and plan.strips == plan.chunks == (1,)
                continue
            npass = math.ceil(iters / D)
            assert len(plan.depths) == npass and max(plan.depths) <= D
            assert max(plan.depths) - min(plan.depths) <= 1  # as even as they come
            assert plan.cells in jacobi_cuda.DIFFUSE_CELLS
            for d, n, m in zip(plan.depths, plan.strips, plan.chunks):
                assert _kept(plan, w, d, n) is not None
                # the fewest strips that keep every column
                assert n == 1 or _kept(plan, w, d, n - 1) is None or n - 1 < -(-w // plan.width)
                assert 1 <= m <= h


def test_plan_diffuse_at_2048_takes_two_passes():
    for planes in (2, 5, 11):
        plan = jacobi_cuda.plan_diffuse(2048, 2048, 20, planes)
        assert plan.depths == (D, D) and plan.cells == 4
    # the strips' stale columns (20 strips of 128 for 2048: 1.25x) and the
    # chunks' lead-in rows (10 chunks: 1.09x) together: 1.37x the cells
    # kept, computed at about half the trapezoid's instructions a cell
    plan = jacobi_cuda.plan_diffuse(2048, 2048, 20, 5)
    assert plan.strips == (20, 20) and plan.chunks == (10, 10)
    for d, n, m in zip(plan.depths, plan.strips, plan.chunks):
        cols = n * plan.width / 2048
        rows = sum(y1 + d - max(y0 - d, 0) for y0, y1 in jacobi_cuda.chunk_rows(2048, m)) / 2048
        assert cols * rows <= 1.37, (cols, rows)
        # a block or two on every SM of the card
        assert jacobi_cuda.SMS * jacobi_cuda.DIFFUSE_WARPS < 5 * n * m <= (
            jacobi_cuda.SMS * jacobi_cuda.DIFFUSE_WARPS * jacobi_cuda.DIFFUSE_BLOCKS_PER_SM)


@pytest.mark.parametrize("cells", [8, 4, 1])
@pytest.mark.parametrize("d", [1, 3, 8, 10])
def test_every_column_is_kept_by_one_strip(cells, d):
    width = jacobi_cuda.LANES * cells
    a = 4 if cells >= 4 else 1
    for w in list(range(1, 3 * width, 1 if cells == 1 else 3)) + [960, 2048, 2047, 8192]:
        if cells >= 4 and w % 4:
            assert jacobi_cuda.strip_spans(w, width, cells, d, 1) is None
            continue
        n = jacobi_cuda._fewest_strips(w, width, cells, d)
        if n is None:
            # only a grid narrower than a strip that no lane ends on
            assert cells > 1 and w < width + 2 * d + 4
            continue
        spans = jacobi_cuda.strip_spans(w, width, cells, d, n)
        seen = np.zeros(w, np.int32)
        for j, (f, e0, e1) in enumerate(spans):
            seen[e0:e1] += 1
            assert e0 % a == 0 and f % a == 0 and 0 <= f <= e0 and e1 <= f + width
            # d stale columns on each side that is not the grid's edge
            assert f == 0 or f <= e0 - d
            assert f + width >= w or e1 + d <= f + width
            # the grid's edge columns are a lane's first and last cell
            if f + width >= w:
                assert (w - f) % cells == 0
            assert f + width <= w or n == 1
        assert (seen == 1).all(), (w, n)


def test_cells_follow_the_rows_alignment():
    assert jacobi_cuda.plan_diffuse(512, 512, 20, 5, aligned=False).cells == 1
    assert jacobi_cuda.plan_diffuse(512, 510, 20, 5).cells == 1
    assert jacobi_cuda.plan_diffuse(512, 512, 20, 320).cells == 4
    assert jacobi_cuda.plan_diffuse(64, 8, 20, 5).cells == 1  # one strip: 1 issues least
    assert jacobi_cuda.plan_diffuse(64, 8, 20, 5, cells=4).cells == 4


def test_budgets():
    # csrc/diffuse.cu: a block of DIFFUSE_WARPS warps holds its rings of
    # input rows in static shared memory (at most 48 KB, and two blocks an
    # SM fit its 227 KB), and a lane's DIFFUSE_DEPTH stages hold two rows of
    # its cells each in registers, under the cap __launch_bounds__ gives
    # (DIFFUSE_BLOCKS_PER_SM blocks an SM of 65536 registers, 8 at a time,
    # at most 255) with room for the rest
    warps, blocks = jacobi_cuda.DIFFUSE_WARPS, jacobi_cuda.DIFFUSE_BLOCKS_PER_SM
    cap = min(255, 65536 // (jacobi_cuda.LANES * warps * blocks) // 8 * 8)
    assert cap == 255
    for cells in jacobi_cuda.DIFFUSE_CELLS:
        smem = 4 * warps * jacobi_cuda.DIFFUSE_RING * jacobi_cuda.LANES * cells
        assert smem <= 48 * 1024 and blocks * smem <= 227 * 1024
        assert 2 * D * cells + 96 <= cap


@pytest.mark.parametrize("args,kw", [
    ((0, 8, 1), {}), ((8, 0, 1), {}), ((8, 8, -1), {}), ((8, 8, 1, 0), {}),
    ((8, 8, 4), {"depth": D + 1}), ((8, 8, 4), {"depth": 0}), ((8, 8, 4), {"cells": 2}),
    ((8, 8, 4), {"chunk": 0}), ((8, 510, 4), {"cells": 4})])
def test_plan_diffuse_rejects_bad_arguments(args, kw):
    with pytest.raises(ValueError):
        jacobi_cuda.plan_diffuse(*args, **kw)


def test_launcher_rejects_a_plan_for_other_lanes():
    f = torch.zeros((2, 8, 8))
    with pytest.raises(ValueError, match="lanes"):
        jacobi_cuda._plan_for(f, 8, 8, 4, 2, jacobi_cuda.plan_diffuse(8, 8, 4, 2, lanes=8))


# -- H3's wavefront, emulated in plain torch ---------------------------------------------


class Regions:
    """The (strip, chunk) regions of one pass that reaches ``reach`` columns
    and rows in: the strips' spans (``strip_spans``), the chunks' rows, and
    each region's rows ``gy`` (m, R), columns ``gx`` (n, S) and the cells
    the kernel loads there, ``valid`` (m, R, n, S): the strip's columns by
    the chunk's rows from ``reach`` rows above it (or the grid's first) to
    ``reach`` rows below it, inside the grid.  ``x_halo`` / ``lead_in``
    False: the control, strips that start on the columns they keep / chunks
    that load from their first row."""

    def __init__(self, plan, h, w, reach, n, m, x_halo=True, lead_in=True):
        self.h, self.w = h, w
        spans = jacobi_cuda.strip_spans(w, plan.width, plan.cells, reach, n)
        if not x_halo:
            spans = [(e0 if 0 < j < n - 1 else f, e0, e1) for j, (f, e0, e1) in enumerate(spans)]
        chunks = jacobi_cuda.chunk_rows(h, m)
        self.first = torch.tensor([f for f, _, _ in spans])
        self.s0 = torch.tensor([max(y0 - reach, 0) if lead_in else y0 for y0, _ in chunks])
        self.steps = steps = torch.tensor([y1 + reach for _, y1 in chunks]) - self.s0
        rows = int(steps.max())
        self.gy = self.s0[:, None] + torch.arange(rows)
        self.gx = self.first[:, None] + torch.arange(plan.width)
        self.valid = (((self.gy < h) & (torch.arange(rows) < steps[:, None]))[:, :, None, None]
                      & (self.gx < w))
        self.gy5, self.gx5 = self.gy[None, :, :, None, None], self.gx[None, None, None]
        # each cell's region: the strip and chunk that keep it
        self.ky = torch.tensor([k for k, (y0, y1) in enumerate(chunks) for _ in range(y0, y1)])
        self.jx = torch.tensor([j for j, (_, e0, e1) in enumerate(spans) for _ in range(e0, e1)])

    def load(self, x, valid=None):
        """The (C, H, W) field ``x`` over the regions, (C, m, R, n, S): NaN
        where the kernel does not load it (``valid``, default the pass's)."""
        region = x[:, self.gy.clamp(max=self.h - 1)][..., self.gx.clamp(max=self.w - 1)]
        return torch.where(self.valid if valid is None else valid, region,
                           torch.tensor(float("nan")))

    def taps(self, region):
        """(left, right, bottom, top) of each region cell: clamped at the
        grid's edges, NaN past the region's."""
        nan_x = region.new_full(region.shape[:-1] + (1,), float("nan"))
        nan_y = region.new_full(region.shape[:2] + (1,) + region.shape[3:], float("nan"))
        w, h = self.w, self.h
        return (torch.where(self.gx5 == 0, region, torch.cat([nan_x, region[..., :-1]], -1)),
                torch.where(self.gx5 == w - 1, region, torch.cat([region[..., 1:], nan_x], -1)),
                torch.where(self.gy5 == 0, region, torch.cat([nan_y, region[:, :, :-1]], 2)),
                torch.where(self.gy5 == h - 1, region, torch.cat([region[:, :, 1:], nan_y], 2)))

    def kept(self, region):
        """The (C, H, W) field of the cells each region keeps."""
        ry = torch.arange(self.h) - self.s0[self.ky]
        rx = torch.arange(self.w) - self.first[self.jx]
        return region[:, self.ky[:, None], ry[:, None], self.jx[None, :], rx[None, :]]

    def behind(self, rows):
        """``valid`` of a stream the kernel reads ``rows`` rows behind the
        input row: the regions' last ``rows`` rows are never loaded."""
        last = torch.arange(self.gy.shape[1]) < self.steps[:, None] - rows
        return self.valid & last[:, :, None, None]


def emulate_wave(x, plan, sweep_consts, x_halo=True, lead_in=True):
    """Run ``plan``'s passes on the (C, H, W) field ``x``: on each (strip,
    chunk) region (:class:`Regions`), ``d`` sweeps with taps clamped at the
    grid's edges and NaN past the region's; then the cells each region
    keeps.  ``sweep_consts`` = (alpha, inv_beta) per channel."""
    h, w = x.shape[-2:]
    alpha, inv_beta = (torch.as_tensor(a)[:, None, None, None, None] for a in sweep_consts)
    for d, n, m in zip(plan.depths, plan.strips, plan.chunks):
        if d == 0:
            continue
        reg = Regions(plan, h, w, d, n, m, x_halo, lead_in)
        region = reg.load(x)
        for _ in range(d):
            l, r, b, t = reg.taps(region)
            region = (l + r + b + t + region * alpha) * inv_beta
        x = reg.kept(region)
    return x


def emulate_diffuse(f, coeffs, plan, splat=None, **control):
    alpha, inv_beta = ref.diffusion_alphas(DT, coeffs)
    out = emulate_wave(f, plan, (alpha, inv_beta), **control)
    return out if splat is None else ref.splat_tail(out, *splat)


@pytest.mark.parametrize("plan_name", WAVE_PLANS)
@pytest.mark.parametrize("shape", WAVE_SHAPES, ids=[f"{h}x{w}" for h, w in WAVE_SHAPES])
def test_diffuse_schedule_is_bit_equal(rng, shape, plan_name):
    h, w = shape
    kw = WAVE_PLANS[plan_name]
    f, _, _ = _fields(rng, h, w)
    for iters in _wave_iters(kw.get("depth", D)):
        plan = jacobi_cuda.plan_diffuse(h, w, iters, 3, **kw)
        got = emulate_diffuse(f, COEFFS, plan)
        if iters > 0:
            assert torch.equal(got, ref.diffuse_multi(f, DT, COEFFS, iters))
        assert torch.equal(ref.splat_tail(got, *_splat(h, w)),
                           ref.diffuse_multi_splat(f, DT, COEFFS, iters, *_splat(h, w)))


@pytest.mark.parametrize("control", ["x_halo", "lead_in"])
def test_schedule_without_the_halo_is_wrong(rng, control):
    # the control: the same strips without their stale columns, or the
    # same chunks without their lead-in rows, give other values, so the
    # tests above see the halo at work
    f, _, _ = _fields(rng, 37, 53)
    plan = jacobi_cuda.plan_diffuse(37, 53, 9, 3, **WAVE_PLANS["small"])
    assert len(plan.depths) == 3 and min(plan.strips) > 2 and min(plan.chunks) > 2
    assert torch.equal(emulate_diffuse(f, COEFFS, plan), ref.diffuse_multi(f, DT, COEFFS, 9))
    assert not torch.equal(emulate_diffuse(f, COEFFS, plan, **{control: False}),
                           ref.diffuse_multi(f, DT, COEFFS, 9))


# -- H4's wavefront: the planner ------------------------------------------------------

# H4's small plan: strips of 16 lanes of one cell (a 3-sweep last pass
# reaches 4 columns in from each side), passes of 3 and chunks of 7 rows
PRESSURE_PLANS = {"default": {}, "small": {"cells": 1, "lanes": 16, "depth": 3, "chunk": 7}}
PD = jacobi_cuda.PRESSURE_DEPTH
# the emulated grids: SHAPES (960 x 540 among them) and a 512² whose strips
# and chunks are ragged
PRESSURE_SHAPES = SHAPES + ((512, 512),)


def _pressure_kept(plan, w, j):
    reach = jacobi_cuda.pressure_reaches(plan.depths)[j]
    return jacobi_cuda.strip_spans(w, plan.width, plan.cells, reach, plan.strips[j])


@pytest.mark.parametrize("shape", SHAPES, ids=[f"{h}x{w}" for h, w in SHAPES])
def test_plan_pressure(shape):
    h, w = shape
    for planes in (1, 64):
        for iters in _wave_iters(PD):
            plan = jacobi_cuda.plan_pressure(h, w, iters, planes)
            assert plan.iters == iters and plan.lanes == jacobi_cuda.LANES
            if iters == 0:
                # one pass: p = 0 and the projection
                assert plan.depths == (0,)
            else:
                assert len(plan.depths) == math.ceil(iters / PD) and max(plan.depths) <= PD
                assert max(plan.depths) - min(plan.depths) <= 1  # as even as they come
            assert plan.cells in jacobi_cuda.DIFFUSE_CELLS
            reaches = jacobi_cuda.pressure_reaches(plan.depths)
            assert reaches == plan.depths[:-1] + (plan.depths[-1] + 1,)
            for j, (a, n, m) in enumerate(zip(reaches, plan.strips, plan.chunks)):
                assert _pressure_kept(plan, w, j) is not None
                # the fewest strips that keep every column at the pass's reach
                assert n == 1 or n - 1 < -(-w // plan.width) or jacobi_cuda.strip_spans(
                    w, plan.width, plan.cells, a, n - 1) is None
                assert 1 <= m <= h


def test_plan_pressure_at_2048_takes_four_passes():
    for planes in (1, 64):
        plan = jacobi_cuda.plan_pressure(2048, 2048, 40, planes)
        assert plan.depths == (PD,) * 4 and plan.cells == 4
        assert jacobi_cuda.pressure_reaches(plan.depths) == (PD,) * 3 + (PD + 1,)
        for j in range(4):
            seen = np.zeros(2048, np.int32)
            for _, e0, e1 in _pressure_kept(plan, 2048, j):
                seen[e0:e1] += 1
            assert (seen == 1).all()  # every column kept by one strip
    # one wave of blocks on the card for a single grid
    plan = jacobi_cuda.plan_pressure(2048, 2048, 40)
    assert plan.strips == (20,) * 4
    for n, m in zip(plan.strips, plan.chunks):
        assert -(-n * m // jacobi_cuda.PRESSURE_WARPS) <= (
            jacobi_cuda.SMS * jacobi_cuda.PRESSURE_BLOCKS_PER_SM)


def test_plan_pressure_cells_follow_the_alignment():
    assert jacobi_cuda.plan_pressure(512, 512, 40, 64, aligned=False).cells == 1
    assert jacobi_cuda.plan_pressure(540, 958, 40).cells == 1  # a width no 16-byte row takes
    assert jacobi_cuda.plan_pressure(540, 960, 40).cells == 4


def test_pressure_budgets():
    # csrc/pressure.cu: a block of PRESSURE_WARPS warps holds each warp's
    # rings in static shared memory, up to 4 of DIFFUSE_RING input rows and
    # div's of PRESSURE_DIV_RING rows (at most 48 KB, and the blocks an SM
    # fit its 227 KB); div's ring holds a row from its copy, started
    # WAVE_AHEAD (DIFFUSE_RING - 2) steps ahead, until the last stage reads
    # it; a lane keeps two rows of each stage's sweep and two of the last
    # sweep in registers, under the 255 a thread that 8 warps an SM (as
    # H3's) allow, with room for the rest
    warps, blocks = jacobi_cuda.PRESSURE_WARPS, jacobi_cuda.PRESSURE_BLOCKS_PER_SM
    assert warps * blocks == jacobi_cuda.DIFFUSE_WARPS * jacobi_cuda.DIFFUSE_BLOCKS_PER_SM
    assert min(255, 65536 // (jacobi_cuda.LANES * warps * blocks) // 8 * 8) == 255
    assert jacobi_cuda.PRESSURE_DIV_RING == PD + jacobi_cuda.DIFFUSE_RING - 2
    for cells in jacobi_cuda.DIFFUSE_CELLS:
        slots = 4 * jacobi_cuda.DIFFUSE_RING + jacobi_cuda.PRESSURE_DIV_RING
        smem = 4 * warps * slots * jacobi_cuda.LANES * cells
        assert smem <= 48 * 1024 and blocks * smem <= 227 * 1024
        assert 2 * PD * cells + 2 * cells + 96 <= 255


@pytest.mark.parametrize("args,kw", [
    ((0, 8, 1), {}), ((8, 0, 1), {}), ((8, 8, -1), {}), ((8, 8, 1, 0), {}),
    ((8, 8, 4), {"depth": PD + 1}), ((8, 8, 4), {"depth": 0}), ((8, 8, 4), {"cells": 2}),
    ((8, 8, 4), {"chunk": 0}), ((8, 510, 4), {"cells": 4}),
    # a last pass of 3 sweeps reaches 4 columns in: 8-column strips keep none
    ((8, 64, 3), {"cells": 1, "lanes": 8})])
def test_plan_pressure_rejects_bad_arguments(args, kw):
    with pytest.raises(ValueError):
        jacobi_cuda.plan_pressure(*args, **kw)


# -- H4's wavefront, emulated in plain torch ---------------------------------------------


def emulate_pressure(u, v, half, plan, x_halo=True, lead_in=True):
    """Run ``plan``'s passes of H4's projection on (H, W) ``u``, ``v``, as
    :func:`emulate_wave` runs H3's: the first pass computes div from u and v
    loaded over its regions and sweeps from p = 0 (its first sweep
    (0 - div) / 4); a later pass loads p and div (div one row behind, so a
    region's last row of div is never loaded); div of a region's last row
    is never computed either; the last pass, reaching one further, takes the
    gradient of its last sweep and u and v (read ``reach`` rows behind),
    and keeps p, u' and v'.  Returns (u', v', p, vel_stats)."""
    h, w = u.shape
    uv = torch.stack([u, v])
    reaches = jacobi_cuda.pressure_reaches(plan.depths)
    p = div = None
    for j, (d, a, n, m) in enumerate(zip(plan.depths, reaches, plan.strips, plan.chunks)):
        reg = Regions(plan, h, w, a, n, m, x_halo, lead_in)
        if j == 0:
            ru, rv = reg.load(uv)
            ul, ur, _, _ = reg.taps(ru[None])
            _, _, vb, vt = reg.taps(rv[None])
            dreg = (ur - ul) + (vt - vb)
            dreg = 0.5 * dreg if half else dreg
            dreg = torch.where(reg.behind(1), dreg, torch.tensor(float("nan")))
            preg = torch.zeros_like(dreg) if d == 0 else (0.0 - dreg) * 0.25
            sweeps = d - 1
            if j < len(plan.depths) - 1:
                div = reg.kept(dreg)
        else:
            preg, dreg = reg.load(p[None]), reg.load(div, reg.behind(1))
            sweeps = d
        for _ in range(max(sweeps, 0)):
            l, r, b, t = reg.taps(preg)
            preg = (l + r + b + t - dreg) * 0.25
        p = reg.kept(preg)[0]
    pl, pr, pb, pt = reg.taps(preg)
    ru, rv = reg.load(uv, reg.behind(a))
    u2 = reg.kept(ru[None] - 0.5 * (pr - pl))[0]
    v2 = reg.kept(rv[None] - 0.5 * (pt - pb))[0]
    return u2, v2, p, ref.vel_max(u2, v2)


@pytest.mark.parametrize("half", [True, False], ids=["half", "full"])
@pytest.mark.parametrize("plan_name,shape", [
    (name, s) for name in PRESSURE_PLANS
    for s in (PRESSURE_SHAPES if name == "default" else SMALL_SHAPES + ((512, 512),))],
    ids=lambda x: x if isinstance(x, str) else f"{x[0]}x{x[1]}")
def test_pressure_schedule_is_bit_equal(rng, plan_name, shape, half):
    h, w = shape
    kw = PRESSURE_PLANS[plan_name]
    _, u, v = _fields(rng, h, w)
    depth = kw.get("depth", PD)
    for iters in _wave_iters(depth):
        plan = jacobi_cuda.plan_pressure(h, w, iters, **kw)
        _equal(emulate_pressure(u, v, half, plan),
               ref.pressure_project(u, v, iters, half, return_stats=True))


@pytest.mark.parametrize("control", ["x_halo", "lead_in"])
def test_pressure_schedule_without_the_halo_is_wrong(rng, control):
    # the control: the same strips without their stale columns, or the
    # same chunks without their lead-in rows, give other values, so the
    # tests above see the halo at work
    _, u, v = _fields(rng, 37, 53)
    plan = jacobi_cuda.plan_pressure(37, 53, 9, **PRESSURE_PLANS["small"])
    assert len(plan.depths) == 3 and min(plan.strips) > 2 and min(plan.chunks) > 2
    exp = ref.pressure_project(u, v, 9, True, return_stats=True)
    _equal(emulate_pressure(u, v, True, plan), exp)
    got = emulate_pressure(u, v, True, plan, **{control: False})
    assert not all(torch.equal(g, e) for g, e in zip(got, exp))


# -- against the JAX Pallas kernels (interpret mode) ------------------------------------


def _close(got, exp, rtol=1e-5):
    got, exp = got.numpy(), np.asarray(exp)
    assert got.shape == exp.shape
    np.testing.assert_allclose(got, exp, rtol=0,
                               atol=rtol * max(float(np.max(np.abs(exp))), 1.0))


@pytest.mark.parametrize("plan_name", PLANS)
def test_schedule_vs_pallas(rng, plan_name):
    h, w = 64, 128
    f = torch.from_numpy(rng.standard_normal((5, h, w)).astype(np.float32))
    coeffs = [0.8] * 5
    amps = np.asarray([-3.5, 2.25, 1.0, 0.5, 0.3], np.float32)
    last = np.asarray([70.5, 30.25], np.float32)
    got = emulate_diffuse(f, coeffs, jacobi_cuda.plan_diffuse(h, w, 20, 5, **WAVE_PLANS[plan_name]),
                          (amps, last, 400.0))
    exp = jacobi_pallas.diffuse_multi_splat(
        jnp.asarray(f.numpy()), DT, jnp.asarray(coeffs, jnp.float32), 20,
        jnp.asarray(amps), jnp.asarray(last), 400.0)
    _close(got, exp)
    u, v = (torch.from_numpy((rng.standard_normal((h, w)) * 10).astype(np.float32))
            for _ in range(2))
    got = emulate_pressure(u, v, True, jacobi_cuda.plan_pressure(h, w, 40, **PRESSURE_PLANS[plan_name]))
    exp = jacobi_pallas.pressure_project(jnp.asarray(u.numpy()), jnp.asarray(v.numpy()),
                                         40, True, return_stats=True)
    for g, e in zip(got, exp):
        _close(g, e)
