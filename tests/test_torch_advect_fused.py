"""H1's velocity and dye advection in one launch (``advect_both``), and the
row schedule of the redesigned H1/H8 kernels, on the CPU.

- ``advect_cuda.advect_both`` (and its batched form), which the ``cuda``
  namespace gives the step, runs its plain version on CPU tensors: it must
  equal ``advect_velocity`` followed by ``advect_dye`` bit for bit, into a
  fresh dye or into the step's pack, and the JAX package's Pallas
  ``advect_velocity`` plus ``advect_dye`` (interpret mode) within 1e-5 of
  scale, the tolerance of tests/test_torch_kernels_vs_pallas.py.
- ``csrc/advect.cu`` runs only on the card (``chip_smoke.py`` holds it
  there bit for bit against the two passes and the plain versions).  Here
  :func:`emulate` runs its schedule (``advect_cuda.CELLS``, ``ROWS``,
  ``TILES``) in plain torch: blocks of 32 x 8 threads that walk up to 4
  tiles of rows, a thread 4 consecutive cells of a row, one 16-byte access
  a plane where every plane's rows and member strides are aligned and the
  width is a multiple of 4, else a scalar access a cell; the dye
  backtraced through the u', v' the thread holds; each block's
  [max|u'|, max|v'|] into its own slot and the slots reduced.  Every cell
  must be written once, the result must equal the plain versions bit for
  bit, and the bound ``ref.vel_max``, NaN included.
- The step: a ``cuda``-namespace parity step and a batched step with
  ``advect_both`` equal the same steps through a namespace without it; the
  fast modes keep the two calls; nothing is launched on the CPU.
"""

import dataclasses
import math
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudafluidsimulation_tpu.ops import advect_pallas

from cudafluidsimulation_tpu_torch import FluidConfig, Simulation
from cudafluidsimulation_tpu_torch.models.ensemble import batched_impulse, batched_state, step_of
from cudafluidsimulation_tpu_torch.models.pipelines import make_batched_step, make_step
from cudafluidsimulation_tpu_torch.ops import advect_cuda, backend, ref
from cudafluidsimulation_tpu_torch.utils import impulse as timp
from cudafluidsimulation_tpu_torch.utils.instrument import StageSpans, timed_ops

torch.set_num_threads(1)

DT = np.float32(1 / 60)
RATE = 1.2
SHAPES = [(1, 1), (4, 8), (37, 53), (64, 48)]
FIELDS = ("u", "v", "dye", "pressure", "vel_stats")
KERNELS = (advect_cuda.KERNEL, advect_cuda.BATCHED, advect_cuda.VELOCITY_PASS,
           advect_cuda.DYE_PASS, advect_cuda.VELOCITY_PASS_BATCHED,
           advect_cuda.DYE_PASS_BATCHED, advect_cuda.PACKED, advect_cuda.PACKED_BATCHED)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _fields(rng, h, w, b=None, scale=120.0):
    lead = () if b is None else (b,)
    u = _t(rng.standard_normal(lead + (h, w)) * scale)
    v = _t(rng.standard_normal(lead + (h, w)) * scale)
    dye = _t(rng.uniform(0.0, 1.0, lead + (3, h, w)))
    return u, v, dye


def _equal(got, exp):
    assert len(got) == len(exp)
    for g, e in zip(got, exp):
        assert torch.equal(g, e)


@pytest.fixture
def launches():
    """Launch counts before the test; the CPU path must not move them."""
    before = [k.launches for k in KERNELS]
    yield
    assert [k.launches for k in KERNELS] == before


def _cuda_ns(**kw):
    cfg = FluidConfig.gpu_reference(nx=32, ny=32, backend="ref", **kw)
    return backend.kernel_ops(cfg), backend.kernel_ops(cfg, batched=True)


# -- (a) the plain path of advect_both ---------------------------------------------------


@pytest.mark.parametrize("into_pack", [False, True], ids=["fresh", "pack"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_advect_both_equals_the_two_passes(rng, launches, shape, into_pack):
    h, w = shape
    u, v, dye = _fields(rng, h, w)
    both = _cuda_ns()[0].advect_both
    u2, v2, st = advect_cuda.advect_velocity(u, v, DT, RATE, return_stats=True)
    dye2 = advect_cuda.advect_dye(dye, u2, v2, DT, RATE, vel_stats=st)
    pack = torch.full((5, h, w), float("nan"))
    got = both(u, v, dye, DT, RATE, vel_stats=torch.zeros(2), return_stats=True,
               out=pack[2:] if into_pack else None)
    _equal(got, (u2, v2, dye2, st))
    if into_pack:
        assert torch.equal(pack[2:], dye2) and bool(pack[:2].isnan().all())
    _equal(both(u, v, dye, DT, RATE), (u2, v2, dye2))


@pytest.mark.parametrize("into_pack", [False, True], ids=["fresh", "pack"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_advect_both_batched_equals_the_two_passes(rng, launches, shape, into_pack):
    h, w = shape
    b = 3
    u, v, dye = _fields(rng, h, w, b)
    dts = (DT * (1.0 + 0.25 * rng.random(b))).astype(np.float32)
    both = _cuda_ns()[1].advect_both
    u2, v2, st = advect_cuda.advect_velocity_batched(u, v, dts, RATE, return_stats=True)
    dye2 = advect_cuda.advect_dye_batched(dye, u2, v2, dts, RATE)
    pack = torch.full((b, 5, h, w), float("nan"))
    got = both(u, v, dye, dts, RATE, return_stats=True, out=pack[:, 2:] if into_pack else None)
    _equal(got, (u2, v2, dye2, st))
    if into_pack:
        assert torch.equal(pack[:, 2:], dye2) and bool(pack[:, :2].isnan().all())
    for i in range(b):  # each member is its single call
        _equal([x[i] for x in got], advect_cuda.advect_both(u[i], v[i], dye[i], dts[i], RATE,
                                                            return_stats=True))


def _close(got, exp, rtol=1e-5):
    exp = np.asarray(exp)
    scale = max(float(np.max(np.abs(exp))), 1.0)
    np.testing.assert_allclose(got.numpy(), exp, rtol=0, atol=rtol * scale)


@pytest.mark.parametrize("shape", SHAPES + [(64, 128)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_advect_both_vs_pallas(rng, launches, shape):
    # as tests/test_torch_kernels_vs_pallas.py runs H1's two passes: d = 31
    # keeps every Pallas tap of the velocity exact, d = 15 the dye's; the
    # Pallas dye pass takes the port's u', v', the same inputs as the port's
    # dye (through its own u', v' the last ulps of the velocity would move
    # the dye's taps)
    h, w = shape
    u, v, dye = _fields(rng, h, w, scale=60.0)
    gu, gv, gd, gst = advect_cuda.advect_both(u, v, dye, DT, RATE, return_stats=True)
    eu, ev, est = advect_pallas.advect_velocity(jnp.asarray(u.numpy()), jnp.asarray(v.numpy()),
                                                DT, RATE, d=31, return_stats=True)
    ed = advect_pallas.advect_dye(jnp.asarray(dye.numpy()), jnp.asarray(gu.numpy()),
                                  jnp.asarray(gv.numpy()), DT, RATE, d=15)
    for g, e in ((gu, eu), (gv, ev), (gd, ed)):
        _close(g, e)
    # the port's bound is the exact max; the Pallas kernel's an upper bound
    # (exact on its tiled shapes, above the max on small and ragged ones)
    assert torch.equal(gst, ref.vel_max(gu, gv))
    assert (np.asarray(est) >= gst.numpy() * (1 - 1e-5)).all()


def test_advect_both_checks_out(launches):
    u, v, dye = torch.zeros(8, 8), torch.zeros(8, 8), torch.zeros(3, 8, 8)
    with pytest.raises(ValueError, match="out: expected shape"):
        advect_cuda.advect_both(u, v, dye, DT, RATE, out=torch.zeros(2, 8, 8))
    with pytest.raises(ValueError, match="shares memory"):
        advect_cuda.advect_both(u, v, dye, DT, RATE, out=dye)
    meta = torch.empty((8, 8), device="meta")
    with pytest.raises(ValueError, match="several devices"):
        advect_cuda.advect_both(meta, v, dye, DT, RATE)


# -- (b) the kernels' schedule, emulated -------------------------------------------------


CELLS, ROWS, TILES = advect_cuda.CELLS, advect_cuda.ROWS, advect_cuda.TILES


def _vec(w, tensors, strides=()):
    """The kernel's choice of 16-byte row accesses (``fluid_advect_rows``):
    the width a multiple of the cells, every plane's start and every member
    stride a multiple of the cells' bytes."""
    return (w % CELLS == 0
            and all(t.data_ptr() % (4 * CELLS) == 0 for t in tensors)
            and all(s % CELLS == 0 for s in strides))


def _row_run(x0, cells, w, vec):
    """The columns one thread loads and stores from x0."""
    if vec:
        assert x0 + cells <= w  # one access, inside the row
        return list(range(x0, x0 + cells))
    return [x for x in range(x0, x0 + cells) if x < w]


def _sample(f, ys, xs, uc, vc, dt):
    """``ref.bilerp``'s arithmetic at the cells (ys, xs) backtraced through
    (uc, vc), for planes f (C, H, W): (C, n)."""
    h, w = f.shape[-2:]
    px = xs.to(torch.float32) - dt * uc
    py = ys.to(torch.float32) - dt * vc
    x1, y1 = torch.trunc(px), torch.trunc(py)
    tx, ty = px - x1, py - y1
    xi1, xi2 = x1.clamp(0, w - 1).long(), (x1 + 1).clamp(0, w - 1).long()
    yi1, yi2 = y1.clamp(0, h - 1).long(), (y1 + 1).clamp(0, h - 1).long()
    tap = lambda yi, xi: f[:, yi, xi]
    top = tap(yi1, xi1) * (1.0 - tx) + tap(yi1, xi2) * tx
    bot = tap(yi2, xi1) * (1.0 - tx) + tap(yi2, xi2) * tx
    return top * (1.0 - ty) + bot * ty


def _slot(a):
    """A block's max of |x| over its cells, a NaN kept (``block_bound``)."""
    return a.abs().max() if a.numel() else torch.zeros(())


def emulate(u, v, dye, dt, decay_rate, vec, cells=CELLS, rows=ROWS, tiles=TILES):
    """``advect_rows_kernel``'s both mode, block by block, for one member:
    returns u', v', the dye, the bound reduced from the blocks' slots, and
    how often each cell was written."""
    h, w = u.shape
    blocks_y = math.ceil(math.ceil(h / rows) / tiles)  # fluid_advect_rows' rows_grid
    dt, decay = float(ref.f32(dt)), ref.decay_factor(dt, decay_rate)
    u2, v2, blend = torch.empty_like(u), torch.empty_like(v), torch.empty_like(dye)
    written = torch.zeros((h, w), dtype=torch.int64)
    slots = []
    for by in range(blocks_y):
        for bx in range(math.ceil(w / (32 * cells))):
            ys, xs = [], []
            for ty in range(rows):
                for tx in range(32):
                    x0 = (bx * 32 + tx) * cells
                    # the block's tiles, blocks_y tiles apart
                    for y in range(by * rows + ty, h, blocks_y * rows):
                        if x0 < w:
                            for x in _row_run(x0, cells, w, vec):
                                ys.append(y)
                                xs.append(x)
            ys, xs = torch.tensor(ys, dtype=torch.int64), torch.tensor(xs, dtype=torch.int64)
            uc, vc = u[ys, xs], v[ys, xs]  # the thread's row loads
            uv = _sample(torch.stack([u, v]), ys, xs, uc, vc, dt) * decay
            u2[ys, xs], v2[ys, xs] = uv[0], uv[1]
            # the dye through the u', v' the thread holds
            blend[:, ys, xs] = _sample(dye, ys, xs, uv[0], uv[1], dt)
            written[ys, xs] += 1
            slots.append(torch.stack([_slot(uv[0]), _slot(uv[1])]))
    bound = torch.stack(slots).max(dim=0).values  # the last block's reduction
    # the fade, a cell's own operations, over the whole plane as the plain
    # version takes it: PyTorch's CPU pow rounds a vector's tail apart
    dye2 = torch.fmin(torch.pow(blend, 1.005) * decay, blend.new_ones(()))
    return u2, v2, dye2, bound, written


ROW_SHAPES = SHAPES + [(9, 130), (33, 128), (70, 36), (8, 256), (65, 4), (17, 3)]
# which planes lie one float off their 16-byte start
ALIGNMENTS = ("aligned", "u unaligned", "dye unaligned", "all unaligned")


def _placed(t, shift):
    """A copy of ``t`` whose data starts ``shift`` floats into a buffer."""
    buf = torch.empty(t.numel() + shift)[shift:]
    return buf.view(t.shape).copy_(t)


@pytest.mark.parametrize("members", [None, 2], ids=["single", "batched"])
@pytest.mark.parametrize("alignment", ALIGNMENTS)
@pytest.mark.parametrize("shape", ROW_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_row_schedule_is_bit_equal(rng, shape, alignment, members):
    # batched, the dye is channels 2-4 of the step's (B, 5, H, W) pack, as
    # the batched step hands it over
    h, w = shape
    b = members or 1
    u, v, dye = _fields(rng, h, w, b)
    uv = _placed(torch.stack([u, v]), int(alignment in ("u unaligned", "all unaligned")))
    u, v = uv[0], uv[1]
    pack = _placed(torch.zeros((b, 5, h, w)), int(alignment in ("dye unaligned", "all unaligned")))
    pack[:, 2:] = dye
    dye = pack[:, 2:]
    planes = [u[i] for i in range(b)] + [v[i] for i in range(b)] + [
        dye[i, ch] for i in range(b) for ch in range(3)]
    strides = (u.stride(0), v.stride(0), pack.stride(0)) if members else ()
    vec = _vec(w, planes, strides)
    assert vec == (alignment == "aligned" and w % CELLS == 0)
    dts = (DT * (1.0 + 0.25 * rng.random(b))).astype(np.float32)
    for i in range(b):
        u2, v2, dye2, bound, written = emulate(u[i], v[i], dye[i], dts[i], RATE, vec)
        assert bool((written == 1).all())
        if members:
            eu, ev, est = ref.advect_velocity_batched(u, v, dts, RATE, return_stats=True)
            edye = ref.advect_dye_batched(dye, eu, ev, dts, RATE)
            eu, ev, est, edye = eu[i], ev[i], est[i], edye[i]
        else:
            eu, ev, est = ref.advect_velocity(u[0], v[0], dts[0], RATE,
                                              return_stats=True)
            edye = ref.advect_dye(dye[0], eu, ev, dts[0], RATE)
        assert torch.equal(u2, eu) and torch.equal(v2, ev) and torch.equal(bound, est)
        assert torch.equal(dye2, edye)


def test_row_schedule_walks_every_tile():
    # a block walks up to TILES tiles of ROWS rows, gridDim.y tiles apart:
    # at 70 rows (9 tiles) 3 blocks take 3 tiles each; at 8 rows one block
    # takes its one tile
    for h, walks in ((70, [3, 3, 3]), (8, [1]), (33, [3, 2]), (64, [4, 4])):
        blocks_y = math.ceil(math.ceil(h / ROWS) / TILES)
        got = [len(range(by * ROWS, h, blocks_y * ROWS)) for by in range(blocks_y)]
        assert got == walks


@pytest.mark.parametrize("where", [(0, 0), (5, 40), (8, 129)], ids=["first", "middle", "last"])
def test_row_schedule_bound_keeps_nan(rng, where):
    # the slots' reduction over a u' with a NaN cell: the bound is NaN, as
    # ref.vel_max's; v' keeps its finite max
    h, w = 9, 130
    u2, v2, _ = _fields(rng, h, w)
    u2[where] = float("nan")
    blocks_y = math.ceil(math.ceil(h / ROWS) / TILES)
    slots = []
    for by in range(blocks_y):
        # the block's rows: its tiles, blocks_y tiles apart
        ys = [y for y in range(h) if (y // ROWS) % blocks_y == by]
        for bx in range(math.ceil(w / (32 * CELLS))):
            block = (ys, slice(bx * 32 * CELLS, (bx + 1) * 32 * CELLS))
            slots.append(torch.stack([_slot(u2[block]), _slot(v2[block])]))
    bound = torch.stack(slots).max(dim=0).values
    exp = ref.vel_max(u2, v2)
    assert bool(bound[0].isnan()) and bool(exp[0].isnan())
    assert torch.equal(bound[1], exp[1])


def test_row_vec_rule_takes_member_strides(rng):
    # batched: a member stride that is not a multiple of the cells (the
    # 5-channel pack at an odd plane size) takes the scalar path
    pack = torch.zeros((2, 5, 3, 5))
    assert not _vec(5, (pack[0, 2],), (pack.stride(0),))
    pack = torch.zeros((2, 5, 4, 8))
    assert _vec(8, (pack[0, 2], pack[0, 3], pack[0, 4]), (pack.stride(0),))
    assert not _vec(8, (pack[0, 2],), (pack.stride(0) + 2,))


# -- (c) the step ---------------------------------------------------------------------------


def _without_both(ns):
    out = types.SimpleNamespace(**vars(ns))
    del out.advect_both
    return out


def _driven(cfg, steps=4):
    sim = Simulation(dataclasses.replace(cfg, backend="ref"))
    imp = timp.orbit_impulse(steps + 2, cfg.dt, center=(cfg.nx / 2, cfg.ny / 2),
                             radius=cfg.ny / 6, omega=3.0)
    return sim.run(sim.init(), timp.Impulse(*(f[:steps] for f in imp))), imp


def test_cuda_namespace_gives_advect_both_to_the_exact_advection():
    for kw, has in ((dict(), True), (dict(fast_diffuse=True), True),
                    (dict(fast_velocity=True), False), (dict(fast_dye=True), False)):
        single, batched = _cuda_ns(**kw)
        assert hasattr(single, "advect_both") == has
        assert hasattr(batched, "advect_both") == has
    assert not hasattr(backend.get_ops(FluidConfig.gpu_reference(nx=32, ny=32, backend="ref")),
                       "advect_both")


def test_parity_step_with_advect_both_equals_the_two_calls(launches):
    cfg = FluidConfig.gpu_reference(nx=48, ny=40, pressure_iters=10, backend="ref")
    ns = _cuda_ns()[0]
    state, imp = _driven(cfg)
    calls = []
    spy = types.SimpleNamespace(**vars(ns))
    spy.advect_both = lambda *a, **k: (calls.append(k.get("out")), ns.advect_both(*a, **k))[1]
    a = b = state
    for i in range(4, 6):
        a = make_step(cfg, spy)(a, timp.slice_step(imp, i))
        b = make_step(cfg, _without_both(ns))(b, timp.slice_step(imp, i))
    assert len(calls) == 2 and all(o is not None and o.shape[0] == 3 for o in calls)
    for name in FIELDS:
        assert torch.equal(getattr(a, name), getattr(b, name)), name


def test_batched_step_with_advect_both_equals_the_two_calls(launches):
    cfg = FluidConfig.gpu_reference(nx=32, ny=24, pressure_iters=10, backend="ref")
    ns = _cuda_ns()[1]
    n = 3
    state = batched_state(cfg, n)
    imp = batched_impulse(timp.orbit_impulse(3, cfg.dt, center=(16.0, 12.0), radius=4.0,
                                             omega=3.0), n,
                          jitter_pos=np.asarray([[0, 0], [2, -1], [-3, 2]], np.float32))
    a = b = state
    for i in range(3):
        step_imp = step_of(imp, i)
        a = make_batched_step(cfg, ns)(a, step_imp)
        b = make_batched_step(cfg, _without_both(ns))(b, step_imp)
    for name in FIELDS:
        assert torch.equal(getattr(a, name), getattr(b, name)), name


@pytest.mark.parametrize("kw", [dict(fast_velocity=True), dict(fast_dye=True)],
                         ids=["fast_velocity", "fast_dye"])
def test_fast_steps_keep_the_two_calls(launches, kw):
    cfg = FluidConfig.gpu_reference(nx=32, ny=32, pressure_iters=10, backend="ref", **kw)
    ns = types.SimpleNamespace(**vars(_cuda_ns(**kw)[0]))
    state, imp = _driven(cfg)
    calls = []
    for name in ("advect_velocity", "advect_dye"):
        fn = getattr(ns, name)
        setattr(ns, name, lambda *a, _fn=fn, _n=name, **k: (calls.append(_n), _fn(*a, **k))[1])
    make_step(cfg, ns)(state, timp.slice_step(imp, 4))
    assert calls == ["advect_velocity", "advect_dye"]


def test_stage_timings_advect_takes_advect_both(launches):
    cfg = FluidConfig.gpu_reference(nx=32, ny=32, pressure_iters=4, backend="ref")
    ns = types.SimpleNamespace(**vars(_cuda_ns()[0]))
    calls = []
    both = ns.advect_both
    ns.advect_both = lambda *a, **k: (calls.append(1), both(*a, **k))[1]
    Simulation(cfg, ops=ns).stage_timings(iters=2)
    assert calls  # the Advect row times the step's call


def test_decomposed_report_splits_advect_both_with_out(launches):
    base = _cuda_ns()[0]
    wrapped = timed_ops(base, StageSpans(torch.device("cpu")))
    u, v, dye = _fields(np.random.default_rng(1), 32, 32)
    pack = torch.full((5, 32, 32), float("nan"))
    got = wrapped.advect_both(u, v, dye, DT, RATE, return_stats=True, out=pack[2:])
    _equal(got, base.advect_both(u, v, dye, DT, RATE, return_stats=True))
    assert torch.equal(pack[2:], got[2])
