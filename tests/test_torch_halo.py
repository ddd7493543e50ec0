"""The sharded rollout's building blocks on the CPU: the halo exchanges
and the communicator (``parallel/halo.py``, ``parallel/mesh.py``) against
the JAX package's, and the kernels' new entries against the JAX package's
Pallas kernels in interpret mode.

- ``exchange_rows``, ``exchange_cols``, ``exchange_2d`` (corners) equal
  JAX's bit for bit, clamp and mirror, at widths 1, 2 and d = 8;
  ``pmax``, ``psum`` (the same bits on every shard) and ``all_gather``.
- H1/H8's window entry (``advect_cuda.advect_window``, plain on CPU
  tensors) against ``advect_pallas.advect(y0=, h_phys=, x0=, w_phys=,
  d_x=)`` on a first, a middle and a last shard's padded view, both modes,
  f32 and bf16 taps, with ``vel_stats`` given and absent, flows whose taps
  reach past the halo (clamped at +-d), within tests/test_advect_pallas.py's
  own tolerance of the Pallas kernel against the JAX ref op (max(1e-4,
  3e-5 * scale): the kernel sums its masked shifted taps in another order
  than the bilinear blend); against the JAX sharded ref step's sample
  (``shardmap_step._bilerp_padded``) within 1e-6 of scale; at y0 = -d with
  the whole grid in one shard it equals the one-device op bit for bit.
- H4's solve continued from ``init`` against ``jacobi_pallas.pressure_solve
  (init=)``, and its tiled burst schedule from ``init`` emulated
  (tests/test_torch_burst.py) bit-equal to the plain sweeps; H3 on a
  kk-padded shard whose kk spans several of the planner's bursts keeps the
  rows the shard keeps equal to global sweeps (the trapezoid): bit for
  bit at a seam, to rounding at a physical edge, where the mirrored ghost
  rows sum their neighbours in the other order.
"""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from cudafluidsimulation_tpu.ops import advect_pallas, jacobi_pallas
from cudafluidsimulation_tpu.parallel import halo as jhalo

import shard_pairs as sp
from cudafluidsimulation_tpu_torch import FluidConfig
from cudafluidsimulation_tpu_torch.ops import advect_cuda, jacobi_cuda, ref
from cudafluidsimulation_tpu_torch.parallel import halo, mesh as tmesh
from test_torch_burst import DT, _pressure_sweep, emulate, emulate_diffuse

torch.set_num_threads(1)

H, W = 64, 128


def _field(c=2):
    return np.arange(c * H * W, dtype=np.float32).reshape(c, H, W) * 0.5


def _port_shards(a, mesh):
    """(C, H, W) -> each shard's block, in mesh order."""
    nr = mesh.dims[0]
    nc = mesh.dims[1] if len(mesh.dims) > 1 else 1
    hl, wl = H // nr, W // nc
    return [(torch.from_numpy(a[:, r * hl:(r + 1) * hl, k * wl:(k + 1) * wl].copy()),)
            for r in range(nr) for k in range(nc)]


@pytest.mark.parametrize("edge", ["clamp", "mirror"])
@pytest.mark.parametrize("width", [1, 2, 8])
def test_exchange_rows_matches_jax(width, edge):
    a = _field()
    fn = shard_map(lambda x: jhalo.exchange_rows(x, width, "x", edge),
                   mesh=sp.jax_mesh("rows"), in_specs=P(None, "x", None),
                   out_specs=P(None, "x", None))
    exp = np.asarray(fn(jnp.asarray(a))).reshape(2, 8, 8 + 2 * width, W)
    mesh = sp.port_mesh("rows")
    out, comms = tmesh.run(mesh, lambda x: halo.exchange_rows(x, width, "x", edge),
                           _port_shards(a, mesh))
    for i, o in enumerate(out):
        np.testing.assert_array_equal(o.numpy(), exp[:, i])
    assert comms[0].counts["exchanges"] == 1
    assert comms[0].counts["bytes"] == 2 * 2 * width * W * 4


@pytest.mark.parametrize("edge", ["clamp", "mirror"])
@pytest.mark.parametrize("width", [1, 2, 8])
@pytest.mark.parametrize("which", ["cols", "2d"])
def test_exchange_cols_and_2d_match_jax(which, width, edge):
    a = _field(1)

    def jfn(x):
        if which == "cols":
            return jhalo.exchange_cols(x, width, "cols", edge)
        return jhalo.exchange_2d(x, width, "rows", "cols", edge)

    spec = P(None, "rows", "cols")
    exp = np.asarray(shard_map(jfn, mesh=sp.jax_mesh("2d"), in_specs=spec,
                               out_specs=spec)(jnp.asarray(a)))
    mesh = sp.port_mesh("2d")
    if which == "cols":
        out, comms = tmesh.run(mesh, lambda x: halo.exchange_cols(x, width, "cols", edge),
                               _port_shards(a, mesh))
        ph, pw = 32, 32 + 2 * width
    else:
        out, comms = tmesh.run(mesh, lambda x: halo.exchange_2d(x, width, "rows", "cols",
                                                                edge),
                               _port_shards(a, mesh))
        ph, pw = 32 + 2 * width, 32 + 2 * width
    for i, o in enumerate(out):
        r, k = mesh.coords(i)
        np.testing.assert_array_equal(o.numpy(), exp[:, r * ph:(r + 1) * ph,
                                                     k * pw:(k + 1) * pw])
    assert comms[0].counts["exchanges"] == (1 if which == "cols" else 2)


def test_neighbors_padded_and_shift_match_jax():
    a = _field(1)[0]
    fn = shard_map(lambda x: jnp.stack(jhalo.neighbors_padded(jhalo.exchange_rows(x, 1, "x"))),
                   mesh=sp.jax_mesh("rows"), in_specs=P("x", None),
                   out_specs=P(None, "x", None))
    exp = np.asarray(fn(jnp.asarray(a)))
    mesh = sp.port_mesh("rows")
    parts = [(p[0][0],) for p in _port_shards(a[None], mesh)]
    out, _ = tmesh.run(mesh, lambda x: torch.stack(
        halo.neighbors_padded(halo.exchange_rows(x, 1, "x"))), parts)
    np.testing.assert_array_equal(torch.cat(out, dim=1).numpy(), exp)


def test_collectives_give_every_shard_the_same_bits():
    rng = np.random.default_rng(0)
    vals = (rng.standard_normal((8, 3)) * 10.0 ** rng.integers(-6, 6, (8, 1))).astype(np.float32)
    mesh = sp.port_mesh("2d")

    def body(x):
        comm = tmesh.current()
        return (comm.psum(x, ("rows", "cols")), comm.pmax(x, "cols"),
                comm.psum(x, "rows"), comm.all_gather(x[None], "cols", dim=0))

    out, comms = tmesh.run(mesh, body, [(torch.from_numpy(v),) for v in vals])
    total = vals[0]
    for v in vals[1:]:
        total = total + v  # mesh order, float32
    for i, (s, m, r, g) in enumerate(out):
        row, col = mesh.coords(i)
        np.testing.assert_array_equal(s.numpy(), total)
        np.testing.assert_array_equal(m.numpy(), vals[row * 4:(row + 1) * 4].max(0))
        np.testing.assert_array_equal(r.numpy(), vals[col] + vals[4 + col])
        np.testing.assert_array_equal(g.numpy(), vals[row * 4:(row + 1) * 4])
    assert comms[3].counts == {"exchanges": 0, "bytes": 12, "pmax": 1, "psum": 2,
                               "all_gather": 1}


def test_a_failing_shard_raises_its_error_and_frees_the_others():
    mesh = sp.port_mesh("rows")

    def body(i):
        if i == 5:
            raise KeyError("shard 5")
        return halo.exchange_rows(torch.zeros(4, 4), 1, "x")

    with pytest.raises(KeyError, match="shard 5"):
        tmesh.run(mesh, body, [(i,) for i in range(8)])
    assert threading.active_count() < 8
    with pytest.raises(RuntimeError, match="no shard"):
        tmesh.current()


def test_kernel_counts_lose_no_launch_across_shard_threads():
    # more threads than cores, each tagged as a shard, launching a fake
    # kernel with a short switch interval: a lost update would show
    import os
    import sys

    from cudafluidsimulation_tpu_torch.ops import _build

    class FakeLib:
        @staticmethod
        def fluid_fake():
            return 0

    kern = _build.Kernel("fake", {})
    kern._lib = FakeLib()
    n, per = 2 * (os.cpu_count() or 4), 400

    def work(i):
        _build.set_shard(i)
        for _ in range(per):
            kern.launch("fluid_fake")
        _build.set_shard(None)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert kern.launches == n * per
    assert kern.by_shard == {i: per for i in range(n)}
    kern.reset()
    assert kern.launches == 0 and kern.by_shard == {}


def test_shards_round_robin_and_gather_back():
    assert [str(d) for d in tmesh.place(5, ["cpu", "meta"])] == ["cpu", "meta", "cpu",
                                                                 "meta", "cpu"]
    arrays = sp.numpy_state(FluidConfig.gpu_reference(nx=128, ny=64, backend="ref"))
    state = sp.interop.state_from_numpy(arrays)
    for mesh in (sp.port_mesh("rows"), sp.port_mesh("2d")):
        sharded = tmesh.shard_state(state, mesh)
        assert sharded.shards[0].u.is_contiguous() and sharded.shards[0].dye.is_contiguous()
        back = sp.interop.state_to_numpy(tmesh.gather_state(sharded))
        for name, a in arrays.items():
            np.testing.assert_array_equal(back[name], a, err_msg=name)


# -- H1/H8's window entry against the Pallas kernel -----------------------------------

D = 8
HG, WG = 64, 128  # the global grid: 4 row shards of 16, or 2 x 2 of 32 x 64


def _padded(g, rows, cols):
    """g[..., rows, cols] with indices clamped to the grid (a clamp
    exchange's padded view)."""
    r = np.clip(rows, 0, g.shape[-2] - 1)
    c = np.clip(cols, 0, g.shape[-1] - 1)
    return g[..., r[:, None], c[None, :]]


def _window_case(seed, c, speed):
    rng = np.random.default_rng(seed)
    f = rng.uniform(-1.0, 2.0, (c, HG, WG)).astype(np.float32)
    u = (rng.standard_normal((HG, WG)) * speed).astype(np.float32)
    v = (rng.standard_normal((HG, WG)) * speed).astype(np.float32)
    return f, u, v


WINDOWS = {
    # (row block, col block, rows mesh?)
    "first": (0, 0, True), "middle": (1, 0, True), "last": (3, 0, True),
    "2d-corner": (0, 1, False), "2d-last": (1, 0, False),
}


@pytest.mark.parametrize("stats", ["given", "absent"])
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("mode", ["field", "dye"])
@pytest.mark.parametrize("where", list(WINDOWS))
def test_window_advect_matches_pallas(where, mode, packed, stats):
    rb, cb, rows_mesh = WINDOWS[where]
    c = 2 if mode == "field" else 3
    # a driven flow (taps reach past the halo: clamped at +-d) or, with the
    # bound given, a quiet one (the exact branch of H8)
    speed = 300.0 if stats == "absent" or not packed else 20.0
    f, u, v = _window_case(hash(where) % 1000, c, speed)
    hl = 16 if rows_mesh else 32
    wl = WG if rows_mesh else 64
    d_x = 0 if rows_mesh else D
    rows = np.arange(rb * hl - D, (rb + 1) * hl + D)
    cols = np.arange(WG) if rows_mesh else np.arange(cb * wl - D, (cb + 1) * wl + D)
    fp, up, vp = (_padded(a, rows, cols) for a in (f, u, v))
    y0, x0 = rb * hl - D, (0 if rows_mesh else cb * wl - D)
    dt = np.float32(1 / 60)
    if mode == "field":
        fp = np.stack([up, vp])
    cu, cv = up[D:-D, d_x:fp.shape[-1] - d_x], vp[D:-D, d_x:fp.shape[-1] - d_x]
    vel = (np.asarray([np.abs(cu).max(), np.abs(cv).max()], np.float32)
           if stats == "given" else None)
    if rows_mesh:
        assert advect_pallas._tile_plan(hl + 2 * D, WG, c, D) is None
    exp = np.asarray(advect_pallas.advect(
        jnp.asarray(fp), jnp.asarray(up), jnp.asarray(vp), dt, 1.2, mode, D, y0=y0,
        h_phys=HG, x0=x0, w_phys=WG, d_x=d_x,
        vel_stats=None if vel is None else jnp.asarray(vel), packed=packed))
    exp = exp[:, D:-D, d_x:exp.shape[-1] - d_x]
    win = ref.Window(y0=y0, h_phys=HG, d=D, x0=x0, w_phys=WG, d_x=d_x)
    got = advect_cuda.advect_window(
        torch.from_numpy(np.ascontiguousarray(fp)), torch.from_numpy(cu.copy()),
        torch.from_numpy(cv.copy()), dt, 1.2, mode, win,
        vel_stats=None if vel is None else torch.from_numpy(vel),
        return_stats=mode == "field", packed=packed)
    out = got[0] if mode == "field" else got
    scale = max(float(np.abs(exp).max()), 1.0)
    np.testing.assert_allclose(out.numpy(), exp, rtol=0, atol=max(1e-4, 3e-5 * scale))
    if mode == "field":
        # the bound covers the interior alone
        np.testing.assert_array_equal(got[1].numpy(), np.abs(out.numpy()).max(axis=(1, 2)))


@pytest.mark.parametrize("mode", ["field", "dye"])
def test_window_sample_matches_jax_sharded_ref(mode):
    # the JAX rows mesh's ref sample on each shard's clamp-exchanged view
    from cudafluidsimulation_tpu.parallel import shardmap_step as jss

    c = 2 if mode == "field" else 3
    f, u, v = _window_case(11, c, 300.0)
    dt = np.float32(1 / 60)

    def jfn(ff, uu, vv):
        fp = jhalo.exchange_rows(ff, D, "x", edge="clamp")
        return jss._bilerp_padded(fp, uu, vv, dt, HG, D, "x")

    exp = np.asarray(shard_map(jfn, mesh=sp.jax_mesh("rows"),
                               in_specs=(P(None, "x", None), P("x", None), P("x", None)),
                               out_specs=P(None, "x", None))(
        jnp.asarray(f), jnp.asarray(u), jnp.asarray(v)))
    mesh = sp.port_mesh("rows")
    hl = HG // 8

    def body(ff, uu, vv):
        fp = halo.exchange_rows(ff, D, "x", edge="clamp")
        win = ref.Window(y0=tmesh.current().axis_index("x") * hl - D, h_phys=HG, d=D)
        return ref.window_bilerp(fp, uu, vv, dt, win)

    parts = [(torch.from_numpy(f[:, i * hl:(i + 1) * hl].copy()),
              torch.from_numpy(u[i * hl:(i + 1) * hl].copy()),
              torch.from_numpy(v[i * hl:(i + 1) * hl].copy())) for i in range(8)]
    out, _ = tmesh.run(mesh, body, parts)
    got = torch.cat(out, dim=1).numpy()
    np.testing.assert_allclose(got, exp, rtol=0, atol=1e-6 * max(np.abs(exp).max(), 1.0))


def test_window_over_the_whole_grid_is_the_one_device_op():
    f, u, v = _window_case(7, 3, 200.0)
    rows = np.arange(-D, HG + D)
    fp, up, vp = (torch.from_numpy(np.ascontiguousarray(_padded(a, rows, np.arange(WG))))
                  for a in (f, u, v))
    tu, tv = torch.from_numpy(u), torch.from_numpy(v)
    win = ref.Window(y0=-D, h_phys=HG, d=HG)  # a halo as deep as the grid: no bound
    big = torch.from_numpy(np.ascontiguousarray(
        _padded(np.stack([u, v]), np.arange(-HG, 2 * HG), np.arange(WG))))
    uv, st = ref.advect_window(big, tu, tv, DT, 1.2, "field", ref.Window(-HG, HG, HG),
                               return_stats=True)
    u2, v2, st2 = ref.advect_velocity(tu, tv, DT, 1.2, return_stats=True)
    assert torch.equal(uv[0], u2) and torch.equal(uv[1], v2) and torch.equal(st, st2)
    del fp, up, vp, win
    bigf = torch.from_numpy(np.ascontiguousarray(
        _padded(f, np.arange(-HG, 2 * HG), np.arange(WG))))
    dye = ref.advect_window(bigf, u2, v2, DT, 1.2, "dye", ref.Window(-HG, HG, HG))
    assert torch.equal(dye, ref.advect_dye(torch.from_numpy(f), u2, v2, DT, 1.2))


def test_window_entry_refuses_what_the_kernel_does_not_take():
    f = torch.zeros(2, 20, 16)
    u = torch.zeros(4, 16)
    with pytest.raises(ValueError):  # 4 + 2*8 rows, but d says 8 and the view 20
        advect_cuda.advect_window(torch.zeros(2, 21, 16), u, u, DT, 1.2, "field",
                                  ref.Window(0, 20, 8))
    with pytest.raises(ValueError, match="return_stats"):
        advect_cuda.advect_window(f, u, u, DT, 1.2, "dye", ref.Window(0, 20, 8),
                                  return_stats=True)
    meta = torch.empty(2, 20, 16, device="meta")
    with pytest.raises(ValueError):  # neither the CPU nor a card
        advect_cuda.advect_window(meta, u.to("meta"), u.to("meta"), DT, 1.2, "field",
                                  ref.Window(0, 20, 8))


# -- H4's solve from init, and H3 on a padded shard --------------------------------


@pytest.mark.parametrize("iters", [0, 1, 3, 8, 9, 17])
def test_pressure_solve_from_init_matches_pallas(iters):
    rng = np.random.default_rng(iters)
    div = rng.standard_normal((40, 136)).astype(np.float32)
    p0 = rng.standard_normal((40, 136)).astype(np.float32)
    exp = np.asarray(jacobi_pallas.pressure_solve(jnp.asarray(div), iters, burst=8,
                                                  init=jnp.asarray(p0)))
    got = jacobi_cuda.pressure_solve(torch.from_numpy(div), iters, init=torch.from_numpy(p0))
    np.testing.assert_allclose(got.numpy(), exp, rtol=0,
                               atol=1e-5 * max(np.abs(exp).max(), 1.0))
    # continuing from the iterate of k sweeps is k more sweeps, bit for bit
    td, tp = torch.from_numpy(div), torch.from_numpy(p0)
    assert torch.equal(ref.pressure_solve(td, iters, init=ref.pressure_solve(td, 3, init=tp)),
                       ref.pressure_solve(td, iters + 3, init=tp))
    assert torch.equal(ref.pressure_solve(td, iters, init=torch.zeros_like(td)),
                       ref.pressure_solve(td, iters))


@pytest.mark.parametrize("plan_kw", [{}, {"tile": (8, 16), "depth": 3}])
@pytest.mark.parametrize("iters", [1, 3, 8, 9, 17])
def test_pressure_solve_schedule_from_init_is_bit_equal(iters, plan_kw):
    rng = np.random.default_rng(1)
    div = torch.from_numpy(rng.standard_normal((37, 53)).astype(np.float32))
    p0 = torch.from_numpy(rng.standard_normal((37, 53)).astype(np.float32))
    plan = jacobi_cuda.plan_bursts(37, 53, iters, "solve", **plan_kw)
    assert torch.equal(emulate(p0, plan, _pressure_sweep(div)),
                       ref.pressure_solve(div, iters, init=p0))


@pytest.mark.parametrize("shard", [0, 1, 3])
@pytest.mark.parametrize("kk", [5, 8, 13])
def test_h3_on_a_padded_shard_keeps_its_rows_exact(kk, shard):
    # 4 shards of 24 rows; the shard's kk-deep mirror-exchanged view swept
    # by H3's wavefront in passes of at most 3 sweeps (several launches)
    rng = np.random.default_rng(kk)
    g = torch.from_numpy(rng.standard_normal((5, 96, 40)).astype(np.float32))
    rows = np.arange(shard * 24 - kk, (shard + 1) * 24 + kk)
    mirror = np.where(rows < 0, -1 - rows, np.where(rows >= 96, 2 * 96 - 1 - rows, rows))
    fp = g[:, torch.from_numpy(mirror)].contiguous()
    coeffs = [0.8] * 2 + [0.5] * 3
    plan = jacobi_cuda.plan_diffuse(fp.shape[1], 40, kk, 5, cells=1, lanes=8, depth=3, chunk=7)
    assert len(plan.depths) > 1
    got = emulate_diffuse(fp, coeffs, plan)[:, kk:-kk]
    exp = ref.diffuse_multi(g, DT, coeffs, kk)[:, shard * 24:(shard + 1) * 24]
    plain = jacobi_cuda.diffuse_multi(fp, DT, coeffs, kk)[:, kk:-kk]
    assert torch.equal(got, plain)
    if shard in (1, 2):
        # at a seam the halo rows are the neighbour's: bit for bit
        assert torch.equal(got, exp)
    else:
        # at a physical edge the mirrored rows are the Neumann ghost in
        # exact arithmetic; a mirrored row adds its vertical neighbours in
        # the other order, so its image differs by rounding
        np.testing.assert_allclose(got.numpy(), exp.numpy(), rtol=0, atol=1e-6)
