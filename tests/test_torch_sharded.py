"""The port's (ens, x) mesh (``parallel/sharded.py``) against the JAX
package's auto-SPMD step, on 8 CPU shards and 8 virtual CPU devices.

The same numpy-made states (``shard_pairs.numpy_state``) go through both
packages (``interop``); fields agree within 1e-5 of each field's largest
magnitude, the scalars exactly.  JAX's result is the global step (XLA
partitions the one-device step and gathers what the backtrace reads), so
the port's must be too:

- ``make_mesh`` shapes and errors; ``shard_state``/``gather_state`` round
  trips bit for bit, batched and not, on (1, 8), (2, 4) and (4, 2), with
  each shard's block the shape of JAX's;
- ``make_sharded_step`` on (1, 8) over 6 orbit steps at
  tests/test_sharded.py's ``cfg64``, on the ``ref`` schedule and the kernel
  schedule (the wrappers' plain versions on CPU shards);
- a state whose displacement exceeds the shard height (asserted): the port
  equals JAX and its own single-device step, where the rows mesh's
  bounded taps (``make_shardmap_step``) do not;
- ``sharded_rollout(batched=True)`` on (2, 4), members with their own
  states and jittered orbits, each equal to JAX and to its single run;
- every group's members against ``make_ensemble_run`` over the whole
  batch: bit for bit on (4, 1), within 1e-5 on (4, 2);
- a quality (2, 2) rollout whose groups stop at different V-cycle counts
  runs to its end and equals JAX's;
- the fast flags: JAX's auto-SPMD step drops them (its ``ref`` ops) and
  the port's ``ref`` schedule equals that; its kernel schedule honours
  them: on (1, 8) and (2, 4) each member equals JAX's one-device pallas
  fast run (interpret mode) and the port's one-device fast ``Simulation``;
- the communicator's groups: a collective over "x" meets only its ens
  group, a skipped collective raises within the barrier's timeout, and the
  rows and 2-D meshes keep their exchange counts;
- H1/H8's rows-unbounded window (plain) equal to the one-device ops' rows.
"""

import dataclasses
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudafluidsimulation_tpu import FluidConfig as JConfig
from cudafluidsimulation_tpu import Simulation as JSimulation
from cudafluidsimulation_tpu.parallel import sharded as jsh
from cudafluidsimulation_tpu.state import FluidState as JState
from cudafluidsimulation_tpu.utils.impulse import Impulse as JImpulse

import shard_pairs as sp
from cudafluidsimulation_tpu_torch import FluidConfig, Simulation, interop
from cudafluidsimulation_tpu_torch.models import ensemble
from cudafluidsimulation_tpu_torch.ops import advect_packed, backend, ref
from cudafluidsimulation_tpu_torch.parallel import mesh as tmesh
from cudafluidsimulation_tpu_torch.parallel import sharded, shardmap2d, shardmap_step
from cudafluidsimulation_tpu_torch.utils import impulse as timp

torch.set_num_threads(1)

DT = np.float32(1 / 60)


def cfg64(**kw):
    """tests/test_sharded.py's cfg64: 128 x 64, mild dynamics."""
    base = dict(nx=128, ny=64, backend="ref", diffusion_iters=5, pressure_iters=10,
                vorticity=0.5, force_scale=500.0)
    base.update(kw)
    return JConfig.gpu_reference(**base)


def jmesh(ens, x):
    return jsh.make_mesh(ens * x, ens=ens, devices=jax.devices()[:ens * x])


def tmesh_of(ens, x):
    return sharded.make_mesh(ens * x, ens=ens, devices=["cpu"])


def members(cfg, n, speed=20.0):
    """``n`` members' numpy states, stacked: member b from seed b."""
    states = [sp.numpy_state(cfg, seed=b, speed=speed) for b in range(n)]
    return {k: np.stack([s[k] for s in states]) for k in states[0]}


def streams(cfg, steps, n):
    """The orbit stream jittered per member: the port's (n, T, ...) and the
    same numbers as JAX arrays."""
    one, _ = sp.impulses(cfg, steps)
    jit = np.linspace(-6.0, 6.0, n)[:, None] * np.asarray([[1.0, -0.5]])
    t = ensemble.batched_impulse(one, n, jitter_pos=jit)
    return t, JImpulse(*(jnp.asarray(f.numpy()) for f in t))


def jax_rollout(jcfg, arrays, jimps, ens, x, batched):
    mesh = jmesh(ens, x)
    state = jsh.shard_state(JState(**{k: jnp.asarray(a) for k, a in arrays.items()}), mesh,
                            batched)
    out = jsh.sharded_rollout(jcfg, mesh, batched=batched)(state, jimps)
    return {k: np.asarray(v) for k, v in out._asdict().items()}


def port_rollout(cfg, arrays, imps, ens, x, batched, kernels=None):
    """(the final state's arrays, the rollout's communicator counts)."""
    mesh = tmesh_of(ens, x)
    run = sharded.sharded_rollout(cfg, mesh, batched=batched, kernels=kernels)
    out = run(sharded.shard_state(interop.state_from_numpy(arrays), mesh, batched), imps)
    return interop.state_to_numpy(tmesh.gather_state(out)), run.counts


def member(arrays, b):
    return {k: a[b] for k, a in arrays.items()}


def single_run(cfg, arrays, stream):
    sim = Simulation(cfg, device="cpu")
    return interop.state_to_numpy(sim.run(interop.state_from_numpy(arrays), stream))


# -- the mesh and the layouts ----------------------------------------------------------


def test_make_mesh_shapes_and_errors():
    for ens in (1, 2, 4, 8):
        m = tmesh_of(ens, 8 // ens)
        assert m.shape == dict(jmesh(ens, 8 // ens).shape) == {"ens": ens, "x": 8 // ens}
        assert m.axis_names == ("ens", "x") and m.devices == (torch.device("cpu"),) * 8
    with pytest.raises(ValueError, match="not divisible by ens=3"):
        sharded.make_mesh(8, ens=3, devices=["cpu"])
    with pytest.raises(ValueError, match="not divisible by ens=3"):
        jsh.make_mesh(8, ens=3)
    # one shard a device by default; more shards than devices go round-robin
    assert sharded.make_mesh(devices=["cpu", "meta"]).shape == {"ens": 1, "x": 2}
    assert [str(d) for d in sharded.make_mesh(4, ens=2, devices=["cpu", "meta"]).devices] == [
        "cpu", "meta", "cpu", "meta"]
    assert sharded.state_sharding(None, True).dye == ("ens", None, "x", None)
    assert sharded.impulse_sharding(None, True).pos == ("ens", None, None)
    assert sharded.impulse_sharding(None, False, time_axis=False).pressed == ()


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("ens,x", [(1, 8), (2, 4), (4, 2)])
def test_shard_and_gather_round_trip(ens, x, batched):
    cfg = cfg64()
    arrays = members(cfg, 4) if batched else sp.numpy_state(cfg)
    mesh = tmesh_of(ens, x)
    st = sharded.shard_state(interop.state_from_numpy(arrays), mesh, batched)
    jst = jsh.shard_state(JState(**{k: jnp.asarray(a) for k, a in arrays.items()}),
                          jmesh(ens, x), batched)
    for name in ("u", "dye", "t", "mouse", "vel_stats"):
        jshape = getattr(jst, name).addressable_shards[0].data.shape
        assert all(tuple(getattr(s, name).shape) == jshape for s in st.shards), name
    for i, s in enumerate(st.shards):
        e, r = mesh.coords(i)
        hl = 64 // x
        rows = np.s_[..., r * hl:(r + 1) * hl, :]
        exp = arrays["u"][e * (4 // ens):(e + 1) * (4 // ens)] if batched else arrays["u"]
        np.testing.assert_array_equal(s.u.numpy(), exp[rows])
        assert s.u.is_contiguous() and s.dye.is_contiguous()
    back = interop.state_to_numpy(tmesh.gather_state(st))
    for name, a in arrays.items():
        np.testing.assert_array_equal(back[name], a, err_msg=name)


# -- the global step -------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_1x8():
    jcfg = cfg64()
    arrays = sp.numpy_state(jcfg)
    _, jimp = sp.impulses(jcfg, 6)
    return jcfg, arrays, jax_rollout(jcfg, arrays, jimp, 1, 8, False)


@pytest.mark.parametrize("schedule", ["ref", "kernels"])
def test_step_on_1x8_matches_jax(jax_1x8, schedule):
    jcfg, arrays, exp = jax_1x8
    cfg = interop.config_from_jax(jcfg)
    kernels = shardmap_step.KERNELS if schedule == "kernels" else None
    mesh = tmesh_of(1, 8)
    step = sharded.make_sharded_step(cfg, mesh, kernels=kernels)
    state = sharded.shard_state(interop.state_from_numpy(arrays), mesh)
    stream, _ = sp.impulses(cfg, 6)
    for i in range(6):
        state = step(state, timp.slice_step(stream, i))
    got = interop.state_to_numpy(tmesh.gather_state(state))
    sp.assert_close(got, exp, what=schedule)
    sp.assert_close(got, single_run(cfg, arrays, stream), what=f"{schedule} vs one device")
    # one gather a step for the advection, and its bytes: every row of 5 planes
    assert step.counts[0]["all_gather"] == 1


def test_displacement_past_the_shard_height_is_the_global_step():
    # 8 shards of 4 rows.  (At a 14-cell reach the one-device steps of the
    # two packages already lie 1.7e-5 of scale apart in the dye: the
    # backtrace's x - dt * u rounds otherwise in XLA's float32.)
    jcfg = cfg64(ny=32, diffusion_iters=2, pressure_iters=4)
    cfg = interop.config_from_jax(jcfg)
    hl = cfg.ny // 8
    arrays = sp.numpy_state(jcfg, seed=3, speed=300.0)
    reach = max(np.abs(arrays["u"]).max(), np.abs(arrays["v"]).max()) * DT
    assert reach > hl + 1  # the backtrace reaches past the shard's height
    assert cfg.max_displacement > hl  # the rows mesh would refuse this config
    stream, jimp = sp.impulses(cfg, 1)
    exp = jax_rollout(jcfg, arrays, jimp, 1, 8, False)
    got, _ = port_rollout(cfg, arrays, stream, 1, 8, False)
    sp.assert_close(got, exp, what="vs JAX")
    sp.assert_close(got, single_run(cfg, arrays, stream), what="vs one device")
    # the rows mesh, its taps bounded by a shard-deep halo, lands elsewhere
    rcfg = interop.config_from_jax(cfg64(ny=32, diffusion_iters=2, pressure_iters=4,
                                         max_displacement=hl))
    rows_mesh = tmesh.make_mesh(8, devices=["cpu"] * 8)
    rows = shardmap_step.make_shardmap_step(rcfg, rows_mesh)
    bounded = rows(tmesh.shard_state(interop.state_from_numpy(arrays), rows_mesh),
                   timp.slice_step(stream, 0))
    bounded = interop.state_to_numpy(tmesh.gather_state(bounded))
    scale = np.abs(exp["u"]).max()
    assert np.abs(bounded["u"] - exp["u"]).max() > 100 * sp.RTOL * scale


def test_batched_rollout_on_2x4_matches_jax_and_single_runs():
    jcfg = cfg64()
    cfg = interop.config_from_jax(jcfg)
    arrays = members(jcfg, 2)
    stream, jimps = streams(jcfg, 4, 2)
    exp = jax_rollout(jcfg, arrays, jimps, 2, 4, True)
    got, counts = port_rollout(cfg, arrays, stream, 2, 4, True)
    sp.assert_close(got, exp, what="vs JAX")
    for b in range(2):
        sp.assert_close(member(got, b), single_run(cfg, member(arrays, b),
                                                   timp.Impulse(*(f[b] for f in stream))),
                        what=f"member {b}")
    assert not np.allclose(got["u"][0], got["u"][1])  # the members differ
    assert counts[0]["all_gather"] == 4  # one a step


@pytest.mark.parametrize("schedule", ["ref", "kernels"])
@pytest.mark.parametrize("x", [1, 2])
def test_groups_equal_the_one_device_ensemble(x, schedule):
    cfg = FluidConfig.gpu_reference(nx=64, ny=64, backend="ref", diffusion_iters=4,
                                    pressure_iters=8, vorticity=0.5, force_scale=500.0)
    arrays = members(cfg, 8)
    stream, _ = streams(cfg, 3, 8)
    kernels = shardmap_step.KERNELS if schedule == "kernels" else None
    ops = backend.kernel_ops(cfg, batched=True) if kernels else None
    exp = interop.state_to_numpy(ensemble.make_ensemble_run(cfg, ops)(
        interop.state_from_numpy(arrays), stream))
    got, counts = port_rollout(cfg, arrays, stream, 4, x, True, kernels=kernels)
    if x == 1:
        # each group runs the same batched ops on its 2 members: no collective
        assert all(c == {"exchanges": 0, "bytes": 0, "pmax": 0, "psum": 0, "all_gather": 0}
                   for c in counts)
        for name, a in exp.items():
            np.testing.assert_array_equal(got[name], a, err_msg=name)
    else:
        # the physical edges' mirrored rows add in another order
        sp.assert_close(got, exp, what=f"(4, {x}) {schedule}")


def test_quality_members_stop_apart_and_match_jax():
    jcfg = JConfig.gpu_reference(nx=64, ny=64, backend="ref", diffusion_iters=4,
                                 vorticity=0.5, force_scale=500.0,
                                 pressure_solver="multigrid", mg_tol=0.05)
    cfg = interop.config_from_jax(jcfg)
    from cudafluidsimulation_tpu_torch.ops import multigrid as mg
    assert mg._levels(64, 64) <= mg.local_levels(64 // 2)  # the shard's cap does not bind
    arrays = members(jcfg, 2)
    arrays["u"][1] *= 4.0  # member 1 starts faster: more V-cycles
    arrays["vel_stats"][1] *= 4.0
    stream, jimps = streams(jcfg, 3, 2)
    exp = jax_rollout(jcfg, arrays, jimps, 2, 2, True)
    t0 = time.perf_counter()
    got, counts = port_rollout(cfg, arrays, stream, 2, 2, True)
    assert time.perf_counter() - t0 < tmesh.BARRIER_TIMEOUT
    sp.assert_close(got, exp, what="quality (2, 2)")
    tests = [c["psum"] for c in counts]  # a psum a stopping test
    assert tests[0] == tests[1] and tests[2] == tests[3]  # a group agrees
    assert tests[0] != tests[2], tests  # the groups stopped at different counts


FAST = dict(fast_dye=True, fast_velocity=True, fast_diffuse=True)
FAST_SWEEPS = dict(diffusion_iters=20, pressure_iters=8)


def test_fast_flags_are_dropped_by_jax():
    jfast, jexact = cfg64(backend="pallas", **FAST_SWEEPS, **FAST), cfg64(**FAST_SWEEPS)
    arrays = sp.numpy_state(jexact, seed=1, speed=80.0)
    assert max(np.abs(arrays["u"]).max(), np.abs(arrays["v"]).max()) * DT > 1.0  # driven
    _, jimp = sp.impulses(jexact, 1)
    exact = jax_rollout(jexact, arrays, jimp, 1, 8, False)
    dropped = jax_rollout(jfast, arrays, jimp, 1, 8, False)
    for name, a in exact.items():
        np.testing.assert_array_equal(dropped[name], a, err_msg=name)
    stream, _ = sp.impulses(jexact, 1)
    # the port's ref schedule drops them as JAX does
    got_ref, _ = port_rollout(interop.config_from_jax(cfg64(**FAST_SWEEPS, **FAST)), arrays,
                              stream, 1, 8, False)
    sp.assert_close(got_ref, exact, what="port ref vs JAX")


@pytest.mark.parametrize("ens,x", [(1, 8), (2, 4)])
def test_fast_kernel_schedule_is_the_one_device_fast_step(ens, x):
    # the kernel schedule honours the flags.  Each step of each member is
    # JAX's one-device pallas fast step (interpret mode) of the same input
    # within 1e-5 of scale, as tests/test_torch_fast.py's fast step, ten
    # times that from its exact step; the whole rollout is the port's own one-device fast
    # Simulation run within 1e-5.  (From one start, the two packages' fast
    # runs leave 1e-5 after the first step: a float32 difference in a
    # backtrace can round a bf16 tap the other way; so JAX is given each
    # step's input.)
    steps, batched = 3, ens > 1
    jfast = cfg64(backend="pallas", **FAST_SWEEPS, **FAST)
    cfg = interop.config_from_jax(jfast)
    n = 2 if batched else 1
    arrays = members(jfast, n, speed=80.0)
    reach = max(np.abs(arrays["u"]).max(), np.abs(arrays["v"]).max()) * DT
    assert 1.0 < reach < cfg.max_displacement  # driven, inside JAX's tap halo
    stream, jimps = streams(jfast, steps, n)
    mesh = tmesh_of(ens, x)
    step = sharded.make_sharded_step(cfg, mesh, batched=batched,
                                     kernels=shardmap_step.KERNELS)
    run_arrays = arrays if batched else member(arrays, 0)
    state = sharded.shard_state(interop.state_from_numpy(run_arrays), mesh, batched)
    jsim, jexact = JSimulation(jfast), JSimulation(cfg64(**FAST_SWEEPS))
    for i in range(steps):
        before = interop.state_to_numpy(tmesh.gather_state(state))
        imp = timp.Impulse(*(f[:, i] if batched else f[0, i] for f in stream))
        state = step(state, imp)
        after = interop.state_to_numpy(tmesh.gather_state(state))
        for b in range(n):
            jstart = JState(**{k: jnp.asarray(a) for k, a in
                               (member(before, b) if batched else before).items()})
            jimp = JImpulse(*(f[b, i] for f in jimps))
            exp = {k: np.asarray(a) for k, a in jsim.step(jstart, jimp)._asdict().items()}
            exact = jexact.step(jstart, jimp)
            # fast and exact lie far more than the tolerance apart
            gap = np.abs(exp["u"] - np.asarray(exact.u)).max()
            assert gap > 10 * sp.RTOL * np.abs(exp["u"]).max()
            sp.assert_close(member(after, b) if batched else after, exp,
                            what=f"step {i} member {b} vs JAX's one-device fast step")
    # the kernels' namespace on a ref config: its wrappers run their plain
    # versions on the CPU
    rcfg = dataclasses.replace(cfg, backend="ref")
    sim = Simulation(rcfg, device="cpu", ops=backend.kernel_ops(rcfg))
    for b in range(n):
        one = interop.state_to_numpy(sim.run(interop.state_from_numpy(member(arrays, b)),
                                             timp.Impulse(*(f[b] for f in stream))))
        sp.assert_close(member(after, b) if batched else after, one,
                        what=f"member {b} vs the port's one-device fast run")


def test_the_step_refuses_what_it_does_not_take():
    cfg = interop.config_from_jax(cfg64())
    mesh = tmesh_of(2, 4)
    st = sharded.shard_state(interop.state_from_numpy(sp.numpy_state(cfg64())), mesh)
    stream, _ = sp.impulses(cfg, 1)
    with pytest.raises(ValueError, match="batched=True"):
        sharded.make_sharded_step(cfg, mesh, batched=True)(st, timp.slice_step(stream, 0))
    with pytest.raises(ValueError, match=r"\(ens, x\) mesh"):
        sharded.make_sharded_step(cfg, tmesh.make_mesh(2, devices=["cpu"] * 2))
    with pytest.raises(ValueError, match="KERNELS"):
        sharded.make_sharded_step(cfg, tmesh_of(4, 1), kernels=shardmap_step.PLAIN)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        sharded.make_sharded_step(interop.config_from_jax(cfg64(backend="pallas")),
                                  tmesh_of(4, 1))


# -- the communicator's groups ---------------------------------------------------------


def test_a_collective_over_x_meets_only_its_group():
    mesh = tmesh_of(2, 4)

    def body(v):
        comm = tmesh.current()
        out = v
        # group 1 makes three times the collectives of group 0
        for _ in range(1 + 2 * comm.axis_index("ens")):
            out = comm.psum(out, "x")
        return out, comm.all_gather(v[None], "x", dim=0)

    vals = [torch.tensor([float(i + 1)]) for i in range(8)]
    out, comms = tmesh.run(mesh, body, [(v,) for v in vals])
    for i, (s, g) in enumerate(out):
        e = mesh.coords(i)[0]
        group = torch.cat(vals[4 * e:4 * e + 4])
        exp = group.sum() * (1 if e == 0 else 4 ** 2)
        assert float(s) == float(exp)
        assert torch.equal(g[:, 0], group)
    assert [c.counts["psum"] for c in comms] == [1] * 4 + [3] * 4


def test_a_skipped_collective_raises_within_the_timeout(monkeypatch):
    monkeypatch.setattr(tmesh, "BARRIER_TIMEOUT", 0.5)
    mesh = tmesh.make_mesh(4, devices=["cpu"] * 4)

    def body(i):
        if i != 2:  # shard 2 skips the collective
            tmesh.current().psum(torch.ones(1), "x")
        return i

    t0 = time.perf_counter()
    with pytest.raises(threading.BrokenBarrierError):
        tmesh.run(mesh, body, [(i,) for i in range(4)])
    assert time.perf_counter() - t0 < 10.0


@pytest.mark.parametrize("kind,pairs", [("rows", 5), ("2d", 10)])
def test_rows_and_2d_meshes_keep_their_exchange_counts(kind, pairs):
    # the dry run's kernel configurations at 8 shards (the JAX dry run's pins)
    if kind == "rows":
        cfg = FluidConfig.gpu_reference(nx=128, ny=256, backend="ref", max_displacement=8,
                                        diffusion_iters=4, pressure_iters=8, jacobi_burst=4)
        mesh, make = sp.port_mesh("rows"), shardmap_step.make_shardmap_step
    else:
        cfg = FluidConfig.gpu_reference(nx=256, ny=128, backend="ref", max_displacement=8,
                                        diffusion_iters=4, pressure_iters=8, jacobi_burst=4)
        mesh, make = sp.port_mesh("2d"), shardmap2d.make_shardmap2d_step
    step = make(cfg, mesh, kernels=shardmap_step.KERNELS)
    state = tmesh.shard_state(interop.state_from_numpy(sp.numpy_state(cfg)), mesh)
    stream, _ = sp.impulses(cfg, 1)
    step(state, timp.slice_step(stream, 0))
    assert [c["exchanges"] for c in step.counts] == [pairs] * mesh.size
    assert [c["pmax"] for c in step.counts] == [2] * mesh.size


# -- H1/H8's rows-unbounded window -----------------------------------------------------


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("first", [0, 24, 48])
def test_unbounded_window_is_the_one_device_ops_rows(first, packed):
    rng = np.random.default_rng(first)
    h, w, hl = 64, 48, 16
    u, v = (torch.from_numpy((rng.standard_normal((h, w)) * 900.0).astype(np.float32))
            for _ in range(2))
    dye = torch.from_numpy(rng.uniform(0.0, 1.0, (3, h, w)).astype(np.float32))
    win = ref.Window(y0=0, h_phys=h, d=0, y_in=first)
    assert ref.window_shape(win, hl, w) == (h, w) and ref.window_rows(win) == (first, h)
    rows = np.s_[..., first:first + hl, :]
    uv = torch.stack([u, v])
    got_uv, st = advect_packed.window_plain(uv, u[rows], v[rows], DT, 1.2, "field", win,
                                            return_stats=True, packed=packed)
    mod = advect_packed if packed else ref
    u2, v2 = mod.advect_velocity(u, v, DT, 1.2)
    assert torch.equal(got_uv[0], u2[rows]) and torch.equal(got_uv[1], v2[rows])
    assert torch.equal(st, ref.vel_max(got_uv[0], got_uv[1]))
    got_dye = advect_packed.window_plain(dye, u2[rows].contiguous(), v2[rows].contiguous(),
                                         DT, 1.2, "dye", win, packed=packed)
    assert torch.equal(got_dye, mod.advect_dye(dye, u2, v2, DT, 1.2)[rows])
    with pytest.raises(ValueError, match="starts at row 0"):
        ref.window_rows(win._replace(y0=-1))
    with pytest.raises(ValueError, match="outside the view"):
        ref.window_bilerp(dye, u[:hl], v[:hl], DT, win._replace(y_in=h - hl + 1))
