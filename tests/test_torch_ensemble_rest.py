"""Fast and multigrid ensembles on batched H5-H8, on the CPU.

Given CPU tensors the batched kernel wrappers run their plain versions
(``ops/advect_packed.py``, ``ops/fastdiffuse.py``, ``ops/multigrid.py``'s
``PLAIN_BATCHED``, ``ops/ref.py``); ``chip_smoke.py`` holds the CUDA
kernels against the same plain versions on the card.

- Against the JAX package: the fast ensemble (``fast_dye``,
  ``fast_velocity``, ``fast_diffuse``) through the kernel wrappers against
  ``make_ensemble_run`` of a pallas config, vmapped over the Pallas kernels
  in interpret mode; the fixed-cycle and residual-targeted (quality)
  multigrid ensembles and a quality viscosity sweep against the vmapped ref
  runs.  Tolerance 1e-5 of each field's scale: one fast step against JAX's
  (tests/test_torch_fast.py) and the ensembles (tests/test_torch_ensemble.py)
  hold the same; the ops agree to float32 rounding and a few steps carry it.
- Each member against its single run, bit for bit: fast, fixed-cycle,
  quality and the quality sweep, on the plain batched ops and through the
  wrappers.  The quality members stop at different V-cycle counts (counted
  on the single runs), so each member's own stopping is tested.
- The fast sweep's departure from the JAX package: a member whose viscosity
  or dt is not the config's raises ``ValueError`` before the first step.
- H8's quiet branch per member: one quiet and one driven member in one
  batched step equal their single steps.
- The batched kernels' member indexing (grid z walked beyond its extent,
  each operand at its member stride, the coarse planes at theirs),
  emulated with views of flat storage, bit-equal to the plain versions.
- The batched stopping loop: one read a test, each member's own result.
"""

import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudafluidsimulation_tpu import FluidConfig as JConfig
from cudafluidsimulation_tpu import Simulation as JSimulation
from cudafluidsimulation_tpu.models import ensemble as jens
from cudafluidsimulation_tpu.utils import impulse as jimp

from cudafluidsimulation_tpu_torch import FluidConfig, Simulation, interop
from cudafluidsimulation_tpu_torch.models import ensemble
from cudafluidsimulation_tpu_torch.models.pipelines import make_batched_step, make_step
from cudafluidsimulation_tpu_torch.ops import (
    advect_cuda, advect_packed, backend, cuda_kernels, fastdiffuse, fastdiffuse_cuda,
    jacobi_cuda, member_params, multigrid, multigrid_cuda, ref)
from cudafluidsimulation_tpu_torch.utils import impulse as timp

torch.set_num_threads(1)

RTOL = 1e-5
FIELDS = ("u", "v", "dye", "pressure", "vel_stats")
HOST = ("t", "press_time", "time_since_press", "mouse", "step")
FAST = dict(fast_dye=True, fast_velocity=True, fast_diffuse=True)
MG = {"quality": dict(pressure_solver="multigrid", mg_tol=0.05),
      "fixed": dict(pressure_solver="multigrid", mg_cycles=2)}
B, STEPS = 4, 4
DIFFS = np.asarray([0.1, 0.8, 1.4, 2.0], np.float32)
DT = np.float32(1 / 60)
KERNELS = (advect_cuda.PACKED_BATCHED, fastdiffuse_cuda.SEP_BATCHED,
           jacobi_cuda.STENCIL_BATCHED) + multigrid_cuda.KERNELS_BATCHED


@pytest.fixture
def launches():
    """The CPU path must not move the batched kernels' launch counts."""
    before = [k.launches for k in KERNELS]
    yield
    assert [k.launches for k in KERNELS] == before


def _np(tree):
    return {k: np.asarray(x) for k, x in tree._asdict().items()}


def _timp(jstream):
    return timp.Impulse(*(torch.from_numpy(np.array(f)) for f in jstream))


def _jitter(b=B):
    return np.linspace(-6, 6, b)[:, None] * np.ones((1, 2))


def _member_stream(bimp, i):
    return timp.Impulse(*(f[i] for f in bimp))


def _assert_close(ts, js):
    got, exp = interop.state_to_numpy(ts), _np(js)
    for name in FIELDS:
        scale = max(float(np.abs(exp[name]).max()), 1.0)
        np.testing.assert_allclose(got[name], exp[name], rtol=0, atol=RTOL * scale,
                                   err_msg=name)
    for name in HOST:
        np.testing.assert_array_equal(got[name], exp[name], err_msg=name)


def _assert_member(out, single, i):
    for name in single._fields:
        assert torch.equal(getattr(out, name)[i], getattr(single, name)), name


def _assert_equal(a, b):
    for name in a._fields:
        assert torch.equal(getattr(a, name), getattr(b, name)), name


def _wrappers(cfg):
    """The batched kernel wrappers' namespace (their plain versions here)."""
    return backend.batched_namespace(cuda_kernels.batched_overrides(cfg))


def _plain_fast(cfg):
    """The batched fast ops on the kernels' plain versions, on any device."""
    return backend.batched_namespace({
        "advect_velocity": functools.partial(advect_packed.advect_velocity_batched,
                                             fast_path=cfg.advect_fast_path),
        "advect_dye": functools.partial(advect_packed.advect_dye_batched,
                                        fast_path=cfg.advect_fast_path),
        **fastdiffuse.make_batched_ops(cfg, apply=fastdiffuse.sep_apply_batched)})


def _mg_cfg(kind, **kw):
    # tests/test_ensemble.py's cfg64() with multigrid pressure
    return FluidConfig.gpu_reference(nx=64, ny=64, backend="ref", diffusion_iters=4,
                                     vorticity=0.5, force_scale=500.0, **MG[kind], **kw)


# -- against the JAX package ---------------------------------------------------------


@pytest.fixture(scope="module")
def fast_pair():
    """JAX's vmapped fast ensemble on the pallas backend (interpret mode on
    the CPU) from a driven start: 8 exact steps, then STEPS fast ones."""
    kw = dict(nx=128, ny=64, pressure_iters=40, max_displacement=31)
    jref = JSimulation(JConfig.gpu_reference(backend="ref", **kw))
    js = jref.run(jref.init(), jimp.orbit_impulse(8, 1 / 60, center=(64.0, 32.0),
                                                  radius=10.0, omega=3.0))
    jcfg = JConfig.gpu_reference(backend="pallas", **kw, **FAST)
    state = jax.tree.map(lambda x: jnp.stack([x] * 3), js)
    bimp = jens.batched_impulse(jimp.orbit_impulse(3, 1 / 60, center=(64.0, 32.0),
                                                   radius=10.0, omega=3.0), 3,
                                jitter_pos=_jitter(3) * 0.5)
    return jcfg, _np(state), bimp, jens.make_ensemble_run(jcfg)(state, bimp)


def test_fast_ensemble_vs_pallas(fast_pair, launches):
    jcfg, jstate, bimp, jout = fast_pair
    cfg = dataclasses.replace(interop.config_from_jax(jcfg), backend="ref")
    assert fastdiffuse.make_batched_ops(cfg)  # the taps are granted: H7 runs
    state = interop.state_from_numpy(jstate)
    assert float(state.vel_stats.max()) * DT > 1.0  # driven: H8 rounds its taps
    out = ensemble.make_ensemble_run(cfg, _wrappers(cfg))(state, _timp(bimp))
    _assert_close(out, jout)


@pytest.fixture(scope="module")
def mg_jax_runs():
    cache = {}

    def get(kind, sweep):
        if (kind, sweep) not in cache:
            jcfg = JConfig.gpu_reference(nx=64, ny=64, backend="ref", diffusion_iters=4,
                                         vorticity=0.5, force_scale=500.0, **MG[kind])
            state = jens.batched_state(jcfg, B)
            bimp = jens.batched_impulse(jimp.orbit_impulse(STEPS, jcfg.dt, center=(32.0, 32.0),
                                                           radius=10.0), B, jitter_pos=_jitter())
            if sweep:
                out = jens.make_diffusion_sweep_run(jcfg)(jnp.asarray(DIFFS), state, bimp)
            else:
                out = jens.make_ensemble_run(jcfg)(state, bimp)
            cache[(kind, sweep)] = (jcfg, _np(state), bimp, out)
        return cache[(kind, sweep)]

    return get


@pytest.mark.parametrize("namespace", ["plain", "kernel wrappers"])
@pytest.mark.parametrize("kind,sweep", [("quality", False), ("fixed", False),
                                        ("quality", True)],
                         ids=["quality", "fixed", "quality_sweep"])
def test_multigrid_ensemble_vs_jax(mg_jax_runs, launches, kind, sweep, namespace):
    jcfg, jstate, bimp, jout = mg_jax_runs(kind, sweep)
    cfg = interop.config_from_jax(jcfg)
    ops = backend.get_batched_ops(cfg) if namespace == "plain" else _wrappers(cfg)
    state = interop.state_from_numpy(jstate)
    if sweep:
        out = ensemble.make_diffusion_sweep_run(cfg, ops)(DIFFS, state, _timp(bimp))
    else:
        out = ensemble.make_ensemble_run(cfg, ops)(state, _timp(bimp))
    _assert_close(out, jout)


# -- each member against its single run ------------------------------------------------


def counted_single_run(cfg, stream):
    """A single rollout on the kernel wrappers' CPU path and the V-cycles
    each step completed (fine-level post-smooths)."""
    h, w = cfg.shape
    done = []

    def count(name, fn):
        def call(*args, **kw):
            if (name == "prolong_smooth_project"
                    or name == "prolong_smooth" and tuple(args[0].shape) == (h, w)):
                done.append(1)
            return fn(*args, **kw)
        return call

    ends = types.SimpleNamespace(**{k: count(k, f) for k, f in vars(multigrid_cuda.ENDS).items()})
    ops = backend._namespace(cuda_kernels.overrides(cfg))
    ops.pressure_project_mg = functools.partial(multigrid.pressure_project_mg, ends=ends)
    step, state, cycles = make_step(cfg, ops), Simulation(cfg).init(), []
    for i in range(timp.num_steps(stream)):
        before = len(done)
        state = step(state, timp.slice_step(stream, i))
        cycles.append(len(done) - before)
    return state, cycles


@pytest.mark.parametrize("namespace", ["plain", "kernel wrappers"])
@pytest.mark.parametrize("kind", ["fast", "fixed", "quality", "quality_sweep"])
def test_members_equal_single_runs(launches, kind, namespace):
    if kind == "fast":
        cfg = FluidConfig.gpu_reference(nx=64, ny=64, backend="ref", pressure_iters=12, **FAST)
        ops = _plain_fast(cfg) if namespace == "plain" else _wrappers(cfg)
    else:
        cfg = _mg_cfg("fixed" if kind == "fixed" else "quality")
        ops = backend.get_batched_ops(cfg) if namespace == "plain" else _wrappers(cfg)
    bimp = ensemble.batched_impulse(timp.orbit_impulse(STEPS, cfg.dt, center=(32.0, 32.0),
                                                       radius=10.0), B, jitter_pos=_jitter())
    sweep = kind == "quality_sweep"
    start = ensemble.batched_state(cfg, B)
    if sweep:
        out = ensemble.make_diffusion_sweep_run(cfg, ops)(DIFFS, start, bimp)
    else:
        out = ensemble.make_ensemble_run(cfg, ops)(start, bimp)
    cycles = []
    for i in range(B):
        mcfg = dataclasses.replace(cfg, velocity_diffusion=float(DIFFS[i])) if sweep else cfg
        if kind == "fast":
            sim = Simulation(mcfg, ops=backend._namespace(cuda_kernels.overrides(mcfg)))
            single = sim.run(sim.init(), _member_stream(bimp, i))
        else:
            single, counts = counted_single_run(mcfg, _member_stream(bimp, i))
            sim = Simulation(mcfg)  # the ref backend's composition: the same run
            _assert_equal(single, sim.run(sim.init(), _member_stream(bimp, i)))
            cycles.append(counts)
        _assert_member(out, single, i)
    if kind == "fast":
        assert float(out.vel_stats.max()) * DT > 1.0  # the rounded branch ran
    elif kind == "fixed":
        assert all(c == [cfg.mg_cycles] * STEPS for c in cycles)
    else:
        # the members stop at different V-cycle counts in some step
        assert any(len({c[s] for c in cycles}) > 1 for s in range(STEPS)), cycles


@pytest.mark.parametrize("ends", ["PLAIN_BATCHED", "ENDS_BATCHED"])
@pytest.mark.parametrize("shape", [(64, 64), (32, 48), (12, 20)], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("kw", [dict(cycles=2), dict(cycles=2, tol=0.05),
                                dict(cycles=2, tol=0.3, max_cycles=3)],
                         ids=["fixed", "tol", "tol_capped"])
def test_pressure_project_mg_batched_members_equal_single(rng, launches, ends, shape, kw):
    # members of different amplitudes: their residuals cross tol after
    # different cycle counts (member 0 meets tol at its first probe for
    # "tol_capped", the largest hits max_cycles)
    scale = np.asarray([0.02, 2.0, 20.0, 200.0], np.float32)[:, None, None]
    u, v = (torch.from_numpy((rng.standard_normal((4,) + shape) * scale).astype(np.float32))
            for _ in range(2))
    pack = torch.stack([u, v], dim=1)  # u, v at a member stride of 2 planes
    ns = getattr(multigrid_cuda if ends == "ENDS_BATCHED" else multigrid, ends)
    got = multigrid.pressure_project_mg_batched(pack[:, 0], pack[:, 1], half=True,
                                                return_stats=True, ends=ns, **kw)
    for i in range(4):
        exp = multigrid.pressure_project_mg(u[i], v[i], half=True, return_stats=True,
                                            ends=multigrid_cuda.ENDS, **kw)
        for g, e in zip(got, exp):
            assert torch.equal(g[i], e)
    oracle = ref.pressure_project_mg_batched(u, v, kw["cycles"], tol=kw.get("tol", 0.0),
                                             max_cycles=kw.get("max_cycles", 8), half=True,
                                             return_stats=True)
    for g, e in zip(got, oracle):
        assert torch.equal(g, e)


def test_fast_members_take_their_own_quiet_branch(launches):
    # member 0 under one cell a step (quiet: the exact f32 advection), member
    # 1 driven (bf16 taps): one batched fast step equals each single step
    cfg = FluidConfig.gpu_reference(nx=48, ny=32, backend="ref", pressure_iters=12, **FAST)
    rng = np.random.default_rng(3)
    states = []
    for scale in (5.0, 300.0):
        u, v = (torch.from_numpy((rng.standard_normal(cfg.shape) * scale).astype(np.float32))
                for _ in range(2))
        states.append(Simulation(cfg).init()._replace(
            u=u, v=v, dye=torch.from_numpy(rng.random((3,) + cfg.shape).astype(np.float32)),
            vel_stats=ref.vel_max(u, v)))
    quiet = [bool((s.vel_stats * float(DT) < 1.0).all()) for s in states]
    assert quiet == [True, False]
    bstate = type(states[0])(*(torch.stack(list(f)) for f in zip(*states)))
    imp = timp.single((20.0, 16.0), (18.0, 15.0), True, cfg.dt)
    bimp = timp.Impulse(*(torch.stack([torch.as_tensor(f)] * 2) for f in imp))
    single_ops = backend._namespace(cuda_kernels.overrides(cfg))
    for ops in (_plain_fast(cfg), _wrappers(cfg)):
        out = make_batched_step(cfg, ops)(bstate, bimp)
        for i in range(2):
            _assert_member(out, make_step(cfg, single_ops)(states[i], imp), i)
    # the op itself: the quiet member's advection is H1's, the driven one's is not
    u, v, st = bstate.u, bstate.v, bstate.vel_stats
    got = advect_cuda.advect_velocity_batched(u, v, [DT, DT], 1.2, vel_stats=st, packed=True)
    exact = ref.advect_velocity_batched(u, v, [DT, DT], 1.2)
    assert torch.equal(got[0][0], exact[0][0]) and not torch.equal(got[0][1], exact[0][1])


# -- the fast sweep's departure ------------------------------------------------------


@pytest.mark.parametrize("case", ["viscosity", "dt", "nominal"])
def test_fast_diffuse_sweep_raises_before_the_first_step(case):
    cfg = FluidConfig.gpu_reference(nx=32, ny=32, backend="ref", vorticity=0.5,
                                    force_scale=500.0, pressure_iters=6, **FAST)
    ops, calls = _wrappers(cfg), []
    advect = ops.advect_velocity
    ops.advect_velocity = lambda *a, **k: calls.append(1) or advect(*a, **k)
    bimp = ensemble.batched_impulse(timp.orbit_impulse(2, cfg.dt, center=(16.0, 16.0),
                                                       radius=5.0), 3)
    diffs = np.full(3, cfg.velocity_diffusion, np.float32)
    if case == "viscosity":
        diffs[1] = 1.2
    elif case == "dt":
        bimp = bimp._replace(dt=bimp.dt.clone())
        bimp.dt[2, 1] = 1 / 30
    run = ensemble.make_diffusion_sweep_run(cfg, ops)
    if case == "nominal":
        out = run(diffs, ensemble.batched_state(cfg, 3), bimp)
        exp = ensemble.make_ensemble_run(cfg, ops)(ensemble.batched_state(cfg, 3), bimp)
        _assert_equal(out, exp)
        return
    with pytest.raises(ValueError, match="fast_diffuse sweep"):
        run(diffs, ensemble.batched_state(cfg, 3), bimp)
    assert not calls  # nothing ran


@pytest.mark.parametrize("op", ["diffuse", "diffuse_multi", "diffuse_multi_splat"])
def test_batched_fast_diffusion_ops_hold_members_to_the_nominal_values(rng, op):
    cfg = FluidConfig.gpu_reference(nx=32, ny=32, backend="ref", **FAST)
    ops = fastdiffuse.make_batched_ops(cfg, apply=fastdiffuse.sep_apply_batched)
    f = torch.from_numpy(rng.standard_normal((3, 5, 16, 24)).astype(np.float32))
    dt = np.full(3, np.float32(cfg.dt))
    co = np.full((3, 5), np.float32(0.8))
    amps, last = rng.uniform(-1, 1, (3, 5)).astype(np.float32), np.full((3, 2), 8.0, np.float32)
    call = {"diffuse": lambda d, c: ops["diffuse"](f[:, :2], d, c[:, 0], 20),
            "diffuse_multi": lambda d, c: ops["diffuse_multi"](f, d, c, 20),
            "diffuse_multi_splat": lambda d, c: ops["diffuse_multi_splat"](
                f, d, c, 20, amps, last, 400.0)}[op]
    out = call(dt, co)
    taps = fastdiffuse._design(cfg)
    for i in range(3):
        if op == "diffuse":
            exp = fastdiffuse.sep_apply(f[i, :2], np.broadcast_to(taps[2][:1], (2, 40)), taps[3])
        else:
            exp = fastdiffuse.sep_apply(f[i], taps[0], taps[1], None if op == "diffuse_multi"
                                        else (amps[i], last[i], 400.0))
        assert torch.equal(out[i], exp)
    bad = co.copy()
    bad[2, 0 if op == "diffuse" else 1] = 1.0
    with pytest.raises(ValueError, match="member 2"):
        call(dt, bad)
    bad_dt = dt.copy()
    bad_dt[1] = np.float32(1 / 30)
    with pytest.raises(ValueError, match="member 1"):
        call(bad_dt, co)


# -- the batched stopping loop -------------------------------------------------------


def test_batched_tol_loop_reads_once_a_test_and_keeps_stopped_members():
    # member i's probes have mean squared residuals res[i]; tol 0.75 (0.5625)
    res = [[4.0, 2.0, 1.0, 0.5, 0.1], [0.5, 0.4, 0.3, 0.2, 0.1], [4.0, 0.5, 0.1, 0.1, 0.1],
           [9.0, 9.0, 9.0, 9.0, 9.0]]
    reads, count = [], iter(range(10))

    def probe(q):
        k = next(count)
        return q + 1, torch.tensor([r[k] for r in res])[:, None, None].expand(4, 2, 2) ** 0.5

    def res_mean(r):
        reads.append(1)
        return multigrid.mean_square(r)

    p = multigrid.probed_tol_loop(probe, lambda q, r: q * 10, res_mean, None,
                                  probe(torch.zeros(4, 2, 2)), tol=0.75, max_cycles=3)
    assert len(reads) == 4  # three cycles completed (member 3 capped): 3 + 1 tests
    # member 0 stops after 3 cycles (probed 1111), 1 at once (1), 2 after one
    # cycle (11); 3 is capped and returns its third completed cycle (1110)
    assert [float(p[i, 0, 0]) for i in range(4)] == [1111.0, 1.0, 11.0, 1110.0]
    for i in range(4):
        single = iter(range(10))

        def probe1(q, i=i, single=single):
            return q + 1, torch.full((2, 2), res[i][next(single)] ** 0.5)

        exp = multigrid.probed_tol_loop(probe1, lambda q, r: q * 10, multigrid.mean_square,
                                        None, probe1(torch.zeros(2, 2)), tol=0.75, max_cycles=3)
        assert torch.equal(p[i], exp)


# -- the batched wrappers' CPU path --------------------------------------------------


def _mg_inputs(rng, b, h, w):
    t = lambda *s, scale=1.0: torch.from_numpy(  # noqa: E731
        (rng.standard_normal(s) * scale).astype(np.float32))
    pack = t(b, 5, h, w, scale=20.0)
    return dict(p=t(b, h, w, scale=5.0), rhs=t(b, h, w), u=pack[:, 0], v=pack[:, 1],
                e=t(b, h // 2, w // 2, scale=3.0))


def _ends_calls(x, s):
    """End name -> call on a namespace of ends (single ends for (H, W)
    inputs, batched ones for (B, H, W))."""
    p, rhs, u, v, e = x["p"], x["rhs"], x["u"], x["v"], x["e"]
    return {
        "smooth_damped": lambda ns: (ns.smooth_damped(p, rhs, s),),
        "smooth_damped_zero_plane": lambda ns: (ns.smooth_damped(None, rhs, s),),
        "smooth_res": lambda ns: ns.smooth_res(p, rhs, s),
        "smooth_res_from_zero": lambda ns: ns.smooth_res(rhs, rhs, s, from_zero=True),
        "first_smooth_res": lambda ns: ns.first_smooth_res(u, v, s, True),
        "last_smooth_project": lambda ns: ns.last_smooth_project(p, rhs, u, v, s,
                                                                 return_stats=True),
        "smooth_res_restrict": lambda ns: ns.smooth_res_restrict(p, rhs, s, return_res=True),
        "smooth_res_restrict_from_zero": lambda ns: ns.smooth_res_restrict(
            None, rhs, s, from_zero=True),
        "first_smooth_res_restrict": lambda ns: ns.first_smooth_res_restrict(u, v, s, False),
        "prolong_smooth": lambda ns: (ns.prolong_smooth(p, e, rhs, s),),
        "prolong_smooth_project": lambda ns: ns.prolong_smooth_project(p, e, rhs, u, v, s,
                                                                       return_stats=True),
        "divergence": lambda ns: (ns.divergence(u, v, True),),
        "project": lambda ns: ns.project(u, v, p, return_stats=True),
    }


END_NAMES = list(_ends_calls(_mg_inputs(np.random.default_rng(0), 1, 4, 4), 1))


@pytest.mark.parametrize("name", END_NAMES)
def test_batched_ends_equal_single_ends(rng, launches, name):
    # the wrappers (their plain versions here) and the plain batched ends:
    # member i equals the single plain end on member i
    x = _mg_inputs(rng, 3, 16, 24)
    got = _ends_calls(x, 3)[name](multigrid_cuda.ENDS_BATCHED)
    plain = _ends_calls(x, 3)[name](multigrid.PLAIN_BATCHED)
    assert len(got) == len(plain)
    for i in range(3):
        single = _ends_calls({k: t[i] for k, t in x.items()}, 3)[name](multigrid.PLAIN)
        for g, p_, e in zip(got, plain, single):
            assert torch.equal(g[i], e) and torch.equal(p_[i], e)


def test_sep_apply_batched_wrapper_on_cpu_tensors(rng, launches):
    alpha = 0.8 * 0.8 * 60.0
    taps, radii = fastdiffuse._taps_array([alpha] * 5, 20, 2e-4)
    f = torch.from_numpy(rng.standard_normal((3, 5, 20, 28)).astype(np.float32))
    amps = rng.uniform(-2, 2, (3, 5)).astype(np.float32)
    last = (rng.random((3, 2)) * 20).astype(np.float32)
    for splat in (None, (amps, last, 400.0)):
        got = fastdiffuse_cuda.sep_apply_batched(f, taps, radii, splat)
        for i in range(3):
            one = None if splat is None else (amps[i], last[i], 400.0)
            assert torch.equal(got[i], fastdiffuse.sep_apply(f[i], taps, radii, one))


@pytest.mark.parametrize("bad", ["channels", "dims", "vel_stats"])
def test_batched_fast_wrappers_refuse(bad):
    # meta tensors: neither CPU nor CUDA, refused before any launch
    m = lambda *s: torch.empty(s, device="meta")  # noqa: E731
    with pytest.raises(ValueError):
        if bad == "channels":
            fastdiffuse_cuda.sep_apply_batched(m(2, 6, 8, 8), np.zeros((6, 40), np.float32),
                                               (5, 4))
        elif bad == "dims":
            multigrid_cuda.prolong_smooth_batched(m(8, 8), m(4, 4), m(8, 8), 2)
        else:
            advect_cuda.advect_velocity_batched(torch.zeros(2, 8, 8), torch.zeros(2, 8, 8), DT,
                                                1.2, vel_stats=m(2, 2), packed=True)


# -- the batched kernels' member indexing, emulated ----------------------------------


def walk(nb, grid_z):
    """The members a launch visits, in order: block z takes z, z + grid_z,
    ... (``fluid_grid_z``: the grid's z extent stops at 65535)."""
    order = [b for bz in range(min(nb, grid_z)) for b in range(bz, nb, grid_z)]
    assert sorted(order) == list(range(nb))  # every member once
    return order


def at(storage, offset, shape):
    """The contiguous (…, H, W) array at ``offset`` floats of flat storage."""
    strides = [1]
    for n in reversed(shape[1:]):
        strides.insert(0, strides[0] * n)
    return storage.as_strided(tuple(shape), tuple(strides), offset)


GRID_Z = [jacobi_cuda.MAX_GRID_Z, 2, 1]


@pytest.mark.parametrize("grid_z", GRID_Z)
@pytest.mark.parametrize("name", END_NAMES)
def test_h5_h6_member_indexing_emulated(rng, name, grid_z):
    # fluid_mg_smooth, fluid_divergence and fluid_project over nb members:
    # u, v at b * u_ms, b * v_ms floats (planes of a (B, 5, H, W) pack); p,
    # rhs and every fine output at b * h * w; the coarse planes e_c and rhs_c
    # at b * (h/2) * (w/2); stats at 2b.  Each member, visited in the grid's
    # order, runs the single plain end on views of the flat storage.
    b_, h, w = 5, 16, 24
    x = _mg_inputs(rng, b_, h, w)
    exp = _ends_calls(x, 2)[name](multigrid.PLAIN_BATCHED)
    pack = x["u"]._base  # the (B, 5, H, W) pack the velocity planes lie in
    u_ms, hw, hwc = pack.stride(0), h * w, (h // 2) * (w // 2)
    outs = [torch.full((e.numel(),), float("nan")) for e in exp]
    for b in walk(b_, grid_z):
        member = dict(p=at(x["p"].reshape(-1), b * hw, (h, w)),
                      rhs=at(x["rhs"].reshape(-1), b * hw, (h, w)),
                      e=at(x["e"].reshape(-1), b * hwc, (h // 2, w // 2)),
                      u=at(pack.reshape(-1), b * u_ms, (h, w)),
                      v=at(pack.reshape(-1), b * u_ms + hw, (h, w)))
        for o, r in zip(outs, _ends_calls(member, 2)[name](multigrid.PLAIN)):
            o[b * r.numel():(b + 1) * r.numel()] = r.reshape(-1)  # hw, hwc or 2 floats
    for o, e in zip(outs, exp):
        assert torch.equal(o.reshape(e.shape), e)


@pytest.mark.parametrize("grid_z", GRID_Z)
@pytest.mark.parametrize("splat", [False, True])
def test_h7_plane_indexing_emulated(rng, splat, grid_z):
    # n = B x C planes; plane z: member z // C, channel z % C; its taps the
    # channel's row, its splat amp[ch] and centre from member row b of
    # [amp[0..C), lx, ly] (the step's diffuse_cols from column 2C on)
    b_, c, h, w = 4, 5, 12, 20
    taps, radii = fastdiffuse._taps_array([0.8 * 0.8 * 60.0] * c, 20, 2e-4)
    # a row of its own for each channel, so a plane that took another
    # channel's taps would show
    taps = (taps * np.linspace(1.0, 1.4, c, dtype=np.float32)[:, None]).astype(np.float32)
    f = torch.from_numpy(rng.standard_normal((b_, c, h, w)).astype(np.float32))
    amps = rng.uniform(-2, 2, (b_, c)).astype(np.float32)
    last = (rng.random((b_, 2)) * [w, h]).astype(np.float32)
    coeffs = np.full((b_, c), 0.8, np.float32)
    rows = member_params.diffuse_cols(np.full(b_, DT), coeffs, amps, last)[:, 2 * c:]
    planes = f.reshape(b_ * c, h, w)
    out = torch.full_like(planes, float("nan"))
    for z in walk(b_ * c, grid_z):
        b, ch = divmod(z, c)
        one = None if not splat else (rows[b, ch:ch + 1], rows[b, c:c + 2], 400.0)
        out[z] = fastdiffuse.sep_apply(planes[z][None], taps[ch:ch + 1], radii, one)[0]
    exp = fastdiffuse.sep_apply_batched(f, taps, radii, (amps, last, 400.0) if splat else None)
    assert torch.equal(out.reshape(b_, c, h, w), exp)


@pytest.mark.parametrize("grid_z", GRID_Z)
@pytest.mark.parametrize("dye", [False, True])
def test_h8_member_indexing_emulated(rng, dye, grid_z):
    # member b: its planes at b times each array's member stride (the
    # velocity from, the dye from and into, a (B, 5, H, W) pack), dt and
    # decay from row b of the step's parameters, its quiet branch from
    # bound[2b..2b+1] and its own dt
    b_, h, w = 5, 12, 20
    scale = np.asarray([5.0, 300.0, 5.0, 300.0, 40.0], np.float32)[:, None, None, None]
    pack = torch.from_numpy((rng.standard_normal((b_, 5, h, w)) * scale).astype(np.float32))
    u, v, flat, ms, hw = pack[:, 0], pack[:, 1], pack.reshape(-1), pack.stride(0), h * w
    dts = (DT * (1 + 0.5 * rng.random(b_))).astype(np.float32)
    rows = member_params.advect_cols(dts, 1.2)
    bound = torch.stack([ref.vel_max(u[i], v[i]) for i in range(b_)])
    quiet = [bool((bound[i] * float(dts[i]) < 1).all()) for i in range(b_)]
    assert any(quiet) and not all(quiet)
    out = torch.full((b_, 5, h, w), float("nan"))
    for b in walk(b_, grid_z):
        ub, vb = at(flat, b * ms, (h, w)), at(flat, b * ms + hw, (h, w))
        assert rows[b, 1] == np.float32(ref.decay_factor(rows[b, 0], 1.2))
        if dye:
            out[b, 2:] = advect_packed.advect_dye(at(flat, b * ms + 2 * hw, (3, h, w)), ub, vb,
                                                  rows[b, 0], 1.2, vel_stats=bound[b])
        else:
            out[b, 0], out[b, 1] = advect_packed.advect_velocity(ub, vb, rows[b, 0], 1.2,
                                                                 vel_stats=bound[b])
    if dye:
        exp = advect_cuda.advect_dye_batched(pack[:, 2:], u, v, dts, 1.2, vel_stats=bound,
                                             packed=True)
        assert torch.equal(out[:, 2:], exp)
    else:
        exp = advect_cuda.advect_velocity_batched(u, v, dts, 1.2, vel_stats=bound, packed=True)
        assert torch.equal(out[:, 0], exp[0]) and torch.equal(out[:, 1], exp[1])


# -- the stopping test's reduction -----------------------------------------------------


def _mean_square_in_numpy(r):
    """``fluid_mean_square``'s additions, written out in float32 numpy:
    per chunk, thread t adds the squares of cells t, t + 256, ... from 0;
    the threads' sums meet in a tree; then the chunk sums the same way."""
    def chunk_sums(x, per):
        n, block = x.shape[0], 256 * per
        out = []
        for c0 in range(0, n, block):
            acc = np.zeros(256, np.float32)
            for j in range(per):
                part = x[c0 + j * 256:c0 + (j + 1) * 256]
                acc[:part.shape[0]] = acc[:part.shape[0]] + part
            off = 128
            while off:
                acc[:off] = acc[:off] + acc[off:2 * off]
                off //= 2
            out.append(acc[0])
        return np.asarray(out, np.float32)

    sq = (r * r).reshape(-1)
    part = chunk_sums(sq, multigrid.MS_PER_THREAD)
    total = chunk_sums(part, -(-part.shape[0] // 256))[0]
    return np.float32(total / np.float32(sq.shape[0]))


@pytest.mark.parametrize("shape", [(3, 5), (64, 130), (96, 128)])
def test_mean_square_is_the_kernels_order(rng, shape):
    # one partial chunk; two chunks, the second partial; two whole ones
    r = (rng.standard_normal(shape) * 3).astype(np.float32)
    got = multigrid.mean_square(torch.from_numpy(r))
    assert got.dim() == 0 and got.numpy().tobytes() == _mean_square_in_numpy(r).tobytes()
    # a batch's members get their single planes' bits, on the plain and the
    # wrappers' path
    batch = torch.from_numpy(np.stack([r, 2 * r, r[::-1].copy()]))
    for fn in (multigrid.mean_square, multigrid_cuda.mean_square_batched):
        means = fn(batch)
        for i in range(3):
            assert torch.equal(means[i], multigrid_cuda.mean_square(batch[i]))
