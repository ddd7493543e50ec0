"""Ensembles in the port against the JAX package's vmapped ensembles.

- ``make_ensemble_run`` (with and without ``jitter_pos``) and
  ``make_diffusion_sweep_run`` against the JAX package's, both variants,
  from the same batched state carried across with ``interop``.  The JAX
  runs are ``vmap`` of the ref step; the tolerance is 1e-5 of each field's
  scale, the one the JAX package's own traced-coefficient test uses
  (tests/test_ensemble.py): the ops agree to float32 rounding and a few
  steps carry it along.  The parameters are ``cfg64()``'s mild ones.
- Every member of a port ensemble equals the port's single-member run of
  that member bit for bit: the batched step does the single step's host
  arithmetic on (B,) arrays in the same float32 order, and the batched
  plain ops run the single plain ops on each member.
- The batched plain ops against a loop of the single plain ops, and the
  batched kernel wrappers on CPU tensors (their plain versions) against
  them.
- H3's batched parameter rows (``ops/member_params.py``) read as the
  kernel reads them (plane z takes row z // C, a block walks z in strides
  of the grid's z extent), emulated on the CPU, bit-equal to the plain ops.
- Fast and multigrid ensembles build on ``ref``, and on ``cuda`` without
  a card they raise ``RuntimeError`` (tests/test_torch_ensemble_rest.py
  runs them through the kernel wrappers' CPU path).
- The runner's ``run_steps``, ``collect_frames`` and ``run_scan_render``
  against JAX's.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudafluidsimulation_tpu import FluidConfig as JConfig
from cudafluidsimulation_tpu import Simulation as JSimulation
from cudafluidsimulation_tpu.models import ensemble as jens
from cudafluidsimulation_tpu.models.simulation import run_scan_render as jrun_scan_render
from cudafluidsimulation_tpu.utils import impulse as jimp

from cudafluidsimulation_tpu_torch import FluidConfig, Simulation, interop
from cudafluidsimulation_tpu_torch.models import ensemble
from cudafluidsimulation_tpu_torch.models.pipelines import make_batched_step
from cudafluidsimulation_tpu_torch.models.simulation import run_scan_render
from cudafluidsimulation_tpu_torch.ops import (
    advect_cuda, backend, cuda_kernels, jacobi_cuda, member_params, ref)
from cudafluidsimulation_tpu_torch.utils import impulse as timp

torch.set_num_threads(1)

RTOL = 1e-5
FIELDS = ("u", "v", "dye", "pressure", "vel_stats")
HOST = ("t", "press_time", "time_since_press", "mouse", "step")
B, STEPS = 4, 8
DIFFS = (0.2, 0.8, 1.2, 2.0)
DT = np.float32(1 / 60)


def jcfg64(variant="gpu", **kw):
    # tests/test_ensemble.py's cfg64(); the cpu variant at the same mild
    # vorticity and force
    ctor = JConfig.gpu_reference if variant == "gpu" else JConfig.cpu_reference
    return ctor(nx=64, ny=64, backend="ref", diffusion_iters=4, pressure_iters=6,
                vorticity=0.5, force_scale=500.0, **kw)


def _np(tree):
    return {k: np.asarray(x) for k, x in tree._asdict().items()}


def _timp(jstream):
    return timp.Impulse(*(torch.from_numpy(np.array(f)) for f in jstream))


def _jitter(b=B):
    return np.linspace(-6, 6, b)[:, None] * np.ones((1, 2))


def _stream(cfg):
    return jimp.orbit_impulse(STEPS, cfg.dt, center=(32.0, 32.0), radius=10.0)


def _assert_close(ts, js):
    got, exp = interop.state_to_numpy(ts), _np(js)
    for name in FIELDS:
        scale = max(float(np.abs(exp[name]).max()), 1.0)
        np.testing.assert_allclose(got[name], exp[name], rtol=0, atol=RTOL * scale,
                                   err_msg=name)
    for name in HOST:
        np.testing.assert_array_equal(got[name], exp[name], err_msg=name)


def _assert_equal(a, b, i=None):
    for name in a._fields:
        x = getattr(a, name) if i is None else getattr(a, name)[i]
        assert torch.equal(x, getattr(b, name)), name


def _member_stream(bimp, i):
    return timp.Impulse(*(f[i] for f in bimp))


# the batched kernel wrappers of a parity configuration
WRAPPERS = cuda_kernels.batched_overrides(FluidConfig.gpu_reference(nx=32, ny=32, backend="ref"))


# -- against the JAX package ------------------------------------------------------


@pytest.fixture(scope="module")
def jax_runs():
    """JAX results by (variant, kind), computed once per module."""
    cache = {}

    def get(variant, kind):
        key = (variant, kind)
        if key not in cache:
            jcfg = jcfg64(variant)
            state = jens.batched_state(jcfg, B)
            jitter = _jitter() if kind == "jitter" else None
            bimp = jens.batched_impulse(_stream(jcfg), B, jitter_pos=jitter)
            if kind == "sweep":
                out = jens.make_diffusion_sweep_run(jcfg)(jnp.asarray(DIFFS), state, bimp)
            else:
                out = jens.make_ensemble_run(jcfg)(state, bimp)
            cache[key] = (jcfg, _np(state), bimp, out)
        return cache[key]

    return get


@pytest.mark.parametrize("variant", ["gpu", "cpu"])
@pytest.mark.parametrize("kind", ["plain", "jitter", "sweep"])
def test_ensemble_vs_jax(jax_runs, variant, kind):
    jcfg, jstate, bimp, jout = jax_runs(variant, kind)
    cfg = interop.config_from_jax(jcfg)
    state = interop.state_from_numpy(jstate)
    if kind == "sweep":
        out = ensemble.make_diffusion_sweep_run(cfg)(np.asarray(DIFFS, np.float32), state,
                                                     _timp(bimp))
    else:
        out = ensemble.make_ensemble_run(cfg)(state, _timp(bimp))
    _assert_close(out, jout)


@pytest.mark.parametrize("jitter", [False, True])
def test_batched_impulse_equals_jax(jitter):
    jcfg = jcfg64()
    j = _jitter() if jitter else None
    got = ensemble.batched_impulse(_timp(_stream(jcfg)), B, jitter_pos=j)
    exp = jens.batched_impulse(_stream(jcfg), B, jitter_pos=j)
    for g, e in zip(got, exp):
        np.testing.assert_array_equal(g.numpy(), np.asarray(e))
        assert g.device.type == "cpu"


def test_batched_state_equals_jax():
    jcfg = jcfg64()
    got = ensemble.batched_state(interop.config_from_jax(jcfg), 3)
    exp = _np(jens.batched_state(jcfg, 3))
    for name, x in interop.state_to_numpy(got).items():
        np.testing.assert_array_equal(x, exp[name], err_msg=name)
        assert x.dtype == exp[name].dtype, name
    assert all(getattr(got, n).device.type == "cpu" for n in HOST)


# -- each member against its single-member run -------------------------------------


def _port_cfg(variant, **kw):
    return interop.config_from_jax(jcfg64(variant, **kw))


@pytest.mark.parametrize("variant", ["gpu", "cpu"])
@pytest.mark.parametrize("kind", ["ensemble", "sweep"])
@pytest.mark.parametrize("namespace", ["ref", "kernel wrappers"])
def test_members_equal_single_runs(variant, kind, namespace):
    cfg = _port_cfg(variant)
    bimp = ensemble.batched_impulse(_timp(_stream(cfg)), B, jitter_pos=_jitter())
    diffs = np.asarray(DIFFS, np.float32) if kind == "sweep" else None
    # on CPU tensors the kernel wrappers take their plain versions
    ops = (backend.get_batched_ops(cfg) if namespace == "ref"
           else backend.batched_namespace(WRAPPERS))
    out = ensemble.run_batched(make_batched_step(cfg, ops, diffs),
                               ensemble.batched_state(cfg, B), bimp)
    for i in range(B):
        mcfg = cfg if diffs is None else dataclasses.replace(
            cfg, velocity_diffusion=float(diffs[i]))
        sim = Simulation(mcfg)
        _assert_equal(out, sim.run(sim.init(), _member_stream(bimp, i)), i)


@pytest.mark.parametrize("overrides", [
    dict(color_diffusion_enabled=False),
    dict(diffusion_iters=0),
    dict(variant="cpu", color_diffusion_enabled=True),
    dict(variant="cpu", color_diffusion_enabled=True, diffusion_iters=0),
])
def test_members_equal_single_runs_other_paths(overrides):
    # the step's other diffusion branches: velocity-only sweeps, no sweeps,
    # the cpu variant's 5-channel pack and its splat without sweeps
    cfg = dataclasses.replace(_port_cfg("gpu"), **overrides)
    bimp = ensemble.batched_impulse(_timp(_stream(cfg)), 3, jitter_pos=_jitter(3))
    diffs = np.asarray([0.3, 0.8, 1.7], np.float32)
    out = ensemble.make_diffusion_sweep_run(cfg)(diffs, ensemble.batched_state(cfg, 3), bimp)
    for i in range(3):
        sim = Simulation(dataclasses.replace(cfg, velocity_diffusion=float(diffs[i])))
        _assert_equal(out, sim.run(sim.init(), _member_stream(bimp, i)), i)


@pytest.mark.parametrize("preset", ["quality", "fixed multigrid", "fast"])
def test_ref_runs_every_configuration(preset):
    # multigrid (residual-targeted: each member its own V-cycles, as a
    # vmapped while-loop leaves a converged member alone) and the fast
    # flags, which ref ignores, run on the plain ops
    kw = {"quality": dict(pressure_solver="multigrid", mg_tol=0.05),
          "fixed multigrid": dict(pressure_solver="multigrid", mg_cycles=2),
          "fast": dict(fast_dye=True, fast_velocity=True, fast_diffuse=True)}[preset]
    cfg = FluidConfig.gpu_reference(nx=32, ny=32, backend="ref", vorticity=0.5,
                                    force_scale=500.0, **kw)
    imp = timp.orbit_impulse(3, cfg.dt, center=(16.0, 16.0), radius=5.0)
    bimp = ensemble.batched_impulse(imp, 3, jitter_pos=_jitter(3) / 2)
    out = ensemble.make_ensemble_run(cfg)(ensemble.batched_state(cfg, 3), bimp)
    for i in range(3):
        sim = Simulation(cfg)
        _assert_equal(out, sim.run(sim.init(), _member_stream(bimp, i)), i)


def test_vmapped_run_is_the_ensemble_run():
    cfg = _port_cfg("gpu")
    bimp = ensemble.batched_impulse(_timp(_stream(cfg)), 2, jitter_pos=_jitter(2))
    got = Simulation(cfg).vmapped_run()(ensemble.batched_state(cfg, 2), bimp)
    _assert_equal(got, ensemble.make_ensemble_run(cfg)(ensemble.batched_state(cfg, 2), bimp))


# -- the batched plain ops and the kernel wrappers' CPU path --------------------------


def _batch(rng, b=3, h=12, w=20):
    f = lambda *s, scale=1.0: torch.from_numpy((rng.standard_normal(s) * scale).astype(np.float32))
    return dict(
        u=f(b, h, w, scale=20.0), v=f(b, h, w, scale=20.0),
        dye=torch.from_numpy(rng.random((b, 3, h, w)).astype(np.float32)),
        pack=f(b, 5, h, w),
        dt=(DT * (1 + 0.2 * rng.random(b))).astype(np.float32),
        coeffs=rng.uniform(0.1, 2.0, (b, 5)).astype(np.float32),
        amps=rng.uniform(-3, 3, (b, 5)).astype(np.float32),
        cur=(rng.random((b, 2)) * [w, h]).astype(np.float32),
        last=(rng.random((b, 2)) * [w, h]).astype(np.float32),
        force=rng.uniform(0, 500, b).astype(np.float32),
        color=rng.random((b, 3)).astype(np.float32),
    )


def _mg_single(u, v):
    # the single step's multigrid projection on the plain ops
    p = ref.pressure_solve_mg(ref.divergence(u, v, False), 2, tol=0.05)
    u2, v2, st = ref.project(u, v, p, return_stats=True)
    return u2, v2, p, st


def _cases(x):
    """op name -> (batched call on ``ns``, single call on member i)."""
    u, v, dye, pack, dt, co, amps, cur, last = (x[k] for k in (
        "u", "v", "dye", "pack", "dt", "coeffs", "amps", "cur", "last"))
    force, color = x["force"], x["color"]
    return {
        "advect_velocity": (
            lambda ns: ns.advect_velocity(u, v, dt, 1.2, return_stats=True),
            lambda i: ref.advect_velocity(u[i], v[i], dt[i], 1.2, return_stats=True)),
        "advect_dye": (
            lambda ns: (ns.advect_dye(dye, u, v, dt, 1.2),),
            lambda i: (ref.advect_dye(dye[i], u[i], v[i], dt[i], 1.2),)),
        "vorticity_confinement_gpu": (
            lambda ns: ns.vorticity_confinement_gpu(u, v, dt, 50.0),
            lambda i: ref.vorticity_confinement_gpu(u[i], v[i], dt[i], 50.0)),
        "vorticity_confinement_cpu": (
            lambda ns: ns.vorticity_confinement_cpu(u, v, dt, 0.35),
            lambda i: ref.vorticity_confinement_cpu(u[i], v[i], dt[i], 0.35)),
        "diffuse": (
            lambda ns: (ns.diffuse(pack[:, :2], dt, co[:, 0], 5),),
            lambda i: (ref.diffuse(pack[i, :2], dt[i], co[i, 0], 5),)),
        "diffuse_multi": (
            lambda ns: (ns.diffuse_multi(pack, dt, co, 9),),
            lambda i: (ref.diffuse_multi(pack[i], dt[i], co[i], 9),)),
        "diffuse_multi_splat": (
            lambda ns: (ns.diffuse_multi_splat(pack, dt, co, 9, amps, last, 40.0),),
            lambda i: (ref.diffuse_multi_splat(pack[i], dt[i], co[i], 9, amps[i], last[i],
                                               40.0),)),
        "splat_cpu": (
            lambda ns: ns.splat_cpu(u, v, dye, cur, last, dt, force, 10.0, color),
            lambda i: ref.splat_cpu(u[i], v[i], dye[i], cur[i], last[i], dt[i], force[i],
                                    10.0, color[i])),
        "splat_gpu": (
            lambda ns: ns.splat_gpu(u, v, dye, cur, last, dt, force, 400.0, color),
            lambda i: ref.splat_gpu(u[i], v[i], dye[i], cur[i], last[i], dt[i], force[i],
                                    400.0, color[i])),
        "pressure_project": (
            lambda ns: ns.pressure_project(u, v, 12, True, return_stats=True),
            lambda i: ref.pressure_project(u[i], v[i], 12, True, return_stats=True)),
        "pressure_project_mg": (
            lambda ns: ns.pressure_project_mg(u, v, 2, tol=0.05, half=False,
                                              return_stats=True),
            lambda i: _mg_single(u[i], v[i])),
        "boundary_strip": (
            lambda ns: ns.boundary_strip(u, v, dye, 5),
            lambda i: ref.boundary_strip(u[i], v[i], dye[i], 5)),
    }


OP_NAMES = list(_cases(_batch(np.random.default_rng(0))))


@pytest.mark.parametrize("name", OP_NAMES)
def test_batched_plain_ops_equal_a_loop_of_single_ops(rng, name):
    x = _batch(rng)
    batched, single = _cases(x)[name]
    got = batched(backend.batched_namespace())
    for i in range(x["u"].shape[0]):
        exp = single(i)
        assert len(got) == len(exp)
        for g, e in zip(got, exp):
            assert torch.equal(g[i], e)


@pytest.mark.parametrize("name", [n for n in OP_NAMES if n in WRAPPERS])
def test_kernel_wrappers_on_cpu_tensors_equal_plain(rng, name):
    x = _batch(rng)
    batched, _ = _cases(x)[name]
    got = batched(backend.batched_namespace(WRAPPERS))
    for g, e in zip(got, batched(backend.batched_namespace())):
        assert torch.equal(g, e)


@pytest.mark.parametrize("into", ["dye", "confinement"])
def test_batched_out_into_a_pack(rng, into):
    # the step's (B, 5, H, W) pack: the dye advection writes channels 2-4,
    # the confinement 0-1, both through their out= (plain and wrappers)
    x = _batch(rng)
    for ns in (backend.batched_namespace(),
               backend.batched_namespace(WRAPPERS)):
        pack = torch.full_like(x["pack"], float("nan"))
        if into == "dye":
            got = ns.advect_dye(x["dye"], x["u"], x["v"], x["dt"], 1.2, out=pack[:, 2:])
            assert torch.equal(got, ns.advect_dye(x["dye"], x["u"], x["v"], x["dt"], 1.2))
            assert torch.equal(pack[:, 2:], got) and pack[:, :2].isnan().all()
        else:
            got = ns.vorticity_confinement_gpu(x["u"], x["v"], x["dt"], 50.0, out=pack[:, :2])
            exp = ns.vorticity_confinement_gpu(x["u"], x["v"], x["dt"], 50.0)
            assert all(torch.equal(g, e) for g, e in zip(got, exp))
            assert pack[:, 2:].isnan().all()


@pytest.mark.parametrize("bad", ["shape", "dtype", "planes", "overlap"])
def test_batched_out_contract(bad):
    # meta tensors: the wrappers check out= before they choose a device
    b, h, w = 2, 8, 12
    u = torch.empty((b, h, w), device="meta")
    dye = torch.empty((b, 3, h, w), device="meta")
    pack = torch.empty((b, 5, h, w), device="meta")
    out = {"shape": pack[:, 1:], "dtype": pack.to(torch.float64)[:, 2:],
           "planes": torch.empty((b, 3, w, h), device="meta").transpose(2, 3),
           "overlap": dye}[bad]
    err = TypeError if bad == "dtype" else ValueError
    with pytest.raises(err, match="out"):
        advect_cuda.advect_dye_batched(dye, u, u, DT, 1.2, out=out)
    cout = {"shape": pack[:, :3], "dtype": pack.to(torch.float64)[:, :2],
            "planes": torch.empty((b, 2, w, h), device="meta").transpose(2, 3),
            "overlap": u.unsqueeze(1).expand(b, 2, h, w)}[bad]
    with pytest.raises(err, match="out"):
        jacobi_cuda.vorticity_confinement_batched(u, u, DT, 50.0, out=cout)


# -- H3's parameter rows, emulated on the CPU --------------------------------------


def test_member_param_columns_equal_the_single_scalars(rng):
    x = _batch(rng, b=5)
    rows = member_params.advect_cols(x["dt"], 1.2)
    d = member_params.diffuse_cols(x["dt"], x["coeffs"], x["amps"], x["last"])
    assert rows.dtype == d.dtype == np.float32 and d.shape == (5, 3 * 5 + 2)
    for i in range(5):
        assert rows[i, 0] == x["dt"][i]
        assert rows[i, 1] == np.float32(ref.decay_factor(x["dt"][i], 1.2))
        alpha, inv_beta = ref.diffusion_alphas(x["dt"][i], x["coeffs"][i])
        np.testing.assert_array_equal(d[i, :5], alpha)
        np.testing.assert_array_equal(d[i, 5:10], inv_beta)
        np.testing.assert_array_equal(d[i, 10:15], x["amps"][i])
        np.testing.assert_array_equal(d[i, 15:], x["last"][i])
    assert member_params.upload(rows, "cpu") is None


def emulate_h3(fields, rows, iters, splat, radius, grid_z):
    """csrc/diffuse.cu over (B, C, H, W) ``fields``: plane z = b*C + ch,
    visited by the block of grid z z % grid_z (each block walks z, z +
    grid_z, ...); its alpha, 1/beta and amp are row b's columns ch, C + ch,
    2C + ch, the splat centre its columns 3C, 3C + 1."""
    n, c, h, w = fields.shape
    planes = fields.reshape(n * c, h, w)
    out = torch.full_like(planes, float("nan"))
    seen = []
    for bz in range(min(n * c, grid_z)):
        for z in range(bz, n * c, grid_z):
            b, ch = divmod(z, c)
            row = rows[b]
            x = planes[z]
            for _ in range(iters):
                l, r, bo, t = ref.neighbors(x)
                x = (l + r + bo + t + x * float(row[ch])) * float(row[c + ch])
            if splat:
                x = x + float(row[2 * c + ch]) * ref._gaussian(x, row[3 * c:3 * c + 2], radius)
            out[z] = x
            seen.append(z)
    assert sorted(seen) == list(range(n * c))  # every plane once
    return out.reshape(n, c, h, w)


@pytest.mark.parametrize("grid_z", [jacobi_cuda.MAX_GRID_Z, 7, 1])
@pytest.mark.parametrize("splat", [False, True])
def test_h3_rows_emulated_equal_plain(rng, splat, grid_z):
    # 4 members x 5 channels = 20 planes, more than the 8 a by-value call
    # takes; a grid z extent below the plane count makes blocks walk z
    x = _batch(rng, b=4)
    rows = member_params.diffuse_cols(x["dt"], x["coeffs"],
                                      x["amps"] if splat else None,
                                      x["last"] if splat else None)
    got = emulate_h3(x["pack"], rows, 9, splat, 40.0, grid_z)
    if splat:
        exp = ref.diffuse_multi_splat_batched(x["pack"], x["dt"], x["coeffs"], 9,
                                              x["amps"], x["last"], 40.0)
    else:
        exp = ref.diffuse_multi_batched(x["pack"], x["dt"], x["coeffs"], 9)
    assert torch.equal(got, exp)


def test_h3_takes_more_than_eight_planes_on_one_call(rng):
    # JAX's diffuse_multi takes any C; the single wrapper's plain path does too
    f = torch.from_numpy(rng.standard_normal((11, 8, 8)).astype(np.float32))
    coeffs = np.linspace(0.2, 1.5, 11).astype(np.float32)
    assert torch.equal(jacobi_cuda.diffuse_multi(f, DT, coeffs, 5),
                       ref.diffuse_multi(f, DT, coeffs, 5))


# -- fast and multigrid ensembles on both backends -----------------------------------


@pytest.mark.parametrize("kw", [
    dict(fast_dye=True), dict(fast_velocity=True), dict(fast_diffuse=True),
    dict(pressure_solver="multigrid"), dict(pressure_solver="multigrid", mg_tol=0.05),
], ids=["fast_dye", "fast_velocity", "fast_diffuse", "multigrid", "quality"])
@pytest.mark.parametrize("make", ["ensemble", "sweep"])
def test_fast_and_multigrid_ensembles_on_cuda_raise(kw, make):
    # every configuration builds on ref; on cuda it needs a card (with one,
    # it runs on the batched kernels: chip_smoke.py)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: backend='cuda' is valid here")
    cfg = FluidConfig.gpu_reference(nx=32, ny=32, backend="cuda", **kw)
    fn = ensemble.make_ensemble_run if make == "ensemble" else ensemble.make_diffusion_sweep_run
    with pytest.raises(RuntimeError, match="CUDA device"):
        fn(cfg)
    fn(dataclasses.replace(cfg, backend="ref"))


def test_batched_cuda_config_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: backend='cuda' is valid here")
    with pytest.raises(RuntimeError, match="CUDA device"):
        ensemble.make_ensemble_run(FluidConfig.gpu_reference(nx=32, ny=32, backend="cuda"))
    with pytest.raises(RuntimeError, match="CUDA device"):
        ensemble.batched_state(FluidConfig.gpu_reference(nx=32, ny=32), 2)


# -- the runner's leftovers against JAX ----------------------------------------------


@pytest.fixture(scope="module")
def runner_pair():
    jcfg = jcfg64()
    jsim = JSimulation(jcfg)
    js = jsim.run(jsim.init(), jimp.orbit_impulse(4, jcfg.dt, center=(32.0, 32.0),
                                                  radius=10.0))
    return jsim, Simulation(interop.config_from_jax(jcfg)), js


def _frames_close(got, exp):
    # frames quantise fields that agree to float32 rounding: a level at most
    got, exp = np.asarray(got, np.int16), np.asarray(exp, np.int16)
    assert got.shape == exp.shape
    assert np.abs(got - exp).max() <= 1 and (got != exp).mean() < 1e-3


def test_run_steps_vs_jax(runner_pair):
    jsim, tsim, js = runner_pair
    _assert_close(tsim.run_steps(interop.state_from_numpy(_np(js)), 5), jsim.run_steps(js, 5))


@pytest.mark.parametrize("every", [1, 3])
def test_collect_frames_vs_jax(runner_pair, every):
    jsim, tsim, js = runner_pair
    imp = jimp.orbit_impulse(7, jsim.config.dt, center=(30.0, 34.0), radius=8.0)
    tstate, tframes = tsim.collect_frames(interop.state_from_numpy(_np(js)), _timp(imp),
                                          every=every)
    jstate, jframes = jsim.collect_frames(js, imp, every=every)
    assert tframes.dtype == np.uint8 and tframes.shape == (-(-7 // every), 64, 64, 4)
    _frames_close(tframes, jframes)
    _assert_close(tstate, jstate)


def test_run_scan_render_vs_jax(runner_pair):
    jsim, tsim, js = runner_pair
    imp = jimp.orbit_impulse(5, jsim.config.dt, center=(30.0, 34.0), radius=8.0)
    tstate, tframes = run_scan_render(tsim.step_fn, tsim.render_fn,
                                      interop.state_from_numpy(_np(js)), _timp(imp))
    jstate, jframes = jrun_scan_render(jsim.step_fn, jsim.render_fn, js, imp)
    assert tframes.dtype == torch.uint8 and tframes.shape == (5, 4, 64, 64)
    _frames_close(tframes.numpy(), jframes)
    _assert_close(tstate, jstate)
