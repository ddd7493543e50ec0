"""The port's whole step against the NumPy oracle and the JAX package.

- North star twin (tests/test_northstar.py): cpu variant, 128², 500 orbit
  steps, field RMSE <= 1e-4 against ``oracle.OracleSim``.
- gpu variant against the JAX ref ``Simulation``, both started from the
  same state through ``interop``.  The gpu-reference parameters are
  chaotic (CLAUDE.md), so the multi-step comparison runs at mild
  parameters (vorticity 0.5, force 500) and the shipped parameters are
  compared over single steps.  Tolerance 1e-5 relative to each field's
  largest magnitude: the ops agree to float32 rounding (test_torch_ops_ref)
  and a few steps carry that along.
- Rendered frames (uint8) are equal.
- ``backend="cuda"`` without a card raises.
- ``make_step`` and ``make_batched_step`` (B = 1 and 2) call the same ops
  in the same order, with the same iteration counts and ``out=`` planes,
  over the kernels' namespaces in every branch of the step, and only the
  batched step uploads per-member scalars, once a step.
"""

import dataclasses
import types

import jax
import numpy as np
import pytest
import torch

from cudafluidsimulation_tpu import FluidConfig as JConfig
from cudafluidsimulation_tpu import Simulation as JSimulation
from cudafluidsimulation_tpu.utils import impulse as jimp
import oracle

from cudafluidsimulation_tpu_torch import FluidConfig, Simulation, interop
from cudafluidsimulation_tpu_torch.config import PALETTE
from cudafluidsimulation_tpu_torch.models import ensemble
from cudafluidsimulation_tpu_torch.models.pipelines import (make_batched_step, make_render,
                                                            make_step)
from cudafluidsimulation_tpu_torch.ops import backend, cuda_kernels, member_params
from cudafluidsimulation_tpu_torch.utils import impulse as timp

torch.set_num_threads(1)

RTOL = 1e-5
FIELDS = ("u", "v", "dye", "pressure", "vel_stats")


def _np_state(js):
    return {k: np.asarray(x) for k, x in js._asdict().items()}


def _timp(jstream):
    return timp.Impulse(*(torch.from_numpy(np.array(f)) for f in jstream))


def _assert_states_close(ts, js, rtol=RTOL):
    got, exp = interop.state_to_numpy(ts), _np_state(js)
    for name in FIELDS:
        scale = max(float(np.abs(exp[name]).max()), 1.0)
        np.testing.assert_allclose(got[name], exp[name], rtol=0,
                                   atol=rtol * scale, err_msg=name)
    for name in ("t", "press_time", "time_since_press", "mouse", "step"):
        np.testing.assert_array_equal(got[name], exp[name], err_msg=name)


def test_500_step_rmse_vs_cpu_reference_oracle():
    cfg = FluidConfig.cpu_reference(nx=128, ny=128, backend="ref")
    sim = Simulation(cfg)
    steps = 500
    imp = timp.orbit_impulse(steps, cfg.dt, center=(64.0, 64.0), radius=20.0,
                             omega=3.0)
    state = sim.init()
    orc = oracle.OracleSim(cfg, PALETTE)
    for i in range(steps):
        state = sim.step(state, timp.slice_step(imp, i))
        orc.step(imp.pos[i].numpy(), imp.last_pos[i].numpy(),
                 bool(imp.pressed[i]), float(imp.dt[i]))
    for name, got, exp in [("u", state.u, orc.u), ("v", state.v, orc.v),
                           ("dye", state.dye, orc.dye)]:
        rmse = float(np.sqrt(np.mean((got.numpy() - exp) ** 2)))
        assert rmse <= 1e-4, f"{name} rmse={rmse:.3e} (north-star bound 1e-4)"


def _pair(jcfg, warm_steps):
    """A JAX ref simulation, the port's twin, and a common start state made
    by ``warm_steps`` driven JAX steps."""
    jsim = JSimulation(jcfg)
    tsim = Simulation(interop.config_from_jax(jcfg))
    n = jcfg.nx
    warm = jimp.orbit_impulse(warm_steps, jcfg.dt, center=(n / 2, n / 2),
                              radius=n / 8, omega=3.0)
    js = jsim.run(jsim.init(), warm)
    return jsim, tsim, js, interop.state_from_numpy(_np_state(js))


@pytest.mark.parametrize("variant", ["gpu", "cpu"])
def test_mild_multistep_vs_jax_ref(variant):
    ctor = JConfig.gpu_reference if variant == "gpu" else JConfig.cpu_reference
    jcfg = ctor(nx=128, ny=128, backend="ref", vorticity=0.5, force_scale=500.0)
    jsim, tsim, js, ts = _pair(jcfg, 10)
    imp = jimp.orbit_impulse(6, jcfg.dt, center=(60.0, 70.0), radius=12.0,
                             omega=2.0, pressed_every=2)
    for i in range(6):
        js = jsim.step(js, jimp.slice_step(imp, i))
        ts = tsim.step(ts, timp.slice_step(_timp(imp), i))
    _assert_states_close(ts, js)


@pytest.mark.parametrize("pressed", [True, False])
def test_shipped_gpu_parameters_single_step_vs_jax_ref(pressed):
    jcfg = JConfig.gpu_reference(nx=128, ny=128, backend="ref", pressure_iters=40)
    jsim, tsim, js, ts = _pair(jcfg, 8)
    imp = jimp.single((70.0, 60.0), (66.5, 61.0), pressed, jcfg.dt)
    _assert_states_close(tsim.step(ts, _timp(imp)), jsim.step(js, imp))


def test_cpu_variant_with_dye_diffusion_vs_jax_ref():
    # the cpu variant with colour diffusion enabled runs diffuse_multi and
    # splat_cpu, a path the shipped presets leave out
    jcfg = JConfig.cpu_reference(nx=64, ny=64, backend="ref",
                                 color_diffusion_enabled=True)
    jsim, tsim, js, ts = _pair(jcfg, 4)
    imp = jimp.orbit_impulse(3, jcfg.dt, center=(30.0, 34.0), radius=6.0)
    js = jsim.run(js, imp)
    ts = tsim.run(ts, _timp(imp))
    _assert_states_close(ts, js)


def test_run_displacement_vs_jax_ref():
    jcfg = JConfig.gpu_reference(nx=64, ny=64, backend="ref", vorticity=0.5,
                                 force_scale=500.0)
    jsim, tsim, js, ts = _pair(jcfg, 3)
    imp = jimp.orbit_impulse(4, jcfg.dt, center=(32.0, 32.0), radius=8.0)
    jfinal, jdisp = jsim.run_displacement(js, imp)
    tfinal, tdisp = tsim.run_displacement(ts, _timp(imp))
    np.testing.assert_allclose(tdisp, jdisp, rtol=RTOL)
    _assert_states_close(tfinal, jfinal)


@pytest.mark.parametrize("since_press", [0.5, 9.0])  # bloom on / off
def test_render_frame_equals_jax(since_press):
    jcfg = JConfig.gpu_reference(nx=96, ny=64, backend="ref")
    jsim, tsim, js, _ = _pair(jcfg, 6)
    js = js._replace(time_since_press=jax.numpy.float32(since_press))
    ts = interop.state_from_numpy(_np_state(js))
    got = make_render(tsim.config, tsim.ops)(ts)
    exp = np.asarray(jsim.render_fn(js))
    assert got.dtype == torch.uint8 and got.shape == (4, 64, 96)
    np.testing.assert_array_equal(got.numpy(), exp)
    np.testing.assert_array_equal(tsim.render(ts), jsim.render(js))
    np.testing.assert_array_equal(tsim.render(ts, flip=False),
                                  jsim.render(js, flip=False))


def test_render_without_bloom_equals_jax():
    jcfg = JConfig.cpu_reference(nx=48, ny=40, backend="ref")
    jsim, tsim, js, ts = _pair(jcfg, 5)
    np.testing.assert_array_equal(tsim.render(ts), jsim.render(js))


@pytest.mark.parametrize("variant", ["gpu", "cpu"])
def test_kernel_namespace_on_cpu_tensors_equals_ref(variant):
    # the cuda backend's wrappers, given CPU tensors, take their plain
    # versions: the whole step through them equals the ref step exactly,
    # which pins that each wrapper takes the pipeline's arguments
    ctor = FluidConfig.gpu_reference if variant == "gpu" else FluidConfig.cpu_reference
    cfg = ctor(nx=48, ny=32, backend="ref")
    kern_step = make_step(cfg, backend._namespace(cuda_kernels.overrides(cfg)))
    ref_step = make_step(cfg)
    imp = timp.orbit_impulse(4, cfg.dt, center=(24.0, 16.0), radius=6.0)
    a = b = Simulation(cfg).init()
    for i in range(4):
        a = kern_step(a, timp.slice_step(imp, i))
        b = ref_step(b, timp.slice_step(imp, i))
    for name in a._fields:
        assert torch.equal(getattr(a, name), getattr(b, name)), name


def test_state_scalars_stay_on_host():
    cfg = FluidConfig.gpu_reference(nx=32, ny=32, backend="ref")
    sim = Simulation(cfg)
    s = sim.run(sim.init(), timp.orbit_impulse(3, cfg.dt, center=(16.0, 16.0),
                                               radius=4.0))
    for name in ("t", "press_time", "time_since_press", "mouse", "step"):
        assert getattr(s, name).device.type == "cpu"
    assert int(s.step) == 3 and s.step.dtype == torch.int32


def test_backend_cuda_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: backend='cuda' is valid here")
    cfg = FluidConfig.gpu_reference(nx=32, ny=32, backend="cuda")
    with pytest.raises(RuntimeError, match="CUDA device"):
        Simulation(cfg)
    with pytest.raises(RuntimeError, match="CUDA device"):
        backend.get_ops(cfg)
    with pytest.raises(RuntimeError, match="CUDA device"):
        Simulation(dataclasses.replace(cfg, backend="ref")).benchmark(steps=2)


BRANCHES = {
    "gpu": lambda: FluidConfig.gpu_reference(nx=32, ny=32, backend="ref"),
    "cpu": lambda: FluidConfig.cpu_reference(nx=32, ny=32, backend="ref"),
    "cpu_color": lambda: FluidConfig.cpu_reference(nx=32, ny=32, backend="ref",
                                                   color_diffusion_enabled=True),
    "cpu_no_diffusion": lambda: FluidConfig.cpu_reference(nx=32, ny=32, backend="ref",
                                                          diffusion_iters=0),
    "no_color": lambda: FluidConfig.gpu_reference(nx=32, ny=32, backend="ref",
                                                  color_diffusion_enabled=False),
    "no_diffusion": lambda: FluidConfig.gpu_reference(nx=32, ny=32, backend="ref",
                                                      diffusion_iters=0),
    "multigrid_fixed": lambda: FluidConfig.gpu_reference(nx=32, ny=32, backend="ref",
                                                         pressure_solver="multigrid"),
    "quality": lambda: FluidConfig.quality(nx=32, ny=32, backend="ref"),
    "fast": lambda: FluidConfig.gpu_reference(nx=32, ny=32, backend="ref", fast_dye=True,
                                              fast_velocity=True, fast_diffuse=True),
}


def _spied(ns, calls):
    """``ns`` with every op recording its call: its name, its int arguments
    (iteration counts, radii, rows), its keywords but ``params`` and its
    ``out=`` planes without a member axis.  The colour is left out: the
    single step takes it from the namespace, the batched one from
    ``cycle_color_batched``."""
    spy = types.SimpleNamespace()
    for name, fn in vars(ns).items():
        def op(*args, _fn=fn, _name=name, **kw):
            if _name != "cycle_color":
                out = kw.get("out")
                calls.append((_name,
                              tuple(a for a in list(args) + list(kw.values()) if type(a) is int),
                              tuple(sorted(k for k in kw if k != "params")),
                              None if out is None else tuple(out.shape[-3:])))
            return _fn(*args, **kw)

        setattr(spy, name, op)
    return spy


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_single_and_batched_steps_make_the_same_calls(branch, monkeypatch):
    cfg = BRANCHES[branch]()
    uploads = []
    upload = member_params.upload
    monkeypatch.setattr(member_params, "upload",
                        lambda *a, **k: (uploads.append(1), upload(*a, **k))[1])
    imp = timp.orbit_impulse(2, cfg.dt, center=(16.0, 16.0), radius=4.0, omega=3.0)
    seqs = {}
    calls = []
    step = make_step(cfg, _spied(backend.kernel_ops(cfg), calls))
    state = Simulation(cfg).init()
    for i in range(2):
        state = step(state, timp.slice_step(imp, i))
    seqs["single"] = calls
    assert not uploads, "the single step passes its scalars as launch arguments"
    for b in (1, 2):
        calls = []
        step = make_batched_step(cfg, _spied(backend.kernel_ops(cfg, batched=True), calls))
        state, bimp = ensemble.batched_state(cfg, b, device="cpu"), ensemble.batched_impulse(imp, b)
        for i in range(2):
            state = step(state, ensemble.step_of(bimp, i))
        seqs[f"B={b}"] = calls
    assert len(uploads) == 4, "one upload a batched step"
    assert seqs["single"] and seqs["B=1"] == seqs["single"] and seqs["B=2"] == seqs["single"]
