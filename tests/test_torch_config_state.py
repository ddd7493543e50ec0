"""The PyTorch/CUDA port's skeleton against the JAX package: config fields,
defaults and presets, the initial state, the impulse streams and the
interop round trip.  Everything here is exact: the same values, no
tolerance."""

import dataclasses

import numpy as np
import pytest
import torch

from cudafluidsimulation_tpu import FluidConfig as JConfig
from cudafluidsimulation_tpu import Simulation as JSimulation
from cudafluidsimulation_tpu.state import init_state as j_init_state
from cudafluidsimulation_tpu.utils import impulse as jimp

from cudafluidsimulation_tpu_torch import FluidConfig, Simulation, interop
from cudafluidsimulation_tpu_torch.config import PALETTE
from cudafluidsimulation_tpu_torch.ops.backend import get_ops
from cudafluidsimulation_tpu_torch.state import FluidState, init_state
from cudafluidsimulation_tpu_torch.utils import impulse as timp

torch.set_num_threads(1)

PRESETS = {
    "default": ((), {}),
    "cpu_reference": (("cpu_reference",), {}),
    "gpu_reference": (("gpu_reference",), {}),
    "quality": (("quality",), {}),
    "gpu_2048_parity": (("gpu_reference",),
                        dict(nx=2048, ny=2048, pressure_iters=40,
                             max_displacement=31)),
    "cpu_64": (("cpu_reference",), dict(nx=64, ny=48)),
}


def _make(cls, preset):
    (ctor, kw) = PRESETS[preset]
    return getattr(cls, ctor[0])(**kw) if ctor else cls(**kw)


def test_field_names_and_defaults_match():
    jf = dataclasses.fields(JConfig)
    tf = dataclasses.fields(FluidConfig)
    assert [f.name for f in tf] == [f.name for f in jf]
    for a, b in zip(tf, jf):
        assert a.type == b.type, a.name
        assert a.default == b.default, a.name


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_presets_match_field_by_field(preset):
    jc, tc = _make(JConfig, preset), _make(FluidConfig, preset)
    for f in dataclasses.fields(JConfig):
        assert getattr(tc, f.name) == getattr(jc, f.name), f.name
    assert tc.shape == jc.shape
    np.testing.assert_array_equal(tc.palette_array(), jc.palette_array())


def test_palette_matches():
    from cudafluidsimulation_tpu.config import PALETTE as JPALETTE

    assert PALETTE == JPALETTE


def test_backend_values():
    for b in ("ref", "cuda", "auto"):
        FluidConfig(backend=b)
    with pytest.raises(ValueError):
        FluidConfig(backend="pallas")
    assert FluidConfig(backend="ref").resolve_backend() == "ref"
    if torch.cuda.is_available():
        assert FluidConfig().resolve_backend() == "cuda"
    else:
        # the default never falls back to the plain ops on the CPU unasked
        for b in ("auto", "cuda"):
            with pytest.raises(RuntimeError, match="backend='ref'"):
                FluidConfig(backend=b).resolve_backend()
        with pytest.raises(RuntimeError, match="CUDA device"):
            Simulation(FluidConfig(nx=16, ny=16))


@pytest.mark.parametrize("bad", [dict(variant="x"), dict(pressure_solver="sor"),
                                 dict(diffusion_iters=-1), dict(mg_cycles=0),
                                 dict(mg_tol=-1.0), dict(max_displacement=0)])
def test_validation_matches(bad):
    with pytest.raises(ValueError):
        JConfig(**bad)
    with pytest.raises(ValueError):
        FluidConfig(**bad)


FAST_FLAGS = [dict(fast_dye=True), dict(fast_velocity=True), dict(fast_diffuse=True)]
FAST_IDS = ["fast_dye", "fast_velocity", "fast_diffuse"]


def _driven(cfg):
    """A state after 8 driven orbit steps on the exact ref ops, and the
    next step's impulse."""
    sim = Simulation(dataclasses.replace(cfg, fast_dye=False, fast_velocity=False,
                                         fast_diffuse=False, backend="ref"))
    imp = timp.orbit_impulse(9, cfg.dt, center=(16.0, 16.0), radius=8.0, omega=3.0)
    state = sim.run(sim.init(), timp.Impulse(*(f[:8] for f in imp)))
    return sim, state, timp.slice_step(imp, 8)


@pytest.mark.parametrize("kw", FAST_FLAGS, ids=FAST_IDS)
def test_fast_flags_ignored_on_ref(kw):
    # backend="ref" runs the plain ref ops whatever the fast_* flags say,
    # as the JAX package's ref backend does
    cfg = FluidConfig.gpu_reference(nx=32, ny=32, backend="ref", **kw)
    exact_sim, state, imp = _driven(cfg)
    got, exp = Simulation(cfg).step(state, imp), exact_sim.step(state, imp)
    for name in got._fields:
        assert torch.equal(getattr(got, name), getattr(exp, name)), name


@pytest.mark.parametrize("kw", FAST_FLAGS, ids=FAST_IDS)
def test_fast_flags_engage_on_kernel_namespace(kw):
    # the cuda backend's namespace, given CPU tensors, runs the fast ops'
    # plain versions: the step differs from the exact one
    from cudafluidsimulation_tpu_torch.models.pipelines import make_step
    from cudafluidsimulation_tpu_torch.ops import backend, cuda_kernels, jacobi_cuda

    cfg = FluidConfig.gpu_reference(nx=32, ny=32, backend="ref", **kw)
    ns = backend._namespace(cuda_kernels.overrides(cfg))
    assert ns.advect_velocity.keywords["packed"] is cfg.fast_velocity
    assert ns.advect_dye.keywords["packed"] is cfg.fast_dye
    assert ns.advect_dye.keywords["fast_path"] is cfg.advect_fast_path
    assert (ns.diffuse_multi_splat is not jacobi_cuda.diffuse_multi_splat) == cfg.fast_diffuse
    exact_sim, state, imp = _driven(cfg)
    assert float(state.vel_stats.max()) * cfg.dt > 1.0  # the packed branch
    got, exp = make_step(cfg, ns)(state, imp), exact_sim.step(state, imp)
    for name in ("u", "v", "dye", "pressure", "vel_stats"):
        assert bool(torch.isfinite(getattr(got, name)).all()), name
    changed = "u" if kw != dict(fast_dye=True) else "dye"
    assert not torch.equal(getattr(got, changed), getattr(exp, changed))


def test_fast_step_on_cpu_tensors_launches_nothing():
    from cudafluidsimulation_tpu_torch.models.pipelines import make_step
    from cudafluidsimulation_tpu_torch.ops import (
        advect_cuda, backend, cuda_kernels, fastdiffuse_cuda, jacobi_cuda,
        multigrid_cuda)

    kernels = (advect_cuda.KERNEL, advect_cuda.PACKED, fastdiffuse_cuda.SEP,
               jacobi_cuda.VORTICITY, jacobi_cuda.DIFFUSE, jacobi_cuda.PRESSURE,
               jacobi_cuda.PRESSURE_SOLVE, jacobi_cuda.STENCIL) + multigrid_cuda.KERNELS
    cfg = FluidConfig.gpu_reference(nx=32, ny=32, backend="ref", fast_dye=True,
                                    fast_velocity=True, fast_diffuse=True)
    _, state, imp = _driven(cfg)
    before = [k.launches for k in kernels]
    make_step(cfg, backend._namespace(cuda_kernels.overrides(cfg)))(state, imp)
    assert [k.launches for k in kernels] == before


def _step_once(cfg):
    sim = Simulation(cfg)
    state = sim.step(sim.init(), timp.single((16.0, 16.0), (14.0, 15.0), True,
                                             cfg.dt))
    assert int(state.step) == 1
    for name in ("u", "v", "dye", "pressure", "vel_stats"):
        assert bool(torch.isfinite(getattr(state, name)).all()), name
    return state


@pytest.mark.parametrize("kw", [dict(pressure_solver="multigrid"),
                                dict(pressure_solver="multigrid", mg_tol=0.05),
                                dict(pressure_solver="multigrid", mg_cycles=1)])
def test_multigrid_paths_step_on_ref(kw):
    cfg = FluidConfig.gpu_reference(nx=32, ny=32, backend="ref", **kw)
    assert get_ops(cfg).pressure_solve_mg is not None
    _step_once(cfg)


@pytest.mark.parametrize("fine", [32, 16])  # two levels; one level
def test_quality_preset_steps_on_ref(fine):
    state = _step_once(FluidConfig.quality(nx=fine, ny=fine, backend="ref"))
    assert float(state.pressure.abs().max()) > 0.0


@pytest.mark.parametrize("preset", ["cpu_64", "gpu_reference"])
def test_init_state_shapes_and_dtypes(preset):
    js = j_init_state(_make(JConfig, preset))
    ts = init_state(_make(FluidConfig, preset), device="cpu")
    assert ts._fields == js._fields
    for name in FluidState._fields:
        a, b = np.asarray(getattr(js, name)), getattr(ts, name).numpy()
        assert b.shape == a.shape, name
        assert b.dtype == a.dtype, name
        np.testing.assert_array_equal(b, a, err_msg=name)


def _impulses(mod):
    dt = 1 / 60
    return {
        "none": mod.no_impulse(7, dt),
        "constant": mod.constant_impulse(5, dt, (3.5, 4.25)),
        "constant_drag": mod.constant_impulse(5, dt, (3.5, 4.25), (1.0, 2.0),
                                              pressed=False),
        "orbit": mod.orbit_impulse(50, dt, center=(64.0, 64.0), radius=20.0,
                                   omega=3.0),
        "orbit_2048": mod.orbit_impulse(200, dt, center=(1024.0, 1024.0),
                                        radius=256.0, omega=3.0),
        "orbit_sparse": mod.orbit_impulse(9, 0.02, center=(10.0, 5.0),
                                          radius=3.0, pressed_every=3),
    }


@pytest.mark.parametrize("kind", sorted(_impulses(timp)))
def test_impulse_streams_equal(kind):
    j, t = _impulses(jimp)[kind], _impulses(timp)[kind]
    for a, b in zip(j, t):
        a = np.asarray(a)
        b = b.numpy()
        assert b.dtype == a.dtype
        np.testing.assert_array_equal(b, a)
    assert timp.num_steps(t) == jimp.num_steps(j)
    for i in (0, timp.num_steps(t) - 1):
        for a, b in zip(jimp.slice_step(j, i), timp.slice_step(t, i)):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_single_impulse_equal():
    j = jimp.single((1.5, 2.5), (1.0, 2.0), True, 0.02)
    t = timp.single((1.5, 2.5), (1.0, 2.0), True, 0.02)
    for a, b in zip(j, t):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("variant", ["cpu", "gpu"])
def test_mouse_to_grid_equal(variant):
    for mx, my in [(0.0, 0.0), (100.0, 300.0), (1919.0, 1079.0)]:
        assert (timp.mouse_to_grid(mx, my, (1920, 1080), (960, 540), variant)
                == jimp.mouse_to_grid(mx, my, (1920, 1080), (960, 540), variant))


def test_config_from_jax_maps_pallas_to_cuda():
    jc = JConfig.gpu_reference(nx=64, ny=32, backend="pallas", vorticity=3.0)
    tc = interop.config_from_jax(jc)
    assert tc.backend == "cuda"
    kw = dataclasses.asdict(tc)
    kw["backend"] = "pallas"
    assert kw == dataclasses.asdict(jc)
    assert interop.config_from_jax(JConfig(backend="ref")) == FluidConfig(backend="ref")


def test_interop_round_trip_exact():
    cfg = JConfig.gpu_reference(nx=32, ny=24, backend="ref",
                                diffusion_iters=2, pressure_iters=3)
    sim = JSimulation(cfg)
    imp = jimp.orbit_impulse(3, cfg.dt, center=(16.0, 12.0), radius=4.0)
    js = sim.run(sim.init(), imp)
    arrays = {k: np.asarray(x) for k, x in js._asdict().items()}
    ts = interop.state_from_numpy(arrays)
    back = interop.state_to_numpy(ts)
    for name in FluidState._fields:
        assert getattr(ts, name).dtype == {"step": torch.int32}.get(name, torch.float32)
        assert back[name].dtype == arrays[name].dtype, name
        np.testing.assert_array_equal(back[name], arrays[name], err_msg=name)
    # the port's state is a copy: changing it leaves the source alone
    ts.u.add_(1.0)
    np.testing.assert_array_equal(np.asarray(js.u), arrays["u"])
