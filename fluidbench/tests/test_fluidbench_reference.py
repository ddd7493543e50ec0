"""The frozen reference against the port's plain ops (``backend="ref"``)
on the CPU: the same step and render, bit for bit, at 64^2 and 96x54."""

import dataclasses

import numpy as np
import pytest
import torch

from cudafluidsimulation_tpu_torch import FluidConfig, Simulation, orbit_impulse
from cudafluidsimulation_tpu_torch.utils.impulse import slice_step
from fluidbench.reference import step as ref

FIELDS = ("u", "v", "dye", "pressure", "vel_stats")


def _fluid(cfg):
    d = dataclasses.asdict(cfg)
    d.pop("backend")
    return d


@pytest.mark.parametrize("nx, ny, iters", [(64, 64, 40), (96, 54, 30)])
def test_steps_and_renders_equal_the_port_plain_ops(nx, ny, iters):
    cfg = FluidConfig.gpu_reference(nx=nx, ny=ny, pressure_iters=iters, backend="ref")
    sim = Simulation(cfg)
    p = ref.Params.from_fluid(_fluid(cfg))
    # pressed on even steps only: both branches of the host scalars
    imp = orbit_impulse(8, cfg.dt, center=(nx / 2 + 1.5, ny / 2 - 2), radius=ny / 8,
                        omega=3.0, pressed_every=2)
    a, r = sim.init(), ref.init(p, "cpu")
    for i in range(8):
        im = slice_step(imp, i)
        a = sim.step(a, im)
        r = ref.step(p, r, ref.Impulse(tuple(im.pos.tolist()), tuple(im.last_pos.tolist()),
                                       bool(im.pressed), float(im.dt)))
        for f in FIELDS:
            assert torch.equal(getattr(a, f), getattr(r, f)), (i, f)
        assert (float(a.t), float(a.press_time), float(a.time_since_press), int(a.step)) == (
            r.t, r.press_time, r.time_since_press, r.step)
        np.testing.assert_array_equal(a.mouse.numpy(), r.mouse)
    np.testing.assert_array_equal(sim.render(a), ref.render(p, r).numpy())
    assert float(a.dye.abs().max()) > 0.1  # the splat put dye in


def test_render_without_bloom_packs_the_dye():
    cfg = FluidConfig.gpu_reference(nx=32, ny=24, backend="ref", bloom_enabled=False)
    sim = Simulation(cfg)
    p = ref.Params.from_fluid(_fluid(cfg))
    state = sim.step(sim.init(), slice_step(orbit_impulse(1, cfg.dt, (16.0, 12.0), 3.0), 0))
    r = ref.State(state.u, state.v, state.dye, state.pressure, state.vel_stats,
                  np.float32(state.t), np.float32(state.press_time),
                  np.float32(state.time_since_press), state.mouse.numpy(), 1)
    np.testing.assert_array_equal(sim.render(state), ref.render(p, r).numpy())


@pytest.mark.parametrize("key, value", [("variant", "cpu"), ("pressure_solver", "multigrid"),
                                        ("color_diffusion_enabled", False),
                                        ("boundary_rows", 11)])
def test_params_refuse_a_step_it_does_not_write(key, value):
    fluid = _fluid(FluidConfig.gpu_reference())
    fluid[key] = value
    with pytest.raises(ValueError, match=key):
        ref.Params.from_fluid(fluid)


def test_bfloat16_step_rounds_every_field():
    cfg = FluidConfig.gpu_reference(nx=32, ny=24, backend="ref")
    p = ref.Params.from_fluid(_fluid(cfg))
    imp = ref.Impulse((18.0, 11.0), (16.0, 12.0), True, cfg.dt)
    s = ref.step(p, ref.init(p, "cpu"), imp)
    lo = ref.step(p, s, imp, torch.bfloat16)
    hi = ref.step(p, s, imp)
    assert lo.u.dtype == torch.bfloat16 and lo.dye.dtype == torch.bfloat16
    assert float((lo.u.float() - hi.u).abs().max()) > 0
