"""The per-step physics pipeline.

The same stage order as the JAX package's ``models/pipelines.py``
(cpuFluidSim.cpp:327-410 and GPUFluidSim.cu:604-715):

    advect velocity -> advect dye -> vorticity confinement -> diffuse
    -> [splat if pressed] -> divergence -> Jacobi or multigrid pressure
    -> project -> [cpu only: boundary strip] -> render (pack [+ gpu bloom])

``make_step`` builds ``step(state, impulse) -> state`` over an ops
namespace (``ops.backend.get_ops``); ``make_batched_step`` the same step
over B independent members (ensembles, ``ops.backend.get_batched_ops``).  Where diffusion runs on five channels
(velocity and dye), the step allocates the (5, H, W) pack once and the dye
advection and the confinement write into it (their ``out=``), so no copy
builds it; the JAX package's XLA fuses the same concatenation.

Host syncs: the impulse stream and the scalar state (t, press_time,
time_since_press, mouse, step) depend on the impulse stream alone, so they
stay on the host and their float32 arithmetic runs there; the per-step
scalars (dt, the cursor positions, the palette colour, the splat
amplitudes) reach the kernels as launch arguments.  ``vel_stats`` stays on
the device.  So the step reads nothing back from the device, with one
exception: multigrid with residual-targeted stopping (``mg_tol > 0``, the
``quality`` preset) reads the residual's mean once per stopping test, k + 1
reads for a step that completes k V-cycles (``ops.multigrid.probed_tol_loop``).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from cudafluidsimulation_tpu_torch.config import FluidConfig
from cudafluidsimulation_tpu_torch.ops import member_params
from cudafluidsimulation_tpu_torch.ops.backend import get_batched_ops, get_ops
from cudafluidsimulation_tpu_torch.ops.ref import cycle_color_batched, f32, f32_vec
from cudafluidsimulation_tpu_torch.state import FluidState
from cudafluidsimulation_tpu_torch.utils.impulse import Impulse

StepFn = Callable[[FluidState, Impulse], FluidState]
F = np.float32


def _host_f32(x) -> torch.Tensor:
    return torch.tensor(float(x), dtype=torch.float32)


def make_step(config: FluidConfig, ops=None) -> StepFn:
    if ops is None:
        ops = get_ops(config)
    palette = config.palette_array()
    cpu_variant = config.variant == "cpu"
    coeffs5 = np.asarray([config.velocity_diffusion] * 2
                         + [config.color_diffusion] * 3, np.float32)

    # diffusion takes velocity and dye as one (5, H, W) pack: the dye
    # advection writes channels 2-4 of it and the confinement channels 0-1
    five = config.color_diffusion_enabled and (not cpu_variant or config.diffusion_iters > 0)

    def step(state: FluidState, imp: Impulse) -> FluidState:
        dt = f32(imp.dt)
        u, v, dye = state.u, state.v, state.dye
        pack = (torch.empty((5,) + tuple(u.shape), dtype=torch.float32, device=u.device)
                if five else None)

        # -- advection: velocity first; dye through the advected velocity
        #    (cpuFluidSim.cpp:340-341 / GPUFluidSim.cu:620-622).  A namespace
        #    may give the optional ``advect_both``: H1's one launch for both
        #    on the card, the sharded rollout's one halo exchange for both
        #    (both tap pre-advection data)
        dye_out = None if pack is None else pack[2:]
        advect_both = getattr(ops, "advect_both", None)
        if advect_both is not None:
            u, v, dye, vstats = advect_both(u, v, dye, dt, config.decay_rate,
                                            vel_stats=state.vel_stats, return_stats=True,
                                            out=dye_out)
        else:
            u, v, vstats = ops.advect_velocity(u, v, dt, config.decay_rate,
                                               vel_stats=state.vel_stats,
                                               return_stats=True)
            dye = ops.advect_dye(dye, u, v, dt, config.decay_rate, vel_stats=vstats,
                                 out=dye_out)

        # -- vorticity confinement
        confine = ops.vorticity_confinement_cpu if cpu_variant else ops.vorticity_confinement_gpu
        u, v = confine(u, v, dt, config.vorticity,
                       out=None if pack is None else pack[:2])

        # -- impulse parameters, on the host ("if pressed" as data: the
        #    force scale and colour are zero when unpressed, which makes the
        #    splat the identity)
        pressed = bool(imp.pressed)
        pressed_f = F(pressed)
        press_time = f32(state.press_time) + dt * pressed_f
        color = f32_vec(ops.cycle_color(palette, press_time))
        cur = f32_vec(imp.pos)
        # cpu-parity remembers its own previous position
        # (cpuFluidSim.cpp:31-32,409); gpu-parity gets both from the caller
        last = f32_vec(state.mouse) if cpu_variant else f32_vec(imp.last_pos)
        force_eff = F(config.force_scale) * pressed_f
        color_eff = color * pressed_f

        # -- diffusion + splat: velocity and dye share one 5-channel pass
        #    with the splat folded into its last sweep (amps keep
        #    splat_gpu's association order)
        if config.color_diffusion_enabled and not cpu_variant:
            amps = np.concatenate([
                np.asarray([(last[0] - cur[0]) * force_eff * dt,
                            (last[1] - cur[1]) * force_eff * dt], np.float32),
                color_eff,
            ])
            all5 = ops.diffuse_multi_splat(
                pack, dt, coeffs5, config.diffusion_iters, amps, last,
                config.splat_radius,
            )
            u, v, dye = all5[0], all5[1], all5[2:]
        else:
            if config.diffusion_iters > 0:
                if config.color_diffusion_enabled:
                    all5 = ops.diffuse_multi(pack, dt, coeffs5, config.diffusion_iters)
                    u, v, dye = all5[0], all5[1], all5[2:]
                else:
                    uv = ops.diffuse(torch.stack([u, v]), dt,
                                     config.velocity_diffusion,
                                     config.diffusion_iters)
                    u, v = uv[0], uv[1]
            splat = ops.splat_cpu if cpu_variant else ops.splat_gpu
            u, v, dye = splat(u, v, dye, cur, last, dt, force_eff,
                              config.splat_radius, color_eff)

        # -- pressure projection (emits the next step's vel_stats)
        if config.pressure_solver == "multigrid":
            ppmg = getattr(ops, "pressure_project_mg", None)
            if ppmg is not None:
                # divergence, residuals and projection folded into the
                # smoother ends (ops/multigrid.py)
                u, v, p, vel_stats = ppmg(
                    u, v, config.mg_cycles, tol=config.mg_tol,
                    max_cycles=config.mg_max_cycles,
                    half=config.half_divergence, return_stats=True)
            else:
                div = ops.divergence(u, v, config.half_divergence)
                p = ops.pressure_solve_mg(div, config.mg_cycles,
                                          tol=config.mg_tol,
                                          max_cycles=config.mg_max_cycles)
                u, v, vel_stats = ops.project(u, v, p, return_stats=True)
        else:
            u, v, p, vel_stats = ops.pressure_project(
                u, v, config.pressure_iters, config.half_divergence,
                return_stats=True,
            )

        # -- boundary strip (cpu path only; zeroing rows keeps vel_stats a
        #    valid upper bound)
        if config.boundary_rows > 0:
            u, v, dye = ops.boundary_strip(u, v, dye, config.boundary_rows)

        return FluidState(
            u=u,
            v=v,
            dye=dye,
            pressure=p,
            t=_host_f32(f32(state.t) + dt),
            press_time=_host_f32(press_time),
            time_since_press=_host_f32(
                F(0) if pressed else f32(state.time_since_press) + dt),
            mouse=torch.from_numpy(cur.copy()) if pressed else state.mouse,
            step=state.step + 1,
            vel_stats=vel_stats,
        )

    return step


def make_batched_step(config: FluidConfig, ops=None, diffusions=None) -> StepFn:
    """``step(state, impulse) -> state`` over B independent members at once:
    the analog of the JAX package's ``vmap(make_step(config))``.

    The state's fields carry a leading member axis (u, v (B, H, W), dye
    (B, 3, H, W), vel_stats (B, 2)), its scalars are (B,) host tensors
    (mouse (B, 2)), and the impulse holds one step of each member (pos
    (B, 2), pressed and dt (B,)).  ``ops`` is a batched namespace
    (``ops.backend.get_batched_ops``): each stage is one call for the whole
    batch, one launch (or one burst plan) of the kernels on the card.
    ``diffusions`` (B,), when given, replaces the velocity-diffusion
    coefficient of each member (channels 0-1; the dye keeps the config's),
    as the JAX package's ``make_diffusion_sweep_run`` does.

    The per-member scalars are :func:`make_step`'s float32 arithmetic on
    (B,) host arrays, in the same order, so member i sees the scalars of a
    single run of member i bit for bit.  The kernels read theirs from one
    (B, K) device array a step (``ops/member_params.py``), copied from
    pinned memory without a wait: the step reads nothing back.
    """
    if ops is None:
        ops = get_batched_ops(config)
    palette = config.palette_array()
    cpu_variant = config.variant == "cpu"
    five = config.color_diffusion_enabled and (not cpu_variant or config.diffusion_iters > 0)
    fused_splat = config.color_diffusion_enabled and not cpu_variant

    def step(state: FluidState, imp: Impulse) -> FluidState:
        u, v, dye = state.u, state.v, state.dye
        n = u.shape[0]
        dt = f32_vec(imp.dt)
        pressed = np.asarray(imp.pressed, bool).reshape(n)
        pressed_f = pressed.astype(F)
        press_time = f32_vec(state.press_time) + dt * pressed_f
        color = cycle_color_batched(palette, press_time)
        cur = np.asarray(imp.pos, F).reshape(n, 2)
        mouse = np.asarray(state.mouse, F).reshape(n, 2)
        last = mouse if cpu_variant else np.asarray(imp.last_pos, F).reshape(n, 2)
        force_eff = F(config.force_scale) * pressed_f
        color_eff = color * pressed_f[:, None]
        k = (np.full(n, config.velocity_diffusion, F) if diffusions is None
             else f32_vec(diffusions))
        coeffs = (np.concatenate([np.stack([k, k], axis=1),
                                  np.full((n, 3), F(config.color_diffusion))], axis=1)
                  if config.color_diffusion_enabled else np.stack([k, k], axis=1))
        amps = (np.concatenate([
            np.stack([(last[:, 0] - cur[:, 0]) * force_eff * dt,
                      (last[:, 1] - cur[:, 1]) * force_eff * dt], axis=1),
            color_eff], axis=1) if fused_splat else None)

        # the kernels' per-member scalars, one copy to the device a step
        params = member_params.upload(np.concatenate([
            member_params.advect_cols(dt, config.decay_rate),
            member_params.diffuse_cols(dt, coeffs, amps, last if fused_splat else None),
        ], axis=1), u.device)
        adv_p, dif_p = (None, None) if params is None else (
            params[:, :member_params.ADVECT_COLS], params[:, member_params.ADVECT_COLS:])
        pack = (torch.empty((n, 5) + tuple(u.shape[1:]), dtype=torch.float32,
                            device=u.device) if five else None)

        # -- advection (each member's quiet branch of the fast modes from
        #    its own bound; the optional ``advect_both`` as make_step's),
        #    then vorticity confinement
        dye_out = None if pack is None else pack[:, 2:]
        advect_both = getattr(ops, "advect_both", None)
        if advect_both is not None:
            u, v, dye, vstats = advect_both(u, v, dye, dt, config.decay_rate,
                                            vel_stats=state.vel_stats, return_stats=True,
                                            params=adv_p, out=dye_out)
        else:
            u, v, vstats = ops.advect_velocity(u, v, dt, config.decay_rate,
                                               vel_stats=state.vel_stats, return_stats=True,
                                               params=adv_p)
            dye = ops.advect_dye(dye, u, v, dt, config.decay_rate, vel_stats=vstats,
                                 params=adv_p, out=dye_out)
        confine = ops.vorticity_confinement_cpu if cpu_variant else ops.vorticity_confinement_gpu
        u, v = confine(u, v, dt, config.vorticity, params=adv_p,
                       out=None if pack is None else pack[:, :2])

        # -- diffusion + splat
        if fused_splat:
            all5 = ops.diffuse_multi_splat(pack, dt, coeffs, config.diffusion_iters,
                                           amps, last, config.splat_radius, params=dif_p)
            u, v, dye = all5[:, 0], all5[:, 1], all5[:, 2:]
        else:
            if config.diffusion_iters > 0:
                if config.color_diffusion_enabled:
                    all5 = ops.diffuse_multi(pack, dt, coeffs, config.diffusion_iters,
                                             params=dif_p)
                    u, v, dye = all5[:, 0], all5[:, 1], all5[:, 2:]
                else:
                    uv = ops.diffuse(torch.stack([u, v], dim=1), dt, k,
                                     config.diffusion_iters, params=dif_p)
                    u, v = uv[:, 0], uv[:, 1]
            splat = ops.splat_cpu if cpu_variant else ops.splat_gpu
            u, v, dye = splat(u, v, dye, cur, last, dt, force_eff,
                              config.splat_radius, color_eff)

        # -- pressure projection (emits the next step's vel_stats)
        if config.pressure_solver == "multigrid":
            u, v, p, vel_stats = ops.pressure_project_mg(
                u, v, config.mg_cycles, tol=config.mg_tol,
                max_cycles=config.mg_max_cycles, half=config.half_divergence,
                return_stats=True)
        else:
            u, v, p, vel_stats = ops.pressure_project(
                u, v, config.pressure_iters, config.half_divergence, return_stats=True)

        if config.boundary_rows > 0:
            u, v, dye = ops.boundary_strip(u, v, dye, config.boundary_rows)

        return FluidState(
            u=u,
            v=v,
            dye=dye,
            pressure=p,
            t=torch.from_numpy(f32_vec(state.t) + dt),
            press_time=torch.from_numpy(press_time),
            time_since_press=torch.from_numpy(
                np.where(pressed, F(0), f32_vec(state.time_since_press) + dt)),
            mouse=torch.from_numpy(np.where(pressed[:, None], cur, mouse)),
            step=state.step + 1,
            vel_stats=vel_stats,
        )

    return step


def make_render(config: FluidConfig, ops=None) -> Callable[[FluidState], torch.Tensor]:
    """Frame render on the state's device: dye -> (4, H, W) uint8 RGBA, with
    the bloom (GPUFluidSim.cu:576-591) while the impulse was pressed less
    than ``bloom_duration`` ago.  Bloom centres on ``state.mouse``."""
    if ops is None:
        ops = get_ops(config)

    def render(state: FluidState) -> torch.Tensor:
        if config.bloom_enabled:
            active = f32(state.time_since_press) < F(config.bloom_duration)
            return ops.render_frame(state.dye, state.mouse, config.bloom_intense,
                                    config.splat_radius, active)
        return ops.pack_rgba(state.dye)

    return render
