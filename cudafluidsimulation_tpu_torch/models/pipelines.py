"""The per-step physics pipeline.

The same stage order as the JAX package's ``models/pipelines.py``
(cpuFluidSim.cpp:327-410 and GPUFluidSim.cu:604-715):

    advect velocity -> advect dye -> vorticity confinement -> diffuse
    -> [splat if pressed] -> divergence -> Jacobi or multigrid pressure
    -> project -> [cpu only: boundary strip] -> render (pack [+ gpu bloom])

``make_step`` builds ``step(state, impulse) -> state`` over an ops
namespace (``ops.backend.get_ops``); ``make_batched_step`` the same step
over B independent members (ensembles, ``ops.backend.get_batched_ops``).
Both build one body, ``_make``, whose stages, choices, spans, pack and
host arithmetic serve a single state and a batch whose member axis leads,
so a stage addresses channels from the end.  Chosen when the step is
built: the kernels' scalars as launch arguments (single) or from one
(B, K) device array a step (``ops/member_params.py``); the colour from
``ops.cycle_color`` (single; the decomposed report bills it to Force) or
``cycle_color_batched``; a batch's per-member velocity diffusion.  Where
diffusion runs on five channels (velocity and dye), the step allocates the
5-channel pack once and the dye advection and the confinement write into
it (their ``out=``), so no copy builds it; the JAX package's XLA fuses the
same concatenation.

Prepared launches (the single gpu-variant step, its diffusion and splat
fused, on the card): a wrapper redoes at every call work that a fixed shape
does not change (checks, plans, coefficients, scratch, some 30-40 ctypes
arguments).  Where the namespace's op of a stage offers one
(``op.prepare``: the kernels' H1 ``advect_both``, H2
``vorticity_confinement_gpu``, H3 ``diffuse_multi_splat`` and H4
``pressure_project``; a plain or a wrapped op offers none), the step builds
it once, at the first state on the current card that fits (:func:`_fits`),
for that state's device, stream, shape and the calling thread, and from
then on enqueues the stage with one C call on a record filled once: the
same launches with the same arguments, counted as the wrapper's are.  A
state that does not fit, or another device, stream, shape or thread, takes
the wrappers.  The 5-channel pack, H1's u', v' and bound, H3's scratch and
H4's div and scratch become buffers of the prepared launches, read only
later on the same stream; the step's outputs (H3's 5 planes, H4's u', v', p
and bound) come fresh from one allocation a step, so a returned state never
shares memory with them.  The single step launches its advection and
confinement, which need dt alone, before the rest of its host arithmetic.
Counters (``STEP_STATS``): ``step_calls``, the single steps whose state
lies on the current card, and ``planned_stages``, their stage calls made
through a prepared launch.

Host syncs: the scalar state (t, press_time, time_since_press, mouse,
step) depends on the impulse stream alone, so it stays on the host with its
float32 arithmetic; ``vel_stats`` stays on the device.  So the step reads
nothing back, with one exception: multigrid with residual-targeted stopping
(``mg_tol > 0``, the ``quality`` preset) reads the residual's mean once per
stopping test, k + 1 reads for k V-cycles (``ops.multigrid.probed_tol_loop``).

Spans (``utils.trace.span``, no-ops unless a profiler runs): ``fluid.step``
around a step, and inside it one span a stage, each closed after the
stage's last launch, so the host arithmetic between stages is the step's
own: ``fluid.step.advection``, ``fluid.step.vorticity``,
``fluid.step.diffusion_splat`` (or ``fluid.step.diffusion`` and
``fluid.step.splat`` where they run apart), ``fluid.step.pressure_projection``
and, on the cpu variant, ``fluid.step.boundary_strip``; ``fluid.render``
around a render.  The four stages of the gpu step carry
``fluidbench/roofline.py``'s stage names.
"""

from __future__ import annotations

import threading
from typing import Callable

import numpy as np
import torch

from cudafluidsimulation_tpu_torch.config import FluidConfig
from cudafluidsimulation_tpu_torch.ops import _build, member_params
from cudafluidsimulation_tpu_torch.ops.backend import get_batched_ops, get_ops
from cudafluidsimulation_tpu_torch.ops.ref import cycle_color_batched, f32, f32_vec
from cudafluidsimulation_tpu_torch.state import FluidState
from cudafluidsimulation_tpu_torch.utils.impulse import Impulse
from cudafluidsimulation_tpu_torch.utils.trace import span

StepFn = Callable[[FluidState, Impulse], FluidState]
F = np.float32

# the single step's counters (``utils.trace.counters``): single steps whose
# state lies on the current card, and the stage calls of those steps made
# through a prepared launch
STEP_STATS = {"step_calls": 0, "planned_stages": 0}
_STATS_LOCK = threading.Lock()
# the ops whose prepared launch (``op.prepare``) the single step may take
_PREPARED = ("advect_both", "vorticity_confinement_gpu", "diffuse_multi_splat",
             "pressure_project")


def _offered(ops, name):
    """The prepared launch that the namespace's op ``name`` offers, or None."""
    return getattr(getattr(ops, name, None), "prepare", None)


def _host(x) -> torch.Tensor:
    """A float32 host scalar or array as a host tensor."""
    return torch.from_numpy(np.asarray(x))


def _fits(u, v, dye) -> bool:
    """Whether a single state's planes fit a prepared launch: u, v (H, W)
    and the dye (3, H, W), float32 and contiguous on u's device, each plane
    16-byte aligned where the width takes 16-byte rows."""
    dtype = torch.float32
    if (u.dim() != 2 or v.shape != u.shape or dye.shape != (3, *u.shape)
            or u.dtype != dtype or v.dtype != dtype or dye.dtype != dtype
            or v.device != u.device or dye.device != u.device
            or not (u.is_contiguous() and v.is_contiguous() and dye.is_contiguous())):
        return False
    return u.shape[1] % 4 != 0 or (u.data_ptr() | v.data_ptr() | dye.data_ptr()) % 16 == 0


class _Prepared:
    """The single step's prepared launches for one (device, stream, H, W,
    thread) (the module docstring): one for each stage whose op offers one
    (``op.prepare``; the pressure's only for the Jacobi solve), and the
    5-channel pack, the step's own buffer, where H3's is among them (whose
    output never is the pack)."""

    def __init__(self, config: FluidConfig, ops, key: tuple, coeffs: np.ndarray):
        device, stream, h, w, _ = self.key = key
        self.hw = hw = h * w
        make = _offered(ops, "advect_both")
        self.advect = None if make is None else make(device, stream, h, w)
        make = _offered(ops, "vorticity_confinement_gpu")
        self.vorticity = None if make is None else make(stream, h, w, config.vorticity)
        make = _offered(ops, "diffuse_multi_splat")
        self.pack = self.dye_out = self.diffuse = None
        if make is not None:
            self.pack = torch.empty((5, h, w), dtype=torch.float32, device=device)
            self.dye_out = self.pack.narrow(0, 2, 3)
            self.diffuse = make(self.pack, stream, config.diffusion_iters, coeffs,
                                config.splat_radius)
        make = _offered(ops, "pressure_project")
        self.pressure = (None if make is None or config.pressure_solver == "multigrid" else
                         make(device, stream, h, w, config.pressure_iters,
                              config.half_divergence))
        # a step's outputs, one allocation: H3's 5 planes, then H4's u', v',
        # p and bound (3 H W + 2 floats)
        self._h4 = 5 * hw if self.diffuse is not None else 0
        self._numel = self._h4 + (3 * hw + 2 if self.pressure is not None else 0)
        self._device, self._shape = device, (h, w)
        self.stages = sum(x is not None for x in (self.advect, self.vorticity, self.diffuse,
                                                   self.pressure))

    def outputs(self):
        """Fresh tensors for one step's outputs, carved from one allocation:
        H3's (5, H, W) and H4's (u', v', p, bound), each None where that
        stage has no prepared launch."""
        if not self._numel:
            return None, None
        h, w = self._shape
        hw, o = self.hw, self._h4
        out = torch.empty((self._numel,), dtype=torch.float32, device=self._device)
        h3 = None if self.diffuse is None else out.as_strided((5, h, w), (hw, w, 1), 0)
        h4 = None if self.pressure is None else (
            out.as_strided((h, w), (w, 1), o), out.as_strided((h, w), (w, 1), o + hw),
            out.as_strided((h, w), (w, 1), o + 2 * hw), out.as_strided((2,), (1,), o + 3 * hw))
        return h3, h4


def make_step(config: FluidConfig, ops=None) -> StepFn:
    return _make(config, get_ops(config) if ops is None else ops, batched=False)


def make_batched_step(config: FluidConfig, ops=None, diffusions=None) -> StepFn:
    """``step(state, impulse) -> state`` over B independent members at once:
    the analog of the JAX package's ``vmap(make_step(config))``, and
    :func:`make_step`'s own body over a leading member axis.

    The state's fields carry a leading member axis (u, v (B, H, W), dye
    (B, 3, H, W), vel_stats (B, 2)), its scalars are (B,) host tensors
    (mouse (B, 2)), and the impulse holds one step of each member (pos
    (B, 2), pressed and dt (B,)).  ``ops`` is a batched namespace
    (``ops.backend.get_batched_ops``): each stage is one call for the whole
    batch, and on the card its kernels run over every member at once (H3's
    diffusion and H4's pressure as wavefront passes).  ``diffusions`` (B,),
    when given, replaces the velocity-diffusion coefficient of each member
    (channels 0-1; the dye keeps the config's), as the JAX package's
    ``make_diffusion_sweep_run`` does.  The kernels read the per-member
    scalars from one (B, K) device array a step (``ops/member_params.py``),
    copied from pinned memory without a wait: the step reads nothing back.
    """
    return _make(config, get_batched_ops(config) if ops is None else ops, batched=True,
                 diffusions=diffusions)


def _make(config: FluidConfig, ops, batched: bool, diffusions=None) -> StepFn:
    palette = config.palette_array()
    cpu_variant = config.variant == "cpu"
    # diffusion takes velocity and dye as one 5-channel pack: the dye
    # advection writes channels 2-4 of it and the confinement channels 0-1
    five = config.color_diffusion_enabled and (not cpu_variant or config.diffusion_iters > 0)
    # velocity and dye share one 5-channel pass with the splat folded into
    # its last sweep
    fused_splat = config.color_diffusion_enabled and not cpu_variant

    if batched:
        # (B,) and (B, 2) host arrays; col(x) scales row b by x[b]
        scalar, col = f32_vec, (lambda x: x[:, None])
        pair, flag = ((lambda x: np.asarray(x, F).reshape(-1, 2)),
                      (lambda x: np.asarray(x, bool).reshape(-1)))

        def color_of(press_time):
            return cycle_color_batched(palette, press_time)

        def kernel_scalars(dt, amps, last, u):
            """The diffusion coefficients, (B,) and (B, C), and the kernels'
            per-member scalars, one copy to the device a step."""
            n = u.shape[0]
            k = (np.full(n, config.velocity_diffusion, F) if diffusions is None
                 else f32_vec(diffusions))
            coeffs = (np.concatenate([np.stack([k, k], axis=1),
                                      np.full((n, 3), F(config.color_diffusion))], axis=1)
                      if config.color_diffusion_enabled else np.stack([k, k], axis=1))
            params = member_params.upload(np.concatenate([
                member_params.advect_cols(dt, config.decay_rate),
                member_params.diffuse_cols(dt, coeffs, amps, last if fused_splat else None),
            ], axis=1), u.device)
            adv_p, dif_p = (None, None) if params is None else (
                params[:, :member_params.ADVECT_COLS], params[:, member_params.ADVECT_COLS:])
            return k, coeffs, dict(params=adv_p), dict(params=dif_p)
    else:
        scalar, pair, flag, col = f32, f32_vec, bool, (lambda x: x)

        def color_of(press_time):
            return f32_vec(ops.cycle_color(palette, press_time))

        # the kernels take the scalars as launch arguments
        launch = (config.velocity_diffusion, np.asarray(
            [config.velocity_diffusion] * 2 + [config.color_diffusion] * 3, np.float32), {}, {})

    def host_scalars(state: FluidState, imp: Impulse):
        """The kernels' scalars and the next state's host fields, in float32:
        numpy scalars and (2,) vectors for a single step, (B,) and (B, 2)
        arrays for B members by the same operations in the same order, so
        member i sees a single run's scalars bit for bit.  "If pressed" is
        data: unpressed, the force and colour are zero and the splat is the
        identity."""
        dt, pressed = scalar(imp.dt), flag(imp.pressed)
        pressed_f = F(pressed)
        press_time = scalar(state.press_time) + dt * pressed_f
        cur = pair(imp.pos)
        # cpu-parity remembers its own previous position
        # (cpuFluidSim.cpp:31-32,409); gpu-parity gets both from the caller
        last = pair(state.mouse) if cpu_variant else pair(imp.last_pos)
        force_eff = F(config.force_scale) * pressed_f
        color_eff = color_of(press_time) * col(pressed_f)
        # the splat's amplitudes in splat_gpu's association order
        amps = (np.concatenate([(last - cur) * col(force_eff) * col(dt), color_eff], axis=-1)
                if fused_splat else None)
        if batched:
            since = np.where(pressed, F(0), scalar(state.time_since_press) + dt)
            mouse = _host(np.where(col(pressed), cur, pair(state.mouse)))
        else:
            since = F(0) if pressed else f32(state.time_since_press) + dt
            mouse = torch.from_numpy(cur.copy()) if pressed else state.mouse
        return dt, cur, last, force_eff, color_eff, amps, dict(
            t=_host(scalar(state.t) + dt), press_time=_host(press_time),
            time_since_press=_host(since), mouse=mouse)

    # the single step's prepared launches (the module docstring): made at
    # the first state on the card that fits them, for its device, stream,
    # shape and thread; a state that does not fit takes the wrappers
    prepare = not batched and fused_splat and any(_offered(ops, n) for n in _PREPARED)
    prepared: list = []

    def planned(u, v, dye):
        """The step's prepared launches where the state fits them, else
        None; counts the single steps on the card and their prepared
        stages."""
        if batched:
            return None
        key = _build.launch_key(u)
        if key is None:
            return None
        prep = None
        if prepare and _fits(u, v, dye):
            key += (*u.shape, threading.get_ident())
            if not prepared:
                prepared.append(_Prepared(config, ops, key, launch[1]))
            if prepared[0].key == key:
                prep = prepared[0]
        with _STATS_LOCK:
            STEP_STATS["step_calls"] += 1
            STEP_STATS["planned_stages"] += 0 if prep is None else prep.stages
        return prep

    def step(state: FluidState, imp: Impulse) -> FluidState:
        with span("fluid.step", state.step):
            return _step(state, imp)

    def _step(state: FluidState, imp: Impulse) -> FluidState:
        u, v, dye = state.u, state.v, state.dye
        prep = planned(u, v, dye)
        if batched:
            scalars = host_scalars(state, imp)
            dt = scalars[0]
            k, coeffs, adv_kw, dif_kw = kernel_scalars(dt, scalars[5], scalars[2], u)
        else:
            # the advection and the confinement need dt alone: the card
            # starts on them while the rest of the host arithmetic runs
            scalars, dt = None, scalar(imp.dt)
            k, coeffs, adv_kw, dif_kw = launch
        if prep is not None and prep.pack is not None:
            pack, dye_out = prep.pack, prep.dye_out
        else:
            pack = (torch.empty((*u.shape[:-2], 5, *u.shape[-2:]), dtype=torch.float32,
                                device=u.device) if five else None)
            dye_out = None if pack is None else pack.narrow(-3, 2, 3)

        # -- advection: velocity first; dye through the advected velocity
        #    (cpuFluidSim.cpp:340-341 / GPUFluidSim.cu:620-622).  A namespace
        #    may give the optional ``advect_both``: H1's one launch on the
        #    card, the sharded rollout's one halo exchange (both tap
        #    pre-advection data)
        advect_both = getattr(ops, "advect_both", None)
        with span("fluid.step.advection"):
            if prep is not None and prep.advect is not None:
                u, v = prep.advect(u, v, dye, dye_out, dt, config.decay_rate)
                dye = dye_out
            elif advect_both is not None:
                u, v, dye, vstats = advect_both(u, v, dye, dt, config.decay_rate,
                                                vel_stats=state.vel_stats, return_stats=True,
                                                out=dye_out, **adv_kw)
            else:
                u, v, vstats = ops.advect_velocity(u, v, dt, config.decay_rate,
                                                   vel_stats=state.vel_stats,
                                                   return_stats=True, **adv_kw)
                dye = ops.advect_dye(dye, u, v, dt, config.decay_rate, vel_stats=vstats,
                                     out=dye_out, **adv_kw)

        # -- vorticity confinement
        confine = ops.vorticity_confinement_cpu if cpu_variant else ops.vorticity_confinement_gpu
        with span("fluid.step.vorticity"):
            if prep is not None and prep.vorticity is not None:
                prep.vorticity(u, v, pack, dt)  # into the pack's first two planes
            else:
                u, v = confine(u, v, dt, config.vorticity,
                               out=None if pack is None else pack.narrow(-3, 0, 2), **adv_kw)

        if scalars is None:
            scalars = host_scalars(state, imp)
        dt, cur, last, force_eff, color_eff, amps, fields = scalars
        outs = None if prep is None else prep.outputs()

        # -- diffusion, then the splat unless it rides the last sweep
        if fused_splat:
            with span("fluid.step.diffusion_splat"):
                if prep is not None and prep.diffuse is not None:
                    pack = outs[0]
                    prep.diffuse(pack, dt, amps, last)
                else:
                    pack = ops.diffuse_multi_splat(pack, dt, coeffs, config.diffusion_iters,
                                                   amps, last, config.splat_radius, **dif_kw)
        elif config.diffusion_iters > 0:
            with span("fluid.step.diffusion"):
                if five:
                    pack = ops.diffuse_multi(pack, dt, coeffs, config.diffusion_iters, **dif_kw)
                else:
                    uv = ops.diffuse(torch.stack([u, v], dim=-3), dt, k,
                                     config.diffusion_iters, **dif_kw)
                    u, v = uv.select(-3, 0), uv.select(-3, 1)
        if five:
            u, v, dye = pack.select(-3, 0), pack.select(-3, 1), pack.narrow(-3, 2, 3)
        if not fused_splat:
            splat = ops.splat_cpu if cpu_variant else ops.splat_gpu
            with span("fluid.step.splat"):
                u, v, dye = splat(u, v, dye, cur, last, dt, force_eff,
                                  config.splat_radius, color_eff)

        # -- pressure projection (emits the next step's vel_stats)
        with span("fluid.step.pressure_projection"):
            if prep is not None and prep.pressure is not None:
                prep.pressure(u, v, outs[1][0])
                u, v, p, vel_stats = outs[1]
            elif config.pressure_solver == "multigrid":
                ppmg = getattr(ops, "pressure_project_mg", None)
                if ppmg is not None:
                    # divergence, residuals and projection folded into the
                    # smoother ends (ops/multigrid.py)
                    u, v, p, vel_stats = ppmg(
                        u, v, config.mg_cycles, tol=config.mg_tol, max_cycles=config.mg_max_cycles,
                        half=config.half_divergence, return_stats=True)
                else:
                    div = ops.divergence(u, v, config.half_divergence)
                    p = ops.pressure_solve_mg(div, config.mg_cycles, tol=config.mg_tol,
                                              max_cycles=config.mg_max_cycles)
                    u, v, vel_stats = ops.project(u, v, p, return_stats=True)
            else:
                u, v, p, vel_stats = ops.pressure_project(
                    u, v, config.pressure_iters, config.half_divergence, return_stats=True)

        # -- boundary strip (cpu path only; zeroing rows keeps vel_stats a
        #    valid upper bound)
        if config.boundary_rows > 0:
            with span("fluid.step.boundary_strip"):
                u, v, dye = ops.boundary_strip(u, v, dye, config.boundary_rows)

        return FluidState(u=u, v=v, dye=dye, pressure=p, step=state.step + 1,
                          vel_stats=vel_stats, **fields)

    return step


def make_render(config: FluidConfig, ops=None) -> Callable[[FluidState], torch.Tensor]:
    """Frame render on the state's device: dye -> (4, H, W) uint8 RGBA, with
    the bloom (GPUFluidSim.cu:576-591) while the impulse was pressed less
    than ``bloom_duration`` ago.  Bloom centres on ``state.mouse``."""
    if ops is None:
        ops = get_ops(config)

    def render(state: FluidState) -> torch.Tensor:
        with span("fluid.render"):
            if config.bloom_enabled:
                active = f32(state.time_since_press) < F(config.bloom_duration)
                return ops.render_frame(state.dye, state.mouse, config.bloom_intense,
                                        config.splat_radius, active)
            return ops.pack_rgba(state.dye)

    return render
