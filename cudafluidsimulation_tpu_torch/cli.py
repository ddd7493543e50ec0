"""CLI of the PyTorch/CUDA port — the app shell the reference never had.

The counterpart of the JAX package's CLI, with the same options and
defaults: scripted simulations of either parity variant at any size,
frames (PNG, APNG, AVI), fields and checkpoints, and the end-of-run timing
report in the reference's format (Main.cpp:195-206); or a live view of the
frame loop (``models.app.FluidApp``) in the terminal or a browser, steered
with ``--interactive``.

    python -m cudafluidsimulation_tpu_torch.cli --grid 2048 --steps 300 \\
        --impulse orbit --frames-dir out/ --report
    python -m cudafluidsimulation_tpu_torch.cli --grid 1024 --steps 0 \\
        --view http --interactive

It runs on the CUDA device: the default ``--backend auto`` (and ``cuda``)
runs the Hopper kernels and exits, naming ``--backend ref``, when there is
no card; ``--backend ref`` runs the plain PyTorch ops on the CPU.

``--mesh rows|2d`` runs the sharded rollout (``parallel/``) over
``--mesh-devices`` shards (default: every visible device); more shards than
devices are placed round-robin on them, which a line says.  Frames, fields,
health checks and checkpoints gather the state; ``--report`` keeps the
whole-step timings and skips the sampled stage rows; with ``--view`` the
mesh is ignored (the live frame loop is one device), as in the JAX CLI.

    python -m cudafluidsimulation_tpu_torch.cli --grid 8192 --steps 100 \
        --pressure-iters 100 --mesh 2d --mesh-devices 4 --report

The one-device advection is the reference's unbounded backtrace; the
meshes bound its taps by their halo (``utils.health.clamp_axes``), and the
run warns when the realized displacement outran that bound.
"""

from __future__ import annotations

import argparse
import contextlib
import math
import os
import sys
import time

import numpy as np
import torch

from cudafluidsimulation_tpu_torch.config import FluidConfig
from cudafluidsimulation_tpu_torch.models.simulation import Simulation
from cudafluidsimulation_tpu_torch.state import FluidState
from cudafluidsimulation_tpu_torch.utils import impulse as imps
from cudafluidsimulation_tpu_torch.utils.checkpoint import (
    load_state_with_fallback, save_state)
from cudafluidsimulation_tpu_torch.utils.health import (
    Health, HealthError, check_health, clamp_axes, displacement_check)
from cudafluidsimulation_tpu_torch.utils.png import write_png
from cudafluidsimulation_tpu_torch.utils.timing import StageReport

# spin kernels at each end of a --profile-dir trace (see _pad)
PROFILE_PAD = 32


def _backend(name: str) -> str:
    """The JAX package's name for its kernels' backend is the port's cuda."""
    return "cuda" if name == "pallas" else name


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Stable-fluids simulator on PyTorch and CUDA")
    p.add_argument("--grid", type=int, default=512, help="square grid size")
    p.add_argument("--nx", type=int, default=0)
    p.add_argument("--ny", type=int, default=0)
    p.add_argument("--variant", choices=["cpu", "gpu"], default="gpu",
                   help="reference parity variant (parameter set + quirks)")
    p.add_argument("--backend", type=_backend, choices=["auto", "ref", "cuda"],
                   default="auto",
                   help="auto = cuda: the Hopper kernels on the CUDA device (no "
                   "card: exit); ref = the plain PyTorch ops on the CPU; "
                   "'pallas' is taken as cuda")
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--dt", type=float, default=1.0 / 60.0)
    p.add_argument("--diffusion-iters", type=int, default=-1,
                   help="-1 = variant default (cpu:5, gpu:20)")
    p.add_argument("--pressure-iters", type=int, default=-1,
                   help="-1 = variant default (cpu:5, gpu:30)")
    p.add_argument("--preset", choices=["parity", "quality", "fast"],
                   default=None,
                   help="parity = the reference gpu pipeline as shipped "
                   "(the default config); quality = multigrid pressure with "
                   "residual-targeted stopping rms<0.05 and max_displacement "
                   "31; fast = --fast-dye --fast-vel --fast-diffuse.  "
                   "Explicit flags override the preset")
    p.add_argument("--pressure-solver", choices=["jacobi", "multigrid"],
                   default=None,
                   help="jacobi = reference-parity fixed sweeps (default); "
                   "multigrid = V-cycle solver")
    p.add_argument("--mg-cycles", type=int, default=None,
                   help="V-cycles per step with --pressure-solver multigrid "
                   "(default 2; ignored when --mg-tol is set)")
    p.add_argument("--mg-tol", type=float, default=None,
                   help="with --pressure-solver multigrid: run V-cycles "
                   "until rms(A p + div) < TOL (at most --mg-max-cycles) "
                   "instead of a fixed --mg-cycles count")
    p.add_argument("--mg-max-cycles", type=int, default=None,
                   help="cycle cap for --mg-tol (default 8)")
    p.add_argument("--max-displacement", type=int, default=0,
                   help="the config's advection bound in cells; 0 = config "
                   "default (15).  The port's advection is unbounded on "
                   "every backend, so this only sets the config field")
    p.add_argument("--fast-dye", action="store_true",
                   help="bf16-rounded dye advection taps (H8); quiet steps "
                   "stay exact f32.  Off by default — reference parity "
                   "requires f32 dye")
    p.add_argument("--fast-vel", action="store_true",
                   help="bf16-rounded velocity advection taps (H8); quiet "
                   "steps stay exact f32.  Off by default — reference "
                   "parity requires f32 velocity")
    p.add_argument("--fast-diffuse", action="store_true",
                   help="separable evaluation of the k-sweep diffusion blur "
                   "(H7) where its taps undercut the sweeps; taps are "
                   "designed at the config dt.  Off by default — parity "
                   "requires the exact sweep operator")
    p.add_argument("--impulse", choices=["orbit", "center", "none"], default="orbit")
    p.add_argument("--impulse-file", default="",
                   help="JSON impulse script ([x,y,pressed] per step or "
                   "{pos,pressed,dt} dicts); overrides --impulse/--steps")
    p.add_argument("--frames-dir", default="", help="dump PNG frames here")
    p.add_argument("--frame-every", type=int, default=10)
    p.add_argument("--apng", default="",
                   help="write the collected frames as one animated PNG")
    p.add_argument("--apng-fps", type=float, default=30.0)
    p.add_argument("--video", default="",
                   help="write the collected frames as an AVI (MJPEG when the "
                   "native encoder builds, else uncompressed RGB)")
    p.add_argument("--video-fps", type=float, default=30.0)
    p.add_argument("--video-codec", choices=["auto", "mjpeg", "rgb"],
                   default="auto",
                   help="auto = MJPEG if the native JPEG encoder builds, "
                   "else lossless uncompressed RGB")
    p.add_argument("--video-quality", type=int, default=None,
                   help="MJPEG quality 1-100 (default 90 ~ visually "
                   "lossless; ignored with --video-codec rgb)")
    p.add_argument("--save-fields", default="", help="npz path for final fields")
    p.add_argument("--checkpoint", default="", help="save final state here")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="also save the state to --checkpoint every N steps "
                   "(long-run resilience; 0 = only at the end)")
    p.add_argument("--resume", default="", help="resume from a state checkpoint")
    p.add_argument("--report", action="store_true", help="per-stage timing report")
    p.add_argument("--health", nargs="?", const=0.0, type=float, default=None,
                   metavar="MAX_SPEED",
                   help="check field health between segments (NaN/Inf always; "
                   "velocity blow-up when MAX_SPEED > 0) — fails fast naming "
                   "the bad segment instead of only at the end")
    p.add_argument("--health-every", type=int, default=100,
                   help="steps per health-check segment")
    p.add_argument("--report-mode", choices=["sampled", "decomposed",
                                             "instrumented"],
                   default="sampled",
                   help="sampled = out-of-band timing of the stages the "
                   "pipeline runs, fused buckets included; decomposed = "
                   "reference-style in-run accumulation with the fused ops "
                   "split back into the reference's stage buckets (re-runs "
                   "the rollout on the unfused ops).  'instrumented' is a "
                   "deprecated alias for 'decomposed'")
    p.add_argument("--profile-dir", default="",
                   help="write a torch.profiler trace of the rollout here; on "
                   f"the card the trace also holds {PROFILE_PAD} spin kernels "
                   "('spin_kernel', from torch.cuda._sleep) at each end, a pad "
                   "that keeps every kernel of the rollout in the trace")
    p.add_argument("--view", choices=["none", "term", "http"], default="none",
                   help="live view: ANSI terminal or browser HTTP stream")
    p.add_argument("--http-port", type=int, default=0,
                   help="port for --view http (0 = pick a free one)")
    p.add_argument("--http-host", default="127.0.0.1",
                   help="bind address for --view http")
    p.add_argument("--interactive", action="store_true",
                   help="steer the fluid live with --view")
    p.add_argument("--pipelined", action="store_true",
                   help="with --view: overlap step dispatch with frame readback")
    p.add_argument("--mesh", choices=["none", "rows", "2d"], default="none",
                   help="shard the rollout over a device mesh (rows, or rows x "
                   "cols); the grid must be divisible by the mesh shape")
    p.add_argument("--mesh-devices", type=int, default=0,
                   help="device count for --mesh (0 = all visible devices; "
                   "more are placed round-robin on the visible ones)")
    return p


def _save_fields(path: str, state: FluidState) -> None:
    """--save-fields writer; creates the parent directory like the
    checkpoint writer does (utils.checkpoint.save_state)."""
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    np.savez_compressed(path, **{k: getattr(state, k).cpu().numpy()
                                 for k in ("u", "v", "dye", "pressure")})


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _clamp_warning(cfg: FluidConfig, state: FluidState, mesh: str):
    """Warning string when the state's velocity bound shows a realized
    advection displacement beyond ``max_displacement`` on a path that
    clamps taps there (the meshes, ``utils.health.clamp_axes``); None when
    the path is exact or the flow stayed within the bound."""
    axes = clamp_axes(cfg.resolve_backend(), mesh)
    if not axes:
        return None
    # the producer-emitted bound of the state's velocity: an 8-byte read
    au, av = (float(x) for x in state.vel_stats.cpu())
    if not (math.isfinite(au) and math.isfinite(av)):
        return None  # blow-up reporting is the health check's job
    return displacement_check(Health(True, 0.0, 0.0, au, av), cfg.dt,
                              cfg.max_displacement, axes)


def _mesh_run(args, cfg: FluidConfig, sim: Simulation, state: FluidState):
    """``--mesh``: (the sharded rollout, the sharded state) over
    ``--mesh-devices`` shards, round-robin on the visible devices of the
    simulation's kind (the JAX CLI's mesh shapes: rows, or the squarest
    rows x cols)."""
    from cudafluidsimulation_tpu_torch.parallel import mesh as pmesh

    visible = pmesh.visible_devices() if sim.device.type == "cuda" else [sim.device]
    ndev = args.mesh_devices or len(visible)
    devices = pmesh.place(ndev, visible)
    if ndev > len(visible):
        print(f"mesh: {ndev} shards on {len(visible)} {sim.device.type} device(s), "
              "placed round-robin")
    if args.mesh == "rows":
        from cudafluidsimulation_tpu_torch.parallel.shardmap_step import make_shardmap_rollout

        mesh = pmesh.make_mesh(ndev, devices=devices)
        run_fn = make_shardmap_rollout(cfg, mesh)
        print(f"mesh: {ndev} devices, rows-only decomposition")
    else:
        from cudafluidsimulation_tpu_torch.parallel.shardmap2d import make_shardmap2d_rollout

        nr = 1
        for cand in range(int(ndev ** 0.5), 0, -1):
            if ndev % cand == 0:
                nr = cand
                break
        mesh = pmesh.make_mesh2d(nr, ndev // nr, devices=devices)
        run_fn = make_shardmap2d_rollout(cfg, mesh)
        print(f"mesh: {ndev} devices, {nr}x{ndev // nr} rows x cols")
    return run_fn, pmesh.shard_state(state, mesh)


def _config(args, nx: int, ny: int) -> FluidConfig:
    """The config the flags ask for (the JAX CLI's preset and override
    rules)."""
    maker = FluidConfig.cpu_reference if args.variant == "cpu" else FluidConfig.gpu_reference
    overrides = dict(backend=args.backend, dt=args.dt)
    if args.preset == "quality":
        # explicit flags below win
        if args.variant == "cpu":
            raise SystemExit("--preset quality applies to the gpu variant")
        overrides.update(pressure_solver="multigrid", mg_tol=0.05,
                         max_displacement=31)
    elif args.preset == "fast":
        if args.variant == "cpu":
            raise SystemExit("--preset fast applies to the gpu variant "
                             "(the cpu parity path has no fast modes)")
        overrides.update(fast_dye=True, fast_velocity=True,
                         fast_diffuse=True)
    if args.diffusion_iters >= 0:
        overrides["diffusion_iters"] = args.diffusion_iters
    if args.pressure_iters >= 0:
        overrides["pressure_iters"] = args.pressure_iters
    if args.pressure_solver is not None:
        overrides["pressure_solver"] = args.pressure_solver
    if overrides.get("pressure_solver") == "multigrid":
        if args.mg_cycles is not None:
            overrides["mg_cycles"] = args.mg_cycles
        if args.mg_tol is not None:
            overrides["mg_tol"] = args.mg_tol
        if args.mg_max_cycles is not None:
            overrides["mg_max_cycles"] = args.mg_max_cycles
        if args.pressure_iters >= 0:
            print("note: --pressure-iters is ignored with --pressure-solver "
                  "multigrid (use --mg-cycles / --mg-tol)")
        if args.mg_cycles is not None and overrides.get("mg_tol", 0.0) > 0:
            print("note: --mg-cycles is ignored when --mg-tol is set "
                  "(cycles run until the residual target, up to "
                  "--mg-max-cycles)")
    else:
        for flag, name in [(args.mg_cycles, "--mg-cycles"),
                           (args.mg_tol, "--mg-tol"),
                           (args.mg_max_cycles, "--mg-max-cycles")]:
            if flag is not None:
                print(f"note: {name} is ignored with --pressure-solver "
                      "jacobi (pass --pressure-solver multigrid or "
                      "--preset quality)")
    if args.max_displacement < 0:
        raise SystemExit("--max-displacement must be >= 0 (0 = default)")
    if args.max_displacement > 0:
        overrides["max_displacement"] = args.max_displacement
    if args.fast_dye:
        overrides["fast_dye"] = True
    if args.fast_vel:
        overrides["fast_velocity"] = True
    if args.fast_diffuse:
        overrides["fast_diffuse"] = True
    return maker(nx=nx, ny=ny, **overrides)


def _impulses(args, cfg: FluidConfig, nx: int, ny: int) -> imps.Impulse:
    if args.impulse_file:
        imp = imps.impulse_from_file(args.impulse_file, cfg.dt)
        args.steps = imps.num_steps(imp)
    elif args.impulse == "orbit":
        imp = imps.orbit_impulse(args.steps, cfg.dt, center=(nx / 2, ny / 2),
                                 radius=min(nx, ny) / 8, omega=3.0)
    elif args.impulse == "center":
        imp = imps.constant_impulse(args.steps, cfg.dt, pos=(nx / 2, ny / 2),
                                    last_pos=(nx / 2 - 3, ny / 2 - 2))
    else:
        imp = imps.no_impulse(args.steps, cfg.dt)
    return imp


def _warm_up(sim: Simulation, state: FluidState, imp: imps.Impulse, render: bool,
             run_fn=None) -> None:
    """Build the kernels (one nvcc a source, all at once) and run one step
    (and one render) on a copy of ``state``, dropped, so that neither the
    build nor a first call's planning is billed to the timed rollout.
    ``run_fn``: the sharded rollout, ``state`` then sharded."""
    from cudafluidsimulation_tpu_torch.ops import _build

    _build.build_all()
    if run_fn is not None:
        from cudafluidsimulation_tpu_torch.parallel.mesh import ShardedState, gather_state

        copy = ShardedState(state.mesh, tuple(FluidState(*(t.clone() for t in s))
                                              for s in state.shards))
        warm = gather_state(run_fn(copy, imps.Impulse(*(f[:1] for f in imp))))
    else:
        copy = FluidState(*(t.clone() for t in state))
        warm = sim.step(copy, imps.slice_step(imp, 0))
    if render:
        sim.render_fn(warm)
    _sync(sim.device)


def _pad(device: torch.device) -> None:
    """PROFILE_PAD spin kernels (``torch.cuda._sleep``, ``spin_kernel`` in
    the trace) between pauses of the host, then a synchronize; nothing on
    the CPU.  A ``torch.profiler`` session on the card can lose its first
    device records (up to 7 in a row were seen on an H100, in a process
    that had opened many sessions): the pad, not the rollout, takes that
    loss."""
    if device.type != "cuda":
        return
    time.sleep(0.01)
    for _ in range(PROFILE_PAD):
        torch.cuda._sleep(1000)
    torch.cuda.synchronize(device)
    time.sleep(0.01)


@contextlib.contextmanager
def _profile(profile_dir: str, device: torch.device):
    """A torch.profiler session over the rollout (CPU and, on the card, CUDA
    activity), with the device idle at its start and a pad of spin kernels
    at each end (:func:`_pad`); its Chrome trace lands in ``profile_dir``
    on exit."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    _sync(device)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(profile_dir)):
        _pad(device)
        yield
        _sync(device)
        _pad(device)


def _view(args, cfg: FluidConfig, state: FluidState, imp: imps.Impulse,
          video_quality: int) -> int:
    """The live frame loop (``models.app.FluidApp``) with a view: the ANSI
    terminal or a browser HTTP stream; honors the chosen impulse source and
    the save/checkpoint/video flags (the JAX CLI's ``--view`` branch)."""
    from cudafluidsimulation_tpu_torch.models.app import (
        FluidApp, finish_readback, orbit_source, queue_readback, replay_source)

    nx, ny = cfg.nx, cfg.ny
    if args.impulse_file:
        # replay the loaded script frame-by-frame (dt comes from the frame
        # loop; see models.app.replay_source)
        source = replay_source(imp)
    elif args.impulse == "orbit":
        source = orbit_source(cfg)
    elif args.impulse == "center":
        def source(t, _c=(nx / 2.0, ny / 2.0)):
            return _c, (_c[0] - 3.0, _c[1] - 2.0), True
    else:
        def source(t, _c=(0.0, 0.0)):
            return _c, _c, False

    for flag, name in [(args.frames_dir, "--frames-dir"), (args.apng, "--apng")]:
        if flag:
            print(f"note: {name} is ignored with --view {args.view} "
                  "(frames go to the live view)")
    if args.health is not None:
        print(f"note: --health is ignored with --view {args.view} "
              "(the frame loop surfaces failures per frame)")

    # periodic checkpointing works in the frame loop too (long interactive
    # sessions should survive a crash/Ctrl-C)
    ckpt_every = args.checkpoint_every if args.checkpoint else 0
    if args.checkpoint_every and not args.checkpoint:
        print("note: --checkpoint-every needs --checkpoint; ignored")

    def on_frame(state, nframes):
        if nframes % ckpt_every == 0:
            save_state(args.checkpoint, state)

    if args.view == "http":
        from cudafluidsimulation_tpu_torch.utils.http_view import HttpViewer

        viewer = HttpViewer(port=args.http_port, width=nx, height=ny, host=args.http_host)
        print(f"live view: {'  '.join(viewer.urls)}  "
              f"(bound on {args.http_host}; Ctrl-C to stop)", flush=True)
    else:
        from cudafluidsimulation_tpu_torch.utils.term_view import TermViewer

        viewer = TermViewer()

    # --video records the live session: the AVI writer streams each frame
    # to disk (flat memory), so a tee costs one encode per frame.  Wall-clock
    # pacing varies in a live loop; the file plays back at --video-fps.
    avi = None
    sink = viewer
    if args.video:
        from cudafluidsimulation_tpu_torch.utils.video import AviWriter

        avi = AviWriter(args.video, nx, ny, fps=args.video_fps, codec=args.video_codec,
                        quality=video_quality)

        def sink(frame):
            viewer(frame)
            avi.add(frame)

    stop_when = None
    tin = contextlib.nullcontext()
    if args.interactive and args.view == "http":
        # live input FROM the browser page itself: the stream page posts
        # pointer drags back to /input, the source polls them per frame
        # (Main.cpp:213-243, browser edition)
        source = viewer.input_source(nx, ny)
        stop_when = lambda: viewer.quit_requested  # noqa: E731
    elif args.interactive:
        # live input: mouse drag / WASD — the reference's interactive loop
        # (Main.cpp:213-243), terminal edition, sized to the TERM viewer so
        # mouse cells land on the rendered pixels
        import shutil

        from cudafluidsimulation_tpu_torch.utils.term_input import TermInput

        size = shutil.get_terminal_size((80, 24))
        viewer.cols = viewer.cols or min(size.columns, 120)
        viewer.rows = viewer.rows or min(size.lines - 2, 48)
        tin = TermInput(nx, ny, viewer.cols, viewer.rows)
        source = tin.source()
        stop_when = lambda: tin.quit  # noqa: E731

    app = FluidApp(cfg, input_source=source, frame_sink=sink, fixed_dt=args.dt)
    app.state = state
    if app.sim.device.type == "cuda":
        # the build, the first step's planning and the pinned host blocks of
        # the frames' readback stay out of the first frames' times
        _warm_up(app.sim, state, imps.constant_impulse(1, cfg.dt, pos=(nx / 2, ny / 2)),
                 render=False)
        frame = app.sim.render_fn(state)
        for readback in [queue_readback(frame), queue_readback(frame)]:
            finish_readback(readback)
    try:
        with tin:
            # cbreak keeps ISIG, so Ctrl-C raises here rather than reaching
            # TermInput's \x03 handler — the session's state must still reach
            # the save/checkpoint flags below
            report = app.run(max_frames=args.steps or None, pipelined=args.pipelined,
                             stop_when=stop_when,
                             on_frame=on_frame if ckpt_every > 0 else None)
    except KeyboardInterrupt:
        report = None
    state = app.state
    if args.view == "http":
        viewer.close()
    if avi is not None:
        avi.close()
        print(f"recorded {app.frames}-frame {avi.codec.upper()} AVI of "
              f"the session to {args.video}")
    if args.save_fields:
        _save_fields(args.save_fields, state)
        print(f"saved fields to {args.save_fields}")
    if args.checkpoint:
        save_state(args.checkpoint, state)
        print(f"saved checkpoint to {args.checkpoint}")
    if report is not None:
        print(report.format())
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.checkpoint_every < 0:
        raise SystemExit("--checkpoint-every must be >= 0")
    nx = args.nx or args.grid
    ny = args.ny or args.grid
    cfg = _config(args, nx, ny)
    try:
        cfg.resolve_backend()
    except RuntimeError:
        raise SystemExit(f"--backend {args.backend} runs the CUDA kernels, but no CUDA "
                         "device is available (torch.cuda.is_available() is False); "
                         "pass --backend ref to run the plain PyTorch ops on the CPU") from None
    sim = Simulation(cfg)
    imp = _impulses(args, cfg, nx, ny)

    video_quality = 90 if args.video_quality is None else args.video_quality
    if args.video_quality is not None and args.video_codec == "rgb":
        print("note: --video-quality is ignored with --video-codec rgb "
              "(lossless uncompressed frames)")
    if args.report_mode == "instrumented":
        print("note: --report-mode instrumented is now called 'decomposed' "
              "(it splits the fused ops back into the reference's stage "
              "buckets)")
        args.report_mode = "decomposed"

    if args.resume:
        # fallback loader: a checkpoint torn by a pre-atomic writer (or a
        # partial disk) falls back to the rotated .prev.npz copy
        state = load_state_with_fallback(args.resume, sim.device)
        if tuple(state.u.shape) != (ny, nx):
            raise SystemExit(
                f"checkpoint grid {state.u.shape[1]}x{state.u.shape[0]} does not "
                f"match requested --grid {nx}x{ny}; pass the matching size"
            )
    else:
        state = sim.init()

    if args.view != "none":
        if args.mesh != "none":
            print(f"note: --mesh is ignored with --view {args.view} "
                  "(the live frame loop is single-device)")
        return _view(args, cfg, state, imp, video_quality)

    collect = bool(args.frames_dir or args.apng or args.video)
    health_on = args.health is not None
    max_speed = args.health if (health_on and args.health > 0) else None

    # One segmented rollout serves frame collection, between-segment health
    # checks, checkpoints and min/max frame-time accounting (Main.cpp:199-200's
    # analog); with none of those active it is one full-length segment.
    n_total = imps.num_steps(imp)
    if collect and n_total == 0:
        raise SystemExit("nothing to run: --steps 0 (or an empty impulse "
                         "script) collects no frames")
    ckpt_every = args.checkpoint_every if args.checkpoint else 0
    if args.checkpoint_every and not args.checkpoint:
        print("note: --checkpoint-every needs --checkpoint; ignored")
    if collect:
        seg = max(1, args.frame_every)
    elif health_on:
        seg = max(1, args.health_every)
    elif ckpt_every:
        seg = max(1, ckpt_every)
    elif args.report:
        seg = max(1, -(-n_total // 10))
    else:
        seg = max(1, n_total)

    # --mesh: the sharded rollout over a device mesh; frames, fields,
    # health checks and checkpoints gather the state
    run_fn, whole, devices = sim.run, (lambda st: st), {sim.device}
    if args.mesh != "none":
        from cudafluidsimulation_tpu_torch.parallel.mesh import gather_state

        run_fn, state = _mesh_run(args, cfg, sim, state)
        whole, devices = gather_state, set(state.mesh.devices)

    if sim.device.type == "cuda" and n_total > 0:
        _warm_up(sim, state, imp, collect, None if args.mesh == "none" else run_fn)

    frames = []
    seg_stats = []  # (wall seconds, steps) per segment
    profile_ctx = (_profile(args.profile_dir, sim.device) if args.profile_dir
                   else contextlib.nullcontext())
    with profile_ctx:
        t0 = time.perf_counter()
        start = 0
        # a step allocates its outputs and never writes into its input's
        # tensors, so the state before a segment stays whole
        last_good = state
        steps_since_ckpt = 0
        clamp_warned = False
        while start < n_total:
            end = min(start + seg, n_total)
            part = imps.Impulse(*(f[start:end] for f in imp))
            s0 = time.perf_counter()
            state = run_fn(state, part)
            for d in devices:
                _sync(d)
            seg_stats.append((time.perf_counter() - s0, end - start))
            if collect:
                frames.append(sim.render(whole(state)))
            if health_on:
                try:
                    h = check_health(whole(state), max_speed=max_speed)
                except HealthError as e:
                    # salvage the last healthy state so a long run is not a
                    # total loss (the recovery layer the reference lacks)
                    if args.checkpoint:
                        good = whole(last_good)
                        save_state(args.checkpoint, good)
                        print(f"saved last healthy state (step "
                              f"{int(good.step)}) to {args.checkpoint}")
                    raise SystemExit(f"health check failed: {e}")
                # per segment: a transient fast flow shows even if the
                # final state has calmed
                axes = clamp_axes(cfg.resolve_backend(), args.mesh)
                w = displacement_check(h, cfg.dt, cfg.max_displacement, axes) if axes else None
                if w and not clamp_warned:
                    print(f"warning: {w}")
                    clamp_warned = True
                last_good = state
            if ckpt_every:
                steps_since_ckpt += end - start
                if steps_since_ckpt >= ckpt_every:
                    save_state(args.checkpoint, whole(state))
                    steps_since_ckpt = 0
            start = end
        wall = time.perf_counter() - t0
    state = whole(state)

    if args.frames_dir:
        os.makedirs(args.frames_dir, exist_ok=True)
        for i, frame in enumerate(frames):
            write_png(os.path.join(args.frames_dir, f"frame_{i:05d}.png"), frame)
        print(f"wrote {len(frames)} frames to {args.frames_dir}")

    if args.apng:
        from cudafluidsimulation_tpu_torch.utils.png import write_apng

        write_apng(args.apng, frames, fps=args.apng_fps)
        print(f"wrote {len(frames)}-frame animation to {args.apng}")

    if args.video:
        from cudafluidsimulation_tpu_torch.utils.video import write_avi

        used = write_avi(args.video, frames, fps=args.video_fps,
                         codec=args.video_codec, quality=video_quality)
        print(f"wrote {len(frames)}-frame {used.upper()} AVI to {args.video} "
              "(ffmpeg -i ... out.mp4 to transcode)")

    if args.save_fields:
        _save_fields(args.save_fields, state)
        print(f"saved fields to {args.save_fields}")

    if args.checkpoint:
        save_state(args.checkpoint, state)
        print(f"saved checkpoint to {args.checkpoint}")

    if not clamp_warned:
        warn = _clamp_warning(cfg, state, args.mesh)
        if warn:
            print(f"warning: {warn}")

    rep = StageReport(grid=f"{nx}x{ny}", steps=args.steps, total_s=wall)
    if args.report and args.mesh != "none":
        print("note: per-stage --report sampling reflects the single-chip "
              "op set; skipped with --mesh (whole-step timings above are "
              "the sharded rollout's)")
    elif args.report:
        if args.report_mode == "decomposed":
            from cudafluidsimulation_tpu_torch.utils.instrument import run_instrumented

            rep.stage_ms = run_instrumented(cfg, sim.init(), imp)[1].stage_ms
        else:
            # sample stages from the rollout's final state: advection cost
            # follows the flow, so a zero-state sample would report
            # quiet-flow numbers for a driven run
            rep.stage_ms = sim.stage_timings(state=state).stage_ms
    if len(seg_stats) > 1:
        # per-step min/max over the segments (Main.cpp:199-200)
        per_step = [w / k for w, k in seg_stats]
        rep.stage_ms["Min frame"] = 1000.0 * min(per_step)
        rep.stage_ms["Max frame"] = 1000.0 * max(per_step)
    print(rep.format())
    return 0


if __name__ == "__main__":
    sys.exit(main())
