#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card, end to end.

    python3 chip_smoke.py            # from the repository root; needs one CUDA device

Phases, in order; any failure exits non-zero and no phase's failure is
caught:

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. build the four kernels from ``cudafluidsimulation_tpu_torch/csrc`` with
   ``nvcc`` (one compiler per source, all at once) and print the seconds;
3. hold each kernel (H1 advect in both modes, H2 vorticity, H3 diffusion
   with the splat, H4 pressure with its velocity bound) against its plain
   PyTorch version on the same inputs at 2048x2048 and 540x960, then, at
   540x960, the dye's NaN saturation, the cpu variant's flags (vorticity
   sign and epsilon, full divergence, 2-channel diffusion) and 0, 1 and 2
   iterations;
4. the main path: the 2048² gpu-parity step (``bench.py``'s configuration)
   on ``backend="cuda"`` — a driven 200-step orbit rollout, a quiet
   rollout and one rendered frame, with every kernel's launch count read
   around that run — then one driven step held against the same step on
   ``backend="ref"`` on the card;
5. timing with CUDA events after a warm-up: driven and quiet steps/s, and
   each kernel's ms at the path's shapes beside its plain version's.

The line before the last is the ``kernels`` JSON; the last line is
``{"ok": true, "device": {...}}``.  The script imports nothing of JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

SEED = 0
N = 2048
STEPS = 200
CHECK_SHAPES = ((2048, 2048), (540, 960))
# max |kernel - plain| <= RTOL * max(max|plain|, 1) for each kernel.
# The kernels are built without FMA contraction and use the same CUDA math
# library as PyTorch's own kernels, so they round as the plain versions do;
# what remains is the plain version's division by a host scalar, which
# PyTorch computes as a multiply by the reciprocal (one ulp inside the
# splat's expf), and the sums of 20 or 40 sweeps carrying that ulp along.
RTOL = {"H1": 1e-6, "H2": 1e-6, "H3": 1e-5, "H4": 1e-5}
# one whole driven step, cuda against ref on the card:
# max |cuda - ref| <= STEP_RTOL * max|ref| for each field
STEP_RTOL = 1e-5


def _json(obj) -> None:
    print(json.dumps(obj), flush=True)


def _max_err(got, exp):
    """(max abs error, max abs error over max|exp|)."""
    err = (got.double() - exp.double()).abs().max().item()
    scale = exp.double().abs().max().item()
    return err, err / scale if scale > 0 else err


def _check(worst, name, what, pairs):
    """Fail unless every (label, got, exp) agrees within RTOL[name]; keep
    the largest error seen for ``name`` in ``worst``."""
    for label, got, exp in pairs:
        if got.shape != exp.shape:
            raise AssertionError(f"{name} {what}: shape {tuple(got.shape)} != {tuple(exp.shape)}")
        err, rel = _max_err(got, exp)
        tol = RTOL[name] * max(exp.abs().max().item(), 1.0)
        _json({"phase": "kernel_check", "kernel": name, "case": f"{what} {label}",
               "max_abs_err": err, "max_rel_err": rel, "tol_abs": tol})
        if not err <= tol:
            raise AssertionError(f"{name} {what} {label}: max abs err {err} > {tol}")
        worst[name] = max(worst[name], err)


def _check_bound(name, stats, u, v):
    """Fail if a kernel-emitted [max|u|, max|v|] is below the true max."""
    true = torch.stack([u.abs().max(), v.abs().max()])
    if not bool((stats >= true).all()):
        raise AssertionError(f"{name} vel_stats {stats.tolist()} below {true.tolist()}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from cudafluidsimulation_tpu_torch import FluidConfig, Simulation
    from cudafluidsimulation_tpu_torch.ops import _build, advect_cuda, jacobi_cuda, ref
    from cudafluidsimulation_tpu_torch.utils.impulse import (
        no_impulse, orbit_impulse, slice_step)
    from cudafluidsimulation_tpu_torch.utils.timing import cuda_times_ms

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kernels = {
        "H1": (advect_cuda.KERNEL, "advect.cu", "advect_pallas.py:413"),
        "H2": (jacobi_cuda.VORTICITY, "vorticity.cu", "jacobi_pallas.py:1411"),
        "H3": (jacobi_cuda.DIFFUSE, "diffuse.cu", "jacobi_pallas.py:492"),
        "H4": (jacobi_cuda.PRESSURE, "pressure.cu", "jacobi_pallas.py:1120"),
    }

    # -- 1. the card ---------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()
    print(smi[0], flush=True)
    _json({"phase": "card", "torch": torch.__version__, "cuda": torch.version.cuda,
           "device": torch.cuda.get_device_name(0),
           "count": torch.cuda.device_count()})

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    for name in _build.SOURCES:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}", flush=True)
    _json({"phase": "build", "seconds": build_s, "nvcc": _build.nvcc()})

    # -- 3. each kernel against its plain version ----------------------------
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    dt, decay_rate = 1.0 / 60.0, 1.2
    worst = {k: 0.0 for k in kernels}
    coeffs, amps = [0.8] * 5, [-3.5, 2.25, 1.0, 0.5, 0.3]
    for h, w in CHECK_SHAPES:
        tag = f"{h}x{w}"
        # velocities of ~200 cells/s (a few cells a step) with a tail that
        # backtraces off the domain, so edge taps extrapolate
        u, v = randn(h, w, scale=200.0), randn(h, w, scale=200.0)
        dye = torch.rand((3, h, w), generator=gen, device=dev)
        got = advect_cuda.advect_velocity(u, v, dt, decay_rate, return_stats=True)
        exp = ref.advect_velocity(u, v, dt, decay_rate, return_stats=True)
        _check(worst, "H1", f"velocity {tag}", zip("uv", got[:2], exp[:2]))
        _check_bound("H1", got[2], got[0], got[1])
        _check(worst, "H1", f"dye {tag}", [(
            "dye", advect_cuda.advect_dye(dye, got[0], got[1], dt, decay_rate),
            ref.advect_dye(dye, got[0], got[1], dt, decay_rate))])
        _check(worst, "H2", f"gpu {tag}", zip(
            "uv", jacobi_cuda.vorticity_confinement(u, v, dt, 50.0, variant="gpu"),
            ref.vorticity_confinement_gpu(u, v, dt, 50.0)))
        fields = torch.cat([torch.stack([u, v]), dye])
        last = (w * 0.4, h * 0.6)
        _check(worst, "H3", f"splat {tag}", [(
            "fields",
            jacobi_cuda.diffuse_multi_splat(fields, dt, coeffs, 20, amps, last, 400.0),
            ref.diffuse_multi_splat(fields, dt, coeffs, 20, amps, last, 400.0))])
        got = jacobi_cuda.pressure_project(u, v, 40, True, return_stats=True)
        exp = ref.pressure_project(u, v, 40, True, return_stats=True)
        _check(worst, "H4", f"half {tag}", zip(("u", "v", "p"), got[:3], exp[:3]))
        _check_bound("H4", got[3], got[0], got[1])

    # the variants' flags and the edge cases, at the reference GPU grid
    h, w = CHECK_SHAPES[-1]
    # dye NaN saturation: zeros left of ones and a backtrace past x = 0
    # extrapolate below zero; pow gives NaN and fminf(1, NaN) is 1
    sat = torch.rand((3, h, w), generator=gen, device=dev)
    sat[:, :, 0], sat[:, :, 1] = 0.0, 1.0
    push = torch.full((h, w), 30.0, device=dev)
    got = advect_cuda.advect_dye(sat, push, v, dt, decay_rate)
    if not bool((got[:, :, 0] == 1.0).all()) or bool(torch.isnan(got).any()):
        raise AssertionError("H1 dye: NaN saturation to 1 failed")
    _check(worst, "H1", "dye saturation", [("dye", got, ref.advect_dye(sat, push, v, dt, decay_rate))])
    _check(worst, "H2", "cpu", zip(
        "uv", jacobi_cuda.vorticity_confinement(u, v, dt, 0.35, variant="cpu"),
        ref.vorticity_confinement_cpu(u, v, dt, 0.35)))
    for iters in (0, 1, 2):
        _check(worst, "H3", f"splat iters={iters}", [(
            "fields", jacobi_cuda.diffuse_multi_splat(fields, dt, coeffs, iters, amps, last, 400.0),
            ref.diffuse_multi_splat(fields, dt, coeffs, iters, amps, last, 400.0))])
    _check(worst, "H3", "diffuse 2-channel", [(
        "uv", jacobi_cuda.diffuse(fields[:2].contiguous(), dt, 0.8, 5),
        ref.diffuse(fields[:2], dt, 0.8, 5))])
    for iters in (0, 1, 2):
        got = jacobi_cuda.pressure_project(u, v, iters, False, return_stats=True)
        exp = ref.pressure_project(u, v, iters, False, return_stats=True)
        _check(worst, "H4", f"full iters={iters}", zip(("u", "v", "p"), got[:3], exp[:3]))
        _check_bound("H4", got[3], got[0], got[1])
    del u, v, dye, fields, sat, push, got, exp
    torch.cuda.synchronize()

    # -- 4. the main path ----------------------------------------------------
    cfg = FluidConfig.gpu_reference(nx=N, ny=N, pressure_iters=40,
                                    max_displacement=31, backend="cuda")
    sim = Simulation(cfg)
    driven = orbit_impulse(STEPS, cfg.dt, center=(N / 2, N / 2), radius=N / 8, omega=3.0)
    quiet = no_impulse(STEPS, cfg.dt)
    for kern, _, _ in kernels.values():
        kern.reset()
    state, (disp_x, disp_y) = sim.run_displacement(sim.init(), driven)
    quiet_state = sim.run(sim.init(), quiet)
    frame = sim.render(state)
    torch.cuda.synchronize()
    launches = {k: kern.launches for k, (kern, _, _) in kernels.items()}
    _json({"phase": "main_path", "launches": launches,
           "realized_max_displacement": max(disp_x, disp_y)})
    for k, n in launches.items():
        if n == 0:
            raise AssertionError(f"{k} was not launched on the main path")
    for name in ("u", "v", "dye", "pressure"):
        for s in (state, quiet_state):
            if not bool(torch.isfinite(getattr(s, name)).all()):
                raise AssertionError(f"{name} is not finite after the rollout")
    dmin, dmax = state.dye.min().item(), state.dye.max().item()
    if not (0.0 <= dmin and dmax <= 2.0):
        raise AssertionError(f"dye outside [0, 2]: [{dmin}, {dmax}]")
    if frame.shape != (N, N, 4) or frame.dtype.name != "uint8" or frame[..., :3].max() == 0:
        raise AssertionError(f"bad frame {frame.shape} {frame.dtype} max {frame.max()}")
    ref_sim = Simulation(FluidConfig.gpu_reference(
        nx=N, ny=N, pressure_iters=40, max_displacement=31, backend="ref"), device=dev)
    imp = slice_step(driven, STEPS - 1)
    got, exp = sim.step(state, imp), ref_sim.step(state, imp)
    step_err = {}
    for name in ("u", "v", "dye", "pressure", "vel_stats"):
        err, rel = _max_err(getattr(got, name), getattr(exp, name))
        step_err[name] = rel
        if not rel <= STEP_RTOL:
            raise AssertionError(f"one driven step, cuda vs ref: {name} rel err {rel}")
    frames_equal = bool(torch.equal(sim.render_fn(got), ref_sim.render_fn(exp)))
    _json({"phase": "step_vs_ref", "max_rel_err": step_err, "tol": STEP_RTOL,
           "frames_equal": frames_equal,
           "dye_range": [dmin, dmax], "quiet_u_max": quiet_state.u.abs().max().item()})

    # -- 5. timing -----------------------------------------------------------
    driven_ms = statistics.median(cuda_times_ms(lambda: sim.run(sim.init(), driven), iters=3))
    quiet_ms = statistics.median(cuda_times_ms(lambda: sim.run(sim.init(), quiet), iters=3))
    short = orbit_impulse(20, cfg.dt, center=(N / 2, N / 2), radius=N / 8, omega=3.0)
    ref_ms = statistics.median(cuda_times_ms(lambda: ref_sim.run(ref_sim.init(), short), iters=3))
    _json({"metric": "steps_per_sec", "grid": f"{N}x{N}", "steps": STEPS,
           "driven": STEPS / (driven_ms / 1000.0), "quiet": STEPS / (quiet_ms / 1000.0),
           "driven_ms_per_step": driven_ms / STEPS, "quiet_ms_per_step": quiet_ms / STEPS,
           "ref_backend_driven_ms_per_step": ref_ms / 20, "smi": smi[0]})

    # per kernel, at the main path's shapes, on the driven state's fields
    u, v, dye = state.u, state.v, state.dye
    u2, v2 = advect_cuda.advect_velocity(u, v, dt, decay_rate)
    all5 = torch.cat([torch.stack([u, v]), dye]).contiguous()
    amps = [-3.5, 2.25, 1.0, 0.5, 0.3]
    last = (N / 2 + N / 8, N / 2)
    cases = {
        "H1": (lambda: (advect_cuda.advect_velocity(u, v, dt, decay_rate, return_stats=True),
                        advect_cuda.advect_dye(dye, u2, v2, dt, decay_rate)),
               lambda: (ref.advect_velocity(u, v, dt, decay_rate, return_stats=True),
                        ref.advect_dye(dye, u2, v2, dt, decay_rate))),
        "H2": (lambda: jacobi_cuda.vorticity_confinement(u, v, dt, 50.0, variant="gpu"),
               lambda: ref.vorticity_confinement_gpu(u, v, dt, 50.0)),
        "H3": (lambda: jacobi_cuda.diffuse_multi_splat(all5, dt, [0.8] * 5, 20, amps, last, 400.0),
               lambda: ref.diffuse_multi_splat(all5, dt, [0.8] * 5, 20, amps, last, 400.0)),
        "H4": (lambda: jacobi_cuda.pressure_project(u, v, 40, True, return_stats=True),
               lambda: ref.pressure_project(u, v, 40, True, return_stats=True)),
    }
    rows = []
    for k, (kern_fn, plain_fn) in cases.items():
        # plain, kernel, kernel, plain: drift affects both alike
        p1 = cuda_times_ms(plain_fn, iters=5, warmup=1)
        k1 = cuda_times_ms(kern_fn, iters=10, warmup=2)
        k2 = cuda_times_ms(kern_fn, iters=10, warmup=0)
        p2 = cuda_times_ms(plain_fn, iters=5, warmup=0)
        kern, src, replaces = kernels[k]
        rows.append({
            "name": f"{k} {src[:-3]}", "route": "cuda",
            "source": f"cudafluidsimulation_tpu_torch/csrc/{src}",
            "replaces": f"cudafluidsimulation_tpu/ops/{replaces}",
            "launches": launches[k], "max_abs_err": worst[k],
            "ms": statistics.median(k1 + k2), "plain_ms": statistics.median(p1 + p2),
        })
    print(smi[0], flush=True)
    _json({"kernels": rows})
    _json({"ok": True, "device": {"platform": "gpu",
                                  "kind": torch.cuda.get_device_name(0),
                                  "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
