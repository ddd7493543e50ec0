#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card, end to end.

    python3 chip_smoke.py            # from the repository root; needs one CUDA device

Phases, in order; any failure exits non-zero and no phase's failure is
caught:

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. build the six kernel sources from ``cudafluidsimulation_tpu_torch/csrc``
   with ``nvcc`` (one compiler per source, all at once), print the seconds
   and each kernel's ``ptxas`` registers and spills, and fail if H2, H3,
   H4, H6 or H7 spills;
3. hold each kernel against its plain PyTorch version on the same inputs:
   H2 vorticity, both variants, bit-identical at 2048², 540x960,
   2049x2047, 2050x2046, 135x240, 16x16, 4x8, 3x5 and 1x1 (odd widths
   and unaligned planes take its scalar path), into a fresh (2, H, W)
   tensor and into channels 0-1 of a (5, H, W) pack whose other channels
   it must leave alone; H1 advect in both modes (its dye also into
   channels 2-4 of a pack, equal to the fresh call) and in its one launch
   of both (``advect_both``, the step's call), which must equal the two
   passes bit for bit (into the pack too, at H2's shapes, from unaligned
   planes, through the dye's NaN saturation) and the plain versions
   within RTOL, its bound ``vel_max`` of its output (a NaN velocity
   giving a NaN bound, as H1's and H8's velocity passes); H3 diffusion with
   the splat, H4 pressure with its velocity bound, H5 divergence and
   projection at 2048x2048 and 540x960; H6 (the multigrid smoother ends) also at 135x240
   and 16x16, the coarse levels' shapes, and its ends with the grid
   transfers fused in at the level pairs 2048²→1024², 540x960→270x480,
   32²→16² and 2050x2046→1025x1023 (ragged tiles), at 1, 2 and 9 sweeps
   (9 is two bursts), every H6 entry held to 0; then, at 540x960, the dye's NaN
   saturation, the cpu variant's flags (vorticity sign and epsilon, full
   divergence, 2-channel diffusion), 0, 1 and 2 iterations, and H4's
   standalone ``pressure_solve`` at 0, 1, 2 and 40 sweeps; H3 and H4 at
   k - 1, k, k + 1 and 2k + 1 sweeps (k the planner's burst depth) at
   16x16, 4x8, 135x240 and 2049x2047 (ragged tiles), where H4, its solve
   and H3 without the splat must be bit-identical; H7 (separable
   diffusion) with and without the splat (without it held to 0), at 5 and
   2 channels, at 2048x2048, 540x960, 16x16 and 4x8 (where radius 5
   reflects more than once), its generic kernel on another design's radii,
   and against H3's 20 sweeps; H8 (bf16-tap advection) in both modes on driven
   fields (the rounded branch) and quiet ones (the exact branch, also equal
   to H1 bit for bit), with ``vel_stats`` given and absent, with
   ``advect_fast_path`` off, the dye into a pack as with H1, and the dye's
   clamp and NaN saturation;
4. the gpu-parity path: the 2048² step (``bench.py``'s configuration) on
   ``backend="cuda"`` — a driven 200-step orbit rollout, a quiet rollout
   and one rendered frame, with every kernel's launch count read around
   that run — then one driven step held against ``backend="ref"`` on the
   card, and bit for bit against the same step with the 5-channel pack
   built by ``torch.cat`` (:func:`cat_form`), and the device operations
   of one step (11, none a ``cat``); H1's one launch a step and neither of
   its passes, and both rollouts bit for bit against the same rollouts
   through H1's two passes (a namespace without ``advect_both``);
   ``run_scan_render`` for 4 steps, bit for bit against the step and the
   render one at a time, each step within STEP_RTOL (its frame one level)
   of the same step on ``backend="ref"`` from the same state; one step
   under ``emit_nvtx``, with the
   spans' gate open and the state unchanged;
5. the quality path: ``FluidConfig.quality`` at 2048² (multigrid pressure,
   V-cycles until rms(A p + div) < 0.05) on ``backend="cuda"``, the same
   rollouts and frame, launch counts read around them (H5, H6's fused
   ends and its stopping test's mean of squares launched, H4's
   ``pressure_project`` not), the V-cycles each step
   took (from the H6 entries' counts), the device operations of one step
   (``torch.profiler``: 47 at its 2 V-cycles, none a ``cat``), one driven
   step against ``backend="ref"`` and against the ``torch.cat`` pack, the
   tolerance met by one projection of the driven state, and H1's one
   launch against its two passes as on the parity path;
6. the fixed-cycle multigrid path (``mg_cycles=2``, ``mg_tol=0``) at 2048²
   for a few steps: its last cycle ends in ``prolong_smooth_project``; one
   step against ``backend="ref"``;
7. the fast path: ``bench.py``'s ``fast_steps_per_sec`` configuration
   (the parity step with ``fast_dye``, ``fast_velocity`` and
   ``fast_diffuse``) on ``backend="cuda"``, the same rollouts and frame,
   launch counts read around them (H7 and H8 launched, H1 and H3 not), one
   driven step against the same step on the plain versions of every
   kernel on the card and against the ``torch.cat`` pack, the device
   operations of one step (10, none a ``cat``), that step's distance from the exact parity step
   and of its advected velocity from the exact one (information), and one
   step under ``torch.cuda.set_sync_debug_mode("error")``, which shows
   that the step reads nothing back;
8. ensembles (``models/ensemble.py``), at 64 members x 512² with
   ``gpu_reference(nx=512, ny=512, pressure_iters=40)``: batched H1 (into
   channels 2-4 of a NaN pack), H2 (both variants, into channels 0-1), H3
   (with the splat, without it, and 2-channel) and H4 (from the pack's
   velocity planes) against their batched plain versions and, member by
   member, bit for bit against the single (B = 1) launches, at 64x512²,
   3x540x960, 5x135x240 and 7x4x8; a 200-step ``make_diffusion_sweep_run``
   over viscosities ``linspace(0.1, 2.0, 64)`` (the one nearest the
   config's 0.8 set to it) of ``orbit_impulse(200, dt, center=(256, 256),
   radius=64, omega=3.0)`` jittered by up to 32 cells a member, with the
   batched launch counts read around it (no single-member launch), and
   members 0, 31, 63 and the one at the config's viscosity bit for bit
   against their single-member rollouts; the device operations of one
   batched step (12: the members' parameter copy and the parity step's
   11); batched H1's one launch of both into ``pack[:, 2:5]`` bit for bit
   against its two passes, each member against its B = 1 launch; one
   batched step under ``set_sync_debug_mode("error")``; a
   cpu-variant ensemble (8 x 512², 10 steps) and one of its steps against
   the plain versions on the card;
9. the fast and multigrid ensembles on batched H5-H8: H5 (divergence and
   projection from a pack's velocity planes), every H6 end (the ends with
   the grid transfers at the level pairs 64x512²->256², 3x540x960,
   5x32x32, 2x2050x2046, 1, 2 and 9 sweeps), H7 (unrolled and generic,
   with and without each member's splat from its device row) and H8
   (velocity and dye into ``pack[:, 2:5]``, members quiet and driven
   mixed, ``vel_stats`` given and absent, ``advect_fast_path`` on and off)
   against their batched plain versions and each member against its B = 1
   launch bit for bit at 64x512², 3x540x960, 5x135x240 and 7x4x8; the
   stopping test's fixed-order mean of squares (H6 mean_square), single
   and batched, against its plain version, and whether PyTorch's own
   batched mean equals its single one (information); 65,537 members at 4x8
   (blocks walking the grid's z or y extent) against the 7-member batch
   they repeat; a 200-step 64x512² fast ensemble (H8, H2, H7, H4 batched)
   and a 200-step 64x512² quality viscosity sweep (H1-H3, H5, H6 batched),
   launch counts read around each (no single-member launch), members 0,
   31, 63 and the sweep's member at the config's viscosity bit for bit
   against their single rollouts, the sweep's V-cycles a step for each
   checked member and for the batch (its host reads: cycles + 1); 8
   fixed-cycle multigrid steps from the sweep's state (H6
   ``prolong_smooth_project`` batched); the device operations of one
   batched fast step (11) and of one batched quality step whose members
   stop together (12 + 14k at k V-cycles), the host reads of the sweep's
   last step, and one batched fast step under
   ``set_sync_debug_mode("error")``;
10. the headless CLI (``cudafluidsimulation_tpu_torch.cli.main``, in
   process, outputs under a temporary directory) at 2048² on the default
   backend: the parity run (``--steps 200 --impulse orbit --pressure-iters
   40 --max-displacement 31``, frames every 50 steps, ``--video``,
   ``--save-fields``, ``--checkpoint`` every 100 steps, ``--health``,
   ``--report``) with 4 PNGs, an AVI that parses back with 4 frames, its
   rollout's launches exactly 200 steps' worth, its fields and checkpoint
   bit-equal to ``Simulation.run`` over the same orbit; the same rollout
   with ``--report`` alone (the step rate without outputs); 10 steps resumed
   from that checkpoint, bit-equal to ``Simulation.run`` from
   ``load_state``, with ``--profile-dir`` (one trace written, whose
   kernel events, its pad of spin kernels left out by name, must equal the
   rollout's entry calls times each entry's device launches: 100);
   ``--preset quality`` and ``--preset fast``, 50 steps
   each with ``--report``, bit-equal to ``Simulation.run`` with their
   report rows; ``--report-mode decomposed``, 20 steps, launching H4's
   ``pressure_solve`` entry and H5's divergence and projection 20 times
   each, and one decomposed step against the fused step within 1e-5 of
   scale (the splat's ulp); one ``cli`` JSON line with each run's
   steps/s, stage ms and seconds;
11. the live views at 2048² on the parity configuration with a fixed dt
   (``models.app.FluidApp``, 64 frames a loop, launches read around every
   loop: H1-H4 64, nothing else): the loop's final state bit-equal
   to ``Simulation.run`` over the impulses its orbit source gave; plain and
   pipelined frames equal by their SHA-1, the last one
   ``Simulation.frame_image``'s bytes; frames/s and Min/Max/avg frame ms
   with no sink, ``TermViewer`` into a string, the native ``HttpViewer``
   (required) with a ``/stream`` client (JPEG parts), ``/frame`` (PNG) and
   ``/input`` mapped by ``input_source``, and ``FrameSink`` (required;
   written + dropped = 64), each pipelined and not; a ``TermInput`` drag
   whose dye peaks under it; the CLI's ``--view http --interactive
   --backend cuda`` ended by a client's press and ``q`` (exit 0, dye in
   ``--save-fields``) and ``--view term --impulse orbit --video`` (an AVI
   of 64 frames, fields bit-equal to the loop's); the render's device ms
   and the readback's parts; one ``views`` JSON line; then ``entry()``
   (one 512² step bit-equal to ``Simulation.step``) and
   ``examples/headless_run_torch.py`` (30 frames through ``FrameSink``, a
   checkpoint that loads);
12. the sharded rollout (``parallel/``): H1's and H8's window entry
   against their plain versions, bit for bit but for the dye's ``powf``
   (``RTOL``), on a first, a middle and the last shard of 8192² over 4 rows
   ((2048 + 62) x 8192, y0 = -31, 2017, 6113), a 2 x 2 corner shard
   ((4096 + 62)², x0 = -31) and a ragged 135 x 240 window, both modes,
   driven and quiet flows, ``vel_stats`` given and absent; H4's solve from
   an iterate at 1, k, k + 1, 2k + 1 sweeps on a (2048 + 18) x 8192 shard;
   H3 on an 8-padded shard in bursts of 3, its rows by the seam equal to
   the global sweeps; then gpu parity at 8192² with 100 pressure sweeps
   (BASELINE.json config 5) on a 4-shard rows mesh and a 2 x 2 mesh on
   the visible card(s): a 20-step orbit rollout (launches, each shard's,
   exchange pairs a step), one step against the sharded ``ref`` step, the
   first step against one device within 1e-5 and the rollout against
   ``Simulation.run`` (the realized displacement printed: past the halo
   the meshes clamp taps, so the comparison is information), ms a step of
   both; the fast flags and the quality preset on the rows mesh (3 steps,
   then one step against the plain versions); the CLI's ``--mesh 2d`` and
   ``--mesh rows`` 20-step runs, whose final states equal the rollouts';
   ``entry.dryrun_multichip(4)`` (its (ens, x) part first) and
   ``examples/multichip_2d_torch.py``;
13. sharded ensembles (``parallel/sharded.py``'s (ens, x) mesh): H1's and
   H8's window with its rows unbounded (``ref.Window.y_in``, the global
   step's advection) against their plain versions on each half of 8192²
   and of 2048² and a ragged middle, both modes, driven and quiet flows,
   ``vel_stats`` given and absent; (a) BASELINE.json config 4, 64 x 512²
   gpu parity with 40 pressure sweeps and jittered orbits, 200 steps on an
   (ens 4, x 1) mesh whose groups share the card, bit-equal to
   ``make_ensemble_run``'s 64-member run, each group's launches of batched
   H1-H4, member-steps/s of both, and over the last 25 steps the host's
   time to the call's return and the device's busy time and idle share
   (``torch.profiler``); (b) 2 x 8192² with 100 sweeps on (ens 2, x 2): 20 one-device
   orbit steps per member, one sharded step within 1e-5 of scale of each
   member's ``Simulation.step`` with the realized displacement past
   ``max_displacement``, 20 sharded steps against one device's
   (information), ms a step beside the rows mesh's; (c) the fast and
   quality presets, 3 steps on (2, 2) at 2048², then one step against the
   same mesh's plain schedule (``kernels=shardmap_step.PLAIN``);
14. timing with CUDA events after a warm-up: driven and quiet steps/s of
   the parity, quality and fast paths, the fixed-cycle path's ms/step, the
   plain versions' ms/step on the card, the device launches one H3, one H4
   and each H6 call of the quality path make (``torch.profiler``; one each
   for H6), H3 and H4 under a few other burst
   plans (information), and each kernel's ms at its path's shapes (by CUDA
   events over 10 calls, and its device ms by ``torch.profiler``, which
   differ where a kernel is shorter than its wrapper's host cost) beside
   its plain version's and its bound: the larger of its bytes (each input
   read once, each output written once) at 3.35 TB/s and its float32
   operations at 67 TFLOP/s (``H1`` is the step's one launch, against 10
   planes; ``H1 velocity pass`` and ``H1 dye pass`` its passes apart, 4
   and 8; ``H8`` its two passes, 12, with each pass's device ms); H1's
   velocity pass with and without its bound (``advect_bound`` lines,
   single and batched, information); the ensemble's member-steps/s batched and
   with the same members run one after another as single-member steps,
   and the batched kernels' rows (``H1 batched`` ... ``H4 batched``, each
   asserted to make one device launch a stage or a burst for all members);
   the same for the fast ensemble and the quality sweep over their last 25
   steps (batched, one member at a time and the device trace, all from the
   state each rollout reached before them), and the rows ``H5 batched``,
   ``H6 batched <end>`` (every end at the 64x512² fine level, the bottom at
   16²), ``H6 batched mean_square``, ``H7 batched`` and ``H8 batched``;
   and the sharded rows at the rows mesh's shard shapes: ``H1 window``,
   ``H8 window``, ``H3 sharded``, ``H4 solve init``, ``H7 sharded``; and
   ``H1 window unbounded`` on a (2, 2) shard of (b)'s 8192² state and
   ``H8 window unbounded`` on one of (c)'s fast 2048² state (bound: the
   rows the realized displacement reaches).

Every ``torch.profiler`` trace runs marker kernels before and after the
work it counts, and is taken again when it lost device records.

The line before the last is the ``kernels`` JSON; the last line is
``{"ok": true, "device": {...}}``.  The script imports nothing of JAX.
"""

from __future__ import annotations

import functools
import json
import re
import statistics
import subprocess
import sys
import time
import types
from pathlib import Path

import torch

SEED = 0
N = 2048
STEPS = 200
FIXED_STEPS = 8
BATCH = 10  # kernel calls in each timed window of the per-kernel rows
CHECK_SHAPES = ((2048, 2048), (540, 960))
MG_SHAPES = CHECK_SHAPES + ((135, 240), (16, 16))
# the fine shapes of the level pairs H6's fused ends are checked at: the
# 2048² fine level, the reference grid, the last pair above the 16² bottom,
# and an even grid whose tiles are ragged on both axes
MG_PAIRS = ((2048, 2048), (540, 960), (32, 32), (2050, 2046))
# max |kernel - plain| <= RTOL * max(max|plain|, 1) for each kernel.
# The kernels are built without FMA contraction and use the same CUDA math
# library as PyTorch's own kernels, so they round as the plain versions do.
# H2, H4, its solve, H5 and H6, and H3 without the splat ("H3 sweeps"), are
# additions, multiplications, divisions and square roots in the plain
# version's order, one PyTorch op per operation, so they are
# bit-identical; H4, its solve and "H3
# sweeps" are held to 0 at every burst plan (a blocked sweep computes each
# cell as a global sweep does), and so is H6 (blocked the same way, its
# restriction and prolongation in the plain version's order).  The splat's
# division by a host scalar is a multiply by the reciprocal in PyTorch,
# one ulp inside the exp: H3 and H7 keep 1e-5 for it; H7 without the splat
# ("H7 sweeps": the plain version's products and sums in its order) is
# held to 0.  H8 is H1's arithmetic over taps rounded by integer
# operations, so bit-identical as H1.
RTOL = {"H1": 1e-6, "H2": 0.0, "H3": 1e-5, "H3 sweeps": 0.0, "H4": 0.0,
        "H4 solve": 0.0, "H5": 1e-6, "H6": 0.0, "H7": 1e-5, "H7 sweeps": 0.0,
        "H8": 1e-6}
# H1's velocity and dye in one launch against its two passes: the same
# floats (the dye backtraces through the u', v' the two-pass form writes
# and reads back), so 0; each design against the shipped one, 0
RTOL.update({"H1 fused": 0.0, "H1 fused batched": 0.0})
# phase 12, the sharded rollout's entries: H1/H8's window is H1's/H8's
# arithmetic on global coordinates; H4's solve from an iterate and H3 on a
# padded shard (no splat) are blocked sweeps in the plain order: 0
RTOL.update({"H1 window": 1e-6, "H8 window": 1e-6, "H4 solve init": 0.0, "H3 sharded": 0.0})
# phase 13: the same entry with its rows unbounded (the global step)
RTOL.update({"H1 window unbounded": 1e-6, "H8 window unbounded": 1e-6})
# the batched kernels against their batched plain versions: the single
# kernels' tolerances (and each member equals its B = 1 launch bit for bit)
RTOL.update({f"{k} batched": RTOL[k] for k in ("H1", "H2", "H3", "H3 sweeps", "H4")})
# H5, H6, H8 and H7 without the splat held to 0, batched as single; the
# stopping test's reduction (H6 mean_square) is its plain version's
# additions in its order: 0
RTOL.update({"H5 batched": 0.0, "H6 batched": 0.0, "H8 batched": 0.0, "H7 batched": 1e-5,
             "H7 sweeps batched": 0.0, "H6 mean_square": 0.0})
# the burst checks' shapes: one tile, a grid narrower than a 16-byte row,
# the reference grid's odd coarse level, ragged tiles on both axes
BURST_SHAPES = ((16, 16), (4, 8), (135, 240), (2049, 2047))
# H2's shapes: its 128x16 tiles whole, ragged, odd widths (the scalar
# path), one tile, narrower than one tile, a single cell
VORT_SHAPES = CHECK_SHAPES + ((2049, 2047), (2050, 2046), (135, 240), (16, 16), (4, 8),
                              (3, 5), (1, 1))
# device operations of one driven 2048² step: the kernels' launches and
# the memsets of their velocity bounds, no copy into the 5-channel pack
# (parity: H1's one launch, H2, H3's 3 bursts, H4's memset and 5 bursts;
# fast: H8's two passes, H2, H7, H4's 6; quality at its 2 V-cycles: each of
# its 3 stopping tests is the two passes of H6 mean_square and a read).
# H1 and H8 bound the velocity without a memset since their redesign
STEP_DEVICE_OPS = {"parity": 11, "fast": 10, "quality": 47}
QUALITY_STEP_VCYCLES = 2  # the V-cycles of the quality step counted
# the most device launches one entry call may make at 2048²
MAX_DEVICE_LAUNCHES = {"H3": 5, "H4": 8, "H4 solve": 8,
                       "H6 smooth_res_restrict": 1, "H6 first_smooth_res_restrict": 1,
                       "H6 prolong_smooth": 1, "H6 smooth_damped": 1}
# marker kernels launched before and after the work a profiler session
# counts, and the sessions tried before a trace that lost records fails.
# The leading records a session loses grow with the process's age
# (chip_profiler_loss.py): late in this script a session lost more than 8,
# so each side has the CLI's pad of 32 (cli.PROFILE_PAD)
MARKERS = 32
TRACE_TRIES = 5
# the profiler sessions this run opened, and how many of them had each
# pattern of markers seen before/between/after the work's records
TRACES = {"sessions": 0, "patterns": {}}
# the card's peaks (NVIDIA's H100 SXM data sheet): device memory bytes/s,
# float32 operations/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# one whole driven step, cuda against ref on the card:
# max |cuda - ref| <= STEP_RTOL * max|ref| for each field
STEP_RTOL = 1e-5
STATE_FIELDS = ("u", "v", "dye", "pressure", "vel_stats")
SCAN_STEPS = 4  # run_scan_render's steps in phase 4
FAST = dict(fast_dye=True, fast_velocity=True, fast_diffuse=True)
# the ensemble phase: 64 members at 512² (BASELINE.json config 4, the JAX
# package's viscosity sweep), and the batched kernels' other check shapes:
# the reference grid, an odd coarse grid (ragged tiles), a grid narrower
# than one 16-byte row (the scalar paths)
ENS_B, ENS_N, ENS_STEPS = 64, 512, 200
ENS_SHAPES = ((ENS_B, ENS_N, ENS_N), (3, 540, 960), (5, 135, 240), (7, 4, 8))
ENS_JITTER = 32.0  # each member's orbit centre moves by up to this many cells
# device operations of one batched step: one copy of the members'
# parameters, then the parity step's 11 (H1's one launch, H2, H3's 3
# bursts, H4's memset and 5 bursts)
ENS_STEP_DEVICE_OPS = 12
# device launches one call of each batched entry makes at 64 x 512²: one a
# stage (a burst for H3 and H4) for all 64 members, with H4's memset of
# its velocity bound
ENS_CALL_LAUNCHES = {"H1 batched": 1, "H1 batched velocity pass": 1, "H1 batched dye pass": 1,
                     "H2 batched": 1, "H3 batched": 3, "H4 batched": 6}
ENS_CPU_B, ENS_CPU_STEPS = 8, 10
# phase 9, the fast and multigrid ensembles on batched H5-H8: H6's ends with
# the grid transfers at these level pairs (even extents: 64 x 512² -> 256²,
# the reference grid, the pair above the 16² bottom, ragged tiles)
ENS_MG_PAIRS = ((ENS_B, ENS_N, ENS_N), (3, 540, 960), (5, 32, 32), (2, 2050, 2046))
# members past the grid's 65535 z (and y) extent, so a block walks it: the
# inputs repeat a 7-member batch, whose outputs the walk must repeat
ZWALK_B = 65537
# device operations of one batched fast step: the parameter copy, H8's
# velocity and dye passes, H2, H7 (one launch for every member's 5
# planes), H4's memset and 5 bursts
ENS_FAST_STEP_DEVICE_OPS = 11


def ens_quality_step_ops(k, levels):
    """Device operations of one batched quality step whose members all
    complete k V-cycles on ``levels`` levels: the parameter copy, H1's one
    launch, H2, H3's 3 bursts, H6's first end, 2 levels - 1 H6 ends a
    cycle, the k + 1 stopping tests' two passes and read each, H5's
    projection with its memset."""
    return 1 + 1 + 1 + 3 + 1 + k * (2 * levels - 1) + 3 * (k + 1) + 2


# device launches one call of each batched row makes at 64 x 512² (the
# smooth_res row calls the end twice: from p and from zero)
ENS_REST_CALL_LAUNCHES = {
    "H5 batched": 3, "H7 batched": 1, "H8 batched": 2, "H6 batched mean_square": 2,
    "H6 batched smooth_damped": 1, "H6 batched smooth_res": 2,
    "H6 batched first_smooth_res": 1, "H6 batched last_smooth_project": 2,
    "H6 batched smooth_res_restrict": 1, "H6 batched first_smooth_res_restrict": 1,
    "H6 batched prolong_smooth": 1, "H6 batched prolong_smooth_project": 2}
# the fast ensemble's and the quality sweep's timed window: their last
# ENS_WINDOW steps, from the state their rollouts reached before them, timed
# batched and one member at a time and traced whole
ENS_WINDOW = 25
# float32 operations of a cell of H1's passes, counted from their formulas:
# the backtrace and its clamped taps 18; a bilinear blend 12; the velocity
# two blends, two decays and the bound's two abs and maxes, the dye three
# blends, each with its pow, scale and min
H1_OPS = {"velocity": 18 + 2 * 13 + 4, "dye": 18 + 3 * 15}
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


def _check_vel_max(name, stats, u, v):
    """Fail unless a kernel-emitted bound is ``ref.vel_max`` of its own
    output, member by member, a NaN where the max is NaN."""
    true = torch.stack([u.abs().amax(dim=(-2, -1)), v.abs().amax(dim=(-2, -1))], dim=-1)
    same = (stats == true) | (stats.isnan() & true.isnan())
    if stats.shape != true.shape or not bool(same.all()):
        raise AssertionError(f"{name} vel_stats {stats.tolist()} is not the max {true.tolist()}")


def _without_both(ops):
    """``ops`` with H1's two passes in place of its one launch."""
    ns = types.SimpleNamespace(**vars(ops))
    del ns.advect_both
    return ns


def _check_state(what, *states):
    for s in states:
        for name in ("u", "v", "dye", "pressure"):
            if not bool(torch.isfinite(getattr(s, name)).all()):
                raise AssertionError(f"{what}: {name} is not finite after the rollout")
    dmin, dmax = states[0].dye.min().item(), states[0].dye.max().item()
    if not (0.0 <= dmin and dmax <= 2.0):
        raise AssertionError(f"{what}: dye outside [0, 2]: [{dmin}, {dmax}]")
    return dmin, dmax


def _check_frame(what, frame):
    if frame.shape != (N, N, 4) or frame.dtype.name != "uint8" or frame[..., :3].max() == 0:
        raise AssertionError(f"{what}: bad frame {frame.shape} {frame.dtype} max {frame.max()}")


def _nbytes(obj):
    """Bytes of every tensor in a (nested) tuple or list."""
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, (tuple, list)):
        return sum(_nbytes(o) for o in obj)
    return 0


def _markers():
    """MARKERS marker kernels, between pauses of the host."""
    time.sleep(0.01)
    for _ in range(MARKERS):
        torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    time.sleep(0.01)


def _marker_pattern(marker):
    """(markers before the first of the work's records, markers between
    its records, markers after its last one); (markers, 0, 0) where the
    trace holds markers alone."""
    work = [i for i, m in enumerate(marker) if not m]
    if not work:
        return len(marker), 0, 0
    return work[0], sum(marker[work[0]:work[-1]]), len(marker) - 1 - work[-1]


def _device_trace(fn, calls=1):
    """[(name, µs)] of the device operations ``calls`` calls of ``fn`` make,
    from ``torch.profiler``'s trace of the card.

    A session can lose device records at either end of its trace, or every
    one.  So MARKERS marker kernels run before the calls and MARKERS after
    them, and a trace counts only if a marker survived on each side of the
    calls' records (a trace of markers alone: more than MARKERS of them);
    else the calls are traced again, at most TRACE_TRIES times."""
    # with the CUDA activity alone a short session can miss a kernel that
    # ctypes launched; with the CPU activity too it records each launch
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for attempt in range(TRACE_TRIES):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            _markers()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            _markers()
        recs = sorted((e for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA),
                      key=lambda e: e.time_range.start)
        marker = ["spin_kernel" in e.name for e in recs]
        lead, mid, trail = _marker_pattern(marker)
        has_work = len(marker) > sum(marker)
        key = f"{lead}/{mid}/{trail}" if has_work else f"markers only {lead}"
        TRACES["sessions"] += 1
        TRACES["patterns"][key] = TRACES["patterns"].get(key, 0) + 1
        if (lead and trail and not mid) if has_work else lead > MARKERS:
            return [(e.name, e.time_range.elapsed_us()) for e, m in zip(recs, marker) if not m]
        _json({"phase": "profiler_retry", "try": attempt + 1, "device_records": len(recs),
               "markers_before_between_after": [lead, mid, trail], "markers_launched": 2 * MARKERS})
    raise AssertionError(f"torch.profiler lost device records in {TRACE_TRIES} sessions in a row")


def _device_kernels(fn):
    """{name: count} of the device operations one call of ``fn`` makes."""
    counts = {}
    for name, _ in _device_trace(fn):
        counts[name] = counts.get(name, 0) + 1
    return counts


def _device_ms(fn, calls=10):
    """Device ms a call of ``fn``: its device operations' durations, summed
    over ``calls`` calls, over ``calls``.  Where a kernel is shorter than its
    wrapper's host cost, the event-timed ms of a row is the host's; this is
    the card's."""
    return sum(us for _, us in _device_trace(fn, calls)) / calls / 1e3


def _bound_cost(u, v, dt, decay_rate, params=None):
    """Device ms of H1's velocity pass with its bound (a slot a block, the
    last block's reduction) and of the same launch without it, on u, v
    (H, W) or (B, H, W) with the members' ``params``: the bound's cost."""
    from cudafluidsimulation_tpu_torch.ops import advect_cuda

    batched = u.dim() == 3
    kern = advect_cuda.VELOCITY_PASS_BATCHED if batched else advect_cuda.VELOCITY_PASS
    uv = torch.empty((2,) + tuple(u.shape), dtype=torch.float32, device=u.device)
    stats = torch.empty(tuple(u.shape[:-2]) + (2,), dtype=torch.float32, device=u.device)
    if batched and params is None:
        raise ValueError("_bound_cost: a batch needs its params")

    def launch(with_bound):
        advect_cuda._launch(kern, advect_cuda._VELOCITY, u, v, uv_out=uv,
                            stats=stats if with_bound else None, dt=dt,
                            decay_rate=decay_rate, params=params)

    with_ms, without_ms = _device_ms(lambda: launch(True)), _device_ms(lambda: launch(False))
    return {"velocity_pass_device_ms": with_ms, "without_bound_device_ms": without_ms,
            "bound_device_ms": with_ms - without_ms}


def _step_vs_ref(what, sim, ref_sim, state, imp):
    """One step on kernels against the same step on plain ops, on the card."""
    got, exp = sim.step(state, imp), ref_sim.step(state, imp)
    step_err = {}
    for name in STATE_FIELDS:
        step_err[name] = _max_err(getattr(got, name), getattr(exp, name))[1]
        if not step_err[name] <= STEP_RTOL:
            raise AssertionError(f"{what}: one driven step, cuda vs ref: {name} "
                                 f"rel err {step_err[name]}")
    return step_err, bool(torch.equal(sim.render_fn(got), ref_sim.render_fn(exp)))


def _scan_render(what, sim, ref_sim, state, imp):
    """``run_scan_render`` on the card: its steps and frames bit for bit the
    same as the step and the render called one at a time, and each of its
    steps against the same step on the plain ops from the same state (within
    STEP_RTOL, its frame within one level).  The plain ops follow step by
    step: the flow is chaotic, so a rollout of their own drifts from the
    kernels' by more than one step's rounding."""
    from cudafluidsimulation_tpu_torch.models.simulation import run_scan_render
    from cudafluidsimulation_tpu_torch.utils.impulse import slice_step

    got, frames = run_scan_render(sim.step_fn, sim.render_fn, state, imp)
    err = dict.fromkeys(STATE_FIELDS, 0.0)
    level = 0
    one = state
    for i in range(SCAN_STEPS):
        exp = ref_sim.step(one, slice_step(imp, i))
        one = sim.step(one, slice_step(imp, i))
        if not torch.equal(frames[i], sim.render_fn(one)):
            raise AssertionError(f"{what}: run_scan_render frame {i} differs from the render")
        for name in STATE_FIELDS:
            err[name] = max(err[name], _max_err(getattr(one, name), getattr(exp, name))[1])
        level = max(level, (frames[i].int() - ref_sim.render_fn(exp).int()).abs().max().item())
    for name in STATE_FIELDS:
        if not torch.equal(getattr(got, name), getattr(one, name)):
            raise AssertionError(f"{what}: run_scan_render {name} differs from the steps")
    _json({"phase": "scan_render", "path": what, "steps": SCAN_STEPS,
           "frames": list(frames.shape), "max_rel_err": err, "frame_max_level": level})
    bad = {k: e for k, e in err.items() if not e <= STEP_RTOL}
    if bad or frames.shape != (SCAN_STEPS, 4, N, N) or level > 1:
        raise AssertionError(f"{what}: run_scan_render cuda vs ref: rel err {bad}, "
                             f"frames {tuple(frames.shape)}, {level} levels apart")


def _nvtx_spans(what, sim, state, imp):
    """Under ``emit_nvtx`` the port's span gate is open (its spans are
    pushed as NVTX ranges), and a step gives the same state as without."""
    from cudafluidsimulation_tpu_torch.utils import trace

    plain = sim.step(state, imp)
    with torch.autograd.profiler.emit_nvtx():
        gate = trace.span("fluid.step", 0) is not trace.OFF
        got = sim.step(state, imp)
        torch.cuda.synchronize()
    same = all(torch.equal(getattr(got, n), getattr(plain, n)) for n in STATE_FIELDS)
    _json({"phase": "nvtx_spans", "path": what, "gate_open": gate, "same_step": same})
    if not (gate and same):
        raise AssertionError(f"{what}: under emit_nvtx the gate is open {gate}, "
                             f"the step the same {same}")


def cat_form(ops):
    """``ops`` with the step's 5-channel pack built as it was before the
    dye advection and the confinement wrote into it: they return fresh
    tensors, and diffusion takes ``torch.cat`` of their results in place
    of the pack it is handed."""
    ns = types.SimpleNamespace(**vars(ops))
    made = {}

    def fresh(key, fn):
        def call(*args, out=None, **kw):
            made[key] = fn(*args, **kw)
            return made[key]
        return call

    def from_cat(fn):
        def call(pack, *args, **kw):
            return fn(torch.cat([torch.stack(made["uv"]), made["dye"]]), *args, **kw)
        return call

    ns.advect_dye = fresh("dye", ops.advect_dye)
    if hasattr(ops, "advect_both"):
        def both(*args, out=None, **kw):
            res = ops.advect_both(*args, **kw)
            made["dye"] = res[2]
            return res
        ns.advect_both = both
    ns.vorticity_confinement_gpu = fresh("uv", ops.vorticity_confinement_gpu)
    ns.vorticity_confinement_cpu = fresh("uv", ops.vorticity_confinement_cpu)
    ns.diffuse_multi = from_cat(ops.diffuse_multi)
    ns.diffuse_multi_splat = from_cat(ops.diffuse_multi_splat)
    return ns


def _step_vs_cat(what, sim, state, imp):
    """One step with the pack written in place, bit for bit against the
    same step with the pack built by ``torch.cat``, on the same kernels."""
    from cudafluidsimulation_tpu_torch.models.pipelines import make_step

    got = sim.step(state, imp)
    exp = make_step(sim.config, cat_form(sim.ops))(state, imp)
    for name in STATE_FIELDS:
        if not torch.equal(getattr(got, name), getattr(exp, name)):
            raise AssertionError(f"{what}: the in-place pack changed {name}: max abs diff "
                                 f"{_max_err(getattr(got, name), getattr(exp, name))[0]}")


def _one_advect_launch(what, launches):
    """H1's one launch a step on ``what``'s driven and quiet rollouts, and
    neither of its passes apart."""
    if (launches["H1"] != 2 * STEPS or launches["H1 velocity pass"]
            or launches["H1 dye pass"]):
        raise AssertionError(f"{what}: H1 {launches['H1']} launches in {2 * STEPS} steps, its "
                             f"passes {launches['H1 velocity pass']}, {launches['H1 dye pass']}")


def _same_as_two_passes(what, cfg, ops, driven, quiet, *states):
    """The driven and quiet rollouts bit for bit against the same rollouts
    through H1's two passes (``ops`` without ``advect_both``)."""
    from cudafluidsimulation_tpu_torch import Simulation

    two = Simulation(cfg, ops=_without_both(ops))
    for imp, got in zip((driven, quiet), states):
        exp = two.run(two.init(), imp)
        for name in STATE_FIELDS:
            if not torch.equal(getattr(got, name), getattr(exp, name)):
                raise AssertionError(f"{what}: the rollout on H1's one launch differs from the "
                                     f"two passes' in {name}")
    _json({"phase": "advect_one_launch_rollouts", "path": what, "steps": STEPS,
           "bit_equal_to_two_passes": True})


def _step_device_ops(what, fn):
    """The device operations of one step, asserted against STEP_DEVICE_OPS;
    none may be a ``torch.cat`` or ``torch.stack`` copy."""
    ops = _device_kernels(fn)
    n = sum(ops.values())
    cats = sum(c for name, c in ops.items() if "CatArray" in name)
    _json({"phase": "step_device_ops", "path": what, "grid": f"{N}x{N}", "device_ops": n,
           "cat_ops": cats, "by_name": ops})
    if n != STEP_DEVICE_OPS[what] or cats:
        raise AssertionError(f"{what}: one step made {n} device operations "
                             f"({cats} cat), not {STEP_DEVICE_OPS[what]}")
    return n


def _check_bound_batched(name, stats, u, v):
    """Fail if a member's kernel-emitted [max|u|, max|v|] is below its true max."""
    true = torch.stack([u.abs().amax(dim=(1, 2)), v.abs().amax(dim=(1, 2))], dim=1)
    if not bool((stats >= true).all()):
        raise AssertionError(f"{name}: a member's vel_stats is below its true max")


def _members_equal(what, got, single, i):
    """Member i of a batched kernel's outputs against the B = 1 launch of
    the same kernel on member i, bit for bit."""
    for g, e in zip(got, single):
        if not torch.equal(g[i], e):
            raise AssertionError(f"{what}: member {i} differs from its single launch: max abs "
                                 f"diff {_max_err(g[i], e)[0]}")


def ensemble_phase(smi, gen, worst, reset_counts, read_counts, kernels):
    """Phase 8: H1-H4 over B members a launch.  Checks the batched kernels
    against their batched plain versions and each member against its B = 1
    launch at ENS_SHAPES; runs the 64 x 512² viscosity sweep for ENS_STEPS
    driven steps and holds members 0, 31, 63 and the one at the config's
    viscosity bit for bit against their single-member rollouts; counts the
    device operations of one batched step and runs one under
    ``set_sync_debug_mode("error")``; steps a cpu-variant ensemble and holds
    one step against the plain versions on the card.  Returns the timing
    part, called in phase 14 (timing), which returns the batched rows of the kernels
    line."""
    import dataclasses

    import numpy as np

    from cudafluidsimulation_tpu_torch import FluidConfig, Simulation
    from cudafluidsimulation_tpu_torch.models.ensemble import (
        batched_impulse, batched_state, make_diffusion_sweep_run, make_ensemble_run,
        run_batched, step_of)
    from cudafluidsimulation_tpu_torch.models.pipelines import make_batched_step
    from cudafluidsimulation_tpu_torch.ops import (
        advect_cuda, backend, jacobi_cuda, member_params, ref)
    from cudafluidsimulation_tpu_torch.utils.impulse import Impulse, orbit_impulse
    from cudafluidsimulation_tpu_torch.utils.timing import cuda_times_ms

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    dt, rate, radius = 1.0 / 60.0, 1.2, 400.0

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    def member_scalars(b, h, w):
        """Per-member dt (within 25% of 1/60), coefficients (the viscosity
        swept over channels 0-1), splat amplitudes and centres."""
        dts = (dt * (1.0 + 0.25 * rng.random(b))).astype(np.float32)
        coeffs = np.full((b, 5), 0.8, np.float32)
        coeffs[:, :2] = np.linspace(0.1, 2.0, b, dtype=np.float32)[:, None]
        amps = rng.uniform(-4.0, 4.0, (b, 5)).astype(np.float32)
        last = (rng.random((b, 2)) * [w, h]).astype(np.float32)
        return dts, coeffs, amps, last

    # -- the batched kernels against their plain versions and their single launches
    for b, h, w in ENS_SHAPES:
        tag = f"{b}x{h}x{w}"
        dts, coeffs, amps, last = member_scalars(b, h, w)
        u, v = randn(b, h, w, scale=200.0), randn(b, h, w, scale=200.0)
        dye = torch.rand((b, 3, h, w), generator=gen, device=dev)
        got = advect_cuda.advect_velocity_batched(u, v, dts, rate, return_stats=True)
        _check(worst, "H1 batched", f"velocity {tag}", zip(
            "uv", got[:2], ref.advect_velocity_batched(u, v, dts, rate)))
        _check_vel_max("H1 batched", got[2], got[0], got[1])
        u2, v2 = got[:2]
        pack = torch.full((b, 5, h, w), float("nan"), device=dev)
        dye2 = advect_cuda.advect_dye_batched(dye, u2, v2, dts, rate, out=pack[:, 2:])
        _check(worst, "H1 batched", f"dye into pack {tag}", [(
            "dye", dye2, ref.advect_dye_batched(dye, u2, v2, dts, rate))])
        if not bool(pack[:, :2].isnan().all()):
            raise AssertionError(f"H1 batched {tag}: the dye wrote outside pack[:, 2:5]")
        # the step's call: both in one launch into the pack's dye planes,
        # the two passes' floats bit for bit
        fpack = torch.full((b, 5, h, w), float("nan"), device=dev)
        fused = advect_cuda.advect_both_batched(u, v, dye, dts, rate, return_stats=True,
                                                out=fpack[:, 2:])
        _check(worst, "H1 fused batched", f"two passes into pack {tag}", zip(
            ("u", "v", "dye", "stats"), fused, (u2, v2, dye2, got[2])))
        if not bool(fpack[:, :2].isnan().all()):
            raise AssertionError(f"H1 fused batched {tag}: the dye wrote outside pack[:, 2:5]")
        _check_vel_max("H1 fused batched", fused[3], fused[0], fused[1])
        vorts = {"gpu": 50.0, "cpu": 0.35}
        uvs = {}
        for variant, vort in vorts.items():
            plain = getattr(ref, f"vorticity_confinement_{variant}_batched")
            uv = jacobi_cuda.vorticity_confinement_batched(u2, v2, dts, vort, variant,
                                                           out=pack[:, :2])
            _check(worst, "H2 batched", f"{variant} into pack {tag}",
                   zip("uv", uv, plain(u2, v2, dts, vort)))
            uvs[variant] = torch.stack(uv, dim=1).clone()
            if not torch.equal(pack[:, 2:], dye2):
                raise AssertionError(f"H2 batched {tag}: the confinement wrote outside pack[:, 0:2]")
        h3 = jacobi_cuda.diffuse_multi_splat_batched(pack, dts, coeffs, 20, amps, last, radius)
        _check(worst, "H3 batched", f"splat {tag}", [(
            "fields", h3, ref.diffuse_multi_splat_batched(pack, dts, coeffs, 20, amps, last,
                                                          radius))])
        h3s = jacobi_cuda.diffuse_multi_batched(pack, dts, coeffs, 20)
        _check(worst, "H3 sweeps batched", tag, [(
            "fields", h3s, ref.diffuse_multi_batched(pack, dts, coeffs, 20))])
        h3v = jacobi_cuda.diffuse_batched(pack[:, :2].contiguous(), dts, coeffs[:, 0], 5)
        _check(worst, "H3 sweeps batched", f"2-channel {tag}", [(
            "uv", h3v, ref.diffuse_batched(pack[:, :2], dts, coeffs[:, 0], 5))])
        # H4 from the pack's velocity planes (member stride 5 planes), as the step
        pu, pv = pack[:, 0], pack[:, 1]
        h4 = jacobi_cuda.pressure_project_batched(pu, pv, 40, True, return_stats=True)
        _check(worst, "H4 batched", f"half {tag}", zip(
            ("u", "v", "p", "stats"), h4,
            ref.pressure_project_batched(pu, pv, 40, True, return_stats=True)))
        _check_bound_batched("H4 batched", h4[3], h4[0], h4[1])
        # each member against the single (B = 1) entries on its planes
        for i in range(b):
            _members_equal(f"H1 batched {tag}", got, advect_cuda.advect_velocity(
                u[i], v[i], dts[i], rate, return_stats=True), i)
            _members_equal(f"H1 batched dye {tag}", [dye2], [advect_cuda.advect_dye(
                dye[i], u2[i], v2[i], dts[i], rate)], i)
            _members_equal(f"H1 fused batched {tag}", fused, advect_cuda.advect_both(
                u[i], v[i], dye[i], dts[i], rate, return_stats=True), i)
            for variant, vort in vorts.items():
                _members_equal(f"H2 batched {variant} {tag}", uvs[variant].unbind(1),
                               jacobi_cuda.vorticity_confinement(u2[i], v2[i], dts[i], vort,
                                                                 variant=variant), i)
            _members_equal(f"H3 batched {tag}", [h3, h3s], [
                jacobi_cuda.diffuse_multi_splat(pack[i], dts[i], coeffs[i], 20, amps[i],
                                                last[i], radius),
                jacobi_cuda.diffuse_multi(pack[i], dts[i], coeffs[i], 20)], i)
            _members_equal(f"H3 batched 2-channel {tag}", [h3v], [jacobi_cuda.diffuse(
                pack[i, :2].contiguous(), dts[i], coeffs[i, 0], 5)], i)
            _members_equal(f"H4 batched {tag}", h4, jacobi_cuda.pressure_project(
                pu[i].contiguous(), pv[i].contiguous(), 40, True, return_stats=True), i)
        _json({"phase": "ensemble_kernel_members", "shape": tag, "members": b,
               "bit_equal_to_single_launch": True})
    del u, v, dye, got, u2, v2, pack, dye2, uv, uvs, h3, h3s, h3v, h4, pu, pv, fpack, fused
    # a single call of more than the 8 planes H3 takes by value: one member
    # of device parameter rows
    f11 = randn(11, 135, 240)
    c11 = np.linspace(0.2, 1.8, 11, dtype=np.float32)
    a11 = rng.uniform(-4.0, 4.0, 11).astype(np.float32)
    _check(worst, "H3 sweeps", "11 planes 135x240", [(
        "fields", jacobi_cuda.diffuse_multi(f11, dt, c11, 20), ref.diffuse_multi(f11, dt, c11, 20))])
    _check(worst, "H3", "11 planes splat 135x240", [(
        "fields", jacobi_cuda.diffuse_multi_splat(f11, dt, c11, 20, a11, (96.0, 54.0), radius),
        ref.diffuse_multi_splat(f11, dt, c11, 20, a11, (96.0, 54.0), radius))])
    del f11

    # -- the 64 x 512² viscosity sweep, 200 driven steps -------------------------
    cfg = FluidConfig.gpu_reference(nx=ENS_N, ny=ENS_N, pressure_iters=40, backend="cuda")
    visc = np.linspace(0.1, 2.0, ENS_B, dtype=np.float32)
    # no point of the linspace is the config's 0.8: the nearest takes it, so
    # one member is the config's own single rollout
    at_cfg = int(np.argmin(np.abs(visc - cfg.velocity_diffusion)))
    visc[at_cfg] = np.float32(cfg.velocity_diffusion)
    jitter = rng.uniform(-ENS_JITTER, ENS_JITTER, (ENS_B, 2)).astype(np.float32)
    c = ENS_N / 2
    imp = orbit_impulse(ENS_STEPS, cfg.dt, center=(c, c), radius=64, omega=3.0)
    bimp = batched_impulse(imp, ENS_B, jitter_pos=jitter)
    sweep = make_diffusion_sweep_run(cfg)
    single_keys = ("H1", "H2", "H3", "H4")
    batched_keys = tuple(f"{k} batched" for k in single_keys)
    reset_counts()
    state = sweep(visc, batched_state(cfg, ENS_B), bimp)
    torch.cuda.synchronize()
    launches = read_counts()
    for k in batched_keys:
        if launches[k] == 0:
            raise AssertionError(f"{k} was not launched by the sweep")
    for k in single_keys:
        if launches[k] != 0:
            raise AssertionError(f"the sweep launched the single {k}: a loop over members")
    for name in ("u", "v", "dye", "pressure"):
        if not bool(torch.isfinite(getattr(state, name)).all()):
            raise AssertionError(f"ensemble: {name} is not finite after the sweep")
    dmin, dmax = state.dye.min().item(), state.dye.max().item()
    if not (0.0 <= dmin and dmax <= 2.0):
        raise AssertionError(f"ensemble: dye outside [0, 2]: [{dmin}, {dmax}]")
    checked = sorted({0, ENS_B // 2 - 1, ENS_B - 1, at_cfg})
    for i in checked:
        mcfg = cfg if i == at_cfg else dataclasses.replace(cfg, velocity_diffusion=float(visc[i]))
        sim = Simulation(mcfg)
        single = sim.run(sim.init(), Impulse(*(f[i] for f in bimp)))
        for name in single._fields:
            if not torch.equal(getattr(state, name)[i].cpu(), getattr(single, name).cpu()):
                raise AssertionError(f"ensemble member {i} (viscosity {visc[i]}): {name} differs "
                                     f"from its single-member rollout")
    ke = (0.5 * (state.u ** 2 + state.v ** 2).mean(dim=(1, 2))).tolist()
    _json({"phase": "ensemble_sweep", "members": ENS_B, "grid": f"{ENS_N}x{ENS_N}",
           "steps": ENS_STEPS, "launches": {k: launches[k] for k in batched_keys},
           "members_bit_equal_to_single_rollout": checked, "at_config_viscosity": at_cfg,
           "dye_range": [dmin, dmax], "kinetic_energy_first_last": [ke[0], ke[-1]]})

    # the device operations of one batched step; the step reads nothing back
    estep = make_batched_step(cfg, backend.get_batched_ops(cfg), visc)
    last_imp = step_of(bimp, ENS_STEPS - 1)
    ops = _device_kernels(lambda: estep(state, last_imp))
    n_ops = sum(ops.values())
    _json({"phase": "ensemble_step_device_ops", "members": ENS_B, "device_ops": n_ops,
           "by_name": ops})
    if n_ops != ENS_STEP_DEVICE_OPS:
        raise AssertionError(f"one batched step made {n_ops} device operations, "
                             f"not {ENS_STEP_DEVICE_OPS}")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        estep(state, last_imp)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()

    # -- a cpu-variant ensemble: H1-H4 with the plain splat_cpu and strip ---------
    ccfg = FluidConfig.cpu_reference(nx=ENS_N, ny=ENS_N, backend="cuda")
    cimp = batched_impulse(orbit_impulse(ENS_CPU_STEPS, ccfg.dt, center=(c, c), radius=64,
                                         omega=3.0), ENS_CPU_B,
                           jitter_pos=jitter[:ENS_CPU_B])
    reset_counts()
    cstate = make_ensemble_run(ccfg)(batched_state(ccfg, ENS_CPU_B), cimp)
    torch.cuda.synchronize()
    claunch = read_counts()
    if any(claunch[k] == 0 for k in batched_keys) or any(claunch[k] for k in single_keys):
        raise AssertionError(f"cpu-variant ensemble launches {claunch}")
    cimp1 = step_of(cimp, ENS_CPU_STEPS - 1)
    got = make_batched_step(ccfg)(cstate, cimp1)
    exp = make_batched_step(ccfg, backend.batched_namespace())(cstate, cimp1)
    cerr = {}
    for name in STATE_FIELDS:
        cerr[name] = _max_err(getattr(got, name), getattr(exp, name))[1]
        if not cerr[name] <= STEP_RTOL:
            raise AssertionError(f"cpu-variant ensemble step vs plain: {name} rel err {cerr[name]}")
    _json({"phase": "ensemble_cpu_variant", "members": ENS_CPU_B, "grid": f"{ENS_N}x{ENS_N}",
           "steps": ENS_CPU_STEPS, "launches": {k: claunch[k] for k in batched_keys},
           "step_vs_plain_max_rel_err": cerr, "tol": STEP_RTOL})
    del cstate, got, exp

    def timing():
        """Member-steps/s of the batched sweep against the same members run
        one after another as single-member steps, and the batched rows of
        the kernels line (device ms beside the bound)."""
        steps = 50
        short = Impulse(*(f[:, :steps] for f in bimp))
        start = batched_state(cfg, ENS_B)
        batched_ms = statistics.median(cuda_times_ms(lambda: sweep(visc, start, short),
                                                     iters=3))
        sims = [Simulation(dataclasses.replace(cfg, velocity_diffusion=float(k))) for k in visc]
        inits = [s.init() for s in sims]

        def one_by_one():
            for i, s in enumerate(sims):
                s.run(inits[i], Impulse(*(f[i] for f in short)))

        serial_ms = statistics.median(cuda_times_ms(one_by_one, iters=2))
        # where a batched step's device time goes, and the host's enqueue
        trace = _device_trace(lambda: estep(state, last_imp), calls=5)
        by_op = {}
        for name, us in trace:
            by_op[name.split("(")[0]] = by_op.get(name.split("(")[0], 0.0) + us / 5e3
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            estep(state, last_imp)
        enqueue_ms = (time.perf_counter() - t0) / 5 * 1e3
        torch.cuda.synchronize()
        member_steps = ENS_B * steps
        _json({"metric": "ensemble_member_steps_per_sec", "members": ENS_B,
               "grid": f"{ENS_N}x{ENS_N}", "steps": steps,
               "batched": member_steps / (batched_ms / 1e3),
               "one_member_at_a_time": member_steps / (serial_ms / 1e3),
               "batched_ms_per_step": batched_ms / steps,
               "one_member_at_a_time_ms_per_step": serial_ms / steps,
               "device_busy_ms_per_step": sum(by_op.values()), "device_ms_by_op": by_op,
               "host_enqueue_ms_per_step": enqueue_ms, "smi": smi})

        # the batched kernels at the sweep's shapes, on its driven state
        u, v, dye = state.u, state.v, state.dye
        b = ENS_B
        dts = np.full(b, dt, np.float32)
        coeffs = np.full((b, 5), 0.8, np.float32)
        coeffs[:, :2] = visc[:, None]
        _, _, amps, last = member_scalars(b, ENS_N, ENS_N)
        prm = member_params.upload(np.concatenate([
            member_params.advect_cols(dts, rate),
            member_params.diffuse_cols(dts, coeffs, amps, last)], axis=1), dev)
        adv_p, dif_p = prm[:, :2], prm[:, 2:]
        u2, v2 = advect_cuda.advect_velocity_batched(u, v, dts, rate, params=adv_p)
        all5 = torch.cat([torch.stack([u, v], dim=1), dye], dim=1).contiguous()
        cases = {
            "H1 batched": (
                lambda: advect_cuda.advect_both_batched(u, v, dye, dts, rate, return_stats=True,
                                                        params=adv_p),
                lambda: (ref.advect_velocity_batched(u, v, dts, rate, return_stats=True),
                         ref.advect_dye_batched(dye, u2, v2, dts, rate))),
            "H1 batched velocity pass": (
                lambda: advect_cuda.advect_velocity_batched(u, v, dts, rate, return_stats=True,
                                                            params=adv_p),
                lambda: ref.advect_velocity_batched(u, v, dts, rate, return_stats=True)),
            "H1 batched dye pass": (
                lambda: advect_cuda.advect_dye_batched(dye, u2, v2, dts, rate, params=adv_p),
                lambda: ref.advect_dye_batched(dye, u2, v2, dts, rate)),
            "H2 batched": (
                lambda: jacobi_cuda.vorticity_confinement_batched(u, v, dts, 50.0, "gpu",
                                                                  params=adv_p),
                lambda: ref.vorticity_confinement_gpu_batched(u, v, dts, 50.0)),
            "H3 batched": (
                lambda: jacobi_cuda.diffuse_multi_splat_batched(all5, dts, coeffs, 20, amps,
                                                                last, radius, params=dif_p),
                lambda: ref.diffuse_multi_splat_batched(all5, dts, coeffs, 20, amps, last,
                                                        radius)),
            "H4 batched": (
                lambda: jacobi_cuda.pressure_project_batched(u, v, 40, True, return_stats=True),
                lambda: ref.pressure_project_batched(u, v, 40, True, return_stats=True)),
        }
        cells = b * ENS_N * ENS_N
        io = {"H1 batched": ([u, v, dye, adv_p], cells * (H1_OPS["velocity"] + H1_OPS["dye"])),
              "H1 batched velocity pass": ([u, v, adv_p], cells * H1_OPS["velocity"]),
              "H1 batched dye pass": ([dye, u2, v2, adv_p], cells * H1_OPS["dye"]),
              "H2 batched": ([u, v, adv_p], cells * 25),
              "H3 batched": ([all5, dif_p], 5 * cells * (6 * 20 + 10)),
              "H4 batched": ([u, v], cells * (4 + 5 * 40 + 8))}
        _json({"phase": "advect_bound", "members": b, "grid": f"{ENS_N}x{ENS_N}",
               **_bound_cost(u, v, dts, rate, params=adv_p), "smi": smi})
        rows = []
        for k, (kern_fn, plain_fn) in cases.items():
            calls = _device_kernels(kern_fn)
            if sum(calls.values()) != ENS_CALL_LAUNCHES[k]:
                raise AssertionError(f"{k}: {calls} device launches in one call at "
                                     f"{b}x{ENS_N}x{ENS_N}, not {ENS_CALL_LAUNCHES[k]}")
            inputs, n_ops = io[k]
            nbytes = _nbytes(inputs) + _nbytes(kern_fn())
            bytes_ms, ops_ms = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * n_ops / F32_OPS_PER_S
            # plain, kernel, kernel, plain; the plain loop over 64 members is slow
            p1 = cuda_times_ms(plain_fn, iters=2, warmup=1)
            k1 = cuda_times_ms(kern_fn, iters=5, warmup=1)
            k2 = cuda_times_ms(kern_fn, iters=5, warmup=0)
            p2 = cuda_times_ms(plain_fn, iters=2, warmup=0)
            _, src, replaces = kernels[k]
            rows.append({
                "name": f"{k} {src[:-3]}", "route": "cuda",
                "source": f"cudafluidsimulation_tpu_torch/csrc/{src}",
                "replaces": f"cudafluidsimulation_tpu/ops/{replaces}",
                "launches": launches[k], "path": None if "pass" in k else "ensemble sweep",
                "members": b, "grid": f"{ENS_N}x{ENS_N}",
                "max_abs_err": worst["H1 batched" if k.startswith("H1") else k],
                **({"max_abs_err_without_splat": worst["H3 sweeps batched"]}
                   if k == "H3 batched" else {}),
                "launches_per_call": sum(calls.values()),
                "ms": statistics.median(k1 + k2), "device_ms": _device_ms(kern_fn),
                "plain_ms": statistics.median(p1 + p2),
                "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "bytes": nbytes, "operations": n_ops,
                # no single PyTorch call computes a batched kernel's function either
                "library_ms": None,
            })
        return rows

    return timing


def rest_kernel_checks(gen, worst):
    """Batched H5-H8 and the stopping test's reduction against their
    batched plain versions, each member against its B = 1 launch bit for
    bit, at ENS_SHAPES (H6's ends with the grid transfers at ENS_MG_PAIRS),
    and a batch of ZWALK_B members against the 7-member batch it repeats.
    Returns, by shape, whether PyTorch's own batched mean of squares equals
    its single-plane ``torch.mean`` member by member (information: the
    reason for the fixed-order reduction)."""
    import numpy as np

    from cudafluidsimulation_tpu_torch.ops import (
        advect_cuda, advect_packed, fastdiffuse, fastdiffuse_cuda, jacobi_cuda, member_params,
        multigrid, multigrid_cuda, ref)

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 1)
    dt, rate, radius = 1.0 / 60.0, 1.2, 400.0
    mc, plain = multigrid_cuda, multigrid.PLAIN_BATCHED
    alpha = 0.8 * 0.8 / dt
    taps5, radii = fastdiffuse._taps_array([alpha] * 5, 20, 2e-4)
    taps2 = fastdiffuse._taps_array([alpha] * 2, 20, 2e-4)[0]
    taps_g, radii_g = fastdiffuse._taps_array([3.0] * 3, 6, 2e-4)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    def dts_of(b):
        return (dt * (1.0 + 0.25 * rng.random(b))).astype(np.float32)

    def single_planes(t, i):
        return t[i].contiguous()

    # -- the stopping test's reduction: single planes against the plain
    #    version, and PyTorch's batched mean against its single one
    for h, w in CHECK_SHAPES + ((16, 16),):
        r = randn(h, w, scale=3.0)
        _check(worst, "H6 mean_square", f"{h}x{w}", [(
            "mean", multigrid_cuda.mean_square(r), multigrid.mean_square(r))])
    torch_mean_equal = {}
    for b, h, w in ENS_SHAPES:
        tag = f"{b}x{h}x{w}"
        r = randn(b, h, w, scale=3.0)
        got = multigrid_cuda.mean_square_batched(r)
        _check(worst, "H6 mean_square", f"batched {tag}", [("mean", got, multigrid.mean_square(r))])
        for i in range(b):
            if not torch.equal(got[i], multigrid_cuda.mean_square(r[i])):
                raise AssertionError(f"H6 mean_square {tag}: member {i} differs from its plane")
        single = torch.stack([torch.mean(r[i] * r[i]) for i in range(b)])
        torch_mean_equal[tag] = bool(torch.equal((r * r).mean(dim=(-2, -1)), single))

    for b, h, w in ENS_SHAPES:
        tag = f"{b}x{h}x{w}"
        dts = dts_of(b)
        # -- H8: members alternately quiet (under one cell a step) and driven
        # (4 cells/s: even an edge cell's extrapolated sample stays quiet)
        scale = torch.tensor([4.0 if i % 2 == 0 else 200.0 for i in range(b)],
                             device=dev)[:, None, None]
        u, v = randn(b, h, w) * scale, randn(b, h, w) * scale
        dye = torch.rand((b, 3, h, w), generator=gen, device=dev)
        bound = torch.stack([u.abs().amax(dim=(1, 2)), v.abs().amax(dim=(1, 2))], dim=1)
        quiet = (bound * torch.from_numpy(dts).to(dev)[:, None] < 1.0).all(dim=1).tolist()
        h1 = advect_cuda.advect_velocity_batched(u, v, dts, rate)
        h1_dye = advect_cuda.advect_dye_batched(dye, h1[0], h1[1], dts, rate)
        for given in (True, False):
            for fast_path in (True, False):
                case = f"vel_stats={'given' if given else 'absent'} fast_path={fast_path} {tag}"
                kw = dict(vel_stats=bound if given else None, fast_path=fast_path)
                got = advect_cuda.advect_velocity_batched(u, v, dts, rate, return_stats=True,
                                                          packed=True, **kw)
                _check(worst, "H8 batched", f"velocity {case}", zip(
                    "uv", got[:2], advect_packed.advect_velocity_batched(u, v, dts, rate, **kw)))
                _check_vel_max("H8 batched", got[2], got[0], got[1])
                kd = dict(vel_stats=got[2] if given else None, fast_path=fast_path)
                pack = torch.full((b, 5, h, w), float("nan"), device=dev)
                dye2 = advect_cuda.advect_dye_batched(dye, got[0], got[1], dts, rate, packed=True,
                                                      out=pack[:, 2:], **kd)
                _check(worst, "H8 batched", f"dye into pack {case}", [(
                    "dye", dye2, advect_packed.advect_dye_batched(dye, got[0], got[1], dts, rate,
                                                                  **kd))])
                if not bool(pack[:, :2].isnan().all()):
                    raise AssertionError(f"H8 batched {case}: the dye wrote outside pack[:, 2:5]")
                for i in range(b):
                    _members_equal(f"H8 batched {case}", got, advect_cuda.advect_velocity(
                        u[i], v[i], dts[i], rate, return_stats=True, packed=True,
                        vel_stats=bound[i] if given else None, fast_path=fast_path), i)
                    _members_equal(f"H8 batched dye {case}", [dye2], [advect_cuda.advect_dye(
                        dye[i], got[0][i], got[1][i], dts[i], rate, packed=True,
                        vel_stats=got[2][i] if given else None, fast_path=fast_path)], i)
                    exact = (torch.equal(got[0][i], h1[0][i]) and torch.equal(got[1][i], h1[1][i])
                             and torch.equal(dye2[i], h1_dye[i]))
                    if exact != (quiet[i] and fast_path):
                        raise AssertionError(f"H8 batched {case}: member {i} (quiet {quiet[i]}) "
                                             f"equal to H1 is {exact}")
        del u, v, dye, bound, h1, h1_dye, got, pack, dye2

        # -- H7: the shipped taps (unrolled kernel) on 5 and 2 channels, the
        #    generic kernel on 3; each member's splat from its device row
        f5 = randn(b, 5, h, w)
        amps = rng.uniform(-4.0, 4.0, (b, 5)).astype(np.float32)
        last = (rng.random((b, 2)) * [w, h]).astype(np.float32)
        for c, taps, rad in ((5, taps5, radii), (2, taps2, radii), (3, taps_g, radii_g)):
            fc = f5[:, :c].contiguous()
            for splat in (None, (amps[:, :c], last, radius)):
                name = "H7 batched" if splat else "H7 sweeps batched"
                case = f"{c}ch radii={rad} splat={splat is not None} {tag}"
                # the step's rows: member_params.diffuse_cols from column 2C on
                params = None if splat is None else member_params.upload(
                    member_params.diffuse_cols(dts, np.full((b, c), 0.8, np.float32),
                                               amps[:, :c], last), dev)[:, 2 * c:]
                got = fastdiffuse_cuda.sep_apply_batched(fc, taps, rad, splat, params=params)
                _check(worst, name, case, [("fields", got, fastdiffuse.sep_apply_batched(
                    fc, taps, rad, splat))])
                for i in range(b):
                    one = None if splat is None else (amps[i, :c], last[i], radius)
                    _members_equal(f"{name} {case}", [got], [
                        fastdiffuse_cuda.sep_apply(fc[i], taps, rad, one)], i)
        del f5, fc, got

        # -- H5 from a pack's velocity planes (member stride 5 planes)
        pack = randn(b, 5, h, w, scale=200.0)
        pu, pv = pack[:, 0], pack[:, 1]
        p, rhs = randn(b, h, w, scale=50.0), randn(b, h, w)
        for half in (True, False):
            div = jacobi_cuda.divergence_batched(pu, pv, half)
            _check(worst, "H5 batched", f"divergence half={half} {tag}", [(
                "div", div, ref.divergence_batched(pu, pv, half))])
            for i in range(b):
                _members_equal(f"H5 batched divergence {tag}", [div], [jacobi_cuda.divergence(
                    single_planes(pu, i), single_planes(pv, i), half)], i)
        got = jacobi_cuda.project_batched(pu, pv, p, return_stats=True)
        _check(worst, "H5 batched", f"project {tag}", zip(
            ("u", "v", "stats"), got, ref.project_batched(pu, pv, p, return_stats=True)))
        _check_bound_batched("H5 batched", got[2], got[0], got[1])
        for i in range(b):
            _members_equal(f"H5 batched project {tag}", got, jacobi_cuda.project(
                single_planes(pu, i), single_planes(pv, i), p[i], return_stats=True), i)

        # -- H6's ends without the grid transfers (every shape class)
        ends = {
            **{f"smooth_damped sweeps={s}": (
                lambda ns, s=s: (ns.smooth_damped(p, rhs, s),)) for s in (1, 2, 20)},
            "smooth_damped zero plane": lambda ns: (ns.smooth_damped(None, rhs, 20),),
            **{f"smooth_res from_zero={z}": (
                lambda ns, z=z: ns.smooth_res(p, rhs, 2, from_zero=z)) for z in (False, True)},
            "first_smooth_res": lambda ns: ns.first_smooth_res(pu, pv, 2, True),
            "last_smooth_project": lambda ns: ns.last_smooth_project(p, rhs, pu, pv, 2,
                                                                     return_stats=True),
        }
        _check_ends(worst, ends, tag, plain, mc.ENDS_BATCHED, b)
        del pack, pu, pv, p, rhs, got, div

    # -- H6's ends with the grid transfers, at level pairs
    for b, h, w in ENS_MG_PAIRS:
        tag = f"{b}x{h}x{w}"
        pack = randn(b, 5, h, w, scale=200.0)
        pu, pv = pack[:, 0], pack[:, 1]
        p, rhs = randn(b, h, w, scale=50.0), randn(b, h, w)
        e_c, rhs_c = randn(b, h // 2, w // 2, scale=5.0), randn(b, h // 2, w // 2)
        ends = {"bottom smooth_damped zero plane": lambda ns: (ns.smooth_damped(None, rhs_c, 20),)}
        for s in (1, 2, 9):
            ends.update({
                f"smooth_res_restrict sweeps={s}": (
                    lambda ns, s=s: ns.smooth_res_restrict(p, rhs, s, return_res=True)),
                f"smooth_res_restrict from_zero sweeps={s}": (
                    lambda ns, s=s: ns.smooth_res_restrict(None, rhs, s, from_zero=True)),
                **{f"first_smooth_res_restrict half={hf} sweeps={s}": (
                    lambda ns, s=s, hf=hf: ns.first_smooth_res_restrict(pu, pv, s, hf))
                   for hf in (True, False)},
                f"prolong_smooth sweeps={s}": (
                    lambda ns, s=s: (ns.prolong_smooth(p, e_c, rhs, s),)),
                f"prolong_smooth_project sweeps={s}": (
                    lambda ns, s=s: ns.prolong_smooth_project(p, e_c, rhs, pu, pv, s,
                                                              return_stats=True)),
            })
        _check_ends(worst, ends, tag, plain, mc.ENDS_BATCHED, b)
        del pack, pu, pv, p, rhs, e_c, rhs_c

    # -- ZWALK_B members (blocks walk the grid's z or y extent): the inputs
    #    repeat a 7-member batch at 4x8, and so must the outputs
    h, w = 4, 8
    idx = torch.arange(ZWALK_B, device=dev) % 7
    pack7 = randn(7, 5, h, w, scale=200.0)
    p7, rhs7, e7 = randn(7, h, w, scale=50.0), randn(7, h, w), randn(7, h // 2, w // 2, scale=5.0)
    dts7 = dts_of(7)
    bound7 = torch.stack([pack7[:, 0].abs().amax(dim=(1, 2)),
                          pack7[:, 1].abs().amax(dim=(1, 2))], dim=1)
    amps7 = rng.uniform(-4.0, 4.0, (7, 2)).astype(np.float32)
    last7 = (rng.random((7, 2)) * [w, h]).astype(np.float32)
    i_np = idx.cpu().numpy()

    def walk_cases(pk, pp, rr, ee, dts, bound, amps, last):
        u, v = pk[:, 0], pk[:, 1]
        adv = advect_cuda.advect_velocity_batched(u, v, dts, rate, vel_stats=bound,
                                                  return_stats=True, packed=True)
        return {
            "H5 batched": (jacobi_cuda.divergence_batched(u, v, True),) + tuple(
                jacobi_cuda.project_batched(u, v, pp, return_stats=True)),
            "H6 batched": tuple(mc.prolong_smooth_project_batched(pp, ee, rr, u, v, 2,
                                                                  return_stats=True))
            + tuple(mc.smooth_res_restrict_batched(pp, rr, 2, return_res=True))
            + (mc.mean_square_batched(rr)[:, None],),
            "H7 batched": (fastdiffuse_cuda.sep_apply_batched(
                pk[:, :2].contiguous(), taps2, radii, (amps, last, radius)),),
            "H8 batched": tuple(adv) + (advect_cuda.advect_dye_batched(
                pk[:, 2:], adv[0], adv[1], dts, rate, vel_stats=adv[2], packed=True),),
            "H1 fused batched": tuple(advect_cuda.advect_both_batched(
                u, v, pk[:, 2:], dts, rate, return_stats=True)),
        }

    small = walk_cases(pack7, p7, rhs7, e7, dts7, bound7, amps7, last7)
    big = walk_cases(pack7[idx], p7[idx], rhs7[idx], e7[idx], dts7[i_np], bound7[idx],
                     amps7[i_np], last7[i_np])
    for name, outs in big.items():
        for g, e in zip(outs, small[name]):
            if not torch.equal(g, e[idx]):
                raise AssertionError(f"{name}: {ZWALK_B} members (blocks walking the grid) "
                                     f"differ from the 7-member batch they repeat")
    _json({"phase": "ensemble_rest_zwalk", "members": ZWALK_B, "grid": f"{h}x{w}",
           "kernels": sorted(big), "bit_equal_to_repeated_batch": True})
    del big, small
    torch.cuda.synchronize()
    return torch_mean_equal


def _check_ends(worst, ends, tag, plain, kernels_ns, b):
    """Each H6 end (name -> call on a namespace) batched against its plain
    batched version, and each member against the single ends' B = 1 launch
    on its planes."""
    from cudafluidsimulation_tpu_torch.ops import multigrid_cuda

    for name, call in ends.items():
        got = call(kernels_ns)
        _check(worst, "H6 batched", f"{name} {tag}", [
            (str(j), g, e) for j, (g, e) in enumerate(zip(got, call(plain)))])
        for i in range(b):
            one = types.SimpleNamespace(**{
                k: _member_call(fn, i) for k, fn in vars(multigrid_cuda.ENDS).items()})
            _members_equal(f"H6 batched {name} {tag}", got, call(one), i)


def _member_call(fn, i):
    """``fn`` on member i of each batched tensor argument (a contiguous
    copy of its planes)."""
    def call(*args, **kw):
        pick = lambda a: a[i].contiguous() if isinstance(a, torch.Tensor) else a  # noqa: E731
        return fn(*(pick(a) for a in args), **kw)
    return call


def ensemble_rest_phase(smi, gen, worst, reset_counts, read_counts, kernels):
    """Phase 9: the fast and multigrid ensembles on batched H5-H8.  The
    kernel checks (:func:`rest_kernel_checks`); a 200-step 64 x 512² fast
    ensemble and a 200-step 64 x 512² quality viscosity sweep, each with
    the launch counts read around it (one launch a stage for all members, no
    single-member launch) and members 0, 31, 63 (and the sweep's member at
    the config's viscosity) bit for bit against their single rollouts, the
    sweep's V-cycles per checked member and its host reads; 8 fixed-cycle
    multigrid steps from the sweep's state; the device operations of one
    batched fast step and one batched quality step, and the fast step under
    ``set_sync_debug_mode("error")``.  Returns the timing part, called in
    phase 14 (timing): member-steps/s batched against one member at a time, and the
    batched rows of the kernels line."""
    import dataclasses

    import numpy as np

    from cudafluidsimulation_tpu_torch import FluidConfig, Simulation
    from cudafluidsimulation_tpu_torch.models.ensemble import (
        batched_impulse, batched_state, make_diffusion_sweep_run, make_ensemble_run,
        run_batched, step_of)
    from cudafluidsimulation_tpu_torch.models.pipelines import make_batched_step
    from cudafluidsimulation_tpu_torch.ops import (
        advect_cuda, advect_packed, backend, fastdiffuse, fastdiffuse_cuda, jacobi_cuda,
        member_params, multigrid, multigrid_cuda, ref)
    from cudafluidsimulation_tpu_torch.state import FluidState
    from cudafluidsimulation_tpu_torch.utils.impulse import Impulse, orbit_impulse
    from cudafluidsimulation_tpu_torch.utils.timing import cuda_times_ms

    t0 = time.perf_counter()
    torch_mean_equal = rest_kernel_checks(gen, worst)
    _json({"phase": "ensemble_rest_kernel_checks", "seconds": time.perf_counter() - t0,
           "shapes": [f"{b}x{h}x{w}" for b, h, w in ENS_SHAPES],
           "level_pairs": [f"{b}x{h}x{w}" for b, h, w in ENS_MG_PAIRS],
           "members_bit_equal_to_single_launch": True,
           "torch_batched_mean_equals_single_mean": torch_mean_equal})

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 2)
    mc = multigrid_cuda
    c = ENS_N / 2
    jitter = rng.uniform(-ENS_JITTER, ENS_JITTER, (ENS_B, 2)).astype(np.float32)
    levels = multigrid._levels(ENS_N, ENS_N)
    single_keys = [k for k in kernels if "batched" not in k]

    def finite(what, state):
        for name in ("u", "v", "dye", "pressure"):
            if not bool(torch.isfinite(getattr(state, name)).all()):
                raise AssertionError(f"{what}: {name} is not finite")
        dmin, dmax = state.dye.min().item(), state.dye.max().item()
        if not (0.0 <= dmin and dmax <= 2.0):
            raise AssertionError(f"{what}: dye outside [0, 2]: [{dmin}, {dmax}]")
        return [dmin, dmax]

    def launched(what, counts, on, off):
        for k in on:
            if counts[k] == 0:
                raise AssertionError(f"{what}: {k} was not launched")
        for k in list(off) + single_keys:
            if counts[k] != 0:
                raise AssertionError(f"{what}: {k} was launched ({counts[k]})")

    def window(bimp, a, b):
        """Steps a..b-1 of a batched impulse schedule."""
        return Impulse(*(f[:, a:b] for f in bimp))

    def members_equal(what, state, cfg_of, start, bimp, members):
        """Members bit for bit against their single rollouts; the V-cycles
        a step each single rollout took (the quality path's)."""
        cycles = {}
        for i in members:
            sim = Simulation(cfg_of(i))
            before = mc.SMOOTH_RES_RESTRICT.launches
            init = (sim.init() if start is None
                    else FluidState(*(getattr(start, n)[i] for n in FluidState._fields)))
            single = sim.run(init, Impulse(*(f[i] for f in bimp)))
            cycles[i] = ((mc.SMOOTH_RES_RESTRICT.launches - before)
                         / ((levels - 1) * bimp.dt.shape[1]))
            for name in single._fields:
                if not torch.equal(getattr(state, name)[i].cpu(), getattr(single, name).cpu()):
                    raise AssertionError(f"{what}: member {i}'s {name} differs from its "
                                         f"single rollout")
        return cycles

    # -- the fast ensemble: H8, H2, H7, H4 batched ---------------------------------
    fcfg = FluidConfig.gpu_reference(nx=ENS_N, ny=ENS_N, pressure_iters=40, backend="cuda",
                                     **FAST)
    fimp = batched_impulse(orbit_impulse(ENS_STEPS, fcfg.dt, center=(c, c), radius=64,
                                         omega=3.0), ENS_B, jitter_pos=jitter)
    frun = make_ensemble_run(fcfg)
    reset_counts()
    fmid = frun(batched_state(fcfg, ENS_B), window(fimp, 0, ENS_STEPS - ENS_WINDOW))
    fstate = frun(fmid, window(fimp, ENS_STEPS - ENS_WINDOW, ENS_STEPS))
    torch.cuda.synchronize()
    flaunch = read_counts()
    launched("fast ensemble", flaunch, ("H2 batched", "H4 batched", "H7 batched", "H8 batched"),
             ("H1 batched", "H3 batched"))
    fchecked = [0, ENS_B // 2 - 1, ENS_B - 1]
    members_equal("fast ensemble", fstate, lambda i: fcfg, None, fimp, fchecked)
    driven = (fstate.vel_stats * fcfg.dt >= 1.0).any(dim=1)
    if not bool(driven.any()):
        raise AssertionError("fast ensemble: every member is quiet; H8 would not round its taps")
    _json({"phase": "ensemble_fast", "members": ENS_B, "grid": f"{ENS_N}x{ENS_N}",
           "steps": ENS_STEPS, "launches": {k: v for k, v in flaunch.items() if v},
           "members_bit_equal_to_single_rollout": fchecked,
           "members_driven_at_the_end": int(driven.sum()), "dye_range": finite("fast", fstate)})
    fstep = make_batched_step(fcfg, backend.get_batched_ops(fcfg))
    flast = step_of(fimp, ENS_STEPS - 1)
    fops = _device_kernels(lambda: fstep(fstate, flast))
    n_fops = sum(fops.values())
    _json({"phase": "ensemble_fast_step_device_ops", "device_ops": n_fops, "by_name": fops})
    if n_fops != ENS_FAST_STEP_DEVICE_OPS:
        raise AssertionError(f"one batched fast step made {n_fops} device operations, "
                             f"not {ENS_FAST_STEP_DEVICE_OPS}")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fstep(fstate, flast)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()

    # -- the quality viscosity sweep: H1-H3, H5 and H6 batched -------------------------
    qcfg = FluidConfig.quality(nx=ENS_N, ny=ENS_N, backend="cuda")
    visc = np.linspace(0.1, 2.0, ENS_B, dtype=np.float32)
    at_cfg = int(np.argmin(np.abs(visc - qcfg.velocity_diffusion)))
    visc[at_cfg] = np.float32(qcfg.velocity_diffusion)
    qimp = batched_impulse(orbit_impulse(ENS_STEPS, qcfg.dt, center=(c, c), radius=64,
                                         omega=3.0), ENS_B, jitter_pos=jitter)
    sweep = make_diffusion_sweep_run(qcfg)
    reset_counts()
    qmid = sweep(visc, batched_state(qcfg, ENS_B), window(qimp, 0, ENS_STEPS - ENS_WINDOW))
    qstate = sweep(visc, qmid, window(qimp, ENS_STEPS - ENS_WINDOW, ENS_STEPS))
    torch.cuda.synchronize()
    qlaunch = read_counts()
    launched("quality sweep", qlaunch, (
        "H1 batched", "H2 batched", "H3 batched", "H5 batched", "H6 batched smooth_damped",
        "H6 batched smooth_res_restrict", "H6 batched first_smooth_res_restrict",
        "H6 batched prolong_smooth", "H6 batched mean_square"), (
        "H4 batched", "H7 batched", "H8 batched", "H6 batched smooth_res",
        "H6 batched first_smooth_res", "H6 batched last_smooth_project",
        "H6 batched prolong_smooth_project"))
    # the batch runs the most cycles any member needs, a step
    batched_cycles = qlaunch["H6 batched smooth_res_restrict"] / ((levels - 1) * ENS_STEPS)
    if qlaunch["H6 batched mean_square"] != round((batched_cycles + 1) * ENS_STEPS):
        raise AssertionError(f"quality sweep: {qlaunch['H6 batched mean_square']} stopping "
                             f"tests for {batched_cycles} cycles a step")
    qchecked = sorted({0, ENS_B // 2 - 1, ENS_B - 1, at_cfg})
    cycles = members_equal(
        "quality sweep", qstate,
        lambda i: dataclasses.replace(qcfg, velocity_diffusion=float(visc[i])), None, qimp,
        qchecked)
    if max(cycles.values()) > batched_cycles:
        raise AssertionError(f"a member took more cycles than the batch: {cycles}")
    _json({"phase": "ensemble_quality_sweep", "members": ENS_B, "grid": f"{ENS_N}x{ENS_N}",
           "steps": ENS_STEPS, "levels": levels,
           "launches": {k: v for k, v in qlaunch.items() if v},
           "members_bit_equal_to_single_rollout": qchecked, "at_config_viscosity": at_cfg,
           "vcycles_per_step_of_checked_members": cycles,
           "vcycles_per_step_of_the_batch": batched_cycles,
           "host_reads_per_step": batched_cycles + 1, "dye_range": finite("quality", qstate)})

    # -- fixed-cycle multigrid from the sweep's state: prolong_smooth_project batched
    xcfg = FluidConfig.gpu_reference(nx=ENS_N, ny=ENS_N, pressure_solver="multigrid",
                                     mg_cycles=2, backend="cuda")
    ximp = Impulse(*(f[:, ENS_STEPS - FIXED_STEPS:] for f in qimp))
    reset_counts()
    xstate = run_batched(make_batched_step(xcfg), qstate, ximp)
    torch.cuda.synchronize()
    xlaunch = read_counts()
    launched("fixed-cycle ensemble", xlaunch, (
        "H6 batched first_smooth_res_restrict", "H6 batched smooth_res_restrict",
        "H6 batched prolong_smooth", "H6 batched smooth_damped",
        "H6 batched prolong_smooth_project"), ("H4 batched", "H5 batched",
                                                "H6 batched mean_square"))
    members_equal("fixed-cycle ensemble", xstate, lambda i: xcfg, qstate, ximp,
                  [0, ENS_B - 1])
    _json({"phase": "ensemble_fixed_cycle", "members": ENS_B, "steps": FIXED_STEPS,
           "launches": {k: v for k, v in xlaunch.items() if v},
           "members_bit_equal_to_single_rollout": [0, ENS_B - 1],
           "dye_range": finite("fixed-cycle", xstate)})
    del xstate

    # the device operations of one batched quality step: every member the
    # checked member that took the most cycles (so all stop together), then
    # the sweep's last step
    alike = max(cycles, key=cycles.get)
    rep = FluidState(*(torch.stack([getattr(qstate, n)[alike]] * ENS_B)
                       for n in FluidState._fields))
    rimp = Impulse(*(torch.stack([f[alike, ENS_STEPS - 1]] * ENS_B) for f in qimp))
    qops_ns = backend.get_batched_ops(qcfg)
    rstep = make_batched_step(qcfg, qops_ns, np.full(ENS_B, visc[alike]))
    before = mc.SMOOTH_RES_RESTRICT_BATCHED.launches
    rstep(rep, rimp)
    k = (mc.SMOOTH_RES_RESTRICT_BATCHED.launches - before) // (levels - 1)
    rops = _device_kernels(lambda: rstep(rep, rimp))
    n_rops = sum(rops.values())
    qstep = make_batched_step(qcfg, qops_ns, visc)
    qlast = step_of(qimp, ENS_STEPS - 1)
    before = mc.SMOOTH_RES_RESTRICT_BATCHED.launches
    qstep(qstate, qlast)
    k_last = (mc.SMOOTH_RES_RESTRICT_BATCHED.launches - before) // (levels - 1)
    lops = _device_kernels(lambda: qstep(qstate, qlast))
    reads = sum(n for name, n in lops.items() if "DtoH" in name)
    _json({"phase": "ensemble_quality_step_device_ops", "members_alike": {
        "member": alike, "vcycles": k, "device_ops": n_rops, "predicted": ens_quality_step_ops(k, levels),
        "by_name": rops}, "sweep_last_step": {
        "vcycles": k_last, "device_ops": sum(lops.values()), "host_reads": reads,
        "by_name": lops}})
    if n_rops != ens_quality_step_ops(k, levels):
        raise AssertionError(f"one batched quality step of alike members made {n_rops} device "
                             f"operations at {k} V-cycles, not {ens_quality_step_ops(k, levels)}")
    if reads != k_last + 1:
        raise AssertionError(f"the sweep's last step read {reads} times at {k_last} V-cycles")

    def timing():
        """Member-steps/s of the fast ensemble and the quality sweep against
        the same members one after another, and where the device time goes,
        all over one window: each rollout's last ENS_WINDOW steps from the
        state it reached before them (so the V-cycles a step and the quiet
        branches are the rollout's own there); the batched rows of the
        kernels line."""
        out_rows = []
        for what, cfg_, run_, bimp, start in (
                ("fast", fcfg, frun, fimp, fmid),
                ("quality", qcfg, lambda s, im: sweep(visc, s, im), qimp, qmid)):
            steps = ENS_WINDOW
            win = window(bimp, ENS_STEPS - steps, ENS_STEPS)
            host_s = []

            def batched():
                # the host's time to its return (the quality sweep's
                # includes its waits at the stopping tests)
                t_0 = time.perf_counter()
                run_(start, win)
                host_s.append(time.perf_counter() - t_0)

            batched_ms = statistics.median(cuda_times_ms(batched, iters=3))
            enqueue_ms = statistics.median(host_s[1:]) / steps * 1e3  # [0]: the warm-up
            mcfg = [cfg_ if what == "fast" else
                    dataclasses.replace(cfg_, velocity_diffusion=float(k)) for k in
                    (visc if what == "quality" else range(ENS_B))]
            sims = [Simulation(m) for m in mcfg]
            # member i of the batched state is its single rollout's state
            inits = [FluidState(*(getattr(start, n)[i] for n in FluidState._fields))
                     for i in range(ENS_B)]

            def one_by_one():
                for i, s in enumerate(sims):
                    s.run(inits[i], Impulse(*(f[i] for f in win)))

            serial_ms = statistics.median(cuda_times_ms(one_by_one, iters=2, warmup=0))
            by_op = {}
            for name, us in _device_trace(lambda: run_(start, win)):
                by_op[name.split("(")[0]] = by_op.get(name.split("(")[0], 0.0) + us / (
                    1e3 * steps)
            member_steps = ENS_B * steps
            _json({"metric": "ensemble_member_steps_per_sec", "path": what, "members": ENS_B,
                   "grid": f"{ENS_N}x{ENS_N}", "steps": f"{ENS_STEPS - steps}-{ENS_STEPS}",
                   "batched": member_steps / (batched_ms / 1e3),
                   "one_member_at_a_time": member_steps / (serial_ms / 1e3),
                   "batched_ms_per_step": batched_ms / steps,
                   "one_member_at_a_time_ms_per_step": serial_ms / steps,
                   "device_busy_ms_per_step": sum(by_op.values()),
                   "device_idle_share": 1.0 - sum(by_op.values()) / (batched_ms / steps),
                   "device_ms_by_op": by_op, "host_enqueue_ms_per_step": enqueue_ms,
                   "smi": smi})

        # the batched kernels at the ensembles' shapes, on their driven states
        b, cells = ENS_B, ENS_B * ENS_N * ENS_N
        dt, rate, radius = fcfg.dt, fcfg.decay_rate, fcfg.splat_radius
        dts = np.full(b, dt, np.float32)
        fu, fv, fst, fdye = fstate.u, fstate.v, fstate.vel_stats, fstate.dye
        fu2, fv2, fst2 = advect_cuda.advect_velocity_batched(fu, fv, dts, rate, vel_stats=fst,
                                                             return_stats=True, packed=True)
        all5 = torch.cat([torch.stack([fu, fv], dim=1), fdye], dim=1).contiguous()
        amps = rng.uniform(-4.0, 4.0, (b, 5)).astype(np.float32)
        last = (rng.random((b, 2)) * ENS_N).astype(np.float32)
        prm = member_params.upload(np.concatenate([
            member_params.advect_cols(dts, rate),
            member_params.diffuse_cols(dts, np.full((b, 5), 0.8, np.float32), amps, last)],
            axis=1), dev)
        adv_p, splat_p = prm[:, :2], prm[:, 2 + 10:]
        taps5, radii = fastdiffuse._taps_array([0.8 * 0.8 / dt] * 5, 20, 2e-4)
        sep_taps = sum(2 * (2 * r + 1) for r in radii)
        qu, qv, p = qstate.u, qstate.v, qstate.pressure
        rhs = -jacobi_cuda.divergence_batched(qu, qv, True)
        res = mc.smooth_res_batched(p, rhs, 2)[1]
        e_c = 4.0 * multigrid._restrict(res)
        rhs16 = rhs
        for _ in range(levels - 1):
            rhs16 = 4.0 * multigrid._restrict(rhs16)
        pl = multigrid.PLAIN_BATCHED
        cases = {
            "H5 batched": (
                lambda: (jacobi_cuda.divergence_batched(qu, qv, True),
                         jacobi_cuda.project_batched(qu, qv, p, return_stats=True)),
                lambda: (ref.divergence_batched(qu, qv, True),
                         ref.project_batched(qu, qv, p, return_stats=True)),
                [qu, qv, qu, qv, p], cells * 12, "quality sweep"),
            # the stopping test's reduction (PyTorch's (r * r).mean(dim) is two
            # calls and another order: no library row)
            "H6 batched mean_square": (lambda: mc.mean_square_batched(res),
                                       lambda: multigrid.mean_square(res), [res], cells * 2,
                                       "quality sweep"),
            "H6 batched smooth_damped": (lambda: mc.smooth_damped_batched(None, rhs16, 20),
                                         lambda: pl.smooth_damped(None, rhs16, 20), [rhs16],
                                         rhs16.numel() * 8 * 20, "quality sweep"),
            "H6 batched smooth_res": (
                lambda: (mc.smooth_res_batched(p, rhs, 2),
                         mc.smooth_res_batched(rhs, rhs, 2, from_zero=True)),
                lambda: (pl.smooth_res(p, rhs, 2), pl.smooth_res(rhs, rhs, 2, from_zero=True)),
                [p, rhs, rhs], cells * 46, None),
            "H6 batched first_smooth_res": (
                lambda: mc.first_smooth_res_batched(qu, qv, 2, True),
                lambda: pl.first_smooth_res(qu, qv, 2, True), [qu, qv], cells * 27, None),
            "H6 batched last_smooth_project": (
                lambda: mc.last_smooth_project_batched(p, rhs, qu, qv, 2, return_stats=True),
                lambda: pl.last_smooth_project(p, rhs, qu, qv, 2, return_stats=True),
                [p, rhs, qu, qv], cells * 24, None),
            "H6 batched smooth_res_restrict": (
                lambda: mc.smooth_res_restrict_batched(p, rhs, 2, return_res=True),
                lambda: pl.smooth_res_restrict(p, rhs, 2, return_res=True), [p, rhs],
                cells * 23.25, "quality sweep"),
            "H6 batched first_smooth_res_restrict": (
                lambda: mc.first_smooth_res_restrict_batched(qu, qv, 2, True),
                lambda: pl.first_smooth_res_restrict(qu, qv, 2, True), [qu, qv],
                cells * 22.25, "quality sweep"),
            "H6 batched prolong_smooth": (
                lambda: mc.prolong_smooth_batched(p, e_c, rhs, 2),
                lambda: pl.prolong_smooth(p, e_c, rhs, 2), [p, e_c, rhs], cells * 24,
                "quality sweep"),
            "H6 batched prolong_smooth_project": (
                lambda: mc.prolong_smooth_project_batched(p, e_c, rhs, qu, qv, 2,
                                                          return_stats=True),
                lambda: pl.prolong_smooth_project(p, e_c, rhs, qu, qv, 2, return_stats=True),
                [p, e_c, rhs, qu, qv], cells * 34, "fixed-cycle ensemble"),
            "H7 batched": (
                lambda: fastdiffuse_cuda.sep_apply_batched(all5, taps5, radii,
                                                           (amps, last, radius), params=splat_p),
                lambda: fastdiffuse.sep_apply_batched(all5, taps5, radii, (amps, last, radius)),
                [all5, splat_p], 5 * cells * (2 * sep_taps + 10), "fast ensemble"),
            "H8 batched": (
                lambda: (advect_cuda.advect_velocity_batched(fu, fv, dts, rate, vel_stats=fst,
                                                             return_stats=True, packed=True,
                                                             params=adv_p),
                         advect_cuda.advect_dye_batched(fdye, fu2, fv2, dts, rate,
                                                        vel_stats=fst2, packed=True,
                                                        params=adv_p)),
                lambda: (advect_packed.advect_velocity_batched(fu, fv, dts, rate, vel_stats=fst,
                                                               return_stats=True),
                         advect_packed.advect_dye_batched(fdye, fu2, fv2, dts, rate,
                                                          vel_stats=fst2)),
                [fu, fv, fst, fdye, fu2, fv2, fst2, adv_p], cells * 82, "fast ensemble"),
        }
        path_launches = {"fast ensemble": flaunch, "quality sweep": qlaunch,
                         "fixed-cycle ensemble": xlaunch}

        def h8_velocity():
            return advect_cuda.advect_velocity_batched(fu, fv, dts, rate, vel_stats=fst,
                                                       return_stats=True, packed=True,
                                                       params=adv_p)

        def h8_dye():
            return advect_cuda.advect_dye_batched(fdye, fu2, fv2, dts, rate, vel_stats=fst2,
                                                  packed=True, params=adv_p)

        # H8's two passes apart (information)
        extra = {"H8 batched": {"velocity_device_ms": _device_ms(h8_velocity),
                                "dye_device_ms": _device_ms(h8_dye)}}
        for k, (kern_fn, plain_fn, inputs, n_ops, path) in cases.items():
            calls = _device_kernels(kern_fn)
            if sum(calls.values()) != ENS_REST_CALL_LAUNCHES[k]:
                raise AssertionError(f"{k}: {calls} device launches in one call at "
                                     f"{b}x{ENS_N}x{ENS_N}, not {ENS_REST_CALL_LAUNCHES[k]}")
            nbytes = _nbytes(inputs) + _nbytes(kern_fn())
            bytes_ms, ops_ms = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * n_ops / F32_OPS_PER_S
            # plain, kernel, kernel, plain; the plain loop over 64 members is slow
            p1 = cuda_times_ms(plain_fn, iters=2, warmup=1)
            k1 = cuda_times_ms(kern_fn, iters=5, warmup=1)
            k2 = cuda_times_ms(kern_fn, iters=5, warmup=0)
            p2 = cuda_times_ms(plain_fn, iters=2, warmup=0)
            _, src, replaces = kernels[k]
            worst_key = {"H6 batched mean_square": "H6 mean_square"}.get(
                k, "H6 batched" if k.startswith("H6") else k)
            out_rows.append({
                "name": f"{k} {src[:-3]}", "route": "cuda",
                "source": f"cudafluidsimulation_tpu_torch/csrc/{src}",
                "replaces": f"cudafluidsimulation_tpu/ops/{replaces}",
                "launches": path_launches[path][k] if path else 0, "path": path,
                "members": b, "grid": f"{ENS_N}x{ENS_N}", "max_abs_err": worst[worst_key],
                **({"max_abs_err_without_splat": worst["H7 sweeps batched"]}
                   if k == "H7 batched" else {}),
                **extra.get(k, {}),
                "launches_per_call": sum(calls.values()),
                "ms": statistics.median(k1 + k2), "device_ms": _device_ms(kern_fn),
                "plain_ms": statistics.median(p1 + p2),
                "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "bytes": nbytes, "operations": n_ops,
                # no single PyTorch call computes a batched kernel's function
                "library_ms": None,
            })
        return out_rows

    return timing


# phase 10, the headless CLI: the parity run's flags (bench.py's parity
# configuration with frames, video, fields, checkpoints, health checks and
# the sampled report), a resume, the quality and fast presets, and the
# decomposed report (the first driven path through H4's pressure_solve)
CLI_STEPS = {"parity": 200, "resume": 10, "quality": 50, "fast": 50, "decomposed": 20}
CLI_FRAME_EVERY = 50
CLI_CHECKPOINT_EVERY = 100
CLI_BUCKETS = {
    "parity": ["Advect", "Vorticity", "Diffuse+Force", "Pressure+Project", "Paint+Bloom"],
    "quality": ["Advect", "Vorticity", "Diffuse+Force", "Pressure", "Project", "Paint+Bloom"],
    "fast": ["Advect", "Vorticity", "Diffuse+Force", "Pressure+Project", "Paint+Bloom"],
    "decomposed": ["Advect", "Vorticity", "Diffuse", "Force", "Pressure", "Project"],
}


def _cli_kernels_per_call():
    """Device kernels one entry call of the parity rollout launches at N²:
    H1 and H2 one, H3 and H4 a burst each (the planner's plans for 20
    diffusion and 40 pressure sweeps; memsets are not kernels)."""
    from cudafluidsimulation_tpu_torch.ops import jacobi_cuda

    return {"H1": 1, "H2": 1, "H3": len(jacobi_cuda.plan_bursts(N, N, 20, "diffuse").depths),
            "H4": len(jacobi_cuda.plan_bursts(N, N, 40, "project").depths)}


def _cli_report(text):
    """(steps/s, ms/step, {bucket: ms}) from the CLI's end-of-run report."""
    import re

    rows = {name: float(ms) for name, ms in
            re.findall(r"^(.+) compute time: ([-\d.]+)ms$", text, flags=re.M)}
    per_step = float(re.search(r"^Average compute time: ([\d.]+)ms / step$", text,
                               flags=re.M).group(1))
    sps = float(re.search(r"^Throughput: (\S+) steps/s$", text, flags=re.M).group(1))
    return sps, per_step, rows


def _avi_frames(path):
    """The frame count of an AVI from its main header and its index."""
    import struct

    data = Path(path).read_bytes()
    if data[:4] != b"RIFF" or data[8:12] != b"AVI ":
        raise AssertionError(f"{path} is not an AVI")
    avih = data.index(b"avih") + 8
    frames = struct.unpack("<14I", data[avih:avih + 56])[4]
    idx = data.index(b"idx1")
    entries = struct.unpack("<I", data[idx + 4:idx + 8])[0] // 16
    if entries != frames:
        raise AssertionError(f"{path}: {frames} frames in the header, {entries} indexed")
    return frames, data[data.index(b"strh") + 12:data.index(b"strh") + 16].decode()


def cli_phase(smi, reset_counts, read_counts, dev):
    """Phase 10: ``cudafluidsimulation_tpu_torch.cli.main`` in-process at
    2048² on the default backend, its outputs under a temporary directory.

    The rollout's launches are counted around each ``Simulation.run`` the
    CLI makes (its warm-up step and its report are not the rollout), and
    every count of the whole call is read too.  Returns the decomposed
    run's counts of the whole call (the row of H4's pressure_solve)."""
    import contextlib
    import io
    import tempfile

    import numpy as np

    from cudafluidsimulation_tpu_torch import FluidConfig, Simulation, cli
    from cudafluidsimulation_tpu_torch.models.pipelines import make_step
    from cudafluidsimulation_tpu_torch.ops.backend import get_ops
    from cudafluidsimulation_tpu_torch.utils.checkpoint import load_state
    from cudafluidsimulation_tpu_torch.utils.impulse import (
        no_impulse, orbit_impulse, slice_step)
    from cudafluidsimulation_tpu_torch.utils.instrument import StageSpans, timed_ops

    dt = 1.0 / 60.0
    rollout = {}

    class CountedSimulation(Simulation):
        def run(self, state, impulses):
            before = read_counts()
            out = super().run(state, impulses)
            for k, n in read_counts().items():
                rollout[k] = rollout.get(k, 0) + n - before[k]
            return out

    def run_cli(argv):
        out = io.StringIO()
        rollout.clear()
        reset_counts()
        cli.Simulation = CountedSimulation
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(out):
                rc = cli.main(argv)
        finally:
            cli.Simulation = Simulation
        seconds = time.perf_counter() - t0
        counts = read_counts()
        if rc != 0:
            raise AssertionError(f"cli {' '.join(argv)}: exit {rc}")
        return out.getvalue(), counts, dict(rollout), seconds

    def per_step(cfg):
        """Each kernel's launches in one driven step of ``cfg``."""
        sim = Simulation(cfg)
        reset_counts()
        sim.run(sim.init(), orbit_impulse(1, dt, center=(N / 2, N / 2), radius=N / 8,
                                          omega=3.0))
        torch.cuda.synchronize()
        return read_counts()

    def bit_equal(what, path, state):
        with np.load(path) as d:
            for k in ("u", "v", "dye", "pressure"):
                if not torch.equal(torch.from_numpy(d[k]).to(dev), getattr(state, k)):
                    err = _max_err(torch.from_numpy(d[k]).to(dev), getattr(state, k))
                    raise AssertionError(f"cli {what}: {k} differs from Simulation.run "
                                         f"(max abs {err[0]:.3e})")

    def buckets(what, rows, runs_segments=True):
        expect = CLI_BUCKETS[what] + (["Min frame", "Max frame"] if runs_segments else [])
        if list(rows) != expect:
            raise AssertionError(f"cli {what}: report rows {list(rows)}, expected {expect}")

    base = ["--grid", str(N), "--pressure-iters", "40", "--max-displacement", "31"]
    parity_cfg = FluidConfig.gpu_reference(nx=N, ny=N, dt=dt, pressure_iters=40,
                                           max_displacement=31)
    fast_cfg = FluidConfig.gpu_reference(nx=N, ny=N, dt=dt, pressure_iters=40,
                                         max_displacement=31, **FAST)
    quality_cfg = FluidConfig.gpu_reference(nx=N, ny=N, dt=dt, pressure_solver="multigrid",
                                            mg_tol=0.05, max_displacement=31)
    runs = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as tmp:
        tmp = Path(tmp)

        # -- the parity run
        steps = CLI_STEPS["parity"]
        text, counts, rolled, seconds = run_cli(base + [
            "--steps", str(steps), "--impulse", "orbit",
            "--frames-dir", str(tmp / "frames"), "--frame-every", str(CLI_FRAME_EVERY),
            "--video", str(tmp / "run.avi"), "--save-fields", str(tmp / "parity.npz"),
            "--checkpoint", str(tmp / "ck.npz"), "--checkpoint-every", str(CLI_CHECKPOINT_EVERY),
            "--health", "--report"])
        one = per_step(parity_cfg)
        expect = {k: steps * n for k, n in one.items()}
        if rolled != expect:
            diff = {k: (rolled[k], expect[k]) for k in expect if rolled[k] != expect[k]}
            raise AssertionError(f"cli parity: rollout launches (got, {steps} steps' worth): {diff}")
        for k in ("H1", "H2", "H3", "H4"):
            if rolled[k] == 0:
                raise AssertionError(f"cli parity: {k} not launched")
        pngs = sorted((tmp / "frames").glob("frame_*.png"))
        n_frames = steps // CLI_FRAME_EVERY
        if len(pngs) != n_frames:
            raise AssertionError(f"cli parity: {len(pngs)} PNG frames, expected {n_frames}")
        avi_frames, codec = _avi_frames(tmp / "run.avi")
        if avi_frames != n_frames:
            raise AssertionError(f"cli parity: the AVI holds {avi_frames} frames")
        sim = Simulation(parity_cfg)
        ref_state = sim.run(sim.init(), orbit_impulse(steps, dt, center=(N / 2, N / 2),
                                                      radius=N / 8, omega=3.0))
        bit_equal("parity", tmp / "parity.npz", ref_state)
        ck = load_state(str(tmp / "ck.npz"), dev)
        if int(ck.step) != steps or not all(torch.equal(getattr(ck, k), getattr(ref_state, k))
                                            for k in ("u", "v", "dye", "pressure", "vel_stats")):
            raise AssertionError("cli parity: the checkpoint is not the final state")
        sps, ms, rows = _cli_report(text)
        buckets("parity", rows)
        runs["parity"] = {"steps": steps, "steps_per_s": sps, "ms_per_step": ms,
                          "stage_ms": rows, "seconds": seconds, "frames": len(pngs),
                          "video_codec": codec, "rollout_launches": rolled,
                          "call_launches": counts}
        del ref_state

        # -- the same rollout with the report alone: one synchronize a
        #    20-step segment and no output inside the timed window
        text, counts, rolled, seconds = run_cli(base + [
            "--steps", str(steps), "--impulse", "orbit", "--report"])
        if rolled != expect:
            raise AssertionError(f"cli parity --report: rollout launches {rolled}")
        sps, ms, rows = _cli_report(text)
        buckets("parity", rows)
        runs["parity_report"] = {"steps": steps, "steps_per_s": sps, "ms_per_step": ms,
                                 "stage_ms": rows, "seconds": seconds}

        # -- resume from the parity run's checkpoint
        steps = CLI_STEPS["resume"]
        text, counts, rolled, seconds = run_cli(base + [
            "--steps", str(steps), "--impulse", "none", "--resume", str(tmp / "ck.npz"),
            "--save-fields", str(tmp / "resume.npz"), "--profile-dir", str(tmp / "prof")])
        bit_equal("resume", tmp / "resume.npz", sim.run(ck, no_impulse(steps, dt)))
        traces = list((tmp / "prof").glob("*.json"))
        if len(traces) != 1:
            raise AssertionError(f"cli resume: {len(traces)} profiler traces")
        events = json.loads(traces[0].read_text())["traceEvents"]
        # the trace holds every kernel the rollout launched: its entry
        # calls times each entry's device launches, the pad left out by name
        kernel_names = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
        pad = sum("spin_kernel" in name for name in kernel_names)
        traced = len(kernel_names) - pad
        launched = sum(rolled[k] * n for k, n in _cli_kernels_per_call().items())
        if traced != launched or any(n for k, n in rolled.items()
                                     if k not in _cli_kernels_per_call()):
            raise AssertionError(f"cli resume: the --profile-dir trace holds {traced} kernels "
                                 f"besides its {pad} pad kernels; the rollout launched "
                                 f"{launched} ({rolled})")
        sps, ms, _ = _cli_report(text)
        runs["resume"] = {"steps": steps, "steps_per_s": sps, "ms_per_step": ms,
                          "seconds": seconds, "rollout_launches": rolled,
                          "profile_kernel_events": sum(e.get("cat") == "kernel"
                                                       for e in events),
                          "profile_pad_events": pad, "profile_pad_launched": 2 * cli.PROFILE_PAD,
                          "profile_rollout_kernel_events": traced,
                          "rollout_device_kernels": launched}

        # -- the quality and fast presets
        for what, cfg in (("quality", quality_cfg), ("fast", fast_cfg)):
            steps = CLI_STEPS[what]
            text, counts, rolled, seconds = run_cli(base + [
                "--steps", str(steps), "--impulse", "orbit", "--preset", what, "--report",
                "--save-fields", str(tmp / f"{what}.npz")])
            psim = Simulation(cfg)
            bit_equal(what, tmp / f"{what}.npz",
                      psim.run(psim.init(), orbit_impulse(steps, dt, center=(N / 2, N / 2),
                                                          radius=N / 8, omega=3.0)))
            if what == "fast":
                one = per_step(cfg)
                expect = {k: steps * n for k, n in one.items()}
                if rolled != expect:
                    raise AssertionError(f"cli fast: rollout launches {rolled}, expected {expect}")
                launched, idle = ("H2", "H4", "H7", "H8"), ("H1", "H3")
            else:
                launched, idle = ("H1", "H2", "H3", "H5", "H6 prolong_smooth"), ("H4",)
            for k in launched:
                if rolled[k] == 0:
                    raise AssertionError(f"cli {what}: {k} not launched")
            for k in idle:
                if rolled[k] != 0:
                    raise AssertionError(f"cli {what}: {k} launched")
            sps, ms, rows = _cli_report(text)
            buckets(what, rows)
            runs[what] = {"steps": steps, "steps_per_s": sps, "ms_per_step": ms,
                          "stage_ms": rows, "seconds": seconds}

    # -- the decomposed report: H5 divergence, H4 pressure_solve, H5 project
    steps = CLI_STEPS["decomposed"]
    text, decomposed, rolled, seconds = run_cli(base + [
        "--steps", str(steps), "--impulse", "orbit", "--report", "--report-mode", "decomposed"])
    if decomposed["H4 solve"] != steps or decomposed["H5"] != 2 * steps:
        raise AssertionError(f"cli decomposed: H4 solve {decomposed['H4 solve']}, H5 "
                             f"{decomposed['H5']} launches in {steps} steps")
    if rolled["H4 solve"] != 0 or rolled["H5"] != 0 or rolled["H4"] != steps:
        raise AssertionError(f"cli decomposed: the rollout is not the fused step: {rolled}")
    sps, ms, rows = _cli_report(text)
    buckets("decomposed", rows)
    # one decomposed step against the fused step, from the parity state;
    # the splat after the sweeps rounds its division otherwise (one ulp)
    imp = slice_step(orbit_impulse(CLI_STEPS["parity"] + 1, dt, center=(N / 2, N / 2),
                                   radius=N / 8, omega=3.0), CLI_STEPS["parity"])
    spans = StageSpans(dev)
    got = make_step(parity_cfg, timed_ops(get_ops(parity_cfg), spans))(ck, imp)
    exp = sim.step(ck, imp)
    step_err = {k: _max_err(getattr(got, k), getattr(exp, k))[1] for k in STATE_FIELDS}
    if not max(step_err.values()) <= STEP_RTOL:
        raise AssertionError(f"cli decomposed: one step off the fused step by {step_err}")
    billed = spans.seconds()
    runs["decomposed"] = {"steps": steps, "steps_per_s": sps, "ms_per_step": ms,
                          "stage_ms": rows, "seconds": seconds, "call_launches": decomposed,
                          "step_vs_fused_max_rel_err": step_err, "tol": STEP_RTOL,
                          "one_step_billed_ms": {k: 1e3 * v for k, v in billed.items()}}
    _json({"phase": "cli", "grid": f"{N}x{N}", "runs": runs, "smi": smi})
    return decomposed


# phase 11, the live views: FluidApp frames at N² on the parity
# configuration, through every sink in both modes, and the CLI's --view
VIEW_FRAMES = 64
VIEW_SINKS = ("none", "term", "http", "framesink")
# the CLI's unbounded --view http --interactive session: at most this many
# frames if the client's q were lost, and how long the client holds its press
VIEW_CLI_CAP = 2000
VIEW_PRESS_S = 0.5


def _get(url, timeout=10):
    import urllib.request

    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.status, r.headers, r.read()


def _stream_reader(port, found):
    """Read /stream until the server closes it, as a browser's <img> does;
    record each whole part's Content-Type and first two body bytes in
    ``found``."""
    import http.client

    conn = http.client.HTTPConnection("localhost", port, timeout=30)
    conn.request("GET", "/stream")
    resp = conn.getresponse()
    found.update(status=resp.status, types=[], soi=[])
    buf = b""
    try:
        while True:
            chunk = resp.read1(1 << 20)
            if not chunk:
                break
            buf += chunk
            while True:
                start = buf.find(b"--frame\r\n")
                end = buf.find(b"\r\n\r\n", start)
                if start < 0 or end < 0:
                    break
                head = dict(line.split(": ", 1) for line in
                            buf[start:end].decode().split("\r\n")[1:])
                body = end + 4
                if len(buf) < body + int(head["Content-Length"]):
                    break
                found["types"].append(head["Content-Type"])
                found["soi"].append(buf[body:body + 2].hex())
                buf = buf[body + int(head["Content-Length"]):]
    except OSError:
        pass  # the server closed the connection
    finally:
        conn.close()


def views_phase(smi, reset_counts, read_counts, dev):
    """Phase 11: ``models.app.FluidApp`` at N² on the parity configuration
    (fixed dt), its final state bit-equal to ``Simulation.run`` over the
    impulses its source gave, pipelined frames equal to plain ones, every
    sink in both modes (none, ``TermViewer``, the native ``HttpViewer``
    with a stream client, ``FrameSink``), a ``TermInput`` drag, and the
    CLI's ``--view http --interactive`` and ``--view term --video``.  The
    kernels' launches are read around every loop: H1 2 a frame, H2-H4 one,
    nothing else.  Returns the parity launches of one VIEW_FRAMES loop."""
    import contextlib
    import hashlib
    import io
    import socket
    import tempfile
    import threading

    import numpy as np

    from cudafluidsimulation_tpu_torch import FluidConfig, Simulation, cli
    from cudafluidsimulation_tpu_torch.models.app import (
        FluidApp, finish_readback, orbit_source, queue_readback)
    from cudafluidsimulation_tpu_torch.utils import http_view, native_sink
    from cudafluidsimulation_tpu_torch.utils.impulse import Impulse, single
    from cudafluidsimulation_tpu_torch.utils.native_sink import FrameSink
    from cudafluidsimulation_tpu_torch.utils.term_input import TermInput
    from cudafluidsimulation_tpu_torch.utils.term_view import TermViewer
    from cudafluidsimulation_tpu_torch.utils.timing import cuda_times_ms

    t_phase = time.perf_counter()
    dt = 1.0 / 60.0
    n = VIEW_FRAMES
    cfg = FluidConfig.gpu_reference(nx=N, ny=N, dt=dt, pressure_iters=40, max_displacement=31)
    expect = {k: 0 for k in read_counts()}
    expect.update({"H1": n, "H2": n, "H3": n, "H4": n})
    if not (native_sink.native_available() and http_view.native_available()):
        raise AssertionError("views: the native frame sink or HTTP server did not build")

    def loop(what, sink, pipelined, source=None, frames=n, counted=True):
        """A FluidApp loop from the zero state: (app, {frames/s and the
        report's Min/Max/avg frame ms})."""
        app = FluidApp(cfg, input_source=source or orbit_source(cfg), frame_sink=sink,
                       fixed_dt=dt)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        rep = app.run(max_frames=frames, pipelined=pipelined)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        if counted and counts != expect:
            diff = {k: (counts[k], expect[k]) for k in expect if counts[k] != expect[k]}
            raise AssertionError(f"views {what}: launches (got, expected) {diff}")
        if app.frames != frames:
            raise AssertionError(f"views {what}: {app.frames} frames, not {frames}")
        # the pipelined loop's first frame has no previous one to wait on
        # and is not timed
        timed = frames - (1 if pipelined and sink is not None else 0)
        return app, {"frames_per_s": frames / wall, "min_frame_ms": rep.stage_ms["Min frame"],
                     "max_frame_ms": rep.stage_ms["Max frame"],
                     "avg_frame_ms": 1e3 * rep.total_s / timed}

    def hashing():
        digests = []
        return (lambda frame: digests.append(hashlib.sha1(frame).hexdigest())), digests

    # warm-up: the loop's first frames hold two pinned blocks of the host cache
    loop("warm-up", lambda frame: None, True, frames=4, counted=False)

    # -- the loop without a sink equals the plain rollout over its impulses
    seen = []
    orbit = orbit_source(cfg)

    def recording(t):
        seen.append(orbit(t))
        return seen[-1]

    app, _ = loop("recorded", None, False, source=recording)
    imp = Impulse(*(torch.stack(f) for f in zip(*(single(p, l, q, dt) for p, l, q in seen))))
    sim = Simulation(cfg)
    ref_state = sim.run(sim.init(), imp)
    for k in STATE_FIELDS:
        if not torch.equal(getattr(app.state, k), getattr(ref_state, k)):
            raise AssertionError(f"views: the loop's {k} differs from Simulation.run over its "
                                 f"impulses (max abs {_max_err(getattr(app.state, k), getattr(ref_state, k))[0]})")
    loop_state = app.state
    del ref_state

    # -- pipelined equals plain, frame for frame; the sink's bytes are
    #    Simulation.frame_image's and the old host layout's
    runs = {}
    digests = {}
    for mode in ("plain", "pipelined"):
        sink, digests[mode] = hashing()
        app, runs[f"hash {mode}"] = loop(f"hashing {mode}", sink, mode == "pipelined")
        for k in STATE_FIELDS:
            if not torch.equal(getattr(app.state, k), getattr(loop_state, k)):
                raise AssertionError(f"views: the {mode} loop's {k} differs from the loop "
                                     "without a sink")
    if digests["plain"] != digests["pipelined"] or len(digests["plain"]) != n:
        bad = [i for i, (a, b) in enumerate(zip(digests["plain"], digests["pipelined"]))
               if a != b]
        raise AssertionError(f"views: pipelined frames differ from plain ones at {bad[:8]}")
    frame = sim.render_fn(loop_state)
    old = np.ascontiguousarray(np.moveaxis(frame.cpu().numpy(), 0, -1)[::-1])
    if not (hashlib.sha1(sim.frame_image(frame)).hexdigest() == hashlib.sha1(old).hexdigest()
            == digests["plain"][-1]):
        raise AssertionError("views: the last frame is not Simulation.frame_image's bytes")
    _check_frame("views last frame", old)

    # -- every sink, both modes
    with tempfile.TemporaryDirectory(prefix="chip_smoke_views_") as tmp:
        tmp = Path(tmp)
        http_checks = {}
        for mode in ("plain", "pipelined"):
            piped = mode == "pipelined"
            _, runs[f"none {mode}"] = loop(f"none {mode}", None, piped)

            text = io.StringIO()
            _, runs[f"term {mode}"] = loop(f"term {mode}", TermViewer(stream=text), piped)
            if text.getvalue().count("\u2580") < n:
                raise AssertionError(f"views term {mode}: the viewer painted nothing")

            hv = http_view.HttpViewer(width=N, height=N)
            found = {}
            reader = threading.Thread(target=_stream_reader, args=(hv.port, found), daemon=True)
            reader.start()
            while hv.clients < 1 and reader.is_alive():
                time.sleep(0.001)
            _, runs[f"http {mode}"] = loop(f"http {mode}", hv, piped)
            status, headers, png = _get(hv.url + "frame")
            x, y = N // 7 + 0.25, N // 3 + 0.5  # exact in float32
            _get(hv.url + f"input?x={x}&y={y}&p=1")
            pos, _, pressed = hv.input_source(N, N)(0.0)
            frames_served = hv.frames
            hv.close()
            reader.join(timeout=30)
            if reader.is_alive():
                raise AssertionError("views http: the stream client did not end with the server")
            if (status != 200 or headers["Content-Type"] != "image/png"
                    or png[:8] != b"\x89PNG\r\n\x1a\n"
                    or png[16:24] != N.to_bytes(4, "big") * 2):
                raise AssertionError(f"views http: /frame {status} {headers['Content-Type']}")
            # JPEG parts: the native server's stream (the fallback's is PNG)
            if not found["types"] or set(found["types"]) != {"image/jpeg"} \
                    or set(found["soi"]) != {"ffd8"}:
                raise AssertionError(f"views http: stream parts {found}")
            if pos != (x, N - 1.0 - y) or not pressed:
                raise AssertionError(f"views http: /input ({x}, {y}) mapped to {pos}, {pressed}")
            http_checks[mode] = {"stream_parts": len(found["types"]), "frames_pushed": frames_served,
                                 "frame_png_bytes": len(png), "input_grid_pos": pos}

            with FrameSink(str(tmp / mode), N, N) as fs:
                _, rates = loop(f"framesink {mode}", fs.push, piped)
                fs.flush()
                if fs.written + fs.dropped != n or fs.written < 1:
                    raise AssertionError(f"views framesink {mode}: {fs.written} written + "
                                         f"{fs.dropped} dropped of {n}")
                runs[f"framesink {mode}"] = {**rates, "written": fs.written,
                                             "dropped": fs.dropped}
            if len(list((tmp / mode).glob("frame_*.png"))) != runs[f"framesink {mode}"]["written"]:
                raise AssertionError(f"views framesink {mode}: files != written")

        # -- a TermInput drag steers the loop: the dye lies under it
        tin = TermInput(N, N, cols=80, rows=22)
        tin.feed(b"\x1b[<0;20;8M")
        app = FluidApp(cfg, input_source=tin.source(), fixed_dt=dt)
        app.run(max_frames=4)
        start = tin.pos
        tin.feed(b"\x1b[<32;26;8M")
        app.run(max_frames=8)
        end = tin.pos
        tin.feed(b"\x1b[<0;26;8m")
        dye = app.state.dye.amax(dim=0)
        iy, ix = divmod(int(dye.argmax()), N)
        xs, ys = sorted((start[0], end[0])), sorted((start[1], end[1]))
        if not (dye.max() > 0.1 and xs[0] - 64 <= ix <= xs[1] + 64
                and ys[0] - 64 <= iy <= ys[1] + 64) or tin.pressed:
            raise AssertionError(f"views term input: the dye's peak at ({ix}, {iy}) is not "
                                 f"under the drag {start} -> {end}")
        drag = {"from": start, "to": end, "dye_peak_at": [ix, iy], "dye_max": dye.max().item()}

        # -- the CLI: a browser-like client presses, holds, then quits
        with socket.socket() as probe:
            probe.bind(("127.0.0.1", 0))
            port = probe.getsockname()[1]
        client = {}

        def browser():
            url = f"http://localhost:{port}/"
            t_end = time.perf_counter() + 120
            while time.perf_counter() < t_end:
                try:
                    client["page"] = _get(url)[2] == http_view.PAGE_HTML
                    break
                except OSError:
                    time.sleep(0.01)
            t_hold = time.perf_counter() + VIEW_PRESS_S
            while time.perf_counter() < t_hold:  # the page's ~30 Hz keepalive
                _get(url + f"input?x={N / 2}&y={N / 2}&p=1")
                time.sleep(0.03)
            _get(url + "input?x=0&y=0&p=0&q=1")
            client["quit_sent"] = True

        out = io.StringIO()
        reset_counts()
        th = threading.Thread(target=browser, daemon=True)
        th.start()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli.main(["--grid", str(N), "--pressure-iters", "40", "--max-displacement", "31",
                           "--backend", "cuda", "--view", "http", "--interactive",
                           "--http-port", str(port), "--steps", str(VIEW_CLI_CAP),
                           "--save-fields", str(tmp / "http.npz")])
        cli_http_s = time.perf_counter() - t0
        th.join(timeout=30)
        counts = read_counts()
        text = out.getvalue()
        steps = int(re.search(r"^Grid: \S+ +Steps: (\d+)$", text, flags=re.M).group(1))
        with np.load(tmp / "http.npz") as d:
            dye_max = float(np.abs(d["dye"]).max())
        if (rc != 0 or not client.get("quit_sent") or not client.get("page")
                or not 0 < steps < VIEW_CLI_CAP or dye_max <= 0
                or f"live view: http://localhost:{port}/" not in text):
            raise AssertionError(f"views cli http: rc {rc}, client {client}, {steps} frames, "
                                 f"dye max {dye_max}")
        want = {k: 0 for k in counts}
        want.update({"H1": steps + 1, "H2": steps + 1, "H3": steps + 1, "H4": steps + 1})
        if counts != want:
            raise AssertionError(f"views cli http: launches {counts} for {steps} frames "
                                 "and the warm-up step")
        cli_http = {"frames": steps, "seconds": cli_http_s, "dye_max": dye_max,
                    "report": _cli_report(text)[0]}

        # -- the CLI's terminal view records its session; its fields are the loop's
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = cli.main(["--grid", str(N), "--pressure-iters", "40", "--max-displacement", "31",
                           "--view", "term", "--impulse", "orbit", "--steps", str(n),
                           "--video", str(tmp / "view.avi"),
                           "--save-fields", str(tmp / "term.npz")])
        avi_frames, codec = _avi_frames(tmp / "view.avi")
        if rc != 0 or avi_frames != n:
            raise AssertionError(f"views cli term: rc {rc}, the AVI holds {avi_frames} frames")
        with np.load(tmp / "term.npz") as d:
            for k in ("u", "v", "dye", "pressure"):
                if not torch.equal(torch.from_numpy(d[k]).to(dev), getattr(loop_state, k)):
                    raise AssertionError(f"views cli term: {k} differs from FluidApp's")
        cli_term = {"frames": n, "video_codec": codec, "report": _cli_report(out.getvalue())[0]}

    # -- the render and the readback at N², by CUDA events and the host clock
    render_ms = statistics.median(cuda_times_ms(lambda: sim.render_fn(loop_state), iters=10))
    layout_ms = statistics.median(cuda_times_ms(lambda: Simulation.frame_layout(frame), iters=10))
    img = Simulation.frame_layout(frame)
    pinned = torch.empty(img.shape, dtype=img.dtype, pin_memory=True)
    copy_ms = statistics.median(cuda_times_ms(lambda: pinned.copy_(img, non_blocking=True),
                                              iters=10))

    def host_ms(fn, reps=5):
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            times.append(1e3 * (time.perf_counter() - t0))
        return statistics.median(times)

    readback = {
        "queue_and_wait_ms": host_ms(lambda: finish_readback(queue_readback(frame))),
        "device_layout_ms": layout_ms, "pinned_copy_ms": copy_ms,
        "frame_image_ms": host_ms(lambda: sim.frame_image(frame)),
        "old_cpu_copy_ms": host_ms(lambda: frame.cpu()),
        "old_host_gather_ms": host_ms(
            lambda: np.ascontiguousarray(np.moveaxis(frame.cpu().numpy(), 0, -1)[::-1]))}
    _json({"phase": "views", "grid": f"{N}x{N}", "frames": n, "runs": runs,
           "render_device_ms": render_ms, "readback": readback, "http": http_checks,
           "term_input_drag": drag, "cli_http": cli_http, "cli_term": cli_term,
           "seconds": time.perf_counter() - t_phase, "smi": smi})
    return expect


# phase 12, the sharded rollout at BASELINE.json config 5's size: 8192²,
# gpu parity, 100 pressure sweeps, a 4-shard rows mesh and a 2 x 2 mesh on
# the visible card(s) (round-robin), the orbit of the CLI's --impulse orbit
SH_N, SH_SHARDS, SH_STEPS, SH_FEW = 8192, 4, 20, 3
# the kernels' check windows: a rows shard of 8192² over 4 (first, middle
# and last: y0 = -d, interior, the physical bottom), a 2 x 2 shard, and a
# ragged one; (interior rows, cols, d, d_x, y0, x0, global extent)
SH_WINDOWS = {
    "rows first": (2048, 8192, 31, 0, -31, 0, 8192),
    "rows middle": (2048, 8192, 31, 0, 2048 - 31, 0, 8192),
    "rows last": (2048, 8192, 31, 0, 3 * 2048 - 31, 0, 8192),
    "2x2 corner": (4096, 4096, 31, 31, 4096 - 31, -31, 8192),
    "ragged": (135, 240, 7, 7, 100, 33, 400),
}


def sharded_phase(smi, gen, worst, reset_counts, read_counts, kernels, dev):
    """Phase 12: the sharded rollout (``parallel/``) on the card.

    H1/H8's window entry against its plain version on each window of
    SH_WINDOWS, both modes, driven and quiet flows, ``vel_stats`` given and
    absent; H4's solve from an iterate at 1, k, k + 1 and 2k + 1 sweeps; H3
    on a kk-padded shard in bursts shallower than kk (kept rows equal to the
    global sweeps at the seam).  Then gpu parity at 8192² with 100 pressure
    sweeps on a 4-shard rows mesh and a 2 x 2 mesh: a 20-step rollout with
    each shard's launches, the exchange pairs a step, one step against the
    sharded ``ref`` step on the card, the rollout against the one-device
    ``Simulation.run`` (its first step within rounding; the realized
    displacement printed, past which the meshes clamp taps), ms a step of
    both; the fast flags and the quality preset on the rows mesh against
    the same schedule on the plain versions; the CLI's ``--mesh 2d`` and
    ``--mesh rows`` runs, whose states equal the rollouts'; the dry run and
    the 2-D example.  Returns (the launches of the rollouts, a function
    giving the kernel rows)."""
    import contextlib
    import importlib.util
    import io

    from cudafluidsimulation_tpu_torch import FluidConfig, Simulation, cli
    from cudafluidsimulation_tpu_torch.entry import dryrun_multichip
    from cudafluidsimulation_tpu_torch.ops import (
        advect_cuda, advect_packed, fastdiffuse, fastdiffuse_cuda, jacobi_cuda, ref)
    from cudafluidsimulation_tpu_torch.parallel import mesh as pmesh
    from cudafluidsimulation_tpu_torch.parallel import shardmap2d, shardmap_step
    from cudafluidsimulation_tpu_torch.utils import impulse as timp
    from cudafluidsimulation_tpu_torch.utils.impulse import orbit_impulse, slice_step
    from cudafluidsimulation_tpu_torch.utils.timing import cuda_times_ms

    t_phase = time.perf_counter()
    dt, decay_rate = 1.0 / 60.0, 1.2

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    # -- the kernels against their plain versions ------------------------------
    cells = {}
    for label, (hl, wl, d, d_x, y0, x0, ext) in SH_WINDOWS.items():
        win = ref.Window(y0=y0, h_phys=ext, d=d, x0=x0, w_phys=ext, d_x=d_x)
        fh, fw = ref.window_shape(win, hl, wl)
        # driven (taps past the halo, clamped at +-d) and quiet (H8's exact
        # branch) flows
        for flow, speed in (("driven", 900.0), ("quiet", 30.0)):
            pack = randn(5, fh, fw)
            uv = pack[:2].mul_(speed)
            pack[2:].abs_()
            u, v = uv[0, d:d + hl, d_x:d_x + wl], uv[1, d:d + hl, d_x:d_x + wl]
            bound = torch.stack([u.abs().max(), v.abs().max()])
            for packed, name in ((False, "H1 window"), (True, "H8 window")):
                for given in (True, False):
                    vs = bound if given else None
                    case = f"{label} {flow} vel_stats {'given' if given else 'absent'}"
                    got = advect_cuda.advect_window(uv, u, v, dt, decay_rate, "field", win,
                                                    vel_stats=vs, return_stats=True,
                                                    packed=packed)
                    exp = advect_packed.window_plain(uv, u, v, dt, decay_rate, "field", win,
                                                     vel_stats=vs, return_stats=True,
                                                     packed=packed)
                    _check(worst, name, f"field {case}", [("uv", got[0], exp[0]),
                                                         ("bound", got[1], exp[1])])
                    u2, v2 = got[0][0], got[0][1]
                    out = torch.full((3, hl, wl), float("nan"), device=dev)
                    gd = advect_cuda.advect_window(pack[2:], u2, v2, dt, decay_rate, "dye",
                                                   win, vel_stats=got[1] if given else None,
                                                   packed=packed, out=out)
                    ed = advect_packed.window_plain(pack[2:], u2, v2, dt, decay_rate, "dye",
                                                    win, vel_stats=got[1] if given else None,
                                                    packed=packed)
                    _check(worst, name, f"dye {case}", [("dye", gd, ed)])
        cells[label] = (hl, wl)
    hs, ws = 2048 + 2 * 9, SH_N  # a rows shard with a burst's halo (k + 1)
    k = jacobi_cuda.DEPTH
    div, p0 = randn(hs, ws), randn(hs, ws)
    for iters in (1, k, k + 1, 2 * k + 1):
        _check(worst, "H4 solve init", f"{hs}x{ws} {iters} sweeps", [
            ("p", jacobi_cuda.pressure_solve(div, iters, init=p0),
             ref.pressure_solve(div, iters, init=p0))])
    g = randn(5, 4096, 2048)
    kk = 8
    rows = torch.arange(2048 - kk, 4096 + kk, device=dev)  # shard 1 of 2 and its halo
    fp = g[:, rows.clamp(max=4095)].contiguous()
    fp[:, -kk:] = g[:, 4096 - kk:].flip(1)  # the physical top: the mirror
    plan = jacobi_cuda.plan_bursts(fp.shape[1], fp.shape[2], kk, "diffuse", depth=3)
    exp = ref.diffuse_multi(g, dt, [0.8] * 5, kk)[:, 2048:]
    got = jacobi_cuda._diffuse(fp, dt, [0.8] * 5, kk, plan=plan)
    _check(worst, "H3 sharded", f"padded shard {tuple(fp.shape)} bursts {plan.depths}",
           [("padded", got, ref.diffuse_multi(fp, dt, [0.8] * 5, kk))])
    seam = (got[:, kk:kk + 1024] - exp[:, :1024]).abs().max().item()
    if seam != 0.0:
        raise AssertionError(f"H3 sharded: the kept rows by the seam differ by {seam}")
    del g, fp, got, exp, div, p0

    # -- the full-size paths ----------------------------------------------------
    cfg = FluidConfig.gpu_reference(nx=SH_N, ny=SH_N, pressure_iters=100, backend="cuda")
    rcfg = FluidConfig.gpu_reference(nx=SH_N, ny=SH_N, pressure_iters=100, backend="ref")
    imp = orbit_impulse(SH_STEPS, cfg.dt, center=(SH_N / 2, SH_N / 2), radius=SH_N / 8,
                        omega=3.0)
    devices = pmesh.place(SH_SHARDS)
    meshes = {"rows": pmesh.make_mesh(SH_SHARDS, devices=devices),
              "2x2": pmesh.make_mesh2d(2, 2, devices=devices)}
    builders = {"rows": (shardmap_step.make_shardmap_step, shardmap_step.make_shardmap_rollout),
                "2x2": (shardmap2d.make_shardmap2d_step, shardmap2d.make_shardmap2d_rollout)}
    sim = Simulation(cfg)
    one, disp = sim.run_displacement(sim.init(), imp)
    first = sim.step(sim.init(), slice_step(imp, 0))
    torch.cuda.synchronize()
    single_ms = statistics.median(cuda_times_ms(lambda: sim.run(sim.init(), imp), iters=2))
    launches, finals, report = {}, {}, {}
    for kind, mesh in meshes.items():
        make_step, make_run = builders[kind]
        run = make_run(cfg, mesh)
        state0 = pmesh.shard_state(sim.init(), mesh)
        run(state0, imp)  # warm: each shard's first calls
        reset_counts()
        final = run(state0, imp)
        torch.cuda.synchronize()
        launches[kind] = {k: c for k, c in read_counts().items() if c}
        by_shard = {k: dict(kern.by_shard) for k, (kern, _, _) in kernels.items()
                    if kern.by_shard}
        for k in ("H1 window", "H3", "H4 solve"):
            if sorted(by_shard.get(k, {})) != list(range(mesh.size)):
                raise AssertionError(f"{kind}: {k} launched by shards {by_shard.get(k)}")
        pairs = run.counts[0]["exchanges"] / SH_STEPS
        whole = pmesh.gather_state(final)
        _check_state(f"sharded {kind}", whole)
        step = make_step(cfg, mesh)
        rstep = make_step(rcfg, mesh)
        x = slice_step(imp, SH_STEPS - 1)
        got = pmesh.gather_state(step(final, x))
        exp = pmesh.gather_state(rstep(final, x))
        vs_ref = {n: _max_err(getattr(got, n), getattr(exp, n))[1] for n in STATE_FIELDS}
        if not max(vs_ref.values()) <= STEP_RTOL:
            raise AssertionError(f"{kind}: one sharded step, cuda vs ref: {vs_ref}")
        first_sh = pmesh.gather_state(step(state0, slice_step(imp, 0)))
        vs_one_first = {n: _max_err(getattr(first_sh, n), getattr(first, n))[1]
                        for n in STATE_FIELDS}
        if not max(vs_one_first.values()) <= STEP_RTOL:
            raise AssertionError(f"{kind}: first step against one device: {vs_one_first}")
        vs_one = {n: _max_err(getattr(whole, n), getattr(one, n))[1] for n in STATE_FIELDS}
        ms = statistics.median(cuda_times_ms(lambda: run(state0, imp), iters=2)) / SH_STEPS
        # where one step's device time goes (one step from the final state)
        ops = {}
        for name, us in _device_trace(lambda: step(final, x)):
            key = name.replace("(anonymous namespace)::", "").replace("void ", "")
            key = key.split("(")[0].split("<")[0][:48]
            ops[key] = ops.get(key, 0.0) + us / 1e3
        finals[kind] = whole
        report[kind] = {"launches": launches[kind], "launches_by_shard": by_shard,
                        "exchange_pairs_per_step": pairs,
                        "bytes_per_step_per_shard": run.counts[0]["bytes"] / SH_STEPS,
                        "step_vs_ref_max_rel_err": vs_ref,
                        "first_step_vs_one_device_max_rel_err": vs_one_first,
                        "rollout_vs_one_device_max_rel_diff": vs_one,
                        "ms_per_step": ms,
                        "one_step_device_ms": sum(ops.values()),
                        "one_step_device_ops_ms": dict(sorted(ops.items(), key=lambda kv: -kv[1]))}
        del final, got, exp, first_sh
    d = cfg.max_displacement
    _json({"phase": "sharded", "grid": f"{SH_N}x{SH_N}", "pressure_iters": 100,
           "steps": SH_STEPS, "shards": SH_SHARDS, "devices": [str(x) for x in devices],
           "meshes": report, "one_device_ms_per_step": single_ms / SH_STEPS,
           "realized_max_displacement": disp, "max_displacement": d,
           "rollouts_compared": ("within rounding: the taps never reached past the halo"
                                 if max(disp) <= d else
                                 "information: the flow outran the halo, where the meshes "
                                 "clamp taps and one device does not"),
           "tol_rollout_when_within_halo": 1e-3, "smi": smi})
    if max(disp) <= d:
        for kind in meshes:
            if not max(report[kind]["rollout_vs_one_device_max_rel_diff"].values()) <= 1e-3:
                raise AssertionError(f"{kind}: the rollout differs from one device within "
                                     "the halo")

    # the fast flags and the quality preset on the rows mesh: a few steps,
    # then one driven step against the same schedule on the plain versions
    # on the card
    extra = {}
    few = orbit_impulse(SH_FEW + 1, cfg.dt, center=(SH_N / 2, SH_N / 2), radius=SH_N / 8,
                        omega=3.0)
    for what, c in (("fast", FluidConfig.gpu_reference(nx=SH_N, ny=SH_N, pressure_iters=100,
                                                        backend="cuda", **FAST)),
                    ("quality", FluidConfig.quality(nx=SH_N, ny=SH_N, backend="cuda"))):
        mesh = meshes["rows"]
        run = shardmap_step.make_shardmap_rollout(c, mesh)
        step = shardmap_step.make_shardmap_step(c, mesh)
        plain = shardmap_step.make_shardmap_step(c, mesh, kernels=shardmap_step.PLAIN)
        state0 = pmesh.shard_state(Simulation(c).init(), mesh)
        reset_counts()
        reached = run(state0, timp.Impulse(*(f[:SH_FEW] for f in few)))
        torch.cuda.synchronize()
        counts = {k: n for k, n in read_counts().items() if n}
        x = slice_step(few, SH_FEW)
        a, b = (pmesh.gather_state(fn(reached, x)) for fn in (step, plain))
        err = {n: _max_err(getattr(a, n), getattr(b, n))[1] for n in STATE_FIELDS}
        need = ("H8 window", "H7") if what == "fast" else ("H1 window", "H3")
        if not all(counts.get(k, 0) > 0 for k in need):
            raise AssertionError(f"sharded {what}: launches {counts}")
        extra[what] = {"launches": counts, "steps": SH_FEW,
                       "step_vs_plain_max_rel_err": err}
        if not max(err.values()) <= STEP_RTOL:
            raise AssertionError(f"sharded {what}: one step against the plain versions {err}")
        if what == "fast":
            fast_launches = counts
        del a, b, state0, reached
    _json({"phase": "sharded_fast_quality", "grid": f"{SH_N}x{SH_N}", **extra,
           "tol": STEP_RTOL})

    # the CLI: its final state (kept from --save-fields) equals the rollout's
    cli_runs = {}
    saved = []
    write = cli._save_fields
    cli._save_fields = lambda path, st: saved.append(st)
    try:
        for kind, flag in (("2x2", "2d"), ("rows", "rows")):
            argv = ["--grid", str(SH_N), "--steps", str(SH_STEPS), "--pressure-iters", "100",
                    "--mesh", flag, "--mesh-devices", str(SH_SHARDS), "--report",
                    "--save-fields", "unused.npz"]
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = cli.main(argv)
            seconds = time.perf_counter() - t0
            text = buf.getvalue()
            if rc != 0 or "skipped with --mesh" not in text:
                raise AssertionError(f"cli --mesh {flag}: exit {rc}\n{text}")
            st = saved.pop()
            for n in STATE_FIELDS:
                if not torch.equal(getattr(st, n).to(dev), getattr(finals[kind], n)):
                    raise AssertionError(f"cli --mesh {flag}: {n} differs from the rollout")
            thr = re.search(r"Throughput: ([\d.]+) steps/s", text)
            cli_runs[flag] = {"seconds": seconds, "steps_per_s": float(thr.group(1)),
                              "mesh_lines": re.findall(r"^mesh: .*$", text, flags=re.M),
                              "warnings": re.findall(r"^warning: .*$", text, flags=re.M)}
    finally:
        cli._save_fields = write
    _json({"phase": "sharded_cli", "runs": cli_runs})

    dry = dryrun_multichip(SH_SHARDS)
    path = Path(__file__).resolve().parent / "examples" / "multichip_2d_torch.py"
    spec = importlib.util.spec_from_file_location("multichip_2d_torch", path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    with contextlib.redirect_stdout(io.StringIO()):
        ex = example.main()
    if not bool(torch.isfinite(ex.u).all()):
        raise AssertionError("example multichip_2d_torch: non-finite velocity")
    _json({"phase": "sharded_dryrun", "dryrun_multichip": dry,
           "seconds": time.perf_counter() - t_phase})

    # the rows' shapes: the rows mesh's shard views at 8192²
    hl = SH_N // SH_SHARDS
    win = ref.Window(y0=hl - 31, h_phys=SH_N, d=31)  # d of the rows' check: a middle shard
    dwin = ref.Window(y0=hl - 15, h_phys=SH_N, d=15)  # the path's d
    fp = torch.cat([torch.stack([finals["rows"].u, finals["rows"].v]),
                    finals["rows"].dye])[:, hl - 15:2 * hl + 15].contiguous()
    u, v = fp[0, 15:15 + hl], fp[1, 15:15 + hl]
    u2, v2 = advect_cuda.advect_window(fp[:2], u, v, dt, decay_rate, "field", dwin)
    u2, v2 = u2.contiguous(), v2.contiguous()
    st = torch.stack([u.abs().max(), v.abs().max()])
    sdiv = ref.divergence(finals["rows"].u, finals["rows"].v, True)[hl - 9:2 * hl + 9].contiguous()
    sp0 = finals["rows"].pressure[hl - 9:2 * hl + 9].contiguous()
    s5 = torch.cat([torch.stack([finals["rows"].u, finals["rows"].v]),
                    finals["rows"].dye])[:, hl - 8:2 * hl + 8].contiguous()
    sep = fastdiffuse.sharded_sep(FluidConfig.gpu_reference(
        nx=SH_N, ny=SH_N, backend="cuda", **FAST))
    rm = sep[1]
    s7 = torch.cat([torch.stack([finals["rows"].u, finals["rows"].v]),
                    finals["rows"].dye])[:, hl - rm:2 * hl + rm].contiguous()
    taps5, radii5 = fastdiffuse._design(FluidConfig.gpu_reference(
        nx=SH_N, ny=SH_N, backend="cuda", **FAST))[:2]
    del win
    cases = {
        "H1 window": (lambda: (advect_cuda.advect_window(fp[:2], u, v, dt, decay_rate, "field",
                                                         dwin, return_stats=True),
                               advect_cuda.advect_window(fp[2:], u2, v2, dt, decay_rate, "dye",
                                                         dwin)),
                      lambda: (ref.advect_window(fp[:2], u, v, dt, decay_rate, "field", dwin,
                                                 return_stats=True),
                               ref.advect_window(fp[2:], u2, v2, dt, decay_rate, "dye", dwin)),
                      [fp, u2, v2], hl * SH_N * 72, "rows"),
        "H8 window": (lambda: (advect_cuda.advect_window(fp[:2], u, v, dt, decay_rate, "field",
                                                         dwin, vel_stats=st, return_stats=True,
                                                         packed=True),
                               advect_cuda.advect_window(fp[2:], u2, v2, dt, decay_rate, "dye",
                                                         dwin, vel_stats=st, packed=True)),
                      lambda: (advect_packed.advect_window(fp[:2], u, v, dt, decay_rate,
                                                           "field", dwin, vel_stats=st,
                                                           return_stats=True),
                               advect_packed.advect_window(fp[2:], u2, v2, dt, decay_rate,
                                                           "dye", dwin, vel_stats=st)),
                      [fp, u2, v2, st], hl * SH_N * 82, "fast"),
        "H3 sharded": (lambda: jacobi_cuda.diffuse_multi(s5, dt, [0.8] * 5, 8),
                       lambda: ref.diffuse_multi(s5, dt, [0.8] * 5, 8),
                       [s5], s5[0].numel() * 5 * 6 * 8, "rows"),
        "H4 solve init": (lambda: jacobi_cuda.pressure_solve(sdiv, 8, init=sp0),
                          lambda: ref.pressure_solve(sdiv, 8, init=sp0),
                          [sdiv, sp0], sdiv.numel() * 5 * 8, "rows"),
        "H7 sharded": (lambda: fastdiffuse_cuda.sep_apply(s7, taps5, radii5),
                       lambda: fastdiffuse.sep_apply(s7, taps5, radii5),
                       [s7], s7[0].numel() * 5 * 2 * sum(2 * (2 * r + 1) for r in radii5),
                       "fast"),
    }
    path_launches = {"rows": {k: launches["rows"].get(k, 0) + launches["2x2"].get(k, 0)
                              for k in set(launches["rows"]) | set(launches["2x2"])},
                     "fast": fast_launches}
    source = {"H1 window": ("H1 window", "advect.cu", "advect_pallas.py:413"),
              "H8 window": ("H8 window", "advect.cu", "advect_pallas.py:195"),
              "H3 sharded": ("H3", "diffuse.cu", "jacobi_pallas.py:492"),
              "H4 solve init": ("H4 solve", "pressure.cu", "jacobi_pallas.py:681"),
              "H7 sharded": ("H7", "sepdiffuse.cu", "fastdiffuse.py:262")}
    worst_of = {"H1 window": "H1 window", "H8 window": "H8 window", "H3 sharded": "H3 sharded",
                "H4 solve init": "H4 solve init", "H7 sharded": "H7 sweeps"}

    def rows_fn(per_call):
        out = []
        for name, (kern_fn, plain_fn, inputs, ops, path) in cases.items():
            counter, src, replaces = source[name]
            nbytes = _nbytes(inputs) + _nbytes(kern_fn())
            bytes_ms, ops_ms = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / F32_OPS_PER_S
            p1 = per_call(plain_fn, iters=2, warmup=1)
            k1 = per_call(kern_fn, iters=3, warmup=1)
            k2 = per_call(kern_fn, iters=3, warmup=0)
            p2 = per_call(plain_fn, iters=2, warmup=0)
            out.append({
                "name": name, "route": "cuda",
                "source": f"cudafluidsimulation_tpu_torch/csrc/{src}",
                "replaces": f"cudafluidsimulation_tpu/ops/{replaces}",
                "launches": path_launches[path].get(counter, 0),
                "path": f"sharded {path} 8192²",
                "max_abs_err": worst[worst_of[name]],
                "ms": statistics.median(k1 + k2), "device_ms": _device_ms(kern_fn),
                "plain_ms": statistics.median(p1 + p2),
                "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "bytes": nbytes, "operations": ops, "library_ms": None})
        return out

    return launches, rows_fn


# phase 13, sharded ensembles (``parallel/sharded.py``'s (ens, x) mesh):
# (a) BASELINE.json config 4, 64 x 512² gpu parity with 40 pressure sweeps
# over 4 ens groups on the card; (b) config 5's width, 2 x 8192² with 100
# sweeps on (ens 2, x 2); (c) the fast and quality presets on (2, 2) at 2048²
SE_GROUPS, SE_BIG_B, SE_BIG_STEPS, SE_PRESET_N = 4, 2, 20, 2048
# the unbounded window's check views: (grid rows, cols, interior rows, y_in)
SE_WINDOWS = {
    "8192² half 0": (8192, 8192, 4096, 0),
    "8192² half 1": (8192, 8192, 4096, 4096),
    "2048² half 0": (2048, 2048, 1024, 0),
    "2048² half 1": (2048, 2048, 1024, 1024),
    "ragged middle": (400, 240, 135, 100),
}


def sharded_ensemble_phase(smi, gen, worst, reset_counts, read_counts, kernels, dev):
    """Phase 13: the (ens, x) mesh (``parallel.sharded``) on the card.

    H1/H8's rows-unbounded window against its plain version (first and
    second half of 8192² and of 2048², a ragged middle; both modes, driven
    and quiet flows, ``vel_stats`` given and absent).  (a) 64 x 512² gpu
    parity, 40 pressure sweeps, each member's orbit jittered by up to 32
    cells, on an (ens 4, x 1) mesh whose groups share the card: 200 steps
    bit-equal to ``make_ensemble_run``'s 64-member run, each group's
    launches of batched H1-H4, member-steps/s of both; over the last
    ENS_WINDOW steps the host's time to the call's return and the device's
    busy time a step (``torch.profiler``).  (b) 2 x 8192², 100 sweeps, on (2, 2):
    20 one-device orbit steps per member, then one sharded step within 1e-5
    of scale of each member's ``Simulation.step``, its realized
    displacement past ``max_displacement``; then 20 sharded steps, their
    distance from one device's (information), ms a step beside the rows
    mesh's.  (c) the fast and quality presets, 3 steps on (2, 2) at 2048²,
    then one step against the same mesh's plain schedule.  Returns a
    function giving the unbounded window's kernel rows."""
    import numpy as np

    from cudafluidsimulation_tpu_torch import FluidConfig, Simulation
    from cudafluidsimulation_tpu_torch.models.ensemble import (
        batched_impulse, batched_state, make_ensemble_run)
    from cudafluidsimulation_tpu_torch.ops import advect_cuda, advect_packed, ref
    from cudafluidsimulation_tpu_torch.parallel import mesh as pmesh
    from cudafluidsimulation_tpu_torch.parallel import sharded, shardmap_step
    from cudafluidsimulation_tpu_torch.utils.impulse import Impulse, orbit_impulse
    from cudafluidsimulation_tpu_torch.utils.timing import cuda_times_ms

    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 13)
    dt, decay_rate = 1.0 / 60.0, 1.2

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    def by_shard(names, mesh):
        return {k: {i: kernels[k][0].by_shard.get(i, 0) for i in range(mesh.size)}
                for k in names}

    # -- H1/H8's rows-unbounded window against its plain version ----------------
    for label, (hg, wg, hl, y_in) in SE_WINDOWS.items():
        win = ref.Window(y0=0, h_phys=hg, d=0, y_in=y_in)
        for flow, speed in (("driven", 900.0), ("quiet", 30.0)):
            pack = randn(5, hg, wg)
            uv = pack[:2].mul_(speed)
            pack[2:].abs_()
            u, v = uv[0, y_in:y_in + hl], uv[1, y_in:y_in + hl]
            bound = torch.stack([uv[0].abs().max(), uv[1].abs().max()])
            for packed, name in ((False, "H1 window unbounded"), (True, "H8 window unbounded")):
                for given in (True, False):
                    vs = bound if given else None
                    case = f"{label} {flow} vel_stats {'given' if given else 'absent'}"
                    got = advect_cuda.advect_window(uv, u, v, dt, decay_rate, "field", win,
                                                    vel_stats=vs, return_stats=True,
                                                    packed=packed)
                    exp = advect_packed.window_plain(uv, u, v, dt, decay_rate, "field", win,
                                                     vel_stats=vs, return_stats=True,
                                                     packed=packed)
                    _check(worst, name, f"field {case}", [("uv", got[0], exp[0]),
                                                         ("bound", got[1], exp[1])])
                    u2, v2 = got[0][0], got[0][1]
                    gd = advect_cuda.advect_window(pack[2:], u2, v2, dt, decay_rate, "dye", win,
                                                   vel_stats=vs, packed=packed)
                    ed = advect_packed.window_plain(pack[2:], u2, v2, dt, decay_rate, "dye",
                                                    win, vel_stats=vs, packed=packed)
                    _check(worst, name, f"dye {case}", [("dye", gd, ed)])
            del pack, uv

    # -- (a) 64 x 512² over 4 ens groups, against the one-device ensemble ------------
    cfg = FluidConfig.gpu_reference(nx=ENS_N, ny=ENS_N, pressure_iters=40, backend="cuda")
    jitter = rng.uniform(-ENS_JITTER, ENS_JITTER, (ENS_B, 2)).astype(np.float32)
    c = ENS_N / 2
    bimp = batched_impulse(orbit_impulse(ENS_STEPS, cfg.dt, center=(c, c), radius=64,
                                         omega=3.0), ENS_B, jitter_pos=jitter)
    mesh_a = sharded.make_mesh(SE_GROUPS, ens=SE_GROUPS)
    run_a = sharded.sharded_rollout(cfg, mesh_a, batched=True)
    ens_run = make_ensemble_run(cfg)
    start = batched_state(cfg, ENS_B)
    state_a = sharded.shard_state(start, mesh_a, batched=True)
    batched_keys = ("H1 batched", "H2 batched", "H3 batched", "H4 batched")
    reset_counts()
    got = pmesh.gather_state(run_a(state_a, bimp))
    torch.cuda.synchronize()
    launches_a = {k: n for k, n in read_counts().items() if n}
    groups = by_shard(batched_keys, mesh_a)
    for k, per in groups.items():
        if min(per.values()) < 1:
            raise AssertionError(f"ens groups: {k} launched by groups {per}")
    single = [k for k in ("H1", "H2", "H3", "H4") if launches_a.get(k)]
    if single:
        raise AssertionError(f"ens groups launched the single {single}: a loop over members")
    exp = ens_run(start, bimp)
    torch.cuda.synchronize()
    for name in STATE_FIELDS + ("t", "press_time", "time_since_press", "mouse", "step"):
        if not torch.equal(getattr(got, name).cpu(), getattr(exp, name).cpu()):
            raise AssertionError(f"ens groups: {name} differs from the 64-member run")
    _check_state("ens groups", got)
    # where a step's time goes, over the last ENS_WINDOW steps from the
    # state the rollout reached (the step's work does not depend on it)
    end_a = sharded.shard_state(got, mesh_a, batched=True)
    tail = Impulse(*(f[:, ENS_STEPS - ENS_WINDOW:] for f in bimp))
    del got, exp
    mesh_ms = statistics.median(cuda_times_ms(lambda: run_a(state_a, bimp), iters=2))
    one_ms = statistics.median(cuda_times_ms(lambda: ens_run(start, bimp), iters=2))
    host_s = []

    def tail_run():
        t_0 = time.perf_counter()
        run_a(end_a, tail)
        host_s.append(time.perf_counter() - t_0)

    tail_ms = statistics.median(cuda_times_ms(tail_run, iters=3)) / ENS_WINDOW
    host_ms = statistics.median(host_s[1:]) / ENS_WINDOW * 1e3  # [0]: the warm-up
    busy_ms = _device_ms(lambda: run_a(end_a, tail), calls=1) / ENS_WINDOW
    del end_a
    member_steps = ENS_B * ENS_STEPS
    report_a = {"members": ENS_B, "grid": f"{ENS_N}x{ENS_N}", "steps": ENS_STEPS,
                "mesh": dict(mesh_a.shape), "devices": [str(d) for d in mesh_a.devices],
                "bit_equal_to_one_device_ensemble": True,
                "launches_by_group": groups,
                "member_steps_per_s": member_steps / (mesh_ms / 1e3),
                "one_device_member_steps_per_s": member_steps / (one_ms / 1e3),
                "ms_per_step": mesh_ms / ENS_STEPS, "one_device_ms_per_step": one_ms / ENS_STEPS,
                "window_steps": f"{ENS_STEPS - ENS_WINDOW}-{ENS_STEPS}",
                "window_ms_per_step": tail_ms, "host_ms_per_step": host_ms,
                "device_busy_ms_per_step": busy_ms,
                "device_idle_share": 1.0 - busy_ms / tail_ms,
                "smi": smi}
    _json({"phase": "sharded_ensembles_groups", **report_a})
    del state_a, start

    # -- (b) 2 x 8192² on (ens 2, x 2) -----------------------------------------------
    big = FluidConfig.gpu_reference(nx=SH_N, ny=SH_N, pressure_iters=100, backend="cuda")
    b = SE_BIG_B
    bjit = rng.uniform(-ENS_JITTER, ENS_JITTER, (b, 2)).astype(np.float32)
    orbit = orbit_impulse(2 * SE_BIG_STEPS + 1, big.dt, center=(SH_N / 2, SH_N / 2),
                          radius=SH_N / 8, omega=3.0)
    bstream = batched_impulse(orbit, b, jitter_pos=bjit)

    def window(stream, lo, hi):
        return Impulse(*(f[:, lo:hi] for f in stream))

    def member_stream(stream, i):
        return Impulse(*(f[i] for f in stream))

    sim = Simulation(big)
    # a driven state: 20 one-device orbit steps per member
    reached = [sim.run(sim.init(), member_stream(window(bstream, 0, SE_BIG_STEPS), i))
               for i in range(b)]
    reached = type(reached[0])(*(torch.stack(fs) for fs in zip(*reached)))
    disp = (reached.vel_stats.amax(dim=0) * big.dt).tolist()
    if not max(disp) > big.max_displacement:
        raise AssertionError(f"(2, 2): realized displacement {disp} within max_displacement="
                             f"{big.max_displacement}")
    mesh_b = sharded.make_mesh(4, ens=2)
    step_b = sharded.make_sharded_step(big, mesh_b, batched=True)
    run_b = sharded.sharded_rollout(big, mesh_b, batched=True)
    sh = sharded.shard_state(reached, mesh_b, batched=True)
    x = Impulse(*(f[:, SE_BIG_STEPS] for f in bstream))
    one = pmesh.gather_state(step_b(sh, x))
    vs_one = {}
    for i in range(b):
        exp_i = sim.step(type(reached)(*(f[i] for f in reached)), member_stream(x, i))
        for n in STATE_FIELDS:
            vs_one[f"member {i} {n}"] = _max_err(getattr(one, n)[i], getattr(exp_i, n))[1]
        del exp_i
    if not max(vs_one.values()) <= STEP_RTOL:
        raise AssertionError(f"(2, 2): one step against one device {vs_one}")
    del one
    rest = window(bstream, SE_BIG_STEPS, 2 * SE_BIG_STEPS)
    reset_counts()
    final = pmesh.gather_state(run_b(sh, rest))
    torch.cuda.synchronize()
    launches_b = {k: n for k, n in read_counts().items() if n}
    shards_b = by_shard(("H1 window", "H3", "H4 solve"), mesh_b)
    for k, per in shards_b.items():
        if min(per.values()) < 1:
            raise AssertionError(f"(2, 2): {k} launched by shards {per}")
    _check_state("(2, 2) rollout", final)
    vs_rollout = {}
    for i in range(b):
        exp_i = sim.run(type(reached)(*(f[i] for f in reached)), member_stream(rest, i))
        vs_rollout[f"member {i}"] = {n: _max_err(getattr(final, n)[i], getattr(exp_i, n))[1]
                                     for n in STATE_FIELDS}
        del exp_i
    del final
    ms_b = statistics.median(cuda_times_ms(lambda: run_b(sh, rest), iters=2)) / SE_BIG_STEPS
    counts_b = run_b.counts[0]
    rows_mesh = pmesh.make_mesh(SH_SHARDS, devices=pmesh.place(SH_SHARDS))
    rows_run = shardmap_step.make_shardmap_rollout(big, rows_mesh)
    rows_state = pmesh.shard_state(type(reached)(*(f[0] for f in reached)), rows_mesh)
    rows_ms = statistics.median(cuda_times_ms(
        lambda: rows_run(rows_state, member_stream(rest, 0)), iters=2)) / SE_BIG_STEPS
    del rows_state
    _json({"phase": "sharded_ensembles_8192", "members": b, "grid": f"{SH_N}x{SH_N}",
           "pressure_iters": 100, "mesh": dict(mesh_b.shape),
           "devices": [str(d) for d in mesh_b.devices],
           "realized_displacement_at_step": disp, "max_displacement": big.max_displacement,
           "step_vs_one_device_max_rel_err": vs_one, "tol": STEP_RTOL,
           "rollout_vs_one_device_max_rel_diff": vs_rollout,
           "rollout_compared": "information: the flow is chaotic",
           "launches": launches_b, "launches_by_shard": shards_b,
           "collectives_per_shard": counts_b, "steps": SE_BIG_STEPS,
           "ms_per_step": ms_b, "ms_per_member_step": ms_b / b,
           "rows_mesh_ms_per_step_one_member": rows_ms, "smi": smi})

    # -- (c) the fast and quality presets on (2, 2) at 2048² ----------------------------
    n2 = SE_PRESET_N
    preset_report, fast_launches, fast_reached = {}, {}, None
    for what, pc in (("fast", FluidConfig.gpu_reference(nx=n2, ny=n2, pressure_iters=40,
                                                         backend="cuda", **FAST)),
                     ("quality", FluidConfig.quality(nx=n2, ny=n2, backend="cuda"))):
        mesh_c = sharded.make_mesh(4, ens=2)
        pstream = batched_impulse(orbit_impulse(SH_FEW + 1, pc.dt, center=(n2 / 2, n2 / 2),
                                                radius=n2 / 8, omega=3.0), 2,
                                  jitter_pos=bjit)
        prun = sharded.sharded_rollout(pc, mesh_c, batched=True)
        reset_counts()
        preached = prun(sharded.shard_state(batched_state(pc, 2), mesh_c, batched=True),
                        window(pstream, 0, SH_FEW))
        torch.cuda.synchronize()
        counts = {k: n for k, n in read_counts().items() if n}
        xc = Impulse(*(f[:, SH_FEW] for f in pstream))
        kstep = sharded.make_sharded_step(pc, mesh_c, batched=True)
        plain = sharded.make_sharded_step(pc, mesh_c, batched=True,
                                          kernels=shardmap_step.PLAIN)
        a_, b_ = (pmesh.gather_state(fn(preached, xc)) for fn in (kstep, plain))
        err = {n: _max_err(getattr(a_, n), getattr(b_, n))[1] for n in STATE_FIELDS}
        need = ("H8 window", "H7") if what == "fast" else ("H1 window", "H3")
        if not all(counts.get(k, 0) > 0 for k in need):
            raise AssertionError(f"(2, 2) {what}: launches {counts}")
        if not max(err.values()) <= STEP_RTOL:
            raise AssertionError(f"(2, 2) {what}: one step against the plain schedule {err}")
        preset_report[what] = {"launches": counts, "steps": SH_FEW,
                               "step_vs_plain_max_rel_err": err,
                               "bit_equal": all(torch.equal(getattr(a_, n), getattr(b_, n))
                                                for n in STATE_FIELDS),
                               "stopping_tests_per_shard": [c_["psum"] for c_ in prun.counts]}
        if what == "fast":
            fast_launches, fast_reached = counts, pmesh.gather_state(preached)
        del a_, b_, preached
    _json({"phase": "sharded_ensembles_presets", "grid": f"{n2}x{n2}", "mesh": {"ens": 2, "x": 2},
           **preset_report, "tol": STEP_RTOL,
           "seconds": time.perf_counter() - t_phase, "smi": smi})

    # the kernel rows: the unbounded window at shard 1 of x = 2 (the second
    # half of the grid) on member 0 of the state its path reached: H1 on
    # (b)'s 8192², H8 on (c)'s fast 2048²
    def window_case(reached_, n, packed):
        hl = lo = n // 2
        u0, v0 = reached_.u[0], reached_.v[0]
        fp = torch.cat([torch.stack([u0, v0]), reached_.dye[0]]).contiguous()
        win = ref.Window(y0=0, h_phys=n, d=0, y_in=lo)
        u, v = fp[0, lo:lo + hl], fp[1, lo:lo + hl]
        st = reached_.vel_stats[0]
        kw = dict(vel_stats=st) if packed else {}
        u2, v2 = advect_cuda.advect_window(fp[:2], u, v, dt, decay_rate, "field", win,
                                           packed=packed, **kw)
        u2, v2 = u2.contiguous(), v2.contiguous()
        # the rows the taps can reach: the interior and the realized displacement
        reach = int(np.ceil(float(st.max()) * dt)) + 1
        seen = fp[:, max(0, lo - reach):min(n, lo + hl + reach)]
        plain = advect_packed.advect_window if packed else ref.advect_window

        def kern_fn():
            return (advect_cuda.advect_window(fp[:2], u, v, dt, decay_rate, "field", win,
                                              return_stats=True, packed=packed, **kw),
                    advect_cuda.advect_window(fp[2:], u2, v2, dt, decay_rate, "dye", win,
                                              packed=packed, **kw))

        def plain_fn():
            return (plain(fp[:2], u, v, dt, decay_rate, "field", win, return_stats=True, **kw),
                    plain(fp[2:], u2, v2, dt, decay_rate, "dye", win, **kw))

        inputs = [seen, u2, v2] + ([st] if packed else [])
        return kern_fn, plain_fn, inputs, hl * n * (82 if packed else 72)

    del sh
    cases = {
        "H1 window unbounded": (*window_case(reached, SH_N, False), launches_b,
                                f"sharded ensembles (2, 2) {SH_N}²"),
        "H8 window unbounded": (*window_case(fast_reached, n2, True), fast_launches,
                                f"sharded ensembles (2, 2) fast {n2}²"),
    }
    del reached, fast_reached
    counter = {"H1 window unbounded": "H1 window", "H8 window unbounded": "H8 window"}

    def rows_fn(per_call):
        out = []
        for name, (kern_fn, plain_fn, inputs, ops, path_launches, path) in cases.items():
            nbytes = _nbytes(inputs) + _nbytes(kern_fn())
            bytes_ms, ops_ms = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / F32_OPS_PER_S
            p1 = per_call(plain_fn, iters=2, warmup=1)
            k1 = per_call(kern_fn, iters=3, warmup=1)
            k2 = per_call(kern_fn, iters=3, warmup=0)
            p2 = per_call(plain_fn, iters=2, warmup=0)
            out.append({
                "name": name, "route": "cuda",
                "source": "cudafluidsimulation_tpu_torch/csrc/advect.cu",
                "replaces": "cudafluidsimulation_tpu/ops/advect_pallas.py:"
                            + ("413" if name.startswith("H1") else "195"),
                "launches": path_launches.get(counter[name], 0),
                "path": path,
                "max_abs_err": worst[name],
                "ms": statistics.median(k1 + k2), "device_ms": _device_ms(kern_fn),
                "plain_ms": statistics.median(p1 + p2),
                "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "bytes": nbytes, "operations": ops, "library_ms": None})
        return out

    return rows_fn


def entry_phase(reset_counts, read_counts, dev):
    """The port's ``entry()`` (one 512² parity step, bit-equal to
    ``Simulation.step``) and ``examples/headless_run_torch.py`` (30 frames
    through ``FrameSink`` and a checkpoint that loads) on the card."""
    import contextlib
    import importlib.util
    import io
    import tempfile

    from cudafluidsimulation_tpu_torch import FluidConfig, Simulation
    from cudafluidsimulation_tpu_torch.entry import entry
    from cudafluidsimulation_tpu_torch.utils.checkpoint import load_state

    step, (state, imp) = entry()
    if state.u.device.type != "cuda":
        raise AssertionError("entry: the state is not on the card")
    reset_counts()
    got = step(state, imp)
    torch.cuda.synchronize()
    counts = {k: c for k, c in read_counts().items() if c}
    exp = Simulation(FluidConfig.gpu_reference(nx=512, ny=512, pressure_iters=40)).step(state, imp)
    for k in STATE_FIELDS:
        if not torch.equal(getattr(got, k), getattr(exp, k)):
            raise AssertionError(f"entry: {k} differs from Simulation.step")
    if counts != {"H1": 1, "H2": 1, "H3": 1, "H4": 1}:
        raise AssertionError(f"entry: launches {counts}")

    path = Path(__file__).resolve().parent / "examples" / "headless_run_torch.py"
    spec = importlib.util.spec_from_file_location("headless_run_torch", path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_example_") as tmp:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            final = example.main(tmp)
        seconds = time.perf_counter() - t0
        pngs = list((Path(tmp) / "out_frames").glob("frame_*.png"))
        ck = load_state(str(Path(tmp) / "out_state.npz"), dev)
        if len(pngs) != 30 or int(ck.step) != 300 or not all(
                torch.equal(getattr(ck, k), getattr(final, k)) for k in STATE_FIELDS):
            raise AssertionError(f"example: {len(pngs)} frames, checkpoint step {int(ck.step)}")
    _json({"phase": "entry", "launches": counts, "example_frames": len(pngs),
           "example_seconds": seconds})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from cudafluidsimulation_tpu_torch import FluidConfig, Simulation
    from cudafluidsimulation_tpu_torch.ops import (
        _build, advect_cuda, advect_packed, backend, fastdiffuse, fastdiffuse_cuda,
        jacobi_cuda, multigrid, multigrid_cuda, ref)
    from cudafluidsimulation_tpu_torch.utils.impulse import (
        Impulse, no_impulse, orbit_impulse, slice_step)
    from cudafluidsimulation_tpu_torch.utils.timing import cuda_times_ms

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    jp = "jacobi_pallas.py"
    # name: (launch counter, source, the TPU kernel it replaces)
    kernels = {
        # H1 as the paths launch it (velocity and dye in one launch), and
        # its two passes apart (the decomposed report's)
        "H1": (advect_cuda.KERNEL, "advect.cu", "advect_pallas.py:413"),
        "H1 batched": (advect_cuda.BATCHED, "advect.cu", "advect_pallas.py:413"),
        "H1 velocity pass": (advect_cuda.VELOCITY_PASS, "advect.cu", "advect_pallas.py:413"),
        "H1 dye pass": (advect_cuda.DYE_PASS, "advect.cu", "advect_pallas.py:413"),
        "H1 batched velocity pass": (advect_cuda.VELOCITY_PASS_BATCHED, "advect.cu",
                                     "advect_pallas.py:413"),
        "H1 batched dye pass": (advect_cuda.DYE_PASS_BATCHED, "advect.cu",
                                "advect_pallas.py:413"),
        "H2 batched": (jacobi_cuda.VORTICITY_BATCHED, "vorticity.cu", f"{jp}:1411"),
        "H3 batched": (jacobi_cuda.DIFFUSE_BATCHED, "diffuse.cu", f"{jp}:492"),
        "H4 batched": (jacobi_cuda.PRESSURE_BATCHED, "pressure.cu", f"{jp}:1120"),
        "H2": (jacobi_cuda.VORTICITY, "vorticity.cu", f"{jp}:1411"),
        "H3": (jacobi_cuda.DIFFUSE, "diffuse.cu", f"{jp}:492"),
        "H4": (jacobi_cuda.PRESSURE, "pressure.cu", f"{jp}:1120"),
        "H4 solve": (jacobi_cuda.PRESSURE_SOLVE, "pressure.cu", f"{jp}:681"),
        "H5": (jacobi_cuda.STENCIL, "pressure.cu", f"{jp}:1619"),
        "H6 smooth_damped": (multigrid_cuda.SMOOTH, "multigrid.cu", f"{jp}:778"),
        "H6 smooth_res": (multigrid_cuda.SMOOTH_RES, "multigrid.cu", f"{jp}:1000"),
        "H6 first_smooth_res": (multigrid_cuda.FIRST, "multigrid.cu", f"{jp}:1041"),
        "H6 last_smooth_project": (multigrid_cuda.LAST, "multigrid.cu", f"{jp}:1069"),
        "H6 smooth_res_restrict": (multigrid_cuda.SMOOTH_RES_RESTRICT, "multigrid.cu",
                                   f"{jp}:1000"),
        "H6 first_smooth_res_restrict": (multigrid_cuda.FIRST_RESTRICT, "multigrid.cu",
                                         f"{jp}:1041"),
        "H6 prolong_smooth": (multigrid_cuda.PROLONG_SMOOTH, "multigrid.cu", f"{jp}:778"),
        "H6 prolong_smooth_project": (multigrid_cuda.PROLONG_SMOOTH_PROJECT, "multigrid.cu",
                                      f"{jp}:1069"),
        "H7": (fastdiffuse_cuda.SEP, "sepdiffuse.cu", "fastdiffuse.py:262"),
        "H8": (advect_cuda.PACKED, "advect.cu", "advect_pallas.py:195"),
        # the stopping test's mean of squares: jnp in the JAX package's
        # probed_tol_loop, a kernel here (a fixed order for every batch)
        "H6 mean_square": (multigrid_cuda.MEAN_SQUARE, "multigrid.cu", "multigrid.py:226"),
        # phase 9: batched H5-H8
        "H5 batched": (jacobi_cuda.STENCIL_BATCHED, "pressure.cu", f"{jp}:1619"),
        "H6 batched smooth_damped": (multigrid_cuda.SMOOTH_BATCHED, "multigrid.cu", f"{jp}:778"),
        "H6 batched smooth_res": (multigrid_cuda.SMOOTH_RES_BATCHED, "multigrid.cu",
                                  f"{jp}:1000"),
        "H6 batched first_smooth_res": (multigrid_cuda.FIRST_BATCHED, "multigrid.cu",
                                        f"{jp}:1041"),
        "H6 batched last_smooth_project": (multigrid_cuda.LAST_BATCHED, "multigrid.cu",
                                           f"{jp}:1069"),
        "H6 batched smooth_res_restrict": (multigrid_cuda.SMOOTH_RES_RESTRICT_BATCHED,
                                           "multigrid.cu", f"{jp}:1000"),
        "H6 batched first_smooth_res_restrict": (multigrid_cuda.FIRST_RESTRICT_BATCHED,
                                                 "multigrid.cu", f"{jp}:1041"),
        "H6 batched prolong_smooth": (multigrid_cuda.PROLONG_SMOOTH_BATCHED, "multigrid.cu",
                                      f"{jp}:778"),
        "H6 batched prolong_smooth_project": (multigrid_cuda.PROLONG_SMOOTH_PROJECT_BATCHED,
                                              "multigrid.cu", f"{jp}:1069"),
        "H6 batched mean_square": (multigrid_cuda.MEAN_SQUARE_BATCHED, "multigrid.cu",
                                   "multigrid.py:226"),
        "H7 batched": (fastdiffuse_cuda.SEP_BATCHED, "sepdiffuse.cu", "fastdiffuse.py:262"),
        "H8 batched": (advect_cuda.PACKED_BATCHED, "advect.cu", "advect_pallas.py:195"),
        # phase 12: the sharded rollout's window entries of H1 and H8
        "H1 window": (advect_cuda.WINDOW, "advect.cu", "advect_pallas.py:413"),
        "H8 window": (advect_cuda.PACKED_WINDOW, "advect.cu", "advect_pallas.py:195"),
    }
    row_names = {"H8": "H8 advect_packed"}

    def reset_counts():
        for kern, _, _ in kernels.values():
            kern.reset()

    def read_counts():
        return {k: kern.launches for k, (kern, _, _) in kernels.items()}

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
            if ("registers" in line or "spill" in line
                    or (name == "advect" and "Function properties" in line)):
                print(f"ptxas {name}: {line.strip()}", flush=True)
            if (name in ("vorticity", "diffuse", "pressure", "multigrid", "sepdiffuse")
                    and "spill" in line
                    and "0 bytes spill stores, 0 bytes spill loads" not in line):
                raise AssertionError(f"ptxas {name}: {line.strip()}")
    _json({"phase": "build", "seconds": build_s, "nvcc": _build.nvcc()})

    # -- 3. each kernel against its plain version ----------------------------
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    dt, decay_rate = 1.0 / 60.0, 1.2
    worst = {k: 0.0 for k in RTOL}
    coeffs, amps = [0.8] * 5, [-3.5, 2.25, 1.0, 0.5, 0.3]

    def _pack_out(what, call, exp, first):
        """``call(out=...)`` into channels first.. of a (5, H, W) pack of
        NaNs must equal ``exp`` (the fresh call's result) bit for bit and
        leave the pack's other channels alone."""
        exp = torch.stack(list(exp)) if isinstance(exp, tuple) else exp
        pack = torch.full((5,) + tuple(exp.shape[1:]), float("nan"), device=dev)
        view = pack[first:first + exp.shape[0]]
        got = call(view)
        got = torch.stack(list(got)) if isinstance(got, tuple) else got
        rest = torch.cat([pack[:first], pack[first + exp.shape[0]:]])
        if not (torch.equal(got, exp) and torch.equal(view, exp) and bool(rest.isnan().all())):
            raise AssertionError(f"{what}: out=pack[{first}:] differs from the fresh call")

    # H2 at every shape class, both variants, held to 0; into a fresh
    # tensor and into a pack; then with planes one float off 16-byte
    # alignment (the scalar path at any width)
    for h, w in VORT_SHAPES:
        tag = f"{h}x{w}"
        u, v = randn(h, w, scale=200.0), randn(h, w, scale=200.0)
        for variant, vort in (("gpu", 50.0), ("cpu", 0.35)):
            plain = getattr(ref, f"vorticity_confinement_{variant}")
            got = jacobi_cuda.vorticity_confinement(u, v, dt, vort, variant=variant)
            _check(worst, "H2", f"{variant} {tag}", zip("uv", got, plain(u, v, dt, vort)))
            _pack_out(f"H2 {variant} {tag}", lambda out: jacobi_cuda.vorticity_confinement(
                u, v, dt, vort, variant=variant, out=out), got, 0)
            if h * w > 1:
                buf = torch.empty(2 * h * w + 1, device=dev)[1:]
                uo, vo = buf[:h * w].view(h, w), buf[h * w:].view(h, w)
                uo.copy_(u)
                vo.copy_(v)
                _check(worst, "H2", f"{variant} unaligned {tag}", zip(
                    "uv", jacobi_cuda.vorticity_confinement(uo, vo, dt, vort, variant=variant),
                    plain(uo, vo, dt, vort)))
    del buf, uo, vo

    # H1 fused and its passes at every shape class of H2 (odd widths and
    # ragged blocks take the scalar path), from planes one float off 16
    # bytes too
    for h, w in VORT_SHAPES:
        tag = f"{h}x{w}"
        u, v = randn(h, w, scale=200.0), randn(h, w, scale=200.0)
        dye = torch.rand((3, h, w), generator=gen, device=dev)
        cases = [("aligned", u, v, dye)]
        if h * w > 1:
            buf = torch.empty(5 * h * w + 1, device=dev)[1:]
            cases.append(("unaligned", buf[:h * w].view(h, w).copy_(u),
                          buf[h * w:2 * h * w].view(h, w).copy_(v),
                          buf[2 * h * w:].view(3, h, w).copy_(dye)))
        for label, uu, vv, dd in cases:
            two = advect_cuda.advect_velocity(uu, vv, dt, decay_rate, return_stats=True)
            two_dye = advect_cuda.advect_dye(dd, two[0], two[1], dt, decay_rate)
            fused = advect_cuda.advect_both(uu, vv, dd, dt, decay_rate, return_stats=True)
            _check(worst, "H1 fused", f"two passes {label} {tag}", zip(
                ("u", "v", "dye", "stats"), fused, (two[0], two[1], two_dye, two[2])))
            _check_vel_max("H1", fused[3], fused[0], fused[1])
            exp = ref.advect_velocity(uu, vv, dt, decay_rate)
            _check(worst, "H1", f"fused {label} {tag}", zip(("u", "v", "dye"), fused[:3], (
                exp[0], exp[1], ref.advect_dye(dd, exp[0], exp[1], dt, decay_rate))))
    del buf, cases, two, two_dye, fused
    # a NaN velocity cell (its backtrace and every cell that taps it turn
    # NaN; the plain version cannot index a NaN backtrace): each bound is
    # the max of its own output, NaN
    u, v = randn(540, 960, scale=200.0), randn(540, 960, scale=200.0)
    u[100, 200] = float("nan")
    dye = torch.rand((3, 540, 960), generator=gen, device=dev)
    nan_bounds = {}
    for what, res in (
            ("H1", advect_cuda.advect_velocity(u, v, dt, decay_rate, return_stats=True)),
            ("H1 fused", advect_cuda.advect_both(u, v, dye, dt, decay_rate, return_stats=True)),
            ("H8", advect_cuda.advect_velocity(u, v, dt, decay_rate, vel_stats=ref.vel_max(u, v),
                                               return_stats=True, packed=True))):
        _check_vel_max(what, res[-1], res[0], res[1])
        if not bool(res[-1][0].isnan()):
            raise AssertionError(f"{what}: the bound of a NaN velocity is {res[-1].tolist()}")
        nan_bounds[what] = res[-1].tolist()
    _json({"phase": "advect_nan_bound", "grid": "540x960", "bounds": nan_bounds})

    for h, w in CHECK_SHAPES:
        tag = f"{h}x{w}"
        # velocities of ~200 cells/s (a few cells a step) with a tail that
        # backtraces off the domain, so edge taps extrapolate
        u, v = randn(h, w, scale=200.0), randn(h, w, scale=200.0)
        dye = torch.rand((3, h, w), generator=gen, device=dev)
        got = advect_cuda.advect_velocity(u, v, dt, decay_rate, return_stats=True)
        exp = ref.advect_velocity(u, v, dt, decay_rate, return_stats=True)
        _check(worst, "H1", f"velocity {tag}", zip("uv", got[:2], exp[:2]))
        _check_vel_max("H1", got[2], got[0], got[1])
        h1_dye = advect_cuda.advect_dye(dye, got[0], got[1], dt, decay_rate)
        _check(worst, "H1", f"dye {tag}", [(
            "dye", h1_dye, ref.advect_dye(dye, got[0], got[1], dt, decay_rate))])
        _pack_out(f"H1 dye {tag}", lambda out: advect_cuda.advect_dye(
            dye, got[0], got[1], dt, decay_rate, out=out), h1_dye, 2)
        # the step's call: velocity and dye in one launch, its two passes'
        # floats bit for bit, and the plain versions within RTOL
        fused = advect_cuda.advect_both(u, v, dye, dt, decay_rate, return_stats=True)
        _check(worst, "H1 fused", f"two passes {tag}", zip(
            ("u", "v", "dye", "stats"), fused, (got[0], got[1], h1_dye, got[2])))
        _check(worst, "H1", f"fused {tag}", zip(("u", "v", "dye"), fused[:3], (
            exp[0], exp[1], ref.advect_dye(dye, exp[0], exp[1], dt, decay_rate))))
        _pack_out(f"H1 fused dye {tag}", lambda out: advect_cuda.advect_both(
            u, v, dye, dt, decay_rate, out=out)[2], h1_dye, 2)
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
        div = ref.divergence(u, v, True)
        _check(worst, "H4 solve", f"40 sweeps {tag}", [(
            "p", jacobi_cuda.pressure_solve(div, 40), ref.pressure_solve(div, 40))])
        for half in (True, False):
            _check(worst, "H5", f"divergence half={half} {tag}", [(
                "div", jacobi_cuda.divergence(u, v, half), ref.divergence(u, v, half))])
        p = ref.pressure_solve(div, 40)
        got = jacobi_cuda.project(u, v, p, return_stats=True)
        exp = ref.project(u, v, p, return_stats=True)
        _check(worst, "H5", f"project {tag}", zip("uv", got[:2], exp[:2]))
        _check_bound("H5", got[2], got[0], got[1])

    # H6 at every level shape class: the 2048² fine level, the reference
    # grid, its odd-height coarse level and the 16x16 bottom
    for h, w in MG_SHAPES:
        tag = f"{h}x{w}"
        p, rhs = randn(h, w, scale=50.0), randn(h, w)
        u, v = randn(h, w, scale=200.0), randn(h, w, scale=200.0)
        for sweeps in (1, 2, 20):
            _check(worst, "H6", f"smooth_damped sweeps={sweeps} {tag}", [(
                "p", multigrid_cuda.smooth_damped(p, rhs, sweeps),
                multigrid.smooth_damped(p, rhs, sweeps))])
        for from_zero in (False, True):
            _check(worst, "H6", f"smooth_res from_zero={from_zero} {tag}", zip(
                ("p", "res"),
                multigrid_cuda.smooth_res(p, rhs, 2, from_zero=from_zero),
                multigrid.smooth_res(p, rhs, 2, from_zero=from_zero)))
        _check(worst, "H6", f"first_smooth_res {tag}", zip(
            ("p", "rhs", "res"), multigrid_cuda.first_smooth_res(u, v, 2, True),
            multigrid.first_smooth_res(u, v, 2, True)))
        got = multigrid_cuda.last_smooth_project(p, rhs, u, v, 2, return_stats=True)
        exp = multigrid.last_smooth_project(p, rhs, u, v, 2, return_stats=True)
        _check(worst, "H6", f"last_smooth_project {tag}", zip(("u", "v", "p", "stats"), got, exp))
        _check_bound("H6", got[3], got[0], got[1])
        _check(worst, "H6", f"smooth_damped zero plane {tag}", [(
            "p", multigrid_cuda.smooth_damped(None, rhs, 20), multigrid.smooth_damped(None, rhs, 20))])

    # H6's ends with the grid transfers, at each level pair; 9 sweeps make
    # two bursts at the larger grids
    for h, w in MG_PAIRS:
        tag = f"{h}x{w}"
        p, rhs = randn(h, w, scale=50.0), randn(h, w)
        u, v = randn(h, w, scale=200.0), randn(h, w, scale=200.0)
        e_c = randn(h // 2, w // 2, scale=5.0)
        for s in (1, 2, 9):
            case = f"sweeps={s} {tag}"
            _check(worst, "H6", f"smooth_res_restrict {case}", zip(
                ("p", "rhs_c", "res"), multigrid_cuda.smooth_res_restrict(p, rhs, s, return_res=True),
                multigrid.smooth_res_restrict(p, rhs, s, return_res=True)))
            _check(worst, "H6", f"smooth_res_restrict from_zero {case}", zip(
                ("p", "rhs_c"), multigrid_cuda.smooth_res_restrict(None, rhs, s, from_zero=True),
                multigrid.smooth_res_restrict(None, rhs, s, from_zero=True)))
            for half in (True, False):
                _check(worst, "H6", f"first_smooth_res_restrict half={half} {case}", zip(
                    ("p", "rhs", "res", "rhs_c"),
                    multigrid_cuda.first_smooth_res_restrict(u, v, s, half),
                    multigrid.first_smooth_res_restrict(u, v, s, half)))
            _check(worst, "H6", f"prolong_smooth {case}", [(
                "p", multigrid_cuda.prolong_smooth(p, e_c, rhs, s),
                multigrid.prolong_smooth(p, e_c, rhs, s))])
            got = multigrid_cuda.prolong_smooth_project(p, e_c, rhs, u, v, s, return_stats=True)
            exp = multigrid.prolong_smooth_project(p, e_c, rhs, u, v, s, return_stats=True)
            _check(worst, "H6", f"prolong_smooth_project {case}",
                   zip(("u", "v", "p", "stats"), got, exp))
            _check_bound("H6", got[3], got[0], got[1])
        rhs_c = randn(h // 2, w // 2)
        _check(worst, "H6", f"bottom smooth_damped zero plane {h // 2}x{w // 2}", [(
            "p", multigrid_cuda.smooth_damped(None, rhs_c, 20),
            multigrid.smooth_damped(None, rhs_c, 20))])
    del e_c, rhs_c

    # the variants' flags and the edge cases, at the reference GPU grid
    h, w = CHECK_SHAPES[1]
    u, v = randn(h, w, scale=200.0), randn(h, w, scale=200.0)
    dye = torch.rand((3, h, w), generator=gen, device=dev)
    fields = torch.cat([torch.stack([u, v]), dye])
    last = (w * 0.4, h * 0.6)
    # dye NaN saturation: zeros left of ones and a backtrace past x = 0
    # extrapolate below zero; pow gives NaN and fminf(1, NaN) is 1
    sat = torch.rand((3, h, w), generator=gen, device=dev)
    sat[:, :, 0], sat[:, :, 1] = 0.0, 1.0
    push = torch.full((h, w), 30.0, device=dev)
    got = advect_cuda.advect_dye(sat, push, v, dt, decay_rate)
    if not bool((got[:, :, 0] == 1.0).all()) or bool(torch.isnan(got).any()):
        raise AssertionError("H1 dye: NaN saturation to 1 failed")
    _check(worst, "H1", "dye saturation", [("dye", got, ref.advect_dye(sat, push, v, dt, decay_rate))])
    # the same through H1's one launch, whose dye backtraces through u'
    # (29.4 cells/s: column 0 still extrapolates below zero)
    u2, v2 = advect_cuda.advect_velocity(push, v, dt, decay_rate)
    fused = advect_cuda.advect_both(push, v, sat, dt, decay_rate)
    if not bool((fused[2][:, :, 0] == 1.0).all()) or bool(torch.isnan(fused[2]).any()):
        raise AssertionError("H1 fused dye: NaN saturation to 1 failed")
    _check(worst, "H1 fused", "dye saturation", zip(("u", "v", "dye"), fused, (
        u2, v2, advect_cuda.advect_dye(sat, u2, v2, dt, decay_rate))))
    del u2, v2, fused
    for iters in (0, 1, 2):
        _check(worst, "H3", f"splat iters={iters}", [(
            "fields", jacobi_cuda.diffuse_multi_splat(fields, dt, coeffs, iters, amps, last, 400.0),
            ref.diffuse_multi_splat(fields, dt, coeffs, iters, amps, last, 400.0))])
    _check(worst, "H3 sweeps", "diffuse 2-channel", [(
        "uv", jacobi_cuda.diffuse(fields[:2].contiguous(), dt, 0.8, 5),
        ref.diffuse(fields[:2], dt, 0.8, 5))])
    for iters in (0, 1, 2):
        got = jacobi_cuda.pressure_project(u, v, iters, False, return_stats=True)
        exp = ref.pressure_project(u, v, iters, False, return_stats=True)
        _check(worst, "H4", f"full iters={iters}", zip(("u", "v", "p"), got[:3], exp[:3]))
        _check_bound("H4", got[3], got[0], got[1])
    div = ref.divergence(u, v, False)
    for iters in (0, 1, 2):
        _check(worst, "H4 solve", f"iters={iters}", [(
            "p", jacobi_cuda.pressure_solve(div, iters), ref.pressure_solve(div, iters))])
    del u, v, dye, fields, sat, push, got, exp, p, rhs, div

    # H3 and H4 around the burst depth k: one burst short of k, exactly k,
    # one sweep into a second burst, and 2k + 1 (three bursts); one tile,
    # a grid narrower than one 16-byte load, odd and ragged tiles
    k = jacobi_cuda.DEPTH
    for h, w in BURST_SHAPES:
        u, v = randn(h, w, scale=200.0), randn(h, w, scale=200.0)
        fields = torch.cat([torch.stack([u, v]), torch.rand((3, h, w), generator=gen, device=dev)])
        last = (w * 0.4, h * 0.6)
        div = ref.divergence(u, v, True)
        for iters in (k - 1, k, k + 1, 2 * k + 1):
            tag = f"iters={iters} {h}x{w}"
            _check(worst, "H3 sweeps", tag, [(
                "fields", jacobi_cuda.diffuse_multi(fields, dt, coeffs, iters),
                ref.diffuse_multi(fields, dt, coeffs, iters))])
            _check(worst, "H3", f"splat {tag}", [(
                "fields", jacobi_cuda.diffuse_multi_splat(fields, dt, coeffs, iters, amps, last, 400.0),
                ref.diffuse_multi_splat(fields, dt, coeffs, iters, amps, last, 400.0))])
            for half in (True, False):
                got = jacobi_cuda.pressure_project(u, v, iters, half, return_stats=True)
                exp = ref.pressure_project(u, v, iters, half, return_stats=True)
                _check(worst, "H4", f"half={half} {tag}", zip(("u", "v", "p", "stats"), got, exp))
            _check(worst, "H4 solve", tag, [(
                "p", jacobi_cuda.pressure_solve(div, iters), ref.pressure_solve(div, iters))])
    del u, v, fields, div, got, exp

    # H7 at the shipped design (rank 2, radii 5 and 4): 5 channels with the
    # dye taps, 2 with the velocity taps; 16x16 is one tile, and at 4x8
    # radius 5 reaches past the grid, so the taps reflect more than once
    alpha = 0.8 * 0.8 / dt
    taps5, radii = fastdiffuse._taps_array([alpha] * 5, 20, 2e-4)
    taps2 = fastdiffuse._taps_array([alpha] * 2, 20, 2e-4)[0]
    for h, w in CHECK_SHAPES + ((16, 16), (4, 8)):
        f5 = randn(5, h, w)
        last = (w * 0.4, h * 0.6)
        for c, taps in ((5, taps5), (2, taps2)):
            for splat in (None, (amps[:c], last, 400.0)):
                _check(worst, "H7" if splat else "H7 sweeps", f"{c}ch splat={splat is not None} {h}x{w}", [(
                    "fields", fastdiffuse_cuda.sep_apply(f5[:c], taps, radii, splat),
                    fastdiffuse.sep_apply(f5[:c], taps, radii, splat))])
    # the generic kernel, on a design whose radii are not unrolled
    taps_g, radii_g = fastdiffuse._taps_array([3.0] * 3, 6, 2e-4)
    if fastdiffuse_cuda.plan(3, N, N, radii_g).variant != "generic":
        raise AssertionError(f"H7: radii {radii_g} do not take the generic kernel")
    for h, w in CHECK_SHAPES + ((4, 8),):
        f3 = randn(3, h, w)
        _check(worst, "H7 sweeps", f"generic radii={radii_g} {h}x{w}", [(
            "fields", fastdiffuse_cuda.sep_apply(f3, taps_g, radii_g),
            fastdiffuse.sep_apply(f3, taps_g, radii_g))])
    del f3
    # information: the separable blur against H3's 20 exact sweeps
    f5 = randn(5, N, N)
    sep_err = _max_err(fastdiffuse_cuda.sep_apply(f5, taps5, radii),
                       jacobi_cuda.diffuse_multi(f5, dt, coeffs, 20))
    _json({"phase": "h7_vs_h3", "grid": f"{N}x{N}", "field": "standard normal",
           "max_abs_diff": sep_err[0], "max_rel_diff": sep_err[1]})

    # H8 on driven fields (3.3 cells a step at one sigma: the rounded
    # branch) and quiet ones (under one cell: the exact branch)
    for h, w in CHECK_SHAPES:
        for flow, scale in (("driven", 200.0), ("quiet", 8.0)):
            tag = f"{flow} {h}x{w}"
            u, v = randn(h, w, scale=scale), randn(h, w, scale=scale)
            dye = torch.rand((3, h, w), generator=gen, device=dev)
            bound = ref.vel_max(u, v)
            if bool((bound * dt < 1.0).all()) != (flow == "quiet"):
                raise AssertionError(f"H8 {tag}: bound {bound.tolist()} is not {flow}")
            h1 = advect_cuda.advect_velocity(u, v, dt, decay_rate, return_stats=True)
            h1_dye = advect_cuda.advect_dye(dye, h1[0], h1[1], dt, decay_rate)
            for given in (True, False):
                for fast_path in (True, False):
                    case = f"{tag} vel_stats={'given' if given else 'absent'} fast_path={fast_path}"
                    kw = dict(vel_stats=bound if given else None, fast_path=fast_path)
                    got = advect_cuda.advect_velocity(u, v, dt, decay_rate, return_stats=True,
                                                      packed=True, **kw)
                    exp = advect_packed.advect_velocity(u, v, dt, decay_rate, return_stats=True, **kw)
                    _check(worst, "H8", f"velocity {case}", zip("uv", got[:2], exp[:2]))
                    _check_vel_max("H8", got[2], got[0], got[1])
                    kw["vel_stats"] = got[2] if given else None
                    got_dye = advect_cuda.advect_dye(dye, got[0], got[1], dt, decay_rate,
                                                     packed=True, **kw)
                    _check(worst, "H8", f"dye {case}", [("dye", got_dye, advect_packed.advect_dye(
                        dye, got[0], got[1], dt, decay_rate, **kw))])
                    _pack_out(f"H8 dye {case}", lambda out: advect_cuda.advect_dye(
                        dye, got[0], got[1], dt, decay_rate, packed=True, out=out, **kw),
                        got_dye, 2)
                    exact = all(torch.equal(a, b) for a, b in zip(got, h1))
                    exact = exact and torch.equal(got_dye, h1_dye)
                    if exact != (flow == "quiet" and fast_path):
                        raise AssertionError(f"H8 {case}: equal to H1 is {exact}")
    # the dye clamp: zeros left of ones and a backtrace 1.5 cells past x = 0
    # extrapolate column 1 to -0.5, which H1 saturates to 1 and H8 clamps
    # to 0; a NaN tap still saturates to 1
    h, w = CHECK_SHAPES[1]
    sat = torch.rand((3, h, w), generator=gen, device=dev)
    sat[:, :, 0], sat[:, :, 1] = 0.0, 1.0
    sat[:, 100, 200] = float("nan")
    push, still = torch.full((h, w), 1.5 / dt, device=dev), torch.zeros((h, w), device=dev)
    got = advect_cuda.advect_dye(sat, push, still, dt, decay_rate, packed=True)
    if not bool((got[:, :, 1] == 0.0).all()):
        raise AssertionError("H8 dye: negative blend not clamped to 0")
    if bool(torch.isnan(got).any()) or not bool((got[:, 100, 201] == 1.0).all()):
        raise AssertionError("H8 dye: NaN saturation to 1 failed")
    _check(worst, "H8", "dye clamp and saturation", [("dye", got, advect_packed.advect_dye(
        sat, push, still, dt, decay_rate))])
    del u, v, dye, f5, got, exp, got_dye, h1, h1_dye, sat, push, still
    torch.cuda.synchronize()

    driven = orbit_impulse(STEPS, 1.0 / 60.0, center=(N / 2, N / 2), radius=N / 8, omega=3.0)
    quiet = no_impulse(STEPS, 1.0 / 60.0)
    short = Impulse(*(f[:20] for f in driven))

    def drive(what, sim):
        """The driven rollout, the quiet rollout and one frame, with the
        launch counts read around them (and after the driven rollout)."""
        reset_counts()
        state, disp = sim.run_displacement(sim.init(), driven)
        torch.cuda.synchronize()
        after_driven = read_counts()
        quiet_state = sim.run(sim.init(), quiet)
        frame = sim.render(state)
        torch.cuda.synchronize()
        launches = read_counts()
        dmin, dmax = _check_state(what, state, quiet_state)
        _check_frame(what, frame)
        return state, quiet_state, launches, after_driven, max(disp), (dmin, dmax)

    # -- 4. the gpu-parity path ------------------------------------------------
    cfg = FluidConfig.gpu_reference(nx=N, ny=N, pressure_iters=40,
                                    max_displacement=31, backend="cuda")
    sim = Simulation(cfg)
    state, quiet_state, parity_launches, _, disp, dye_range = drive("parity", sim)
    _json({"phase": "parity_path", "launches": parity_launches,
           "realized_max_displacement": disp})
    for k in ("H1", "H2", "H3", "H4"):
        if parity_launches[k] == 0:
            raise AssertionError(f"{k} was not launched on the parity path")
    _one_advect_launch("parity", parity_launches)
    _same_as_two_passes("parity", cfg, sim.ops, driven, quiet, state, quiet_state)
    ref_sim = Simulation(FluidConfig.gpu_reference(
        nx=N, ny=N, pressure_iters=40, max_displacement=31, backend="ref"), device=dev)
    step_err, frames_equal = _step_vs_ref("parity", sim, ref_sim, state,
                                          slice_step(driven, STEPS - 1))
    _json({"phase": "parity_step_vs_ref", "max_rel_err": step_err, "tol": STEP_RTOL,
           "frames_equal": frames_equal, "dye_range": dye_range,
           "quiet_u_max": quiet_state.u.abs().max().item()})
    _step_vs_cat("parity", sim, state, slice_step(driven, STEPS - 1))
    _step_device_ops("parity", lambda: sim.step(state, slice_step(driven, STEPS - 1)))
    _scan_render("parity", sim, ref_sim, state, Impulse(*(f[:SCAN_STEPS] for f in driven)))
    _nvtx_spans("parity", sim, state, slice_step(driven, STEPS - 1))

    # -- 5. the quality path (multigrid, residual-targeted) --------------------
    qcfg = FluidConfig.quality(nx=N, ny=N, backend="cuda")
    qsim = Simulation(qcfg)
    qstate, qquiet, quality_launches, qdriven, qdisp, qdye = drive("quality", qsim)
    levels = multigrid._levels(N, N)
    # per step one first_smooth_res_restrict (cycle 1's fine pre-smooth, the
    # first probe); per completed V-cycle a smooth_res_restrict at each of
    # the levels - 1 levels above the bottom (the zero-start coarse levels
    # and the next cycle's fine probe), a prolong_smooth at each (the coarse
    # levels' post-smooths and the fine one) and one smooth_damped (the
    # bottom); no other H6 entry
    def cycles(counts, steps):
        if counts["H6 first_smooth_res_restrict"] != steps:
            raise AssertionError(f"{counts['H6 first_smooth_res_restrict']} first pre-smooths "
                                 f"in {steps} steps")
        by = [counts["H6 smooth_res_restrict"] / ((levels - 1) * steps),
              counts["H6 prolong_smooth"] / ((levels - 1) * steps),
              counts["H6 smooth_damped"] / steps]
        if len(set(by)) != 1:
            raise AssertionError(f"cycle counts disagree: {by}")
        for k in ("H6 smooth_res", "H6 first_smooth_res", "H6 last_smooth_project",
                  "H6 prolong_smooth_project"):
            if counts[k] != 0:
                raise AssertionError(f"{k} ran on the quality path")
        return by[0]
    driven_cycles = cycles(qdriven, STEPS)
    quiet_cycles = cycles({k: quality_launches[k] - qdriven[k] for k in qdriven}, STEPS)
    _json({"phase": "quality_path", "launches": quality_launches, "levels": levels,
           "realized_max_displacement": qdisp,
           "vcycles_per_step": {"driven": driven_cycles, "quiet": quiet_cycles},
           "host_reads_per_step": {"driven": driven_cycles + 1, "quiet": quiet_cycles + 1}})
    for k in ("H1", "H2", "H3", "H5", "H6 smooth_damped", "H6 smooth_res_restrict",
              "H6 first_smooth_res_restrict", "H6 prolong_smooth", "H6 mean_square"):
        if quality_launches[k] == 0:
            raise AssertionError(f"{k} was not launched on the quality path")
    _one_advect_launch("quality", quality_launches)
    _same_as_two_passes("quality", qcfg, qsim.ops, driven, quiet, qstate, qquiet)
    if quality_launches["H4"] != 0:
        raise AssertionError("H4 pressure_project ran on the multigrid path")
    qref = Simulation(FluidConfig.quality(nx=N, ny=N, backend="ref"), device=dev)
    step_err, frames_equal = _step_vs_ref("quality", qsim, qref, qstate,
                                          slice_step(driven, STEPS - 1))
    # the tolerance contract, on the velocity one driven step projects
    seen = {}
    project_mg = qsim.ops.pressure_project_mg

    def record(u, v, *args, **kw):
        seen["uv"] = (u, v)
        return project_mg(u, v, *args, **kw)

    qsim.ops.pressure_project_mg = record
    qsim.step(qstate, slice_step(driven, STEPS - 1))
    qsim.ops.pressure_project_mg = project_mg
    u, v = seen["uv"]
    before = multigrid_cuda.SMOOTH_RES_RESTRICT.launches
    p = project_mg(u, v, qcfg.mg_cycles, tol=qcfg.mg_tol, max_cycles=qcfg.mg_max_cycles,
                   half=True)[2]
    taken = (multigrid_cuda.SMOOTH_RES_RESTRICT.launches - before) / (levels - 1)
    residual = multigrid.residual_norm(p, ref.divergence(u, v, True)).item()
    if taken < qcfg.mg_max_cycles and not residual < qcfg.mg_tol:
        raise AssertionError(f"mg_tol contract: rms residual {residual} >= {qcfg.mg_tol}")
    _json({"phase": "quality_step_vs_ref", "max_rel_err": step_err, "tol": STEP_RTOL,
           "frames_equal": frames_equal, "dye_range": qdye,
           "rms_residual": residual, "mg_tol": qcfg.mg_tol, "vcycles": taken,
           "capped": taken >= qcfg.mg_max_cycles})
    _step_vs_cat("quality", qsim, qstate, slice_step(driven, STEPS - 1))
    # the device operations of one driven quality step, at its V-cycles
    before = multigrid_cuda.SMOOTH_RES_RESTRICT.launches
    qsim.step(qstate, slice_step(driven, STEPS - 1))
    step_cycles = (multigrid_cuda.SMOOTH_RES_RESTRICT.launches - before) / (levels - 1)
    if step_cycles != QUALITY_STEP_VCYCLES:
        raise AssertionError(f"the counted quality step takes {step_cycles} V-cycles")
    _step_device_ops("quality", lambda: qsim.step(qstate, slice_step(driven, STEPS - 1)))
    del seen, u, v, p

    # -- 6. fixed-cycle multigrid (its last cycle ends in last_smooth_project)
    fcfg = FluidConfig.gpu_reference(nx=N, ny=N, pressure_solver="multigrid",
                                     mg_cycles=2, backend="cuda")
    fsim = Simulation(fcfg)
    fixed_imp = Impulse(*(f[STEPS - FIXED_STEPS:] for f in driven))
    reset_counts()
    fstate = fsim.run(qstate, fixed_imp)
    torch.cuda.synchronize()
    fixed_launches = read_counts()
    _check_state("fixed-cycle", fstate)
    for k in ("H6 first_smooth_res_restrict", "H6 smooth_res_restrict", "H6 prolong_smooth",
              "H6 smooth_damped", "H6 prolong_smooth_project"):
        if fixed_launches[k] == 0:
            raise AssertionError(f"{k} was not launched on the fixed-cycle path")
    if fixed_launches["H4"] != 0 or fixed_launches["H5"] != 0:
        raise AssertionError("H4/H5 ran on the fixed-cycle multigrid path")
    fref = Simulation(FluidConfig.gpu_reference(
        nx=N, ny=N, pressure_solver="multigrid", mg_cycles=2, backend="ref"), device=dev)
    step_err, frames_equal = _step_vs_ref("fixed-cycle", fsim, fref, fstate,
                                          slice_step(driven, STEPS - 1))
    _json({"phase": "fixed_cycle_path", "steps": FIXED_STEPS, "launches": fixed_launches,
           "step_vs_ref_max_rel_err": step_err, "frames_equal": frames_equal})

    # -- 7. the fast path (bf16-tap advection, separable diffusion) -----------
    kcfg = FluidConfig.gpu_reference(nx=N, ny=N, pressure_iters=40, max_displacement=31,
                                     backend="cuda", **FAST)
    ksim = Simulation(kcfg)
    kstate, kquiet, fast_launches, _, kdisp, kdye = drive("fast", ksim)
    for k in ("H2", "H4", "H7", "H8"):
        if fast_launches[k] == 0:
            raise AssertionError(f"{k} was not launched on the fast path")
    for k in ("H1", "H3", "H1 velocity pass", "H1 dye pass"):
        if fast_launches[k] != 0:
            raise AssertionError(f"{k} ran on the fast path")
    # the same step on the plain version of every kernel, on the card
    plain_ops = backend._namespace({
        "advect_velocity": functools.partial(advect_packed.advect_velocity,
                                             fast_path=kcfg.advect_fast_path),
        "advect_dye": functools.partial(advect_packed.advect_dye,
                                        fast_path=kcfg.advect_fast_path),
        **fastdiffuse.make_ops(kcfg, apply=fastdiffuse.sep_apply)})
    kplain = Simulation(kcfg, ops=plain_ops)
    last_imp = slice_step(driven, STEPS - 1)
    if not float(kstate.vel_stats.max()) * dt >= 1.0:
        raise AssertionError("fast path: the checked step is quiet; H8 would not round")
    step_err, frames_equal = _step_vs_ref("fast", ksim, kplain, kstate, last_imp)
    _step_vs_cat("fast", ksim, kstate, last_imp)
    _step_device_ops("fast", lambda: ksim.step(kstate, last_imp))
    # information: how far one fast step lands from the exact parity step,
    # and how far its advected velocity alone (bf16 taps against f32 ones)
    fast_next, parity_next = ksim.step(kstate, last_imp), ref_sim.step(kstate, last_imp)
    vs_parity = {name: _max_err(getattr(fast_next, name), getattr(parity_next, name))[1]
                 for name in STATE_FIELDS}
    adv = [advect_cuda.advect_velocity(kstate.u, kstate.v, dt, decay_rate, packed=packed,
                                       vel_stats=kstate.vel_stats) for packed in (True, False)]
    vs_parity["advected_u"] = _max_err(adv[0][0], adv[1][0])[1]
    vs_parity["advected_v"] = _max_err(adv[0][1], adv[1][1])[1]
    # the step reads nothing back: an implicit sync raises in this mode
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ksim.step(kstate, last_imp)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    _json({"phase": "fast_path", "launches": fast_launches, "realized_max_displacement": kdisp,
           "step_vs_plain_max_rel_err": step_err, "tol": STEP_RTOL,
           "frames_equal": frames_equal, "dye_range": kdye,
           "step_vs_parity_max_rel_diff": vs_parity, "sync_debug_error_mode": "no sync",
           "quiet_u_max": kquiet.u.abs().max().item()})
    del fast_next, parity_next, adv

    # -- 8. ensembles: H1-H4 over B members a launch ---------------------------
    ens = ensemble_phase(smi[0], gen, worst, reset_counts, read_counts, kernels)

    # -- 9. fast and multigrid ensembles: H5-H8 over B members a launch --------
    rest = ensemble_rest_phase(smi[0], gen, worst, reset_counts, read_counts, kernels)

    # -- 10. the headless CLI at 2048² -----------------------------------------
    cli_decomposed = cli_phase(smi[0], reset_counts, read_counts, dev)

    # -- 11. the live views at 2048², the entry and the example ---------------
    view_launches = views_phase(smi[0], reset_counts, read_counts, dev)
    entry_phase(reset_counts, read_counts, dev)

    # -- 12. the sharded rollout at 8192² -----------------------------------------
    _, sharded_rows = sharded_phase(smi[0], gen, worst, reset_counts, read_counts, kernels,
                                    dev)

    # -- 13. sharded ensembles: the (ens, x) mesh ----------------------------------
    ens_x_rows = sharded_ensemble_phase(smi[0], gen, worst, reset_counts, read_counts,
                                        kernels, dev)

    # -- 14. timing ------------------------------------------------------------
    def rates(what, sim_, ref_sim_):
        driven_ms = statistics.median(cuda_times_ms(lambda: sim_.run(sim_.init(), driven), iters=3))
        quiet_ms = statistics.median(cuda_times_ms(lambda: sim_.run(sim_.init(), quiet), iters=3))
        ref_ms = statistics.median(cuda_times_ms(lambda: ref_sim_.run(ref_sim_.init(), short), iters=3))
        _json({"metric": "steps_per_sec", "path": what, "grid": f"{N}x{N}", "steps": STEPS,
               "driven": STEPS / (driven_ms / 1000.0), "quiet": STEPS / (quiet_ms / 1000.0),
               "driven_ms_per_step": driven_ms / STEPS, "quiet_ms_per_step": quiet_ms / STEPS,
               "ref_backend_driven_ms_per_step": ref_ms / 20, "smi": smi[0]})

    rates("parity", sim, ref_sim)
    rates("quality", qsim, qref)
    rates("fast", ksim, kplain)
    fixed_ms = statistics.median(cuda_times_ms(lambda: fsim.run(qstate, fixed_imp), iters=3))
    _json({"metric": "ms_per_step", "path": "fixed-cycle multigrid", "grid": f"{N}x{N}",
           "steps": FIXED_STEPS, "driven_ms_per_step": fixed_ms / FIXED_STEPS, "smi": smi[0]})

    # per kernel, at its path's shapes, on the driven states' fields
    u, v, dye = state.u, state.v, state.dye
    u2, v2 = advect_cuda.advect_velocity(u, v, dt, decay_rate)
    all5 = torch.cat([torch.stack([u, v]), dye]).contiguous()
    last = (N / 2 + N / 8, N / 2)
    qu, qv = qstate.u, qstate.v
    ku, kv, kst = kstate.u, kstate.v, kstate.vel_stats
    ku2, kv2, kst2 = advect_cuda.advect_velocity(ku, kv, dt, decay_rate, vel_stats=kst,
                                                 return_stats=True, packed=True)
    splat = (amps, last, 400.0)
    div = ref.divergence(qu, qv, True)
    rhs, p = -div, qstate.pressure
    # a coarse correction for the fine post-smooth, and the 16² bottom's
    # right-hand side, from the fine level's residual
    mg_res = multigrid.smooth_res(p, rhs, 2)[1]
    e_c = 4.0 * multigrid._restrict(mg_res)
    rhs16 = rhs
    for _ in range(levels - 1):
        rhs16 = 4.0 * multigrid._restrict(rhs16)
    cases = {
        "H1": (lambda: advect_cuda.advect_both(u, v, dye, dt, decay_rate, return_stats=True),
               lambda: (ref.advect_velocity(u, v, dt, decay_rate, return_stats=True),
                        ref.advect_dye(dye, u2, v2, dt, decay_rate))),
        "H1 velocity pass": (
            lambda: advect_cuda.advect_velocity(u, v, dt, decay_rate, return_stats=True),
            lambda: ref.advect_velocity(u, v, dt, decay_rate, return_stats=True)),
        "H1 dye pass": (lambda: advect_cuda.advect_dye(dye, u2, v2, dt, decay_rate),
                        lambda: ref.advect_dye(dye, u2, v2, dt, decay_rate)),
        "H2": (lambda: jacobi_cuda.vorticity_confinement(u, v, dt, 50.0, variant="gpu"),
               lambda: ref.vorticity_confinement_gpu(u, v, dt, 50.0)),
        "H3": (lambda: jacobi_cuda.diffuse_multi_splat(all5, dt, [0.8] * 5, 20, amps, last, 400.0),
               lambda: ref.diffuse_multi_splat(all5, dt, [0.8] * 5, 20, amps, last, 400.0)),
        "H4": (lambda: jacobi_cuda.pressure_project(u, v, 40, True, return_stats=True),
               lambda: ref.pressure_project(u, v, 40, True, return_stats=True)),
        "H4 solve": (lambda: jacobi_cuda.pressure_solve(div, 40),
                     lambda: ref.pressure_solve(div, 40)),
        "H5": (lambda: (jacobi_cuda.divergence(qu, qv, True),
                        jacobi_cuda.project(qu, qv, p, return_stats=True)),
               lambda: (ref.divergence(qu, qv, True),
                        ref.project(qu, qv, p, return_stats=True))),
        # the quality path's only smooth_damped: the bottom, from a zero plane
        "H6 smooth_damped": (lambda: multigrid_cuda.smooth_damped(None, rhs16, 20),
                             lambda: multigrid.smooth_damped(None, rhs16, 20)),
        "H6 smooth_res": (lambda: (multigrid_cuda.smooth_res(p, rhs, 2),
                                   multigrid_cuda.smooth_res(rhs, rhs, 2, from_zero=True)),
                          lambda: (multigrid.smooth_res(p, rhs, 2),
                                   multigrid.smooth_res(rhs, rhs, 2, from_zero=True))),
        "H6 first_smooth_res": (lambda: multigrid_cuda.first_smooth_res(qu, qv, 2, True),
                                lambda: multigrid.first_smooth_res(qu, qv, 2, True)),
        "H6 last_smooth_project": (
            lambda: multigrid_cuda.last_smooth_project(p, rhs, qu, qv, 2, return_stats=True),
            lambda: multigrid.last_smooth_project(p, rhs, qu, qv, 2, return_stats=True)),
        # the quality path's fine ends: the probe (pre-smooth, residual and
        # its restriction), cycle 1's pre-smooth, the post-smooth
        "H6 smooth_res_restrict": (
            lambda: multigrid_cuda.smooth_res_restrict(p, rhs, 2, return_res=True),
            lambda: multigrid.smooth_res_restrict(p, rhs, 2, return_res=True)),
        "H6 first_smooth_res_restrict": (
            lambda: multigrid_cuda.first_smooth_res_restrict(qu, qv, 2, True),
            lambda: multigrid.first_smooth_res_restrict(qu, qv, 2, True)),
        "H6 prolong_smooth": (lambda: multigrid_cuda.prolong_smooth(p, e_c, rhs, 2),
                              lambda: multigrid.prolong_smooth(p, e_c, rhs, 2)),
        "H6 prolong_smooth_project": (
            lambda: multigrid_cuda.prolong_smooth_project(p, e_c, rhs, qu, qv, 2,
                                                          return_stats=True),
            lambda: multigrid.prolong_smooth_project(p, e_c, rhs, qu, qv, 2,
                                                     return_stats=True)),
        # the quality path's stopping test, on the fine probe's residual
        "H6 mean_square": (lambda: multigrid_cuda.mean_square(mg_res),
                           lambda: multigrid.mean_square(mg_res)),
        # H7 on H3's inputs
        "H7": (lambda: fastdiffuse_cuda.sep_apply(all5, taps5, radii, splat),
               lambda: fastdiffuse.sep_apply(all5, taps5, radii, splat)),
        # H8 on the driven fast state (the rounded branch), velocity + dye
        "H8": (lambda: (advect_cuda.advect_velocity(ku, kv, dt, decay_rate, vel_stats=kst,
                                                    return_stats=True, packed=True),
                        advect_cuda.advect_dye(kstate.dye, ku2, kv2, dt, decay_rate,
                                               vel_stats=kst2, packed=True)),
               lambda: (advect_packed.advect_velocity(ku, kv, dt, decay_rate, vel_stats=kst,
                                                      return_stats=True),
                        advect_packed.advect_dye(kstate.dye, ku2, kv2, dt, decay_rate,
                                                 vel_stats=kst2))),
    }
    def per_call(fn, iters, warmup):
        # BATCH calls back to back in each timed window, as a step issues
        # them: a small kernel's row is then its device time wherever the
        # wrapper's host cost is below it
        times = cuda_times_ms(lambda: [fn() for _ in range(BATCH)], iters=iters,
                              warmup=warmup)
        return [t / BATCH for t in times]

    # what each row's call reads, for its bound (its outputs are counted
    # from one call), and the float32 operations it does, counted per cell
    # from its formulas (a transcendental as one operation): a sweep 8, the
    # residual 6, the restriction 1.25 a fine cell, the prolongation and its
    # add 8, the divergence and its sign 5, the projection with its bound 10
    cells, mg_cells = N * N, qu.numel()
    sep_taps = sum(2 * (2 * r + 1) for r in radii)
    io = {
        # H1's one launch reads u, v and the dye and writes u', v' and the
        # dye: 10 planes (its dye pass alone reads u', v' back: 8)
        "H1": ([u, v, dye], cells * (H1_OPS["velocity"] + H1_OPS["dye"])),
        "H1 velocity pass": ([u, v], cells * H1_OPS["velocity"]),
        "H1 dye pass": ([dye, u2, v2], cells * H1_OPS["dye"]),
        "H2": ([u, v], cells * 25),
        "H3": ([all5], 5 * cells * (6 * 20 + 10)),
        "H4": ([u, v], cells * (4 + 5 * 40 + 8)),
        "H4 solve": ([div], cells * 5 * 40),
        "H5": ([qu, qv, qu, qv, p], mg_cells * 12),
        "H6 smooth_damped": ([rhs16], rhs16.numel() * 8 * 20),
        "H6 smooth_res": ([p, rhs, rhs], mg_cells * 46),
        "H6 first_smooth_res": ([qu, qv], mg_cells * 27),
        "H6 last_smooth_project": ([p, rhs, qu, qv], mg_cells * 24),
        "H6 smooth_res_restrict": ([p, rhs], mg_cells * 23.25),
        "H6 first_smooth_res_restrict": ([qu, qv], mg_cells * 22.25),
        "H6 prolong_smooth": ([p, e_c, rhs], mg_cells * 24),
        "H6 prolong_smooth_project": ([p, e_c, rhs, qu, qv], mg_cells * 34),
        "H6 mean_square": ([mg_res], mg_cells * 2),
        "H7": ([all5], 5 * cells * (2 * sep_taps + 10)),
        "H8": ([ku, kv, kst, kstate.dye, ku2, kv2, kst2], cells * 82),
    }

    # the device operations one call makes at the path's shapes: H3, H4,
    # and each H6 entry the quality path calls (the bottom at 16²)
    device_launches = {k: _device_kernels(cases[k][0]) for k in MAX_DEVICE_LAUNCHES}
    plans = {"H3": jacobi_cuda.plan_bursts(N, N, 20, "diffuse"),
             "H4": jacobi_cuda.plan_bursts(N, N, 40, "project"),
             "H4 solve": jacobi_cuda.plan_bursts(N, N, 40, "solve"),
             "H6 smooth_res_restrict": jacobi_cuda.plan_bursts(N, N, 2, "smooth_res"),
             "H6 first_smooth_res_restrict": jacobi_cuda.plan_bursts(N, N, 2, "smooth_res"),
             "H6 prolong_smooth": jacobi_cuda.plan_bursts(N, N, 2, "smooth"),
             "H6 smooth_damped": jacobi_cuda.plan_bursts(*rhs16.shape, 20, "smooth")}
    for k, counts in device_launches.items():
        n = sum(counts.values())
        _json({"phase": "device_launches_per_call", "kernel": k,
               "grid": "x".join(map(str, rhs16.shape if k == "H6 smooth_damped" else (N, N))),
               "launches": n, "by_name": counts, "plan_depths": plans[k].depths,
               "plan_tile": plans[k].tile, "plan_smem": plans[k].smem})
        if not 0 < n <= MAX_DEVICE_LAUNCHES[k]:
            raise AssertionError(f"{k}: {n} device launches in one call")

    # information: H3 and H4 under other burst plans, against the default
    def plan_ms(fn):
        return statistics.median(per_call(fn, iters=5, warmup=1))

    plan_rows = []
    for tile, depth in ((jacobi_cuda.TILE, jacobi_cuda.DEPTH), ((32, 112), 8), ((40, 112), 8),
                        ((42, 112), 8), ((26, 112), 8), ((48, 104), 10), ((40, 104), 10)):
        hp = jacobi_cuda.plan_bursts(N, N, 20, "diffuse", tile=tile, depth=depth)
        pp = jacobi_cuda.plan_bursts(N, N, 40, "project", tile=tile, depth=depth)
        plan_rows.append({
            "tile": tile, "depth": depth,
            "H3_depths": hp.depths, "H3_smem": max(hp.smem),
            "H3_ms": plan_ms(lambda: jacobi_cuda._diffuse(all5, dt, [0.8] * 5, 20, splat, plan=hp)),
            "H4_depths": pp.depths, "H4_smem": max(pp.smem),
            "H4_ms": plan_ms(lambda: jacobi_cuda._pressure_project(u, v, 40, True, plan=pp))})
    _json({"phase": "burst_plans", "grid": f"{N}x{N}", "plans": plan_rows, "smi": smi[0]})

    # each row's launches come from the path that runs it
    paths = {"H1": "parity", "H1 velocity pass": "cli decomposed",
             "H1 dye pass": "cli decomposed", "H2": "parity", "H3": "parity", "H4": "parity",
             "H4 solve": "cli decomposed", "H5": "quality", "H6 smooth_damped": "quality",
             "H6 smooth_res": None, "H6 first_smooth_res": None,
             "H6 last_smooth_project": None, "H6 smooth_res_restrict": "quality",
             "H6 first_smooth_res_restrict": "quality", "H6 prolong_smooth": "quality",
             "H6 prolong_smooth_project": "fixed-cycle", "H6 mean_square": "quality",
             "H7": "fast", "H8": "fast"}
    path_launches = {"parity": parity_launches, "quality": quality_launches,
                     "fixed-cycle": fixed_launches, "fast": fast_launches,
                     "cli decomposed": cli_decomposed}
    # H8's two passes apart; H1's velocity pass with and without its bound
    # (information)
    def h8_velocity():
        return advect_cuda.advect_velocity(ku, kv, dt, decay_rate, vel_stats=kst,
                                           return_stats=True, packed=True)

    def h8_dye():
        return advect_cuda.advect_dye(kstate.dye, ku2, kv2, dt, decay_rate, vel_stats=kst2,
                                      packed=True)

    extra = {"H8": {"velocity_device_ms": _device_ms(h8_velocity),
                    "dye_device_ms": _device_ms(h8_dye)}}
    _json({"phase": "advect_bound", "grid": f"{N}x{N}", **_bound_cost(u, v, dt, decay_rate),
           "smi": smi[0]})
    rows = []
    for k, (kern_fn, plain_fn) in cases.items():
        inputs, ops = io[k]
        nbytes = _nbytes(inputs) + _nbytes(kern_fn())
        bytes_ms, ops_ms = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / F32_OPS_PER_S
        # plain, kernel, kernel, plain: drift affects both alike
        p1 = per_call(plain_fn, iters=3, warmup=1)
        k1 = per_call(kern_fn, iters=5, warmup=1)
        k2 = per_call(kern_fn, iters=5, warmup=0)
        p2 = per_call(plain_fn, iters=3, warmup=0)
        _, src, replaces = kernels[k]
        path = paths[k]
        rows.append({
            "name": row_names.get(k, f"{k} {src[:-3]}"), "route": "cuda",
            "source": f"cudafluidsimulation_tpu_torch/csrc/{src}",
            "replaces": f"cudafluidsimulation_tpu/ops/{replaces}",
            "launches": path_launches[path][k] if path else 0, "path": path,
            "max_abs_err": worst[k if k == "H6 mean_square" else
                                 k.split()[0] if k.startswith(("H6", "H1")) else k],
            **({"max_abs_err_without_splat": worst[f"{k} sweeps"]} if k in ("H3", "H7") else {}),
            **({"variant": fastdiffuse_cuda.plan(5, N, N, radii).variant} if k == "H7" else {}),
            **extra.get(k, {}),
            "ms": statistics.median(k1 + k2), "device_ms": _device_ms(kern_fn),
            "plain_ms": statistics.median(p1 + p2),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "operations": ops,
            # no single PyTorch call computes any of these functions (20 or
            # 40 clamped sweeps, clamped bilinear gathers, the fused ends)
            "library_ms": None,
        })
    rows += ens()
    rows += rest()
    rows += sharded_rows(per_call)
    rows += ens_x_rows(per_call)
    _json({"phase": "profiler_sessions", **TRACES})
    print(smi[0], flush=True)
    _json({"kernels": rows})
    _json({"ok": True, "device": {"platform": "gpu",
                                  "kind": torch.cuda.get_device_name(0),
                                  "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
