"""H2–H5: the stencil kernels on the card.

Each wrapper takes the plain version (``ops.ref``) for CPU tensors and
launches its kernel or raises for CUDA tensors.  :class:`VorticityLaunch`,
:class:`DiffuseSplatLaunch` and :class:`PressureLaunch` are H2's, H3's and
H4's launches as the single step prepares them (``models/pipelines.py``):
each C entry also takes its parameters as one record (``*_args``,
``VortArgs``, ``DiffuseArgs``, ``PressureArgs``), filled once, so a
prepared call sets what changes and makes one C call.  Byte counts below
are for the 2048² main path (one float32 plane is 16 MiB).

**H2 vorticity** (``csrc/vorticity.cu``) replaces
``cudafluidsimulation_tpu/ops/jacobi_pallas.py`` ``vorticity_confinement``
→ ``_vorticity_kernel`` (``_curl_taps``, ``_confinement``).  Bound by bytes:
read u, v and write u', v' (64 MiB).  One kernel: a block loads its
128 × 16 tile of u and v once, with the halo the curl's ring needs, into
shared memory as 16-byte loads, computes the curl of the tile and its
one-cell ring there, then the confinement force, 4 columns a thread with
16-byte stores; the force reads the curl at clamped coordinates, as
``ops.ref`` clamps the curl field.  The curl never goes to device memory.
A width that is not a multiple of 4, or a plane that is not 16-byte
aligned, takes scalar loads and stores in the same kernel.

**H3 diffusion** (``csrc/diffuse.cu``) replaces ``_diffuse_bursts`` →
``_diffuse_kernel`` and ``_diffuse_burst_tiled`` → ``_diffuse_kernel_tiled``
(entries ``diffuse``, ``diffuse_multi``, ``diffuse_multi_splat``).  A sweep
moves 8 bytes a cell, so one launch per sweep (the first design, 2.45 ms
for 5 channels × 20 sweeps at 2048²) was bound by device memory, and the
trapezoid bursts after it (0.52 ms, 3 launches) by the SMs' issue of
shared-memory traffic and barriers.  Now each launch is a pass of up to
:data:`DIFFUSE_DEPTH` sweeps as a row-streaming wavefront: a warp carries
the pass's sweeps down a column strip in registers, one sweep a row behind
the last, so 20 sweeps are two passes over device memory; the splat tail
rides the last sweep of the last pass.  :func:`plan_diffuse` chooses the
passes, the columns a lane, the strips and the chunks of rows.

**H4 pressure** (``csrc/pressure.cu``) replaces ``pressure_project`` →
``_single_pressure_kernel``, ``_first_pressure_kernel``,
``_pressure_kernel``, ``_last_pressure_kernel`` (and the tiled twins).
Like H3 it runs passes of up to :data:`PRESSURE_DEPTH` sweeps as a
row-streaming wavefront: the first pass computes the divergence from u and
v as the rows stream in (and writes it once for the later passes) and
sweeps from p = 0; the last runs one stage more, the gradient subtraction
on the rows its last sweep finishes, and emits [max|u'|, max|v'|].  40
sweeps at 2048² are 4 passes over device memory, 0.172 ms (the trapezoid
bursts before them: 5 launches and a memset, 0.37 ms).  :func:`plan_pressure`
chooses the passes, the columns a lane, the strips and the chunks of rows.
Its standalone entry ``pressure_solve`` (``PRESSURE_SOLVE``, its own launch
count) replaces ``jacobi_pallas.pressure_solve`` → ``_pressure_kernel``:
trapezoid bursts (``csrc/burst.cuh``: a block loads its tile plus a ring
as deep as the burst into shared memory, sweeps there, and writes the
tile) over a given ``div``, from p = 0 or, as JAX's ``init``, from a given
iterate, whose halo contract the sharded rollout's exchanges keep; the
solve alone 0.32 ms for 40 sweeps at 2048².

:func:`plan_bursts` chooses the solve's (and H6's) tile and the sweeps of
each burst: fewer, deeper bursts trade device-memory round trips and
launches for redundant halo work, (TX + 2k)(TY + 2k) / (TX·TY) cells
computed per cell kept, and for shared memory per block.  A grid inside one
tile runs every sweep in one launch.  The default, 48 × 112 tiles and
bursts of at most 8 sweeps, makes a shared row 128 floats (one warp's
width) and runs 40 sweeps in 5 launches.

**H5 divergence and projection** (``csrc/pressure.cu``, ``STENCIL``)
replaces ``divergence`` → ``_divergence_kernel`` and ``project`` →
``_project_kernel``: one launch each.  Bound by bytes: the divergence
reads u, v and writes div (48 MiB); the projection reads p, u, v and
writes u', v' (80 MiB), with the velocity bound as a block max and an
atomic max (zeroed on the stream first).  The multigrid projection
(``ops/multigrid.py``) ends on ``project``.  ``divergence_batched`` and
``project_batched`` (``STENCIL_BATCHED``) take B members a launch, member b
on grid z, u and v at any member stride (a (B, 5, H, W) pack's planes).
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from cudafluidsimulation_tpu_torch.ops import member_params, ref
from cudafluidsimulation_tpu_torch.ops._build import (
    Kernel, check_f32, check_planes, on_card, stream_of)

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong


class VortArgs(ctypes.Structure):
    """``fluid_vorticity``'s parameters in their order, as the record that
    ``fluid_vorticity_args`` takes (``csrc/vorticity.cu``
    ``FluidVorticityArgs``)."""

    _fields_ = ([(n, _P) for n in ("u", "v", "u2", "v2")]
                + [(n, _I) for n in ("h", "w", "cpu_variant")]
                + [("dt", _F), ("vorticity", _F), ("nb", _I)]
                + [(n, _L) for n in ("u_ms", "v_ms", "u2_ms", "v2_ms")]
                + [("prm", _P), ("prm_stride", _I), ("stream", _P)])


class DiffuseArgs(ctypes.Structure):
    """``fluid_diffuse``'s parameters in their order, as the record that
    ``fluid_diffuse_args`` takes (``csrc/diffuse.cu`` ``FluidDiffuseArgs``):
    depths, strips, chunks, alpha, inv_beta and amp are host pointers, prm
    a device pointer."""

    _fields_ = ([(n, _P) for n in ("in_", "out", "scratch")]
                + [(n, _I) for n in ("n", "h", "w", "cells")]
                + [(n, _P) for n in ("depths", "strips", "chunks")] + [("npasses", _I)]
                + [(n, _P) for n in ("alpha", "inv_beta", "amp")]
                + [(n, _F) for n in ("lx", "ly", "radius")] + [("splat", _I)]
                + [("prm", _P), ("prm_stride", _I), ("chans", _I), ("stream", _P)])


class PressureArgs(ctypes.Structure):
    """``fluid_pressure_project``'s parameters in their order, as the record
    that ``fluid_pressure_project_args`` takes (``csrc/pressure.cu``
    ``FluidPressureProjectArgs``): depths, strips and chunks are host
    pointers."""

    _fields_ = ([(n, _P) for n in ("u", "v", "u2", "v2", "p", "div", "scratch", "stats")]
                + [(n, _I) for n in ("h", "w", "cells")]
                + [(n, _P) for n in ("depths", "strips", "chunks")]
                + [(n, _I) for n in ("npasses", "half", "nb")]
                + [("u_ms", _L), ("v_ms", _L), ("stream", _P)])


def _entries(name: str, record) -> dict:
    """C entry ``name`` by its parameters and ``name_args`` by the record."""
    return {name: [t for _, t in record._fields_], f"{name}_args": [_P]}


_VORTICITY = _entries("fluid_vorticity", VortArgs)
VORTICITY = Kernel("vorticity", _VORTICITY)
_DIFFUSE = _entries("fluid_diffuse", DiffuseArgs)
DIFFUSE = Kernel("diffuse", _DIFFUSE)
_PRESSURE = _entries("fluid_pressure_project", PressureArgs)
PRESSURE = Kernel("pressure", _PRESSURE)
# the same entries, B members a launch (their own launch counts)
VORTICITY_BATCHED = Kernel("vorticity", _VORTICITY)
DIFFUSE_BATCHED = Kernel("diffuse", _DIFFUSE)
PRESSURE_BATCHED = Kernel("pressure", _PRESSURE)
# fluid_pressure_solve(div, p, scratch, h, w, tile_h, tile_w, depths*,
#                      nbursts, init, stream); init may be null
PRESSURE_SOLVE = Kernel("pressure", {
    "fluid_pressure_solve": [_P] * 3 + [_I] * 4 + [_P, _I, _P, _P],
})
# fluid_divergence(u, v, div, h, w, half, nb, u_ms, v_ms, stream);
# fluid_project(p, u, v, u2, v2, stats, h, w, nb, u_ms, v_ms, stream),
# stats may be null
_STENCIL = {"fluid_divergence": [_P] * 3 + [_I] * 4 + [_L] * 2 + [_P],
            "fluid_project": [_P] * 6 + [_I] * 3 + [_L] * 2 + [_P]}
STENCIL = Kernel("pressure", _STENCIL)
# the same entries, B members a launch (their own launch count)
STENCIL_BATCHED = Kernel("pressure", _STENCIL)

MAX_CHANNELS = 8  # csrc/diffuse.cu FLUID_MAX_CHANNELS: by-value parameters
MAX_GRID_Z = 65535  # csrc/fluid_common.cuh: a block walks z beyond it

# -- the burst planner ---------------------------------------------------------

# Dynamic shared memory a block may ask for on sm_90: 227 KB, less 1 KB for
# the kernels' static shared memory (the block max of the velocity bound).
SMEM_LIMIT = 227 * 1024 - 1024
# (rows, columns) of a block's output tile, and the deepest burst: with
# halos up to 8 a shared row is 128 floats, one warp's 4 columns a lane
TILE = (48, 112)
DEPTH = 8
# shared buffers a block holds: two iterates, and the divergence for H4's
# solve or the right-hand side for H6's "smooth" (sweeps only) and
# "smooth_res" (sweeps, then a residual or a gradient on the tile) bursts
_BUFFERS = {"solve": 3, "smooth": 3, "smooth_res": 3}
# kinds whose last burst runs one ring deeper, for a tail that reads p
# beyond the tile
_RING = ("smooth_res",)


@dataclass(frozen=True)
class BurstPlan:
    """The launches of one H4 solve (or H6) call: each burst's sweeps, the
    halo a block loads around its tile, and its dynamic shared memory."""

    tile: Tuple[int, int]
    depths: Tuple[int, ...]
    halos: Tuple[int, ...]
    smem: Tuple[int, ...]

    @property
    def iters(self) -> int:
        return sum(self.depths)


def burst_smem(kind: str, h: int, w: int, tile, halo: int) -> int:
    """Bytes of shared memory a block of one burst holds
    (``csrc/burst.cuh`` ``burst_smem_bytes``): its buffers of tile ± halo
    rows (clipped to the grid) by the tile's width (clipped, rounded up to
    4 floats) plus the halo rounded up to 4 floats on each side."""
    rows = min(tile[0] + 2 * halo, h)
    pad = (min(halo, w) + 3) // 4 * 4
    stride = (min(tile[1], w) + 3) // 4 * 4 + 2 * pad
    return 4 * _BUFFERS[kind] * rows * stride


def plan_bursts(h: int, w: int, iters: int, kind: str, *,
                tile: Optional[Tuple[int, int]] = None,
                depth: Optional[int] = None) -> BurstPlan:
    """Split ``iters`` sweeps of a ``kind`` call (H4's "solve", or H6's
    "smooth" and "smooth_res") into bursts of at most ``depth`` sweeps, as
    even as they come, one launch each; the whole of them in one launch
    when the grid fits in one tile (no halo to recompute).  The last
    "smooth_res" burst runs one ring deeper (the gradient or the residual
    reads p beyond the tile).  ``iters`` = 0 is no burst.  A depth whose
    shared memory exceeds :data:`SMEM_LIMIT` is lowered."""
    if kind not in _BUFFERS:
        raise ValueError(f"kind must be one of {sorted(_BUFFERS)}, got {kind!r}")
    if h < 1 or w < 1 or iters < 0:
        raise ValueError(f"bad shape or iters: {h}x{w}, {iters}")
    tile = tuple(tile or TILE)
    depth = depth or DEPTH
    if min(tile) < 1 or depth < 1:
        raise ValueError(f"bad tile or depth: {tile}, {depth}")
    deeper = kind in _RING
    while True:
        if iters == 0:
            depths = ()
        elif h <= tile[0] and w <= tile[1]:
            depths = (iters,)
        else:
            n = math.ceil(iters / depth)
            depths = tuple(iters // n + (j < iters % n) for j in range(n))
        halos = tuple(d + (deeper and j == len(depths) - 1)
                      for j, d in enumerate(depths))
        smem = tuple(burst_smem(kind, h, w, tile, a) for a in halos)
        if max(smem, default=0) <= SMEM_LIMIT:
            break
        if depth == 1:
            raise ValueError(f"tile {tile} does not fit in shared memory")
        depth -= 1
    return BurstPlan(tile, depths, halos, smem)


# -- H3's and H4's wavefront planners ----------------------------------------------

# csrc/diffuse.cu and csrc/pressure.cu: the most sweeps a pass carries
# (DIFFUSE_DEPTH, PRESSURE_DEPTH), the lanes of a warp (a strip is LANES x
# cells columns wide), the cells a lane the kernels take (4 needs 16-byte
# rows: a width that is a multiple of 4 and 16-byte aligned planes; 1
# takes any), the warps of a block (each its own strip and chunk), the
# blocks an SM their registers are sized for, and the rows in each warp's
# ring of input rows in flight (csrc/wave.cuh)
DIFFUSE_DEPTH = 10
PRESSURE_DEPTH = 10
LANES = 32
DIFFUSE_CELLS = (4, 1)
DIFFUSE_WARPS = 4
DIFFUSE_BLOCKS_PER_SM = 2
PRESSURE_WARPS = 2
PRESSURE_BLOCKS_PER_SM = 4
DIFFUSE_RING = 5
# H4's ring of div rows: one for each stage and the copies in flight
PRESSURE_DIV_RING = PRESSURE_DEPTH + DIFFUSE_RING - 2
# the chunks: the count whose pass takes the fewest steps, as waves of
# blocks over an H100's 132 SMs times the steps of a chunk (its rows and
# 2 d lead-in rows).  A wave is WAVE_SHARE of the DIFFUSE_BLOCKS_PER_SM
# blocks an SM holds: measured on an H100 (5 x 20 sweeps at 2048², 1024²
# and 960 x 540, 2 at 2048²), a step takes 0.42-0.58 us in waves of up to
# 250 blocks, one block on an SM or two, and up to 0.9 us at 260-263 of
# the 264 that fit
SMS = 132
WAVE_SHARE = 0.95


def _chunks(h: int, d: int, tasks_a_row: int, warps: int = DIFFUSE_WARPS,
            blocks_per_sm: int = DIFFUSE_BLOCKS_PER_SM) -> int:
    """The chunks of a pass whose strips and planes make ``tasks_a_row``
    warp tasks a chunk, in blocks of ``warps`` (see :data:`SMS`)."""
    def steps(m):
        blocks = -(-tasks_a_row * m // warps)
        waves = -(-blocks // int(SMS * blocks_per_sm * WAVE_SHARE))
        return waves * (-(-h // m) + 2 * d)

    return min(range(1, h + 1), key=lambda m: (steps(m), m))


@dataclass(frozen=True)
class WavePlan:
    """The launches of one H3 or H4 call: each pass's sweeps (a depth of 0
    is H3's splat alone, or H4's projection of p = 0), its strips and its
    chunks of rows, and the cells a lane of every pass.  H3's C entry puts
    the splat on the last pass; H4's puts the divergence on the first and
    the projection on the last."""

    cells: int
    depths: Tuple[int, ...]
    strips: Tuple[int, ...]
    chunks: Tuple[int, ...]
    lanes: int = LANES

    @property
    def iters(self) -> int:
        return sum(self.depths)

    @property
    def width(self) -> int:
        """Columns a strip's warp holds."""
        return self.lanes * self.cells


def _align(cells: int) -> int:
    return 4 if cells >= 4 else 1


def strip_spans(w: int, width: int, cells: int, d: int, n: int):
    """[(first, e0, e1)] of ``n`` strips ``width`` columns wide
    (``csrc/wave.cuh`` ``wave_first``, ``wave_exact``): strip j's first
    column, and the columns [e0, e1) it keeps when its stale edges reach
    ``d`` columns in (``d`` sweeps; one more for H4's gradient); or None
    where some strip would keep a column its stale edges reach, or would
    reach past the grid.  A strip starts at column 0 or ends at ``w``
    wherever it reaches the grid's edge, so the edge columns are a lane's
    first and last cell, where the kernel's clamp is one select."""
    a = _align(cells)
    if n < 1 or (a == 4 and w % 4):
        return None
    if n == 1:
        return [(0, 0, w)] if w <= width and w % cells == 0 else None
    if w < width:
        return None

    def exact(j):
        return w if j >= n else j * w // n // a * a

    spans = []
    for j in range(n):
        e0, e1 = exact(j), exact(j + 1)
        if j == 0:
            f = 0
        elif j == n - 1:
            f = w - width
        else:
            f = min(max(e0 - d, 0) // a * a, w - width)
        if e1 <= e0 or f < 0 or f + width > w:
            return None
        # stale columns reach d in from a side that is not the grid's edge
        if (f > 0 and f > e0 - d) or (f + width < w and f + width < e1 + d):
            return None
        spans.append((f, e0, e1))
    return spans


def chunk_rows(h: int, m: int):
    """[(y0, y1)] of ``m`` chunks: the rows each keeps."""
    return [(k * h // m, (k + 1) * h // m) for k in range(m)]


@functools.lru_cache(maxsize=256)
def _fewest_strips(w: int, width: int, cells: int, d: int) -> Optional[int]:
    for n in range(max(1, -(-w // width)), w + 1):
        if strip_spans(w, width, cells, d, n) is not None:
            return n
    return None


def _passes(iters: int, depth: int) -> Tuple[int, ...]:
    """``iters`` sweeps in passes of at most ``depth``, as even as they come."""
    npass = math.ceil(iters / depth)
    return tuple(iters // npass + (j < iters % npass) for j in range(npass))


def _wave_plan(h: int, w: int, depths, reaches, planes: int, cells: Optional[int],
               lanes: int, chunk: Optional[int], aligned: bool,
               blocks=(DIFFUSE_WARPS, DIFFUSE_BLOCKS_PER_SM)) -> WavePlan:
    """Each pass's fewest strips that keep every column at its reach; the
    cells a lane (``cells``, or the one of :data:`DIFFUSE_CELLS` that issues
    the least a row: 4 where the rows are 16-byte aligned and its strips
    fit, else 1); and the chunks: ``chunk`` rows each where given, else as
    :func:`_chunks` spreads them over the card."""
    if cells is not None:
        choices = (cells,)
    elif aligned and w % 4 == 0:
        choices = DIFFUSE_CELLS
    else:
        choices = (1,)
    best = None
    for v in choices:
        strips = tuple(_fewest_strips(w, lanes * v, v, a) for a in reaches)
        if None in strips:
            continue
        # issue a row: lane-columns x (6 flops and the two shuffles and
        # selects a lane shares among its cells)
        cost = sum(n * lanes * (6 * v + 4) for n in strips)
        if best is None or cost < best[0]:
            best = (cost, v, strips)
    if best is None:
        raise ValueError(f"no strips of {choices} cells a lane keep a {w}-wide grid "
                         f"at reach {max(reaches)}")
    _, v, strips = best
    chunks = []
    for a, n in zip(reaches, strips):
        m = math.ceil(h / chunk) if chunk is not None else _chunks(h, a, planes * n, *blocks)
        chunks.append(max(1, min(m, h)))
    return WavePlan(v, tuple(depths), strips, tuple(chunks), lanes)


def _check_wave_args(h, w, iters, planes, depth, top, cells, lanes, chunk):
    if h < 1 or w < 1 or iters < 0 or planes < 1:
        raise ValueError(f"bad shape, planes or iters: {h}x{w}, {planes}, {iters}")
    if not 1 <= depth <= top or lanes < 1 or (chunk is not None and chunk < 1):
        raise ValueError(f"bad depth, lanes or chunk: {depth}, {lanes}, {chunk}")
    if cells is not None and cells not in DIFFUSE_CELLS:
        raise ValueError(f"cells must be one of {DIFFUSE_CELLS}, got {cells}")


@functools.lru_cache(maxsize=256)
def plan_diffuse(h: int, w: int, iters: int, planes: int = 1, *,
                 cells: Optional[int] = None, lanes: int = LANES,
                 depth: Optional[int] = None, chunk: Optional[int] = None,
                 aligned: bool = True) -> WavePlan:
    """Split ``iters`` sweeps of ``planes`` (h, w) planes into passes of at
    most ``depth`` (default :data:`DIFFUSE_DEPTH`) sweeps, as even as they
    come, one launch each; ``iters`` = 0 is one pass of the splat alone.
    Each pass takes the fewest strips that keep every column; ``cells``
    sets a strip's width, ``lanes`` x ``cells`` (``lanes`` other than 32
    only for emulation); the chunks as :func:`_wave_plan` gives them."""
    depth = DIFFUSE_DEPTH if depth is None else depth
    _check_wave_args(h, w, iters, planes, depth, DIFFUSE_DEPTH, cells, lanes, chunk)
    if iters == 0:
        return WavePlan(cells or 1, (0,), (1,), (1,), lanes)
    depths = _passes(iters, depth)
    return _wave_plan(h, w, depths, depths, planes, cells, lanes, chunk, aligned)


@functools.lru_cache(maxsize=256)
def plan_pressure(h: int, w: int, iters: int, planes: int = 1, *,
                  cells: Optional[int] = None, lanes: int = LANES,
                  depth: Optional[int] = None, chunk: Optional[int] = None,
                  aligned: bool = True) -> WavePlan:
    """H4's passes: ``iters`` sweeps of ``planes`` members' (h, w) pressure
    in passes of at most ``depth`` (default :data:`PRESSURE_DEPTH`), as even
    as they come, one launch each; ``iters`` = 0 is one pass of no sweep
    (p = 0, and the projection).  The first pass's divergence reaches as
    far as a sweep; the last pass reaches one column and one row further,
    for the gradient (:func:`pressure_reaches`).  Strips, cells and chunks
    as :func:`plan_diffuse`."""
    depth = PRESSURE_DEPTH if depth is None else depth
    _check_wave_args(h, w, iters, planes, depth, PRESSURE_DEPTH, cells, lanes, chunk)
    depths = _passes(iters, depth) if iters else (0,)
    return _wave_plan(h, w, depths, pressure_reaches(depths), planes, cells, lanes, chunk,
                      aligned, (PRESSURE_WARPS, PRESSURE_BLOCKS_PER_SM))


def pressure_reaches(depths) -> Tuple[int, ...]:
    """How far each H4 pass's stale edges reach in: its sweeps, and one
    more on the last pass (the gradient reads p beside each cell)."""
    return tuple(d + (j == len(depths) - 1) for j, d in enumerate(depths))


def _depths(plan: BurstPlan):
    """(host int array, count) of a burst plan's depths for the C entry."""
    depths = np.ascontiguousarray(plan.depths, np.int32)
    return depths, (depths.ctypes.data if depths.size else None), int(depths.size)


def vorticity_confinement(u, v, dt, vorticity, variant: str = "gpu", *,
                          out=None):
    """Curl + confinement force; ``ops.ref.vorticity_confinement_{gpu,cpu}``
    semantics.  ``out`` (2, H, W) receives u' and v' (``ref.check_out``):
    the step hands it channels 0-1 of its 5-channel pack."""
    if variant not in ("gpu", "cpu"):
        raise ValueError(f"variant must be 'gpu' or 'cpu', got {variant!r}")
    if out is not None:
        ref.check_out(out, (2,) + tuple(u.shape), u, v)
    if not on_card(*[t for t in (u, v, out) if t is not None]):
        fn = (ref.vorticity_confinement_gpu if variant == "gpu"
              else ref.vorticity_confinement_cpu)
        return fn(u, v, dt, vorticity, out=out)
    h, w = u.shape
    check_f32("u", u, (h, w))
    check_f32("v", v, (h, w))
    if out is None:
        out = torch.empty((2, h, w), dtype=torch.float32, device=u.device)
    with torch.cuda.device(u.device):
        VORTICITY.launch(
            "fluid_vorticity", u.data_ptr(), v.data_ptr(), out[0].data_ptr(),
            out[1].data_ptr(), h, w, int(variant == "cpu"),
            float(ref.f32(dt)), float(ref.f32(vorticity)), 1, 0, 0, 0, 0, None, 0,
            stream_of(u))
    return out[0], out[1]


class VorticityLaunch:
    """:func:`vorticity_confinement` (the gpu variant) prepared for one
    (stream, H, W) and coefficient: the record of its C call filled once,
    so a call sets the planes' addresses and dt and makes one C call, the
    same launch with the same arguments as the wrapper's."""

    def __init__(self, stream: int, h: int, w: int, vorticity):
        self._plane = 4 * h * w
        self._rec = VortArgs(h=h, w=w, vorticity=float(ref.f32(vorticity)), nb=1,
                             stream=stream)
        self._addr = ctypes.addressof(self._rec)
        VORTICITY.lib()  # loaded now, not in a step

    def __call__(self, u, v, out, dt) -> None:
        """H2 on u, v (H, W), contiguous on the launch's device, into the
        first two (H, W) planes of ``out``, contiguous and apart from them."""
        r = self._rec
        r.u, r.v, r.dt = u.data_ptr(), v.data_ptr(), float(ref.f32(dt))
        r.u2 = o = out.data_ptr()
        r.v2 = o + self._plane
        VORTICITY.launch("fluid_vorticity_args", self._addr)


# H3's counters (``utils.trace.counters``): calls on the card, through a
# wrapper or a prepared launch, and the passes over device memory
# (launches) they made
DIFFUSE_STATS = {"diffuse_calls": 0, "diffuse_passes": 0}
_STATS_LOCK = threading.Lock()


def _count(stats: dict, calls: str, passes: str, npass: int) -> None:
    with _STATS_LOCK:
        stats[calls] += 1
        stats[passes] += npass


def _plan_for(fields, h: int, w: int, iters: int, planes: int,
              plan: Optional[WavePlan]) -> WavePlan:
    if plan is None:
        plan = plan_diffuse(h, w, iters, planes, aligned=fields.data_ptr() % 16 == 0)
    if plan.iters != iters:
        raise ValueError(f"plan runs {plan.iters} sweeps, not {iters}")
    if plan.lanes != LANES:
        raise ValueError(f"plan has {plan.lanes} lanes a strip; the card's warps have {LANES}")
    return plan


@functools.lru_cache(maxsize=256)
def _plan_ints(plan: WavePlan):
    """The plan's depths, strips and chunks as host int arrays for the C
    entry, and their addresses (the arrays kept alive with the plan)."""
    ints = tuple(np.ascontiguousarray(a, np.int32)
                 for a in (plan.depths, plan.strips, plan.chunks))
    return ints, tuple(a.ctypes.data for a in ints)


def _launch_diffuse(kern: Kernel, fields, planes: int, plan: WavePlan, host, lx, ly,
                    radius, splat: bool, params, chans: int):
    """One H3 call: ``plan``'s passes over ``planes`` planes of ``fields``
    into a new tensor, parameters by value (``host``: alpha, inv_beta,
    amps as float32 arrays) or from the device rows ``params``."""
    h, w = fields.shape[-2:]
    npass = len(plan.depths)
    _, ptrs = _plan_ints(plan)
    out = torch.empty_like(fields)
    scratch = torch.empty_like(fields) if npass >= 2 else None
    with torch.cuda.device(fields.device):
        kern.launch(
            "fluid_diffuse", fields.data_ptr(), out.data_ptr(),
            scratch.data_ptr() if scratch is not None else None, planes, h, w, plan.cells,
            *ptrs, npass,
            *[a.ctypes.data if a is not None else None for a in host],
            lx, ly, float(ref.f32(radius)), int(splat),
            params.data_ptr() if params is not None else None,
            params.stride(0) if params is not None else 0, chans, stream_of(fields))
    _count(DIFFUSE_STATS, "diffuse_calls", "diffuse_passes", npass)
    return out


def _diffuse(fields, dt, coeffs, iters: int, splat=None,
             plan: Optional[WavePlan] = None):
    """Shared launcher: ``fields`` (C, H, W) on the card, ``coeffs`` one per
    channel, ``splat`` = (amps, last, radius) or None; ``plan`` defaults to
    :func:`plan_diffuse`'s.  Up to :data:`MAX_CHANNELS` planes take their
    parameters by value; more go through device rows as a batch of one."""
    if fields.dim() != 3:
        raise ValueError(f"fields: expected (C, H, W), got {tuple(fields.shape)}")
    c, h, w = fields.shape
    check_f32("fields", fields, (c, h, w))
    alpha, inv_beta = ref.diffusion_alphas(dt, coeffs)
    if alpha.shape[0] != c:
        raise ValueError(f"coeffs: expected {c} values, got {alpha.shape[0]}")
    amps = None if splat is None else ref.f32_vec(splat[0])
    if amps is not None and amps.shape[0] != c:
        raise ValueError(f"amps: expected {c} values, got {amps.shape[0]}")
    if c > MAX_CHANNELS:
        last = None if splat is None else ref.f32_vec(splat[1])[None]
        rows = member_params.diffuse_cols(ref.f32_vec(dt), ref.f32_vec(coeffs)[None],
                                          None if amps is None else amps[None], last)
        return _diffuse_rows(fields[None], iters, splat is not None,
                             1.0 if splat is None else splat[2],
                             member_params.upload(rows, fields.device), plan)[0]
    if iters < 0:
        raise ValueError("iters must be >= 0")
    if splat is None:
        lx, ly, radius = 0.0, 0.0, 1.0
    else:
        last = ref.f32_vec(splat[1])
        lx, ly, radius = float(last[0]), float(last[1]), splat[2]
    plan = _plan_for(fields, h, w, iters, c, plan)
    host = [np.ascontiguousarray(a, np.float32) if a is not None else None
            for a in (alpha, inv_beta, amps)]
    return _launch_diffuse(DIFFUSE, fields, c, plan, host, lx, ly, radius, splat is not None,
                           None, c)


def _diffuse_rows(fields, iters: int, splat: bool, radius, params,
                  plan: Optional[WavePlan] = None, kern: Kernel = DIFFUSE):
    """H3 over (B, C, H, W) ``fields``, B*C planes a launch a pass, each
    plane's alpha, 1/beta and amp and its member's splat centre from the
    device rows ``params`` (``member_params.diffuse_cols``'s layout)."""
    if fields.dim() != 4:
        raise ValueError(f"fields: expected (B, C, H, W), got {tuple(fields.shape)}")
    n, c, h, w = fields.shape
    check_f32("fields", fields, (n, c, h, w))
    if iters < 0:
        raise ValueError("iters must be >= 0")
    member_params.check(params, n, 3 * c + 2, fields.device)
    plan = _plan_for(fields, h, w, iters, n * c, plan)
    return _launch_diffuse(kern, fields, n * c, plan, (None, None, None), 0.0, 0.0, radius,
                           splat, params, c)


def diffuse(fields, dt, diffusion, iters: int):
    """``iters`` Jacobi sweeps of (C, H, W) fields with one coefficient;
    ``ops.ref.diffuse`` semantics."""
    if not on_card(fields):
        return ref.diffuse(fields, dt, diffusion, iters)
    if iters == 0:
        return fields
    return _diffuse(fields, dt, [ref.f32(diffusion)] * fields.shape[0], iters)


def diffuse_multi(fields, dt, coeffs, iters: int):
    """Per-channel-coefficient sweeps; ``ops.ref.diffuse_multi``."""
    if not on_card(fields):
        return ref.diffuse_multi(fields, dt, coeffs, iters)
    if iters == 0:
        return fields
    return _diffuse(fields, dt, coeffs, iters)


def diffuse_multi_splat(fields, dt, coeffs, iters: int, amps, last, radius):
    """Per-channel sweeps with the gpu-variant splat tail folded into the
    last one; ``ops.ref.diffuse_multi_splat``."""
    if not on_card(fields):
        return ref.diffuse_multi_splat(fields, dt, coeffs, iters, amps, last,
                                       radius)
    return _diffuse(fields, dt, coeffs, iters, splat=(amps, last, radius))


class DiffuseSplatLaunch:
    """:func:`diffuse_multi_splat` prepared for one input ``fields`` (C, H, W)
    on the card, which it reads at every call (the single step's pack,
    ``models/pipelines.py``), and one stream, ``iters`` and ``coeffs``: the
    plan, its int arrays, the scratch plane set and the record of the C
    call made once, and alpha and 1/beta again only when dt changes, so a
    call sets the output's address, the splat's amplitudes and centre and
    makes one C call, the same launches with the same arguments as the
    wrapper's, counted in :data:`DIFFUSE_STATS` as its calls are."""

    def __init__(self, fields, stream: int, iters: int, coeffs, radius):
        if fields.dim() != 3 or not 1 <= fields.shape[0] <= MAX_CHANNELS:
            raise ValueError(f"fields: expected (C<={MAX_CHANNELS}, H, W), "
                             f"got {tuple(fields.shape)}")
        c, h, w = fields.shape
        check_f32("fields", fields, (c, h, w))
        if iters < 0:
            raise ValueError("iters must be >= 0")
        plan = _plan_for(fields, h, w, iters, c, None)
        self._ints, ptrs = _plan_ints(plan)
        self.passes = len(plan.depths)
        self.fields = fields
        self.scratch = torch.empty_like(fields) if self.passes >= 2 else None
        self._coeffs = coeffs
        self._dt = None  # the bytes of the dt that alpha and 1/beta hold
        # alpha, 1/beta and the amplitudes, the C entry's host arrays
        self._host = np.zeros((3, c), np.float32)
        self._rec = DiffuseArgs(
            in_=fields.data_ptr(), scratch=self.scratch.data_ptr() if self.scratch is not None
            else None, n=c, h=h, w=w, cells=plan.cells, depths=ptrs[0], strips=ptrs[1],
            chunks=ptrs[2], npasses=self.passes, alpha=self._host[0].ctypes.data,
            inv_beta=self._host[1].ctypes.data, amp=self._host[2].ctypes.data,
            radius=float(ref.f32(radius)), splat=1, chans=c, stream=stream)
        self._addr = ctypes.addressof(self._rec)
        DIFFUSE.lib()  # loaded now, not in a step

    def __call__(self, out, dt, amps, last) -> None:
        """H3 with the splat tail on the launch's fields into ``out``
        (C, H, W), contiguous on the card and apart from them: ``amps`` (C,),
        ``last`` the splat's centre."""
        key = ref.f32(dt).tobytes()
        if key != self._dt:
            self._host[0], self._host[1] = ref.diffusion_alphas(dt, self._coeffs)
            self._dt = key
        self._host[2] = amps
        last = ref.f32_vec(last)
        r = self._rec
        r.out, r.lx, r.ly = out.data_ptr(), float(last[0]), float(last[1])
        DIFFUSE.launch("fluid_diffuse_args", self._addr)
        _count(DIFFUSE_STATS, "diffuse_calls", "diffuse_passes", self.passes)


# the single step's prepared launch of this op (``models/pipelines.py``)
diffuse_multi_splat.prepare = DiffuseSplatLaunch


# H4's counters (``utils.trace.counters``): calls on the card, through a
# wrapper or a prepared launch, and the passes over device memory
# (launches) they made
PRESSURE_STATS = {"pressure_calls": 0, "pressure_passes": 0}


def _launch_pressure(kern: Kernel, u, v, n: Optional[int], iters: int, half: bool,
                     plan: Optional[WavePlan]):
    """One H4 call on the card: ``plan``'s passes (default
    :func:`plan_pressure`'s) over ``u``, ``v`` (H, W), or (B, H, W) with
    ``n`` = B members at any member stride; (u', v', p, vel_stats)."""
    h, w = u.shape[-2:]
    lead = () if n is None else (n,)
    ms = (0, 0) if n is None else (u.stride(0), v.stride(0))
    if plan is None:
        aligned = (u.data_ptr() % 16 == 0 and v.data_ptr() % 16 == 0
                   and ms[0] % 4 == 0 and ms[1] % 4 == 0)
        plan = plan_pressure(h, w, iters, n or 1, aligned=aligned)
    if plan.iters != iters:
        raise ValueError(f"plan runs {plan.iters} sweeps, not {iters}")
    if plan.lanes != LANES:
        raise ValueError(f"plan has {plan.lanes} lanes a strip; the card's warps have {LANES}")
    npass = len(plan.depths)
    _, ptrs = _plan_ints(plan)
    dev = u.device
    uv2 = torch.empty((2,) + lead + (h, w), dtype=torch.float32, device=dev)
    p = torch.empty(lead + (h, w), dtype=torch.float32, device=dev)
    div, scratch = (torch.empty((2,) + lead + (h, w), dtype=torch.float32, device=dev)
                    if npass >= 2 else (None, None))
    stats = torch.empty(lead + (2,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        kern.launch(
            "fluid_pressure_project", u.data_ptr(), v.data_ptr(),
            uv2[0].data_ptr(), uv2[1].data_ptr(), p.data_ptr(),
            div.data_ptr() if div is not None else None,
            scratch.data_ptr() if scratch is not None else None,
            stats.data_ptr(), h, w, plan.cells, *ptrs, npass, int(bool(half)), n or 1,
            *ms, stream_of(u))
    _count(PRESSURE_STATS, "pressure_calls", "pressure_passes", npass)
    return uv2[0], uv2[1], p, stats


def _pressure_project(u, v, iters: int, half: bool, plan: Optional[WavePlan] = None):
    """Launcher of H4's projection on the card: (u', v', p, vel_stats)."""
    h, w = u.shape
    check_f32("u", u, (h, w))
    check_f32("v", v, (h, w))
    return _launch_pressure(PRESSURE, u, v, None, iters, half, plan)


def pressure_project(u, v, iters: int, half: bool, *,
                     return_stats: bool = False):
    """Divergence → ``iters`` Jacobi sweeps from p = 0 → gradient
    subtraction, returning (u', v', p[, vel_stats]);
    ``ops.ref.pressure_project`` semantics."""
    if not on_card(u, v):
        return ref.pressure_project(u, v, iters, half, return_stats=return_stats)
    out = _pressure_project(u, v, iters, half)
    return out if return_stats else out[:3]


class PressureLaunch:
    """:func:`pressure_project` prepared for one (device, stream, H, W),
    ``iters`` and ``half``: the plan, its int arrays, the div and scratch
    planes and the record of the C call made once, so a call sets the
    planes' addresses and makes one C call, the same launches with the same
    arguments as the wrapper's, counted in :data:`PRESSURE_STATS` as its
    calls are.  The plan is the wrapper's for 16-byte aligned inputs, as
    the step's fresh planes are (the C entry refuses others where the plan
    takes 16-byte rows)."""

    def __init__(self, device: torch.device, stream: int, h: int, w: int, iters: int,
                 half: bool):
        plan = plan_pressure(h, w, iters, 1, aligned=True)
        self._ints, ptrs = _plan_ints(plan)
        self.passes = len(plan.depths)
        # div and scratch, as the wrapper's
        self.work = (torch.empty((2, h, w), dtype=torch.float32, device=device)
                     if self.passes >= 2 else None)
        self._plane = 4 * h * w
        self._rec = PressureArgs(
            div=self.work[0].data_ptr() if self.work is not None else None,
            scratch=self.work[1].data_ptr() if self.work is not None else None, h=h, w=w,
            cells=plan.cells, depths=ptrs[0], strips=ptrs[1], chunks=ptrs[2],
            npasses=self.passes, half=int(bool(half)), nb=1, stream=stream)
        self._addr = ctypes.addressof(self._rec)
        PRESSURE.lib()  # loaded now, not in a step

    def __call__(self, u, v, out) -> None:
        """H4 on u, v (H, W), contiguous on the launch's device, into
        ``out``, 3 H W + 2 contiguous floats apart from them: u', v', p and
        [max|u'|, max|v'|] one after another."""
        r, plane = self._rec, self._plane
        r.u, r.v = u.data_ptr(), v.data_ptr()
        r.u2 = o = out.data_ptr()
        r.v2, r.p, r.stats = o + plane, o + 2 * plane, o + 3 * plane
        PRESSURE.launch("fluid_pressure_project_args", self._addr)
        _count(PRESSURE_STATS, "pressure_calls", "pressure_passes", self.passes)


# the single step's prepared launch of this op (``models/pipelines.py``)
pressure_project.prepare = PressureLaunch


def pressure_solve(div, iters: int, init=None):
    """``iters`` Jacobi sweeps from p = 0, or from the (H, W) iterate
    ``init`` (the sharded rollout's later bursts); ``ops.ref.pressure_solve``."""
    if not on_card(*[t for t in (div, init) if t is not None]):
        return ref.pressure_solve(div, iters, init=init)
    h, w = div.shape
    check_f32("div", div, (h, w))
    if init is not None:
        check_f32("init", init, (h, w))
    plan = plan_bursts(h, w, iters, "solve")
    depths, depths_ptr, nbursts = _depths(plan)
    p = torch.empty_like(div)
    scratch = torch.empty_like(div) if nbursts >= 2 else None
    with torch.cuda.device(div.device):
        PRESSURE_SOLVE.launch(
            "fluid_pressure_solve", div.data_ptr(), p.data_ptr(),
            scratch.data_ptr() if scratch is not None else None,
            h, w, *plan.tile, depths_ptr, nbursts,
            init.data_ptr() if init is not None else None, stream_of(div))
    return p


def divergence(u, v, half: bool):
    """Central-difference divergence; ``ops.ref.divergence``."""
    if not on_card(u, v):
        return ref.divergence(u, v, half)
    h, w = u.shape
    check_f32("u", u, (h, w))
    check_f32("v", v, (h, w))
    div = torch.empty_like(u)
    with torch.cuda.device(u.device):
        STENCIL.launch("fluid_divergence", u.data_ptr(), v.data_ptr(),
                       div.data_ptr(), h, w, int(bool(half)), 1, 0, 0, stream_of(u))
    return div


def project(u, v, p, *, return_stats: bool = False):
    """Gradient subtraction, returning (u', v'[, vel_stats]);
    ``ops.ref.project``."""
    if not on_card(u, v, p):
        return ref.project(u, v, p, return_stats=return_stats)
    h, w = u.shape
    for name, t in (("u", u), ("v", v), ("p", p)):
        check_f32(name, t, (h, w))
    uv2 = torch.empty((2, h, w), dtype=torch.float32, device=u.device)
    stats = (torch.empty((2,), dtype=torch.float32, device=u.device)
             if return_stats else None)
    with torch.cuda.device(u.device):
        STENCIL.launch(
            "fluid_project", p.data_ptr(), u.data_ptr(), v.data_ptr(),
            uv2[0].data_ptr(), uv2[1].data_ptr(),
            stats.data_ptr() if stats is not None else None, h, w, 1, 0, 0,
            stream_of(u))
    if return_stats:
        return uv2[0], uv2[1], stats
    return uv2[0], uv2[1]


# -- B members a launch (ensembles) --------------------------------------------


def vorticity_confinement_batched(u, v, dt, vorticity, variant: str = "gpu", *,
                                  params=None, out=None):
    """H2 over B members: u, v (B, H, W) (each plane contiguous), dt (B,);
    ``ops.ref.vorticity_confinement_{gpu,cpu}_batched`` semantics.
    ``params``: device rows whose column 0 is dt (``ops/member_params.py``;
    uploaded here when None).  ``out`` (B, 2, H, W) with contiguous planes
    receives u' and v' (the step's ``pack[:, 0:2]``); returns ``out[:, 0]``,
    ``out[:, 1]``."""
    if variant not in ("gpu", "cpu"):
        raise ValueError(f"variant must be 'gpu' or 'cpu', got {variant!r}")
    n = u.shape[0]
    if out is not None:
        ref.check_out_planes(out, (n, 2) + tuple(u.shape[1:]), u, v)
    if not on_card(*[t for t in (u, v, out) if t is not None]):
        fn = (ref.vorticity_confinement_gpu_batched if variant == "gpu"
              else ref.vorticity_confinement_cpu_batched)
        return fn(u, v, dt, vorticity, out=out)
    _, h, w = u.shape
    check_planes("u", u, (n, h, w))
    check_planes("v", v, (n, h, w))
    if params is None:
        params = member_params.upload(ref.member_vec(dt, n)[:, None], u.device)
    member_params.check(params, n, 1, u.device)
    if out is None:
        out = torch.empty((n, 2, h, w), dtype=torch.float32, device=u.device)
    u2, v2 = out[:, 0], out[:, 1]
    with torch.cuda.device(u.device):
        VORTICITY_BATCHED.launch(
            "fluid_vorticity", u.data_ptr(), v.data_ptr(), u2.data_ptr(), v2.data_ptr(),
            h, w, int(variant == "cpu"), 0.0, float(ref.f32(vorticity)), n,
            u.stride(0), v.stride(0), u2.stride(0), v2.stride(0),
            params.data_ptr(), params.stride(0), stream_of(u))
    return u2, v2


def _diffuse_batched(fields, dt, coeffs, iters: int, splat, params):
    n, c = fields.shape[:2]
    if params is None:
        amps, last = (None, None) if splat is None else splat[:2]
        params = member_params.upload(member_params.diffuse_cols(
            ref.member_vec(dt, n), ref.member_rows(coeffs, n, c),
            None if amps is None else ref.member_rows(amps, n, c),
            None if last is None else ref.member_rows(last, n, 2)), fields.device)
    return _diffuse_rows(fields, iters, splat is not None,
                         1.0 if splat is None else splat[2], params,
                         kern=DIFFUSE_BATCHED)


def diffuse_batched(fields, dt, diffusion, iters: int, *, params=None):
    """H3 over B members' (C, H, W) fields, one coefficient a member
    (``diffusion`` (B,)); ``ops.ref.diffuse_batched`` semantics.
    ``params``: the step's device rows (``member_params.diffuse_cols``'s
    layout), built and uploaded here when None."""
    if not on_card(fields):
        return ref.diffuse_batched(fields, dt, diffusion, iters)
    if iters == 0:
        return fields
    n, c = fields.shape[:2]
    k = ref.member_vec(diffusion, n)
    return _diffuse_batched(fields, dt, np.repeat(k[:, None], c, axis=1), iters, None,
                            params)


def diffuse_multi_batched(fields, dt, coeffs, iters: int, *, params=None):
    """H3 over B members, a coefficient per plane (``coeffs`` (B, C));
    ``ops.ref.diffuse_multi_batched``."""
    if not on_card(fields):
        return ref.diffuse_multi_batched(fields, dt, coeffs, iters)
    if iters == 0:
        return fields
    return _diffuse_batched(fields, dt, coeffs, iters, None, params)


def diffuse_multi_splat_batched(fields, dt, coeffs, iters: int, amps, last, radius, *,
                                params=None):
    """H3 over B members with each member's gpu-variant splat (``amps``
    (B, C), ``last`` (B, 2)) on the last sweep;
    ``ops.ref.diffuse_multi_splat_batched``."""
    if not on_card(fields):
        return ref.diffuse_multi_splat_batched(fields, dt, coeffs, iters, amps, last,
                                               radius)
    return _diffuse_batched(fields, dt, coeffs, iters, (amps, last, radius), params)


def pressure_project_batched(u, v, iters: int, half: bool, *, return_stats: bool = False):
    """H4 over B members: u, v (B, H, W), each plane contiguous at any
    member stride (``pack[:, 0]``); ``ops.ref.pressure_project_batched``
    semantics, returning (u', v', p[, vel_stats (B, 2)])."""
    if not on_card(u, v):
        return ref.pressure_project_batched(u, v, iters, half, return_stats=return_stats)
    n, h, w = u.shape
    check_planes("u", u, (n, h, w))
    check_planes("v", v, (n, h, w))
    out = _launch_pressure(PRESSURE_BATCHED, u, v, n, iters, half, None)
    return out if return_stats else out[:3]


def divergence_batched(u, v, half: bool):
    """H5's divergence over B members: u, v (B, H, W), each plane
    contiguous at any member stride; ``ops.ref.divergence_batched``."""
    if not on_card(u, v):
        return ref.divergence_batched(u, v, half)
    n, h, w = u.shape
    check_planes("u", u, (n, h, w))
    check_planes("v", v, (n, h, w))
    div = torch.empty((n, h, w), dtype=torch.float32, device=u.device)
    with torch.cuda.device(u.device):
        STENCIL_BATCHED.launch("fluid_divergence", u.data_ptr(), v.data_ptr(), div.data_ptr(),
                               h, w, int(bool(half)), n, u.stride(0), v.stride(0),
                               stream_of(u))
    return div


def project_batched(u, v, p, *, return_stats: bool = False):
    """H5's gradient subtraction over B members: u, v (B, H, W) with
    contiguous planes, p (B, H, W) contiguous; returns (u', v'[, vel_stats
    (B, 2)]); ``ops.ref.project_batched``."""
    if not on_card(u, v, p):
        return ref.project_batched(u, v, p, return_stats=return_stats)
    n, h, w = u.shape
    check_planes("u", u, (n, h, w))
    check_planes("v", v, (n, h, w))
    check_f32("p", p, (n, h, w))
    uv2 = torch.empty((2, n, h, w), dtype=torch.float32, device=u.device)
    stats = (torch.empty((n, 2), dtype=torch.float32, device=u.device)
             if return_stats else None)
    with torch.cuda.device(u.device):
        STENCIL_BATCHED.launch(
            "fluid_project", p.data_ptr(), u.data_ptr(), v.data_ptr(), uv2[0].data_ptr(),
            uv2[1].data_ptr(), stats.data_ptr() if stats is not None else None, h, w, n,
            u.stride(0), v.stride(0), stream_of(u))
    return (uv2[0], uv2[1], stats) if return_stats else (uv2[0], uv2[1])
