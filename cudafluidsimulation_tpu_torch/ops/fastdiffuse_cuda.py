"""H7: separable fast diffusion on the card (``csrc/sepdiffuse.cu``).

Replaces ``cudafluidsimulation_tpu/ops/fastdiffuse.py`` ``_sep_apply`` →
``_sep_kernel`` and ``_sep_kernel_tiled``.  One launch covers up to five
channels (grid z = channel), as the fast step's 5-channel pack needs.  Each
block loads its tile plus an rmax-deep ring at half-sample symmetric
coordinates into shared memory, runs each rank's x pass into shared memory
and its y pass into registers, then adds the optional splat tail.  The TPU
kernels' strip and column-tile planning and their mirror padding have no
counterpart: the kernel takes any grid and any radius, and reflects more
than once when a radius reaches past the grid.

Two kernels, chosen by the radii (:func:`plan`):

- ``unrolled`` for the radii in :data:`UNROLLED` (the shipped design, rank
  2, radii 5 and 4): templated on rank and radii, taps in registers, 64×128
  tiles, a lane computing 4 outputs of a row in the x pass from one
  register window and walking 8 output rows in the y pass;
- ``generic`` for any other rank <= 3: taps in shared memory, 32×32 tiles.

What bounds it: the issue of its float32 operations (40 products and 40
sums a cell at radii (5, 4), unfused so each rounds as the plain version's
does), not its 160 MiB a call at 2048² (PERF.md).

**H7 batched** (:func:`sep_apply_batched`, ensembles): the same kernels
over B members' (C, H, W) fields in one launch, B·C planes with no cap on
B, plane z of member z // C; the taps (the same for every member) by
value, each member's splat amplitudes and centre from its row of the
step's device parameters (``ops/member_params.py``).

The wrappers take the plain versions (``ops.fastdiffuse.sep_apply``,
``sep_apply_batched``) for CPU tensors and launch the kernel or raise for
CUDA tensors.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from cudafluidsimulation_tpu_torch.ops import fastdiffuse, member_params, ref
from cudafluidsimulation_tpu_torch.ops._build import Kernel, on_card, stream_of

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# fluid_sep_diffuse(in, out, n, chans, h, w, taps*, tap_len, radii*, rank,
#                   amp*, lx, ly, radius, splat, prm, prm_stride, unrolled,
#                   stream); taps, radii and amp are host pointers, prm the
#                   members' device rows [amp[0..chans), lx, ly] or null
_SEP = {"fluid_sep_diffuse": [_P, _P, _I, _I, _I, _I, _P, _I, _P, _I, _P, _F, _F, _F, _I,
                              _P, _I, _I, _P]}
SEP = Kernel("sepdiffuse", _SEP)
# the same entry, B members a launch (its own launch count)
SEP_BATCHED = Kernel("sepdiffuse", _SEP)

MAX_CHANNELS = 5  # csrc/sepdiffuse.cu SEP_MAX_CHANNELS
MAX_RANK = 3  # SEP_MAX_RANK
MAX_TAPS = 160  # SEP_MAX_TAPS, floats a channel
# the radii sep_kernel_unrolled is instantiated for (fluid_sep_diffuse)
UNROLLED = ((5, 4),)
# (rows, columns) of a block's output tile: SEP_TH x SEP_TW, GEN_TH x GEN_TW
TILES = {"unrolled": (64, 128), "generic": (32, 32)}


@dataclass(frozen=True)
class SepPlan:
    """One H7 launch: the kernel, its output tile, its grid (columns, rows,
    channels of tiles) and a block's dynamic shared memory."""

    variant: str
    tile: Tuple[int, int]
    grid: Tuple[int, int, int]
    rmax: int
    smem: int


def plan(c: int, h: int, w: int, radii) -> SepPlan:
    """The launch ``fluid_sep_diffuse`` makes for ``c`` (H, W) channels and
    ``radii``: the unrolled kernel for radii in :data:`UNROLLED`, else the
    generic one."""
    radii = tuple(int(r) for r in radii)
    variant = "unrolled" if radii in UNROLLED else "generic"
    th, tw = TILES[variant]
    rmax = max(radii)
    if variant == "unrolled":
        # the tile + ring (a row padded so lane 31's 16-byte loads end in
        # it) and one rank's x sums
        stride = 4 * (31 + (4 + 2 * rmax + 3) // 4)
        smem = 4 * (th + 2 * rmax) * (stride + tw)
    else:
        taps = sum(2 * (2 * r + 1) for r in radii)
        smem = 4 * ((th + 2 * rmax) * (tw + 2 * rmax) + (th + 2 * rmax) * tw + taps)
    grid = (-(-w // tw), -(-h // th), c)
    return SepPlan(variant, (th, tw), grid, rmax, smem)


def _check_design(c, radii, taps):
    if c > MAX_CHANNELS or len(radii) > MAX_RANK or taps.shape[1] > MAX_TAPS:
        raise ValueError(f"sepdiffuse takes at most {MAX_CHANNELS} channels, "
                         f"{MAX_RANK} ranks and {MAX_TAPS} taps a channel, got "
                         f"{c} channels and radii {tuple(radii)}")


def sep_apply(fields, taps, radii, splat=None):
    """Rank-R separable blur of (C, H, W) ``fields`` with half-sample
    symmetric edges and the optional splat tail (amps, last, radius);
    ``ops.fastdiffuse.sep_apply`` semantics."""
    if not on_card(fields):
        return fastdiffuse.sep_apply(fields, taps, radii, splat)
    taps = fastdiffuse.check_taps(fields, taps, radii)
    if not fields.is_contiguous():
        raise ValueError("fields: expected a contiguous tensor")
    c, h, w = fields.shape
    _check_design(c, radii, taps)
    if splat is None:
        amps, lx, ly, radius = None, 0.0, 0.0, 1.0
    else:
        amps = np.ascontiguousarray(ref.f32_vec(splat[0]))  # read by pointer
        if amps.shape[0] != c:
            raise ValueError(f"amps: expected {c} values, got {amps.shape[0]}")
        last = ref.f32_vec(splat[1])
        lx, ly, radius = float(last[0]), float(last[1]), float(ref.f32(splat[2]))
    radii_host = np.asarray(radii, np.int32)
    unrolled = plan(c, h, w, radii).variant == "unrolled"
    out = torch.empty_like(fields)
    with torch.cuda.device(fields.device):
        SEP.launch(
            "fluid_sep_diffuse", fields.data_ptr(), out.data_ptr(), c, c, h, w,
            taps.ctypes.data, taps.shape[1], radii_host.ctypes.data, len(radii),
            amps.ctypes.data if amps is not None else None,
            lx, ly, radius, int(splat is not None), None, 0, int(unrolled), stream_of(fields))
    return out


def sep_apply_batched(fields, taps, radii, splat=None, *, params=None):
    """:func:`sep_apply` over B members' (C, H, W) ``fields`` (B, C, H, W),
    contiguous: every member blurred with the same (C, L) ``taps``, member
    b's splat tail with ``splat`` = (amps (B, C), last (B, 2), radius);
    ``ops.fastdiffuse.sep_apply_batched`` semantics.  ``params``: the
    members' (B, >= C + 2) device rows [amp[0..C), lx, ly] (the step's
    ``member_params.diffuse_cols`` rows from column 2C on), uploaded here
    from ``splat`` when None."""
    if not on_card(fields):
        return fastdiffuse.sep_apply_batched(fields, taps, radii, splat)
    if fields.dim() != 4:
        raise ValueError(f"fields: expected (B, C, H, W), got {tuple(fields.shape)}")
    n, c, h, w = fields.shape
    taps = fastdiffuse.check_taps(fields[0], taps, radii)
    if not fields.is_contiguous():
        raise ValueError("fields: expected a contiguous tensor")
    _check_design(c, radii, taps)
    radius = 1.0
    if splat is not None:
        radius = float(ref.f32(splat[2]))
        if params is None:
            params = member_params.upload(np.concatenate(
                [ref.member_rows(splat[0], n, c), ref.member_rows(splat[1], n, 2)], axis=1),
                fields.device)
        member_params.check(params, n, c + 2, fields.device)
    radii_host = np.asarray(radii, np.int32)
    unrolled = plan(c, h, w, radii).variant == "unrolled"
    out = torch.empty_like(fields)
    with torch.cuda.device(fields.device):
        SEP_BATCHED.launch(
            "fluid_sep_diffuse", fields.data_ptr(), out.data_ptr(), n * c, c, h, w,
            taps.ctypes.data, taps.shape[1], radii_host.ctypes.data, len(radii), None,
            0.0, 0.0, radius, int(splat is not None),
            params.data_ptr() if splat is not None else None,
            params.stride(0) if splat is not None else 0, int(unrolled), stream_of(fields))
    return out
