"""Clamped-edge neighbour shifts.

Every neighbour access in the reference clamps its index to the domain (the
CLAMP macro, cpuFluidSim.cpp:8 / GPUFluidSim.cu:13): edge values replicate
outward.  Shifts by one cell are a slice plus the repeated edge row or
column.
"""

from __future__ import annotations

import torch


def shift_x(a: torch.Tensor, d: int) -> torch.Tensor:
    """Element (..., y, x) of the result is a[..., y, clamp(x+d)], |d| <= 1."""
    if d == 0:
        return a
    if d > 0:
        return torch.cat([a[..., 1:], a[..., -1:]], dim=-1)
    return torch.cat([a[..., :1], a[..., :-1]], dim=-1)


def shift_y(a: torch.Tensor, d: int) -> torch.Tensor:
    """Element (..., y, x) of the result is a[..., clamp(y+d), x], |d| <= 1."""
    if d == 0:
        return a
    if d > 0:
        return torch.cat([a[..., 1:, :], a[..., -1:, :]], dim=-2)
    return torch.cat([a[..., :1, :], a[..., :-1, :]], dim=-2)


def neighbors(a: torch.Tensor):
    """(left, right, bottom, top) clamped 4-neighbourhood; "bottom" is y-1
    and "top" is y+1 (larger y = up, GPUFluidSim.cu:302-307)."""
    return shift_x(a, -1), shift_x(a, 1), shift_y(a, -1), shift_y(a, 1)
