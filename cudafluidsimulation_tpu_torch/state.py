"""Simulation state.

The same ten fields, dtypes and planar layout as the JAX package's
``FluidState``.  The fields (u, v, dye, pressure) and the kernel-emitted
``vel_stats`` live on the simulation's device.  The scalar state (t,
press_time, time_since_press, mouse, step) depends on the impulse stream
alone (models/pipelines.py), so it lives on the host as CPU tensors: a step
never waits on the device to update it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from cudafluidsimulation_tpu_torch.config import FluidConfig


class FluidState(NamedTuple):
    """All evolving simulation state."""

    u: torch.Tensor  # x-velocity, (H, W) f32, device
    v: torch.Tensor  # y-velocity, (H, W) f32, device
    dye: torch.Tensor  # RGB dye, (3, H, W) f32, device
    pressure: torch.Tensor  # last pressure solve result, (H, W) f32, device
    t: torch.Tensor  # total sim time, f32 scalar, host
    press_time: torch.Tensor  # accumulated pressed time, f32 scalar, host
    time_since_press: torch.Tensor  # gates the bloom, f32 scalar, host
    mouse: torch.Tensor  # last impulse grid position, (2,) f32, host
    step: torch.Tensor  # step counter, i32 scalar, host
    vel_stats: torch.Tensor  # (2,) f32 upper bound [max|u|, max|v|], device


def default_device(config: FluidConfig) -> str:
    """The CUDA device, or the CPU when ``config`` resolves to the ``ref``
    backend; raises without a card unless ``backend='ref'``."""
    return "cuda" if config.resolve_backend() == "cuda" else "cpu"


def init_state(config: FluidConfig, device=None) -> FluidState:
    """Zero fields, like the reference's init (cpuFluidSim.cpp:103-106), on
    ``device`` (:func:`default_device` when None: the kernels take CPU
    tensors for their plain versions, so the state goes on the card unless
    asked for the CPU)."""
    if device is None:
        device = default_device(config)
    h, w = config.shape
    f32 = torch.float32
    return FluidState(
        u=torch.zeros((h, w), dtype=f32, device=device),
        v=torch.zeros((h, w), dtype=f32, device=device),
        dye=torch.zeros((3, h, w), dtype=f32, device=device),
        pressure=torch.zeros((h, w), dtype=f32, device=device),
        t=torch.zeros((), dtype=f32),
        press_time=torch.zeros((), dtype=f32),
        time_since_press=torch.full((), 1e9, dtype=f32),  # never pressed yet
        mouse=torch.zeros((2,), dtype=f32),
        step=torch.zeros((), dtype=torch.int32),
        vel_stats=torch.zeros((2,), dtype=f32, device=device),
    )
