"""Carry configurations and state between the JAX package and the port.

Neither side is imported: a JAX ``FluidConfig`` is read through
``dataclasses.asdict`` and state moves as a dict of NumPy arrays (for a JAX
state, ``{k: np.asarray(x) for k, x in state._asdict().items()}``), so the
tests can start both packages from the same state.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from cudafluidsimulation_tpu_torch.config import FluidConfig
from cudafluidsimulation_tpu_torch.state import FluidState

# fields that live on the simulation's device; the rest is host state
DEVICE_FIELDS = ("u", "v", "dye", "pressure", "vel_stats")
_DTYPES = {"step": np.int32}


def config_from_jax(cfg) -> FluidConfig:
    """The port's config for a JAX ``FluidConfig`` (backend ``pallas`` maps
    to ``cuda``)."""
    kw = dataclasses.asdict(cfg)
    if kw["backend"] == "pallas":
        kw["backend"] = "cuda"
    return FluidConfig(**kw)


def state_from_numpy(arrays: Dict[str, np.ndarray], device="cpu") -> FluidState:
    """A port state from the ten fields as NumPy arrays (copied)."""
    out = {}
    for name in FluidState._fields:
        a = np.array(arrays[name], dtype=_DTYPES.get(name, np.float32))
        t = torch.from_numpy(a)
        out[name] = t.to(device) if name in DEVICE_FIELDS else t
    return FluidState(**out)


def state_to_numpy(state: FluidState) -> Dict[str, np.ndarray]:
    """The ten fields of a port state as NumPy arrays on the host."""
    return {name: getattr(state, name).detach().cpu().numpy().copy()
            for name in FluidState._fields}
