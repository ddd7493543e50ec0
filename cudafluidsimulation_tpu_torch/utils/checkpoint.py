"""Checkpoint / resume of the simulation state.

The reference has no checkpointing at all (SURVEY.md §5).  A checkpoint is
an npz of the ten ``FluidState`` fields under their names, the same keys
and dtypes as the JAX package's (``step`` int32, the rest float32), so a
checkpoint written by either package loads in the other.  The state is
split between devices (``state.py``): saving gathers the device fields and
the host scalars, loading puts them back where ``interop.DEVICE_FIELDS``
says.

Writes are crash-safe: the npz is written to a temp file in the target
directory, flushed to disk, and atomically renamed over the destination
(``os.replace``), so a kill mid-write can never corrupt an existing
checkpoint.  When overwriting, the previous checkpoint is first rotated to
``<path>.prev.npz``: a torn *rename* window (a crash between the two
replaces) still leaves the rotated copy loadable through
:func:`load_state_with_fallback`.
"""

from __future__ import annotations

import os
import zipfile
import zlib

import numpy as np
import torch

from cudafluidsimulation_tpu_torch import interop
from cudafluidsimulation_tpu_torch.state import FluidState


def _norm(path: str) -> str:
    # np.savez_compressed appends .npz itself; normalise so that save and
    # load agree for extensionless paths
    return path if path.endswith(".npz") else path + ".npz"


def prev_path(path: str) -> str:
    """The rotation target for the previously saved checkpoint."""
    p = _norm(path)
    return p[: -len(".npz")] + ".prev.npz"


def save_state(path: str, state: FluidState, rotate: bool = True) -> None:
    """Atomically write ``state``; keep the prior file as ``.prev.npz``.

    Order of operations: write tmp -> fsync -> rotate old -> replace.  A
    crash at any point leaves at least one complete, loadable checkpoint on
    disk (the old one until the final ``os.replace``, the new one after).
    """
    dst = _norm(path)
    parent = os.path.dirname(dst)
    if parent:
        os.makedirs(parent, exist_ok=True)
    arrays = interop.state_to_numpy(state)
    tmp = dst + f".tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            np.savez_compressed(f, **arrays)
            f.flush()
            os.fsync(f.fileno())
        if rotate and os.path.exists(dst):
            os.replace(dst, prev_path(dst))
        os.replace(tmp, dst)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load_state(path: str, device=None) -> FluidState:
    """The state saved at ``path``, its fields on ``device``: the CUDA
    device when None, which raises without a card (pass ``device="cpu"``
    for a ``backend="ref"`` simulation on the CPU)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("load_state puts the fields on the CUDA device, but "
                               "torch.cuda.is_available() is False; pass device='cpu'")
        device = "cuda"
    with np.load(_norm(path)) as data:
        arrays = {k: data[k] for k in FluidState._fields if k in data.files}
    if "vel_stats" not in arrays:
        # checkpoints written before the kernel-emitted velocity bound
        # existed: recompute it from the saved fields
        arrays["vel_stats"] = np.stack([np.max(np.abs(arrays["u"])),
                                        np.max(np.abs(arrays["v"]))]).astype(np.float32)
    return interop.state_from_numpy(arrays, device)


def load_state_with_fallback(path: str, device=None) -> FluidState:
    """Load ``path``; if it is missing or unreadable (a torn write from a
    pre-atomic writer, a partial disk), fall back to the rotated
    ``.prev.npz``."""
    try:
        return load_state(path, device)
    except (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile, zlib.error):
        fb = prev_path(path)
        if os.path.exists(fb):
            return load_state(fb, device)
        raise
