"""The per-member scalars of a batched step, in device memory.

A batched kernel (H1–H4 over B independent members, ``models/ensemble.py``)
reads the scalars that differ between members from one float32 (B, K)
array, row b member b's:

    [dt, decay | alpha[0..C), inv_beta[0..C), amp[0..C), lx, ly]

H1 (``csrc/advect.cu``) reads dt and the decay factor, H2
(``csrc/vorticity.cu``) dt, and H3 (``csrc/diffuse.cu``) the rest, from
the column it is handed: alpha and 1/beta of each of a member's C planes
(the viscosity of a sweep differs per member), the splat's amplitudes and
its centre.  The step fills the rows on the host in float32, with the
operations of the single step (so a member's kernels see the scalars a
single run's launch arguments carry), in pinned memory, and copies them to
the card with one non-blocking copy: the step reads nothing back, and a
captured CUDA graph could replay the same buffer with new contents.  A
row is 19 floats for C = 5, so B is bounded by device memory, not by the
32 KB of a launch's parameters.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from cudafluidsimulation_tpu_torch.ops import ref

F = np.float32
ADVECT_COLS = 2  # [dt, decay]


def advect_cols(dt, decay_rate) -> np.ndarray:
    """(B, 2) rows [dt, 1 / (1 + rate*dt)] for (B,) ``dt``, in float32 as
    ``ref.decay_factor``."""
    dt = ref.f32_vec(dt)
    return np.stack([dt, F(1) / (F(1) + ref.f32(decay_rate) * dt)], axis=1)


def diffuse_cols(dt, coeffs, amps=None, last=None) -> np.ndarray:
    """(B, 3C + 2) rows [alpha, 1/beta, amp for each of C planes, lx, ly]
    for (B,) ``dt`` and (B, C) ``coeffs`` (alpha and 1/beta as
    ``ref.diffusion_alphas``); ``amps`` (B, C) and ``last`` (B, 2) default
    to zeros (no splat)."""
    dt = ref.f32_vec(dt)
    coeffs = np.asarray(coeffs, np.float32)
    if coeffs.ndim != 2 or coeffs.shape[0] != dt.shape[0]:
        raise ValueError(f"coeffs: expected ({dt.shape[0]}, C), got {coeffs.shape}")
    alpha = coeffs * coeffs / dt[:, None]
    inv_beta = F(1) / (F(4) + alpha)
    n, c = coeffs.shape
    amps = np.zeros((n, c), F) if amps is None else np.asarray(amps, F).reshape(n, c)
    last = np.zeros((n, 2), F) if last is None else np.asarray(last, F).reshape(n, 2)
    return np.concatenate([alpha, inv_beta, amps, last], axis=1)


def upload(rows: np.ndarray, device) -> Optional[torch.Tensor]:
    """``rows`` as a float32 tensor on ``device`` through one non-blocking
    copy from pinned memory; None for a CPU device, where the plain
    versions read the host arrays themselves.  The caching host allocator
    keeps the pinned block until the copy has run."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    host = torch.empty(rows.shape, dtype=torch.float32, pin_memory=True)
    host.numpy()[...] = rows
    return host.to(device, non_blocking=True)


def check(params: torch.Tensor, n: int, cols: int, device) -> None:
    """Raise unless ``params`` holds ``n`` float32 rows of at least
    ``cols`` columns on ``device``, each row's columns adjacent."""
    if params.dtype != torch.float32 or params.device != torch.device(device):
        raise TypeError(f"params: expected float32 on {device}, got {params.dtype} "
                        f"on {params.device}")
    if params.dim() != 2 or params.shape[0] != n or params.shape[1] < cols:
        raise ValueError(f"params: expected ({n}, >= {cols}), got {tuple(params.shape)}")
    if params.stride(1) != 1:
        raise ValueError("params: a row's columns must be adjacent")
