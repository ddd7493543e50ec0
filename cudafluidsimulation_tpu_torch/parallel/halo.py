"""Halo exchanges over a mesh axis, the building block of the sharded
rollout (the JAX package's ``parallel/halo.py``).

Fields are sharded by rows over one mesh axis (and by columns over a
second on a 2-D mesh); an op that reads neighbours first fetches ``width``
boundary rows (columns) from its mesh neighbours (``Communicator.neighbours``)
and then computes on the padded array.  The physical edges (the first and
last shard) are padded by the edge condition instead: edge replication
("clamp") for one-deep stencil halos, even reflection ("mirror") for
bursts of Jacobi sweeps — the Neumann ghosts of the one-device kernels.
The functions run inside a shard's thread (``parallel.mesh.run``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from cudafluidsimulation_tpu_torch.ops.stencil import shift_x
from cudafluidsimulation_tpu_torch.parallel import mesh as _mesh


def _exchange(a: torch.Tensor, width: int, axis_name: str, dim: int, edge: str):
    if edge not in ("clamp", "mirror"):
        raise ValueError(f"edge must be 'clamp' or 'mirror', got {edge!r}")
    comm = _mesh.current()
    n, idx = comm.axis_size(axis_name), comm.axis_index(axis_name)
    size = a.shape[dim]
    lo = a.narrow(dim, 0, width)  # my first rows: the high halo of the shard before
    hi = a.narrow(dim, size - width, width)  # my last rows: the low halo of the next
    from_below, from_above = comm.neighbours(lo, hi, axis_name)
    if idx == 0:
        low = lo.flip(dim) if edge == "mirror" else a.narrow(dim, 0, 1).expand_as(lo)
    else:
        low = from_below.to(a.device)  # a copy only from another device
    if idx == n - 1:
        high = hi.flip(dim) if edge == "mirror" else a.narrow(dim, size - 1, 1).expand_as(hi)
    else:
        high = from_above.to(a.device)
    # one copy of the shard and the neighbours' rows into the padded array
    return torch.cat([low, a, high], dim=dim)


def exchange_rows(a: torch.Tensor, width: int, axis_name: str,
                  edge: str = "clamp") -> torch.Tensor:
    """Pad local (..., Hl, W) rows with ``width`` halo rows from the mesh
    neighbours along ``axis_name``; the physical edges padded per ``edge``:
    "clamp" (replicate the edge row) or "mirror" (even reflection, exact for
    Jacobi bursts)."""
    return _exchange(a, width, axis_name, a.dim() - 2, edge)


def exchange_cols(a: torch.Tensor, width: int, axis_name: str,
                  edge: str = "clamp") -> torch.Tensor:
    """The column counterpart of :func:`exchange_rows` on a 2-D mesh."""
    return _exchange(a, width, axis_name, a.dim() - 1, edge)


def exchange_2d(a: torch.Tensor, width: int, row_axis: str, col_axis: str,
                edge: str = "clamp") -> torch.Tensor:
    """k-deep halo exchange on a 2-D mesh, corners included: rows first, then
    the columns of the row-padded array, whose column transfer carries the
    diagonal neighbours' rows (a k-sweep 5-point stencil reads the L1 ball
    |dy| + |dx| <= k)."""
    return exchange_cols(exchange_rows(a, width, row_axis, edge), width, col_axis, edge)


def shift_x_clamped(a: torch.Tensor, d: int) -> torch.Tensor:
    """x shifts never cross a rows mesh's shards: the clamped shift."""
    return shift_x(a, d)


def neighbors_padded(ap: torch.Tensor, width: int = 1) -> Tuple[torch.Tensor, ...]:
    """(left, right, below, above) of the core of an
    :func:`exchange_rows`-padded array (the y neighbours from the halo)."""
    hl = ap.shape[-2] - 2 * width
    core = ap[..., width:width + hl, :]
    return (shift_x_clamped(core, -1), shift_x_clamped(core, 1),
            ap[..., width - 1:width - 1 + hl, :], ap[..., width + 1:width + 1 + hl, :])


def measure_halo_traffic(config, mesh, axis_name: str = "x", step_builder=None) -> dict:
    """The collective traffic of one sharded step, counted by the shards'
    communicators: exchange pairs, the bytes one shard sends in them (and
    in its gathers), gathers, and the Jacobi sweeps per exchange pair.

    The step runs once on a zero state of ``config``'s shape on the meta
    device, a shard per position of ``mesh`` (shape-only, so 8192² costs
    no memory).  A config of the ``cuda`` or ``auto`` backend runs the
    kernel schedule on the kernels' plain versions (the wrappers take CPU
    and CUDA tensors only): the exchanges are the namespace's, the same
    with the kernels.  ``step_builder(config, mesh, kernels=...)`` replaces
    ``shardmap_step.make_shardmap_step`` (for example
    ``shardmap2d.make_shardmap2d_step``)."""
    from cudafluidsimulation_tpu_torch.parallel import shardmap_step
    from cudafluidsimulation_tpu_torch.state import init_state
    from cudafluidsimulation_tpu_torch.utils.impulse import single

    meta = _mesh.Mesh(["meta"] * mesh.size, mesh.dims, mesh.axis_names)
    kernels = None if config.backend == "ref" else shardmap_step.PLAIN
    if step_builder is None:
        step = shardmap_step.make_shardmap_step(config, meta, axis_name, kernels=kernels)
    else:
        step = step_builder(config, meta, kernels=kernels)
    state = _mesh.shard_state(init_state(config, device="meta"), meta)
    step(state, single((config.nx / 2.0, config.ny / 2.0),
                       (config.nx / 2.0 - 2.0, config.ny / 2.0 - 2.0), True, config.dt))
    counts = step.counts[0]
    jacobi_sweeps = (config.diffusion_iters * (5 if config.color_diffusion_enabled else 2)
                     + config.pressure_iters)
    pairs = counts["exchanges"]
    return {
        "ppermute_per_step": 2 * pairs,
        "exchange_pairs_per_step": pairs,
        "all_gather_per_step": counts["all_gather"],
        "ici_bytes_per_step_per_device": counts["bytes"],
        "jacobi_sweeps_per_step": jacobi_sweeps,
        "sweeps_per_exchange_pair": float(np.round(jacobi_sweeps / max(1, pairs), 3)),
    }
