"""Device meshes, the shards' communicator and the lockstep runner.

The counterpart of ``jax.sharding.Mesh`` with ``shard_map``: one
controller runs the same per-shard program on every shard, and the
program's collectives (the JAX package's ``ppermute``, ``pmax``, ``psum``,
``all_gather``) are the only contact between shards.

- :class:`Mesh`: ``torch.device``s laid out as (n,) over the axis ``"x"``
  (:func:`make_mesh`, the rows mesh) or as (rows, cols) over ``"rows"`` and
  ``"cols"`` (:func:`make_mesh2d`).  A device may appear more than once, as
  the JAX tests' virtual host devices do: several shards then share a card
  (or the CPU), each with its own part of the grid.
- :func:`run`: the lockstep runner.  It calls the per-shard function once
  for each shard, in one thread a shard, each with its device current and
  the caller's stream on it, and its own :class:`Communicator`.
- :class:`Communicator` (:func:`current` inside a shard's thread): the axis
  index and size, the neighbour exchange of one halo pair
  (:meth:`Communicator.neighbours`: a device-to-device copy from the neighbour's
  tensor, on its device or another), ``pmax``, ``psum`` (summed in shard
  order, so every shard gets the same bits) and ``all_gather``.  Each call
  meets the other shards at a barrier; it counts exchange pairs, their
  bytes and the other collectives, so a schedule can be pinned as the JAX
  tests pin theirs by counting ``ppermute`` in the jaxpr.
- :func:`shard_state`, :func:`shard_state_2d`, :func:`gather_state`: u, v,
  dye and pressure split over the mesh, the scalars and ``vel_stats``
  replicated (:class:`ShardedState`), and back into one state.

Every shard runs the same program, so every shard makes the same
collectives in the same order; a branch that decides on data takes
replicated data (a ``psum``'d residual, a ``pmax``'d bound).

The shards of one process share it by threads: NCCL cannot put two ranks
on one card, and gloo's send and receive take host tensors, so neither
would run a mesh of several shards on one card.  On a host with several
cards the same communicator copies between cards with ``copy_``.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import torch

from cudafluidsimulation_tpu_torch.ops import _build
from cudafluidsimulation_tpu_torch.state import FluidState

FIELDS = ("u", "v", "dye", "pressure")  # split over the mesh; the rest replicated


class Mesh:
    """Devices over named axes: ``shape`` maps each axis name to its size,
    as ``jax.sharding.Mesh.shape`` does; shard i (row-major over the axes)
    lives on ``devices[i]``."""

    def __init__(self, devices: Sequence, dims: Sequence[int], axis_names: Sequence[str]):
        devices = tuple(torch.device(d) for d in devices)
        if len(dims) != len(axis_names) or min(dims) < 1:
            raise ValueError(f"bad mesh dims {tuple(dims)} for axes {tuple(axis_names)}")
        if len(devices) != math.prod(dims):
            raise ValueError(f"mesh {tuple(dims)} needs {math.prod(dims)} devices, "
                             f"got {len(devices)}")
        self.devices = devices
        self.dims = tuple(int(n) for n in dims)
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, self.dims))

    @property
    def size(self) -> int:
        return len(self.devices)

    def coords(self, index: int) -> Tuple[int, ...]:
        """The axis indices of shard ``index`` (row-major)."""
        out = []
        for n in reversed(self.dims):
            index, i = divmod(index, n)
            out.append(i)
        return tuple(reversed(out))

    def index(self, coords: Sequence[int]) -> int:
        i = 0
        for c, n in zip(coords, self.dims):
            i = i * n + c
        return i

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices]})"


def visible_devices() -> List[torch.device]:
    """The CUDA devices, or the CPU where there is none."""
    if torch.cuda.is_available():
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def place(n: int, devices: Optional[Sequence] = None) -> List[torch.device]:
    """``n`` shards' devices, round-robin over ``devices`` (default
    :func:`visible_devices`): more shards than devices share them."""
    devs = list(devices) if devices is not None else visible_devices()
    return [torch.device(devs[i % len(devs)]) for i in range(n)]


def make_mesh(n_devices: Optional[int] = None, devices: Optional[Sequence] = None) -> Mesh:
    """An (n,) mesh over the axis "x", which shards grid rows."""
    devs = list(devices) if devices is not None else visible_devices()
    n = n_devices if n_devices is not None else len(devs)
    if len(devs) < n:
        raise ValueError(f"need {n} devices, have {len(devs)}")
    return Mesh(devs[:n], (n,), ("x",))


def make_mesh2d(rows: int, cols: int, devices: Optional[Sequence] = None) -> Mesh:
    """A (rows, cols) spatial mesh over the axes "rows" and "cols"."""
    devs = list(devices) if devices is not None else visible_devices()
    n = rows * cols
    if len(devs) < n:
        raise ValueError(f"need {n} devices, have {len(devs)}")
    return Mesh(devs[:n], (rows, cols), ("rows", "cols"))


# -- the communicator -----------------------------------------------------------

_CURRENT = threading.local()


def current() -> "Communicator":
    """The communicator of the shard whose thread calls (inside :func:`run`)."""
    comm = getattr(_CURRENT, "comm", None)
    if comm is None:
        raise RuntimeError("no shard: collectives run inside parallel.mesh.run")
    return comm


class _Shared:
    """What the shards of one :func:`run` share: the barrier and two sets of
    slots, used in turn, so that a shard posts into one set while a slower
    one may still read the other (a shard posts again into a set only after
    every shard has passed the barrier of the collective in between)."""

    def __init__(self, n: int):
        self.barrier = threading.Barrier(n)
        self.slots = ([None] * n, [None] * n)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class Communicator:
    """One shard's view of the mesh and its collectives (see the module
    docstring).  ``counts``: exchange pairs, the bytes this shard sent in
    them and in its gathers, and the other collectives, since creation."""

    def __init__(self, mesh: Mesh, index: int, shared: _Shared):
        self.mesh = mesh
        self.index = index
        self.coords = mesh.coords(index)
        self.device = mesh.devices[index]
        self._shared = shared
        self._turn = 0
        self.counts = {"exchanges": 0, "bytes": 0, "pmax": 0, "psum": 0, "all_gather": 0}

    def axis_index(self, axis: str) -> int:
        return self.coords[self.mesh.axis_names.index(axis)]

    def axis_size(self, axis: str) -> int:
        return self.mesh.shape[axis]

    def _post(self, value):
        """Publish ``value``, wait for every shard, return every shard's."""
        slots = self._shared.slots[self._turn % 2]
        slots[self.index] = value
        self._turn += 1
        self._shared.barrier.wait()
        return slots

    def _peer(self, axis: str, offset: int) -> Optional[int]:
        k = self.mesh.axis_names.index(axis)
        c = list(self.coords)
        c[k] += offset
        if not 0 <= c[k] < self.mesh.dims[k]:
            return None
        return self.mesh.index(c)

    def _group(self, axes) -> List[int]:
        """The shards that differ from this one only along ``axes``, in mesh
        order (the members of a collective over ``axes``)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        keep = [k for k, name in enumerate(self.mesh.axis_names) if name not in axes]
        return [i for i in range(self.mesh.size)
                if all(self.mesh.coords(i)[k] == self.coords[k] for k in keep)]

    def neighbours(self, to_lower: torch.Tensor, to_upper: torch.Tensor, axis: str):
        """One exchange pair along ``axis`` (two ``ppermute``s in the JAX
        package): this shard sends ``to_lower`` to the shard before it on the
        axis and ``to_upper`` to the one after it; returns (what the shard
        before sent up, what the shard after sent down), None past a
        physical edge.  The caller copies out of them before its next
        collective."""
        slots = self._post((to_lower, to_upper))
        lo, hi = self._peer(axis, -1), self._peer(axis, 1)
        self.counts["exchanges"] += 1
        self.counts["bytes"] += _nbytes(to_lower) + _nbytes(to_upper)
        return (None if lo is None else slots[lo][1],
                None if hi is None else slots[hi][0])

    def _gathered(self, x, axes) -> List[torch.Tensor]:
        slots = self._post(x)
        return [slots[i].to(self.device) for i in self._group(axes)]

    def pmax(self, x: torch.Tensor, axes) -> torch.Tensor:
        """Elementwise max of ``x`` over the shards along ``axes``."""
        self.counts["pmax"] += 1
        return torch.stack(self._gathered(x, axes)).amax(dim=0)

    def psum(self, x: torch.Tensor, axes) -> torch.Tensor:
        """Sum of ``x`` over the shards along ``axes``, added in mesh order
        on every shard: every shard gets the same bits."""
        self.counts["psum"] += 1
        vals = self._gathered(x, axes)
        acc = vals[0]
        for v in vals[1:]:
            acc = acc + v
        return acc

    def all_gather(self, x: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
        """The shards' ``x`` along ``axis``, concatenated in order along
        ``dim`` (``lax.all_gather(..., tiled=True)``)."""
        self.counts["all_gather"] += 1
        self.counts["bytes"] += _nbytes(x)
        return torch.cat(self._gathered(x, axis), dim=dim)


def run(mesh: Mesh, fn: Callable, args: Sequence[tuple]):
    """``fn(*args[i])`` for every shard i of ``mesh`` at once, each in its
    own thread with its device current (and on a card the caller's current
    stream of that device), :func:`current` its communicator and its kernel
    launches counted for it (``Kernel.by_shard``).  Returns (the results,
    the communicators).  A failing shard breaks the barrier the others wait
    at; the first failure is raised."""
    n = mesh.size
    if len(args) != n:
        raise ValueError(f"{len(args)} argument sets for {n} shards")
    shared = _Shared(n)
    comms = [Communicator(mesh, i, shared) for i in range(n)]
    streams = {d: torch.cuda.current_stream(d) for d in set(mesh.devices) if d.type == "cuda"}
    results: List = [None] * n
    errors: List[Optional[BaseException]] = [None] * n

    def worker(i: int) -> None:
        dev = mesh.devices[i]
        _CURRENT.comm = comms[i]
        _build.set_shard(i)
        try:
            with contextlib.ExitStack() as stack:
                if dev.type == "cuda":
                    stack.enter_context(torch.cuda.device(dev))
                    stack.enter_context(torch.cuda.stream(streams[dev]))
                results[i] = fn(*args[i])
        except BaseException as e:  # noqa: BLE001 - re-raised by the caller below
            errors[i] = e
            shared.barrier.abort()
        finally:
            _CURRENT.comm = None
            _build.set_shard(None)

    threads = [threading.Thread(target=worker, args=(i,), name=f"shard-{i}", daemon=True)
               for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    failed = [e for e in errors if e is not None]
    if failed:
        # a shard's own failure before the broken barriers it caused
        failed.sort(key=lambda e: isinstance(e, threading.BrokenBarrierError))
        raise failed[0]
    return results, comms


# -- sharded states ---------------------------------------------------------------


class ShardedState(NamedTuple):
    """A state split over ``mesh``: ``shards[i]`` is shard i's local state
    (its part of u, v, dye and pressure; the scalars and ``vel_stats``
    replicated)."""

    mesh: Mesh
    shards: Tuple[FluidState, ...]


def _split(shape_hw, mesh: Mesh):
    """Per shard, the (row slice, column slice) of an (H, W) grid."""
    h, w = shape_hw
    nr = mesh.dims[0]
    nc = mesh.dims[1] if len(mesh.dims) > 1 else 1
    if h % nr or w % nc:
        raise ValueError(f"grid {w}x{h} not divisible by mesh {nr}x{nc}")
    hl, wl = h // nr, w // nc
    out = []
    for i in range(mesh.size):
        c = mesh.coords(i)
        r, k = c[0], (c[1] if len(c) > 1 else 0)
        out.append((slice(r * hl, (r + 1) * hl), slice(k * wl, (k + 1) * wl)))
    return out


def _local(t: torch.Tensor, rows: slice, cols: slice, device) -> torch.Tensor:
    part = t[..., rows, cols]
    out = torch.empty(part.shape, dtype=t.dtype, device=device)
    return out.copy_(part)


def shard_state(state: FluidState, mesh: Mesh) -> ShardedState:
    """Split ``state`` over ``mesh``: rows over its first axis, columns over
    its second (a 2-D mesh); each shard's fields are contiguous copies on
    its device, the scalars are shared and ``vel_stats`` is copied to
    every shard's device."""
    parts = _split(tuple(state.u.shape), mesh)
    shards = []
    for i, (rows, cols) in enumerate(parts):
        dev = mesh.devices[i]
        local = {name: _local(getattr(state, name), rows, cols, dev) for name in FIELDS}
        local["vel_stats"] = state.vel_stats.to(dev, copy=True)
        shards.append(state._replace(**local))
    return ShardedState(mesh, tuple(shards))


def shard_state_2d(state: FluidState, mesh: Mesh) -> ShardedState:
    """:func:`shard_state` over a (rows, cols) mesh."""
    if len(mesh.dims) != 2:
        raise ValueError(f"expected a (rows, cols) mesh, got {mesh}")
    return shard_state(state, mesh)


def gather_state(sharded: ShardedState, device=None) -> FluidState:
    """The whole state of ``sharded`` on ``device`` (default shard 0's):
    its fields put back together, its scalars and ``vel_stats`` shard 0's
    (replicated)."""
    mesh, shards = sharded
    device = torch.device(device) if device is not None else mesh.devices[0]
    nr = mesh.dims[0]
    nc = mesh.dims[1] if len(mesh.dims) > 1 else 1
    whole = {}
    for name in FIELDS:
        rows = []
        for r in range(nr):
            cols = [getattr(shards[r * nc + k], name).to(device) for k in range(nc)]
            rows.append(torch.cat(cols, dim=-1))
        whole[name] = torch.cat(rows, dim=-2)
    whole["vel_stats"] = shards[0].vel_stats.to(device)
    return shards[0]._replace(**whole)
