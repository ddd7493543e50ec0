"""Device meshes, the shards' communicator and the lockstep runner.

The counterpart of ``jax.sharding.Mesh`` with ``shard_map``: one
controller runs the same per-shard program on every shard, and the
program's collectives (the JAX package's ``ppermute``, ``pmax``, ``psum``,
``all_gather``) are the only contact between shards.

- :class:`Mesh`: ``torch.device``s laid out over named axes: (n,) over
  ``"x"`` (:func:`make_mesh`, the rows mesh), (rows, cols) over ``"rows"``
  and ``"cols"`` (:func:`make_mesh2d`), or (ens, x) over ``"ens"`` and
  ``"x"`` (``parallel.sharded.make_mesh``: ensemble members over ``"ens"``,
  rows over ``"x"``).  A device may appear more than once, as the JAX
  tests' virtual host devices do: several shards then share a card (or
  the CPU), each with its own part of the state.
- :func:`run`: the lockstep runner.  It calls the per-shard function once
  for each shard, in one thread a shard, each with its device current and
  the caller's stream on it, and its own :class:`Communicator`.
- :class:`Communicator` (:func:`current` inside a shard's thread): the axis
  index and size, the neighbour exchange of one halo pair
  (:meth:`Communicator.neighbours`: a device-to-device copy from the neighbour's
  tensor, on its device or another), ``pmax``, ``psum`` (summed in shard
  order, so every shard gets the same bits) and ``all_gather``.  Each call
  meets the other shards of its group (those that differ from it only
  along the collective's axes) at that group's barrier; it counts exchange
  pairs, their bytes and the other collectives, so a schedule can be
  pinned as the JAX tests pin theirs by counting ``ppermute`` in the jaxpr.
- :func:`shard_state`, :func:`shard_state_2d`, :func:`gather_state`: a
  state split over the mesh by axis name (:func:`field_specs`, or the specs
  given: ``parallel.sharded.state_sharding``): u, v, dye and pressure by
  rows over ``"x"`` or ``"rows"`` and by columns over ``"cols"``, a
  batched state's members over ``"ens"``; the rest replicated
  (:class:`ShardedState`), and back into one state.

Every shard of a group runs the same program, so the shards of a group
make the same collectives in the same order; a branch that decides on
data takes data replicated over the group (a ``psum``'d residual, a
``pmax``'d bound).  Groups need not agree with each other: on an (ens, x)
mesh one ens group may run more V-cycles than another.  A barrier gives up
after :data:`BARRIER_TIMEOUT` seconds, so a shard that skips a collective
makes the others raise ``BrokenBarrierError`` instead of hanging.

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

# the fields on the shards' devices; the rest is host state
DEVICE_FIELDS = ("u", "v", "dye", "pressure", "vel_stats")


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


BARRIER_TIMEOUT = 600.0  # seconds a shard waits at a collective before it gives up


class _Group:
    """What the shards of one collective group share: the barrier and two
    sets of slots, used in turn, so that a shard posts into one set while a
    slower one may still read the other (a shard posts again into a set
    only after every shard of the group has passed the barrier of the
    group's collective in between)."""

    def __init__(self, n_members: int, n_shards: int, timeout: float):
        self.barrier = threading.Barrier(n_members, timeout=timeout)
        self.slots = ([None] * n_shards, [None] * n_shards)


class _Shared:
    """What the shards of one :func:`run` share: a :class:`_Group` for each
    set of shards that meets at a collective, made when first used."""

    def __init__(self, n: int, timeout: float):
        self.n, self.timeout = n, timeout
        self._groups = {}
        self._lock = threading.Lock()
        self._aborted = False

    def group(self, members: Tuple[int, ...]) -> _Group:
        with self._lock:
            g = self._groups.get(members)
            if g is None:
                g = self._groups[members] = _Group(len(members), self.n, self.timeout)
                if self._aborted:
                    g.barrier.abort()
            return g

    def abort(self) -> None:
        """Break every barrier, those made later too: no shard waits on."""
        with self._lock:
            self._aborted = True
            for g in self._groups.values():
                g.barrier.abort()


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
        self._turns = {}
        self._groups = {}
        self.counts = {"exchanges": 0, "bytes": 0, "pmax": 0, "psum": 0, "all_gather": 0}

    def axis_index(self, axis: str) -> int:
        return self.coords[self.mesh.axis_names.index(axis)]

    def axis_size(self, axis: str) -> int:
        return self.mesh.shape[axis]

    def _post(self, value, members: Tuple[int, ...]):
        """Publish ``value`` to the group ``members``, wait for all of
        them, return the slots (indexed by shard) they posted into."""
        g = self._shared.group(members)
        turn = self._turns.get(members, 0)
        slots = g.slots[turn % 2]
        slots[self.index] = value
        self._turns[members] = turn + 1
        g.barrier.wait()
        return slots

    def _peer(self, axis: str, offset: int) -> Optional[int]:
        k = self.mesh.axis_names.index(axis)
        c = list(self.coords)
        c[k] += offset
        if not 0 <= c[k] < self.mesh.dims[k]:
            return None
        return self.mesh.index(c)

    def _group(self, axes) -> Tuple[int, ...]:
        """The shards that differ from this one only along ``axes``, in mesh
        order (the members of a collective over ``axes``)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        out = self._groups.get(axes)
        if out is None:
            keep = [k for k, name in enumerate(self.mesh.axis_names) if name not in axes]
            out = self._groups[axes] = tuple(
                i for i in range(self.mesh.size)
                if all(self.mesh.coords(i)[k] == self.coords[k] for k in keep))
        return out

    def neighbours(self, to_lower: torch.Tensor, to_upper: torch.Tensor, axis: str):
        """One exchange pair along ``axis`` (two ``ppermute``s in the JAX
        package): this shard sends ``to_lower`` to the shard before it on the
        axis and ``to_upper`` to the one after it; returns (what the shard
        before sent up, what the shard after sent down), None past a
        physical edge.  The caller copies out of them before its next
        collective."""
        slots = self._post((to_lower, to_upper), self._group(axis))
        lo, hi = self._peer(axis, -1), self._peer(axis, 1)
        self.counts["exchanges"] += 1
        self.counts["bytes"] += _nbytes(to_lower) + _nbytes(to_upper)
        return (None if lo is None else slots[lo][1],
                None if hi is None else slots[hi][0])

    def _gathered(self, x, axes) -> List[torch.Tensor]:
        members = self._group(axes)
        slots = self._post(x, members)
        return [slots[i].to(self.device) for i in members]

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
    the communicators).  A failing shard breaks every barrier, so none of
    the others waits on; a barrier left waiting :data:`BARRIER_TIMEOUT`
    seconds breaks too.  The first failure is
    raised, a shard's own before the broken barriers it caused."""
    n = mesh.size
    if len(args) != n:
        raise ValueError(f"{len(args)} argument sets for {n} shards")
    shared = _Shared(n, BARRIER_TIMEOUT)
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
            shared.abort()
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
    """A state split over ``mesh``: ``shards[i]`` is shard i's local state,
    its block of each field as ``specs`` lays the fields out
    (:func:`field_specs`; None: the unbatched layout of ``mesh``)."""

    mesh: Mesh
    shards: Tuple[FluidState, ...]
    specs: Optional[FluidState] = None


ROW_AXES = ("x", "rows")  # the axis names that split grid rows


def field_specs(mesh: Mesh) -> FluidState:
    """Each field's layout over ``mesh``, a ``PartitionSpec``-like tuple
    per field (an axis name or None per dimension): rows over ``"x"`` or
    ``"rows"``, columns over ``"cols"`` where the mesh has them.  What no
    axis splits is replicated (a batched layout:
    ``parallel.sharded.state_sharding``)."""
    rows = next((a for a in ROW_AXES if a in mesh.shape), None)
    cols = "cols" if "cols" in mesh.shape else None
    plane = (rows, cols)
    return FluidState(u=plane, v=plane, dye=(None, rows, cols), pressure=plane, t=(),
                      press_time=(), time_since_press=(), mouse=(None,), step=(),
                      vel_stats=(None,))


def _block(t: torch.Tensor, spec, mesh: Mesh, coords) -> torch.Tensor:
    """The block of ``t`` that the shard at ``coords`` holds under ``spec``."""
    if len(spec) != t.dim():
        raise ValueError(f"spec {spec} for a tensor of shape {tuple(t.shape)}")
    index = []
    for dim, axis in enumerate(spec):
        if axis is None:
            index.append(slice(None))
            continue
        if axis not in mesh.shape:
            raise ValueError(f"spec {spec} names an axis {axis!r} that {mesh} lacks")
        n = mesh.shape[axis]
        if t.shape[dim] % n:
            raise ValueError(f"dimension {dim} of {tuple(t.shape)} not divisible by mesh "
                             f"axis {axis!r} of {n}")
        b = t.shape[dim] // n
        c = coords[mesh.axis_names.index(axis)]
        index.append(slice(c * b, (c + 1) * b))
    return t[tuple(index)]


def _local(part: torch.Tensor, device) -> torch.Tensor:
    out = torch.empty(part.shape, dtype=part.dtype, device=device)
    return out.copy_(part)


def shard_state(state: FluidState, mesh: Mesh,
                specs: Optional[FluidState] = None) -> ShardedState:
    """Split ``state`` over ``mesh`` as ``specs`` (default
    :func:`field_specs`) lays it out.  Each shard's u, v, dye, pressure
    and ``vel_stats`` are contiguous copies on its device; its host fields
    are views of the state's (the state's own where nothing splits them)."""
    specs = field_specs(mesh) if specs is None else specs
    shards = []
    for i in range(mesh.size):
        coords, dev = mesh.coords(i), mesh.devices[i]
        local = {}
        for name in FluidState._fields:
            t, spec = getattr(state, name), getattr(specs, name)
            part = _block(t, spec, mesh, coords) if any(spec) else t
            local[name] = _local(part, dev) if name in DEVICE_FIELDS else part
        shards.append(FluidState(**local))
    return ShardedState(mesh, tuple(shards), specs)


def shard_state_2d(state: FluidState, mesh: Mesh) -> ShardedState:
    """:func:`shard_state` over a (rows, cols) mesh."""
    if mesh.axis_names != ("rows", "cols"):
        raise ValueError(f"expected a (rows, cols) mesh, got {mesh}")
    return shard_state(state, mesh)


def _assemble(get, spec, mesh: Mesh, device) -> torch.Tensor:
    """One whole tensor from the shards' blocks (``get(i)``: shard i's):
    the dimensions ``spec`` splits concatenated in axis order, the axes it
    does not name read at index 0; on ``device`` unless None."""

    def build(coords, dim):
        while dim < len(spec) and spec[dim] is None:
            dim += 1
        if dim == len(spec):
            t = get(mesh.index(coords))
            return t if device is None else t.to(device)
        k = mesh.axis_names.index(spec[dim])
        parts = []
        for c in range(mesh.dims[k]):
            coords = list(coords)
            coords[k] = c
            parts.append(build(coords, dim + 1))
        return torch.cat(parts, dim=dim)

    return build([0] * len(mesh.dims), 0)


def gather_state(sharded: ShardedState, device=None) -> FluidState:
    """The whole state of ``sharded``: its device fields put back together
    on ``device`` (default shard 0's), its host fields on the host; what
    the layout replicates is read from the first shard that holds it."""
    mesh, shards = sharded.mesh, sharded.shards
    specs = sharded.specs if sharded.specs is not None else field_specs(mesh)
    device = torch.device(device) if device is not None else mesh.devices[0]
    whole = {}
    for name in FluidState._fields:
        spec = getattr(specs, name)
        whole[name] = _assemble(lambda i: getattr(shards[i], name), spec, mesh,
                                device if name in DEVICE_FIELDS else None)
    return FluidState(**whole)
