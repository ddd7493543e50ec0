"""Ensembles over cards and the global step over rows: an (ens, x) mesh.

The port of the JAX package's ``parallel/sharded.py``, its plan for many
chips: ensemble members split over the mesh axis ``"ens"`` (pure data
parallelism) and each member's rows over ``"x"``.  JAX states the layout
(``NamedSharding``s on the state) and lets XLA's partitioner compute the
vmapped one-device step over it, so its result is the **global** step:
the single-device step of each member, whatever the mesh, with the
advection unbounded (XLA gathers what the backtrace reads).  PyTorch has
no partitioner, so the port writes that program out, one per shard, run
in lockstep by ``parallel.mesh.run``:

- **x = 1**: a shard holds whole members, its ens group's B/ens of them,
  and steps them with ``models.pipelines.make_batched_step``: one launch a
  stage for the group (batched H1–H4; H7/H8 on the fast flags; H5, H6 and
  ``fluid_mean_square`` on the quality preset).  No collective.
- **x > 1**: each shard holds its rows of its group's members and steps
  them one after another with the rows mesh's namespace
  (``shardmap_step.sharded_ops``) on its group's ``"x"`` axis: H3 on a
  padded shard, H4's solve from ``init``, the plain confinement,
  divergence and projection edges; the advection is the unbounded
  window (``ref.Window.y_in``): each shard gathers the advected planes of
  every row over ``"x"`` and advects its own rows through H1/H8, so no
  ``max_displacement`` applies and the rows mesh's shard-height check does
  not either.

An unbatched state is replicated over ``"ens"`` (JAX's ``P("x", None)``):
each group steps its own copy.  Collectives meet only the shards of their
group, so groups whose members branch differently (a quality member's
V-cycle count) do not wait on each other.

A ``cuda`` config runs the kernels, the ``fast_*`` flags included; JAX's
auto-SPMD step runs its ``ref`` ops on a mesh of more than one device,
which ignore them (``_auto_spmd_config``).  A ``ref`` config runs the plain
ops, as JAX's does.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from cudafluidsimulation_tpu_torch.config import FluidConfig
from cudafluidsimulation_tpu_torch.models.ensemble import run_batched
from cudafluidsimulation_tpu_torch.models.pipelines import make_batched_step, make_step
from cudafluidsimulation_tpu_torch.ops import backend
from cudafluidsimulation_tpu_torch.parallel import mesh as _mesh
from cudafluidsimulation_tpu_torch.parallel import shardmap_step
from cudafluidsimulation_tpu_torch.parallel.mesh import Mesh, ShardedState
from cudafluidsimulation_tpu_torch.state import FluidState
from cudafluidsimulation_tpu_torch.utils.impulse import Impulse


def make_mesh(n_devices: Optional[int] = None, ens: int = 1,
              axis_names: Tuple[str, str] = ("ens", "x"),
              devices: Optional[Sequence] = None) -> Mesh:
    """An (ens, n/ens) mesh: ``"x"`` shards grid rows, ``"ens"`` shards
    independent ensemble members.  Its ``n_devices`` shards (default: one a
    device) go round-robin on ``devices`` (default: the visible cards,
    ``mesh.place``), so several may share a card."""
    devs = list(devices) if devices is not None else _mesh.visible_devices()
    n = n_devices if n_devices is not None else len(devs)
    if n % ens != 0:
        raise ValueError(f"n_devices={n} not divisible by ens={ens}")
    return Mesh(_mesh.place(n, devs), (ens, n // ens), axis_names)


def state_sharding(mesh: Mesh, batched: bool = False) -> FluidState:
    """A FluidState of axis specs (JAX's ``PartitionSpec``s): fields
    row-sharded over "x", scalars replicated, an optional leading ensemble
    axis over "ens"."""
    del mesh  # the specs name the axes, as JAX's do
    e = ("ens",) if batched else ()
    plane = e + ("x", None)
    return FluidState(u=plane, v=plane, dye=e + (None, "x", None), pressure=plane, t=e,
                      press_time=e, time_since_press=e, mouse=e + (None,), step=e,
                      vel_stats=e + (None,))


def impulse_sharding(mesh: Mesh, batched: bool = False, time_axis: bool = True) -> Impulse:
    """An Impulse of axis specs: members over "ens" when ``batched``, the
    time axis (after the members) and the coordinates whole."""
    del mesh
    e = ("ens",) if batched else ()
    t = (None,) if time_axis else ()
    return Impulse(pos=e + t + (None,), last_pos=e + t + (None,), pressed=e + t, dt=e + t)


def shard_state(state: FluidState, mesh: Mesh, batched: bool = False) -> ShardedState:
    """``state`` split over ``mesh`` as :func:`state_sharding` lays it out."""
    return _mesh.shard_state(state, mesh, specs=state_sharding(mesh, batched))


def _ops(config: FluidConfig, kernels, batched: bool):
    """The x = 1 namespace: on the kernel schedule (``shardmap_step``'s
    choice, whatever the backend with ``kernels``) the kernels' own
    (``backend.kernel_ops``), else the config's plain ops."""
    use_kernels, table = shardmap_step._schedule(config, kernels)
    if not use_kernels:
        return backend.get_batched_ops(config) if batched else backend.get_ops(config)
    if table is not shardmap_step.KERNELS:
        raise ValueError("on x = 1 the groups run the batched kernels' namespace: "
                         "kernels= takes shardmap_step.KERNELS or None there")
    return backend.kernel_ops(config, batched)


def _members(step):
    """``step`` of one member, looped over a shard's (B, ...) members."""

    def run(state: FluidState, imp: Impulse) -> FluidState:
        outs = [step(FluidState(*(f[b] for f in state)), Impulse(*(f[b] for f in imp)))
                for b in range(state.u.shape[0])]
        return FluidState(*(torch.stack(fs) for fs in zip(*outs)))

    return run


def _shard_step(config: FluidConfig, mesh: Mesh, batched: bool, kernels):
    """The step each shard runs on its block (see the module docstring)."""
    if "x" not in mesh.shape or "ens" not in mesh.shape:
        raise ValueError(f"expected an (ens, x) mesh, got {mesh}")
    if mesh.shape["x"] == 1:
        ops = _ops(config, kernels, batched)
        return make_batched_step(config, ops) if batched else make_step(config, ops)
    ns = shardmap_step._local_ops(config, mesh, "x", kernels, unbounded=True)
    step = make_step(config, ns)
    return _members(step) if batched else step


def _over_mesh(mesh: Mesh, batched: bool, per_shard, time_axis: bool):
    """``fn(ShardedState, impulse)``: ``per_shard`` on every shard in
    lockstep, each given its members' block of the impulse;
    ``fn.counts`` holds each shard's communicator counts of the last
    call."""
    specs = state_sharding(mesh, batched)
    imp_specs = impulse_sharding(mesh, batched, time_axis)

    def fn(state: ShardedState, imp: Impulse) -> ShardedState:
        if state.mesh.dims != mesh.dims or len(state.shards) != mesh.size:
            raise ValueError(f"state sharded over {state.mesh}, the step over {mesh}")
        have = state.specs if state.specs is not None else _mesh.field_specs(state.mesh)
        if have != specs:
            raise ValueError(f"state laid out as {have}, the step takes {specs} "
                             f"(batched={batched})")
        args = []
        for i, s in enumerate(state.shards):
            coords = mesh.coords(i)
            args.append((s, Impulse(*(_mesh._block(f, spec, mesh, coords) if any(spec) else f
                                      for f, spec in zip(imp, imp_specs)))))
        results, comms = _mesh.run(mesh, per_shard, args)
        fn.counts = [c.counts for c in comms]
        return ShardedState(mesh, tuple(results), specs)

    fn.counts = None
    return fn


def make_sharded_step(config: FluidConfig, mesh: Mesh, batched: bool = False, kernels=None):
    """One global step over an (ens, x) mesh: ``step(ShardedState,
    impulse) -> ShardedState``, the state from :func:`shard_state`.

    With ``batched`` the state carries a leading member axis over "ens"
    (the impulse (B, ...)); each member's result is its single-device step.
    ``kernels`` runs the kernel schedule whatever the backend
    (``shardmap_step.KERNELS``, whose wrappers take their plain versions on
    CPU shards; on x > 1 also ``shardmap_step.PLAIN``)."""
    return _over_mesh(mesh, batched, _shard_step(config, mesh, batched, kernels), False)


def sharded_rollout(config: FluidConfig, mesh: Mesh, batched: bool = False, kernels=None):
    """A whole rollout over an (ens, x) mesh, ``run(ShardedState,
    impulses)``: the impulses (T, ...), or (B, T, ...) with ``batched``;
    every shard steps through the stream in its own thread, meeting its
    group only at the collectives."""
    step = _shard_step(config, mesh, batched, kernels)
    if batched:
        return _over_mesh(mesh, True, lambda s, imps: run_batched(step, s, imps), True)
    return _over_mesh(mesh, False, shardmap_step._rollout(step), True)
