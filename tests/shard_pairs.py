"""The sharded-rollout tests' common pieces: one numpy-made state through
the JAX package's shard_map step (8 virtual CPU devices, tests/conftest.py)
and through the port's lockstep step on 8 CPU shards.

Configurations are written as JAX ``FluidConfig``s and carried to the port
with ``interop.config_from_jax`` (``pallas`` -> ``cuda``); a ``cuda`` config
runs the port's kernel schedule on CPU shards (``shardmap_step.KERNELS``,
whose wrappers take the plain versions for CPU tensors), as the JAX
``pallas`` one runs its Pallas kernels in interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from cudafluidsimulation_tpu.parallel import shardmap2d as jss2
from cudafluidsimulation_tpu.parallel import shardmap_step as jss
from cudafluidsimulation_tpu.parallel.sharded import make_mesh as jmake_mesh
from cudafluidsimulation_tpu.parallel.sharded import shard_state as jshard_state
from cudafluidsimulation_tpu.state import FluidState as JState
from cudafluidsimulation_tpu.utils.impulse import Impulse as JImpulse

from cudafluidsimulation_tpu_torch import interop
from cudafluidsimulation_tpu_torch.parallel import mesh as tmesh
from cudafluidsimulation_tpu_torch.parallel import shardmap2d as tss2
from cudafluidsimulation_tpu_torch.parallel import shardmap_step as tss
from cudafluidsimulation_tpu_torch.utils import impulse as timp

RTOL = 1e-5  # of each field's largest magnitude (at least 1)
FIELDS = ("u", "v", "dye", "pressure", "vel_stats")
SCALARS = ("t", "press_time", "time_since_press", "mouse", "step")
MESH2D = (2, 4)


def numpy_state(cfg, seed=0, speed=20.0):
    """A driven state made by numpy from ``seed``: smooth swirls plus noise
    in the velocity (|v| * dt well under a cell), dye in [0, 1)."""
    rng = np.random.default_rng(seed)
    h, w = cfg.ny, cfg.nx
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    ph = rng.uniform(0, 2 * np.pi, 4)
    u = speed * (np.sin(2 * np.pi * y / h * 2 + ph[0]) * np.cos(2 * np.pi * x / w + ph[1])
                 + 0.2 * rng.standard_normal((h, w)))
    v = speed * (np.cos(2 * np.pi * x / w * 3 + ph[2]) * np.sin(2 * np.pi * y / h + ph[3])
                 + 0.2 * rng.standard_normal((h, w)))
    u, v = u.astype(np.float32), v.astype(np.float32)
    return {
        "u": u, "v": v,
        "dye": rng.uniform(0.0, 1.0, (3, h, w)).astype(np.float32),
        "pressure": np.zeros((h, w), np.float32),
        "t": np.float32(0.0), "press_time": np.float32(0.0),
        "time_since_press": np.float32(1e9), "mouse": np.zeros(2, np.float32),
        "step": np.int32(0),
        "vel_stats": np.asarray([np.abs(u).max(), np.abs(v).max()], np.float32),
    }


def impulses(cfg, steps):
    """The port's orbit stream around the grid's centre, and the same
    numbers as a JAX ``Impulse``."""
    t = timp.orbit_impulse(steps, cfg.dt, center=(cfg.nx / 2.0, cfg.ny / 2.0),
                           radius=min(cfg.nx, cfg.ny) / 4.0)
    return t, JImpulse(*(jnp.asarray(f.numpy()) for f in t))


def jax_mesh(kind):
    if kind == "rows":
        return jmake_mesh(8, ens=1)
    return jss2.make_mesh2d(*MESH2D)


def port_mesh(kind):
    if kind == "rows":
        return tmesh.make_mesh(8, devices=["cpu"] * 8)
    return tmesh.make_mesh2d(*MESH2D, devices=["cpu"] * 8)


def jax_run(jcfg, kind, arrays, steps, rollout=False, after_step=None):
    """The JAX package's sharded step (or rollout) from ``arrays``: the
    final state's arrays; ``after_step(i)`` is called after step i (steps
    only)."""
    mesh = jax_mesh(kind)
    state = JState(**{k: jnp.asarray(a) for k, a in arrays.items()})
    if kind == "rows":
        state = jshard_state(state, mesh)
        make = jss.make_shardmap_rollout if rollout else jss.make_shardmap_step
    else:
        state = jss2.shard_state_2d(state, mesh)
        make = jss2.make_shardmap2d_rollout if rollout else jss2.make_shardmap2d_step
    _, jimp = impulses(jcfg, steps)
    fn = make(jcfg, mesh)
    if rollout:
        state = fn(state, jimp)
    else:
        for i in range(steps):
            state = fn(state, JImpulse(*(f[i] for f in jimp)))
            if after_step is not None:
                jax.block_until_ready(state)
                after_step(i)
    return {k: np.asarray(x) for k, x in state._asdict().items()}


def jax_step_jaxpr(jcfg, kind):
    """The jaxpr of the JAX package's sharded step on a zero state."""
    from cudafluidsimulation_tpu import init_state
    from cudafluidsimulation_tpu.utils.impulse import single

    mesh = jax_mesh(kind)
    if kind == "rows":
        st, make = jshard_state(init_state(jcfg), mesh), jss.make_shardmap_step
    else:
        st, make = jss2.shard_state_2d(init_state(jcfg), mesh), jss2.make_shardmap2d_step
    imp = single((jcfg.nx / 2.0, jcfg.ny / 2.0), (jcfg.nx / 2.0 - 4.0, jcfg.ny / 2.0 - 2.0),
                 True, jcfg.dt)
    return jax.make_jaxpr(make(jcfg, mesh))(st, imp)


def assert_jax_runs_pallas(jcfg, kind):
    """The JAX step really runs its Pallas kernels: its geometry gate did
    not fall back to the ref ops (``__graft_entry__.py``'s check)."""
    assert "pallas_call" in str(jax_step_jaxpr(jcfg, kind))


def port_step_fn(cfg, kind, rollout=False):
    """The port's sharded step or rollout for ``cfg`` over 8 CPU shards (the
    kernel schedule for a ``cuda`` config)."""
    kernels = tss.KERNELS if cfg.backend == "cuda" else None
    mesh = port_mesh(kind)
    if kind == "rows":
        make = tss.make_shardmap_rollout if rollout else tss.make_shardmap_step
        return make(cfg, mesh, kernels=kernels), mesh
    make = tss2.make_shardmap2d_rollout if rollout else tss2.make_shardmap2d_step
    return make(cfg, mesh, kernels=kernels), mesh


def port_run(jcfg, kind, arrays, steps, rollout=False, after_step=None):
    """The port's sharded run from ``arrays``: (the final state's arrays,
    the step's communicator counts of its last call, per shard);
    ``after_step(i, counts)`` is called after step i (steps only)."""
    cfg = interop.config_from_jax(jcfg)
    fn, mesh = port_step_fn(cfg, kind, rollout)
    state = tmesh.shard_state(interop.state_from_numpy(arrays), mesh)
    stream, _ = impulses(cfg, steps)
    if rollout:
        state = fn(state, stream)
    else:
        for i in range(steps):
            state = fn(state, timp.slice_step(stream, i))
            if after_step is not None:
                after_step(i, fn.counts)
    return interop.state_to_numpy(tmesh.gather_state(state)), fn.counts


def assert_close(got, exp, rtol=RTOL, what=""):
    for name in FIELDS:
        scale = max(float(np.abs(exp[name]).max()), 1.0)
        np.testing.assert_allclose(got[name], exp[name], rtol=0, atol=rtol * scale,
                                   err_msg=f"{what} {name}")
    for name in SCALARS:
        np.testing.assert_array_equal(got[name], exp[name], err_msg=f"{what} {name}")


def count_ppermute(jaxpr) -> int:
    """``ppermute`` equations of a jaxpr, scan bodies times their length
    (``__graft_entry__._count_ppermute``)."""
    n = 0
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "ppermute":
            n += 1
        m = eqn.params.get("length", 1) if eqn.primitive.name == "scan" else 1
        for p in eqn.params.values():
            for sub in (p if isinstance(p, (list, tuple)) else [p]):
                if hasattr(sub, "eqns"):
                    n += m * count_ppermute(sub)
                elif hasattr(sub, "jaxpr"):
                    n += m * count_ppermute(sub.jaxpr)
    return n



# -- one op of the shard-local namespaces -----------------------------------------

DT = np.float32(1 / 60)
CUR, LAST = np.asarray([70.0, 40.0], np.float32), np.asarray([66.0, 43.0], np.float32)
COLOR = np.asarray([1.0, 0.5, 0.3], np.float32)

# op -> fn(ns, x): x the (6, h, w) local stack u, v, dye (3), p; returns a
# stack of the op's row (and column) sharded outputs
NAMESPACE_OPS = {
    "advect_velocity": lambda ns, st, x: st(list(ns.advect_velocity(x[0], x[1], DT, 1.2))),
    "advect_dye": lambda ns, st, x: ns.advect_dye(x[2:5], x[0], x[1], DT, 1.2),
    "curl": lambda ns, st, x: ns.curl(x[0], x[1])[None],
    "vorticity_gpu": lambda ns, st, x: st(list(ns.vorticity_confinement_gpu(x[0], x[1], DT,
                                                                          50.0))),
    "vorticity_cpu": lambda ns, st, x: st(list(ns.vorticity_confinement_cpu(x[0], x[1], DT,
                                                                          0.35))),
    "diffuse": lambda ns, st, x: ns.diffuse(st([x[0], x[1]]), DT, 0.8, 5),
    "divergence": lambda ns, st, x: ns.divergence(x[0], x[1], True)[None],
    "pressure_solve": lambda ns, st, x: ns.pressure_solve(x[5], 7)[None],
    "project": lambda ns, st, x: st(list(ns.project(x[0], x[1], x[5]))),
    "splat_gpu": lambda ns, st, x: st([*ns.splat_gpu(x[0], x[1], x[2:5], CUR, LAST, DT,
                                                     5000.0, 400.0, COLOR)[:2]]),
    "splat_cpu": lambda ns, st, x: ns.splat_cpu(x[0], x[1], x[2:5], CUR, LAST, DT, 500.0,
                                                10.0, COLOR)[2],
    "boundary_strip": lambda ns, st, x: ns.boundary_strip(x[0], x[1], x[2:5], 11)[2],
    "render_frame": lambda ns, st, x: ns.render_frame(x[2:5], CUR, 0.1, 40.0, True),
}


def namespace_case(kind, op, jns, tns, h, w, seed=0):
    """(port, JAX) outputs of ``NAMESPACE_OPS[op]`` over ``kind``'s mesh on
    one numpy-made (6, h, w) stack: the JAX namespace ``jns`` under
    shard_map, the port's ``tns`` under ``parallel.mesh.run``."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    rng = np.random.default_rng(seed)
    x = np.concatenate([rng.standard_normal((2, h, w)) * 30.0,
                        rng.uniform(0.0, 1.0, (3, h, w)),
                        rng.standard_normal((1, h, w))]).astype(np.float32)
    fn = NAMESPACE_OPS[op]
    spec = P(None, "x", None) if kind == "rows" else P(None, "rows", "cols")
    exp = np.asarray(shard_map(lambda a: fn(jns, jnp.stack, a), mesh=jax_mesh(kind),
                               in_specs=spec, out_specs=spec, check_vma=False)(
        jnp.asarray(x)))
    mesh = port_mesh(kind)
    nr = mesh.dims[0]
    nc = mesh.dims[1] if len(mesh.dims) > 1 else 1
    hl, wl = h // nr, w // nc
    parts = [(torch.from_numpy(x[:, r * hl:(r + 1) * hl, c * wl:(c + 1) * wl].copy()),)
             for r in range(nr) for c in range(nc)]
    out, _ = tmesh.run(mesh, lambda a: fn(tns, torch.stack, a), parts)
    got = torch.cat([torch.cat(out[r * nc:(r + 1) * nc], dim=-1) for r in range(nr)], dim=-2)
    return got.numpy(), exp
