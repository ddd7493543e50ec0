"""The port's entry points: one step of the flagship configuration and its
arguments, and a dry run of the sharded rollout, the counterparts of the
JAX package's ``__graft_entry__.entry`` and ``dryrun_multichip``.

    from cudafluidsimulation_tpu_torch.entry import dryrun_multichip, entry

    step, (state, imp) = entry()        # on the card
    state = step(state, imp)
    dryrun_multichip(4)                 # 4 shards on the visible card(s)
"""

from __future__ import annotations

from cudafluidsimulation_tpu_torch.config import FluidConfig
from cudafluidsimulation_tpu_torch.models.pipelines import make_step
from cudafluidsimulation_tpu_torch.state import init_state
from cudafluidsimulation_tpu_torch.utils.impulse import single


def entry(backend: str = "auto", device=None):
    """(step, (state, impulse)): the gpu-parity stable-fluids step at 512²
    with 40 pressure sweeps, a zero state and one pressed impulse.

    The default ``backend="auto"`` runs the Hopper kernels on the card and
    raises without one; ``backend="ref"`` runs the plain PyTorch ops, on
    the CPU unless ``device`` names another."""
    cfg = FluidConfig.gpu_reference(nx=512, ny=512, pressure_iters=40, backend=backend)
    step = make_step(cfg)
    state = init_state(cfg, device)
    imp = single((256.0, 256.0), (250.0, 252.0), True, cfg.dt)
    return step, (state, imp)


def _ens_x_part(n_devices: int, devices, on_card: bool, out: dict) -> None:
    """The JAX dry run's first part: the batched global step on an (ens, x)
    mesh (ens = 2 for an even count), with the ``ref`` schedule and the
    kernel schedule at the same shapes."""
    import torch

    from cudafluidsimulation_tpu_torch.models.ensemble import batched_state
    from cudafluidsimulation_tpu_torch.ops import advect_cuda, jacobi_cuda
    from cudafluidsimulation_tpu_torch.parallel import mesh as pmesh
    from cudafluidsimulation_tpu_torch.parallel import sharded, shardmap_step
    from cudafluidsimulation_tpu_torch.utils.impulse import Impulse

    ens = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    x = n_devices // ens
    batched = ens > 1
    mesh = sharded.make_mesh(n_devices, ens=ens, devices=devices)
    ny = max(32, 16 * x)
    if x > 1:  # each shard's rows: the window, H3 on a padded shard, H4's solve
        launched = (advect_cuda.WINDOW, jacobi_cuda.DIFFUSE, jacobi_cuda.PRESSURE_SOLVE)
    elif batched:  # each group's members: batched H1-H4
        launched = (advect_cuda.BATCHED, jacobi_cuda.VORTICITY_BATCHED,
                    jacobi_cuda.DIFFUSE_BATCHED, jacobi_cuda.PRESSURE_BATCHED)
    else:
        launched = (advect_cuda.KERNEL, jacobi_cuda.VORTICITY, jacobi_cuda.DIFFUSE,
                    jacobi_cuda.PRESSURE)
    calls: dict = {}
    before = [dict(k.by_shard) for k in launched]
    for backend in ("ref", "cuda"):
        cfg = FluidConfig.gpu_reference(nx=128, ny=ny, backend=backend, diffusion_iters=4,
                                        pressure_iters=8)
        kernels = None
        if backend == "cuda":
            kernels = (_counted(shardmap_step.KERNELS, calls) if x > 1
                       else shardmap_step.KERNELS)
        state = (batched_state(cfg, ens, devices[0]) if batched
                 else init_state(cfg, device=devices[0]))
        imp = single((64.0, ny / 2.0), (60.0, ny / 2.0 - 2.0), True, cfg.dt)
        if batched:
            imp = Impulse(*(torch.stack([f] * ens) for f in imp))
        step = sharded.make_sharded_step(cfg, mesh, batched=batched, kernels=kernels)
        res = pmesh.gather_state(step(sharded.shard_state(state, mesh, batched), imp))
        if tuple(res.u.shape) != ((ens, ny, 128) if batched else (ny, 128)):
            raise AssertionError(f"ens x {backend} step: velocity {tuple(res.u.shape)}")
        if not bool(torch.isfinite(res.u).all()):
            raise AssertionError(f"ens x {backend} step: non-finite velocity")
        out[f"ens x {backend} collectives"] = step.counts[0]
    out["ens x mesh"] = dict(mesh.shape)
    if x > 1:
        out["ens x wrapper calls"] = dict(calls)
        if not {"advect", "diffuse_multi", "pressure_solve"} <= set(calls):
            raise AssertionError(f"ens x kernel step called {sorted(calls)}")
    if on_card:
        by_shard = {f"{k.name} shard {i}": k.by_shard.get(i, 0) - b.get(i, 0)
                    for k, b in zip(launched, before) for i in range(mesh.size)}
        out["ens x launches by shard"] = by_shard
        if min(by_shard.values()) < 1:
            raise AssertionError(f"ens x kernel step: a shard launched no kernel of {by_shard}")


def _counted(kernels, calls: dict):
    """``kernels`` (a sharded kernel table) with each call counted by name."""
    import threading
    import types

    lock = threading.Lock()

    def wrap(name, fn):
        def call(*args, **kw):
            with lock:
                calls[name] = calls.get(name, 0) + 1
            return fn(*args, **kw)

        return call

    return types.SimpleNamespace(**{k: wrap(k, f) for k, f in vars(kernels).items()})


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """One sharded step of each schedule on each mesh, over ``n_devices``
    shards placed round-robin on the visible cards (``device`` names
    another, "cpu" for CPU shards), in the JAX dry run's order: the
    batched global step on the (ens, x) mesh (``parallel.sharded``; ens = 2
    for an even count), the rows mesh and, for an even count of at least
    4, the 2 x n/2 mesh, each with the sweep-by-sweep ``ref`` schedule and
    the kernel schedule, at the JAX dry run's shapes.

    The kernel steps keep their fused exchange schedules, 5 pairs a step on
    the rows mesh and 10 on the 2-D one (the JAX dry run's pins of its
    ``ppermute`` count), and run their kernels: on a card every shard
    launches H1 (window), H3 and H4 (its solve); on the CPU every shard
    calls their wrappers, which run the plain versions.  The (ens, x) step
    launches the same on each shard where x > 1, batched H1-H4 on each
    group where x = 1.  Returns what it counted; raises where a check
    fails."""
    import torch

    from cudafluidsimulation_tpu_torch.ops import advect_cuda, jacobi_cuda
    from cudafluidsimulation_tpu_torch.parallel import mesh as pmesh
    from cudafluidsimulation_tpu_torch.parallel import shardmap2d, shardmap_step

    if device is None:
        devices = pmesh.place(n_devices)
    else:
        devices = pmesh.place(n_devices, [device])
    on_card = devices[0].type == "cuda"
    out = {}
    _ens_x_part(n_devices, devices, on_card, out)
    meshes = {"rows": pmesh.make_mesh(n_devices, devices=devices)}
    if n_devices >= 4 and n_devices % 2 == 0:
        meshes["2d"] = pmesh.make_mesh2d(2, n_devices // 2, devices=devices)
    n = n_devices
    shapes = {  # (nx, ny) of the ref step, of the kernel step
        "rows": ((128, max(32, 16 * n)), (128, max(64, 32 * n))),
        "2d": ((max(64, 32 * (n // 2)), 64), (max(128, 64 * (n // 2)), 128)),
    }
    pinned = {"rows": 5, "2d": 10}
    builders = {"rows": shardmap_step.make_shardmap_step,
                "2d": shardmap2d.make_shardmap2d_step}
    launched = (advect_cuda.WINDOW, jacobi_cuda.DIFFUSE, jacobi_cuda.PRESSURE_SOLVE)
    for kind, mesh in meshes.items():
        (nx, ny), (nxp, nyp) = shapes[kind]
        cfg = FluidConfig.gpu_reference(nx=nx, ny=ny, backend="ref", max_displacement=15,
                                        diffusion_iters=4, pressure_iters=8)
        cfgp = FluidConfig.gpu_reference(nx=nxp, ny=nyp, backend="cuda", max_displacement=8,
                                         diffusion_iters=4, pressure_iters=8, jacobi_burst=4)
        calls: dict = {}
        before = [dict(k.by_shard) for k in launched]
        for c, kernels in ((cfg, None), (cfgp, _counted(shardmap_step.KERNELS, calls))):
            step = builders[kind](c, mesh, kernels=kernels)
            state = pmesh.shard_state(init_state(c, device=devices[0]), mesh)
            imp = single((c.nx / 2.0, c.ny / 2.0), (c.nx / 2.0 - 4.0, c.ny / 2.0 - 2.0),
                         True, c.dt)
            res = pmesh.gather_state(step(state, imp))
            if not bool(torch.isfinite(res.u).all()):
                raise AssertionError(f"{kind} {c.backend} step: non-finite velocity")
            pairs = step.counts[0]["exchanges"]
            out[f"{kind} {c.backend} pairs"] = pairs
        if pairs != pinned[kind]:
            raise AssertionError(f"{kind} kernel step: {pairs} exchange pairs a step, "
                                 f"not {pinned[kind]}")
        out[f"{kind} wrapper calls"] = dict(calls)
        if not {"advect", "diffuse_multi", "pressure_solve"} <= set(calls):
            raise AssertionError(f"{kind} kernel step called {sorted(calls)}")
        if on_card:
            by_shard = {f"{k.name} shard {i}": k.by_shard.get(i, 0) - b.get(i, 0)
                        for k, b in zip(launched, before) for i in range(mesh.size)}
            out[f"{kind} launches by shard"] = by_shard
            if min(by_shard.values()) < 1:
                raise AssertionError(f"{kind} kernel step: a shard launched no kernel of "
                                     f"{by_shard}")
    return out
