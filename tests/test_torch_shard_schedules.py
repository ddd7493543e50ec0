"""The sharded rollout's exchange schedules on the rows mesh against the
JAX package's, counted.

JAX's count is its jaxpr's ``ppermute`` equations / 2 (``__graft_entry__``
counts them so); the port's is its communicators' exchange pairs
(``halo.measure_halo_traffic``: one step on the meta device, shape-only, so
8192² costs no memory).  The configurations are those of
tests/test_fused_pressure_sharded.py::test_fused_exchange_schedule,
tests/test_shardmap.py::test_halo_traffic_accounting,
tests/test_shardmap_mg.py::test_sharded_mg_exchange_schedule_pinned,
tests/test_sharded_fastmodes.py::test_fast_diffuse_cuts_exchange_schedule
and the dry run's cfg1p.  The JAX steps must really hold their Pallas
kernels (``pallas_call`` in the jaxpr).
"""

import jax
import jax.numpy as jnp
import pytest
import torch

from cudafluidsimulation_tpu import FluidConfig as JConfig
from cudafluidsimulation_tpu.parallel import shardmap_step as jss
from cudafluidsimulation_tpu.parallel.halo import measure_halo_traffic as jmeasure

import shard_pairs as sp
from cudafluidsimulation_tpu_torch import FluidConfig, interop
from cudafluidsimulation_tpu_torch.parallel import halo, mesh as tmesh, shardmap_step as tss
from test_torch_shardmap import mild

torch.set_num_threads(1)


def _jax_pairs(fn, *args):
    return sp.count_ppermute(jax.make_jaxpr(fn)(*args).jaxpr) // 2


@pytest.mark.parametrize("iters,pairs", [(5, 1), (8, 1), (9, 2), (30, 4)])
def test_fused_exchange_schedule(iters, pairs):
    # tests/test_fused_pressure_sharded.py's projection alone: 128², d 15,
    # bursts of 8
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    ns = jss.sharded_ops("x", 128, 15, use_pallas=True, pallas_burst=8)
    fn = shard_map(lambda uu, vv: ns.pressure_project(uu, vv, iters, True),
                   mesh=sp.jax_mesh("rows"), in_specs=(P("x", None), P("x", None)),
                   out_specs=(P("x", None),) * 3, check_vma=False)
    sds = jax.ShapeDtypeStruct((128, 128), jnp.float32)
    assert _jax_pairs(fn, sds, sds) == pairs
    tns = tss.sharded_ops("x", 128, 15, use_kernels=True, burst=8)
    mesh = sp.port_mesh("rows")
    u = torch.zeros(16, 128)
    _, comms = tmesh.run(mesh, lambda a, b: tns.pressure_project(a, b, iters, True),
                         [(u, u)] * 8)
    assert comms[0].counts["exchanges"] == pairs


def test_halo_traffic_pinned_like_jax():
    # tests/test_shardmap.py's pins at 8192², 100 sweeps: 124 pairs on the
    # sweep-by-sweep schedule, 18 on the burst schedule
    mesh = sp.port_mesh("rows")
    ref = halo.measure_halo_traffic(FluidConfig.gpu_reference(
        nx=8192, ny=8192, pressure_iters=100, backend="ref"), mesh)
    kern = halo.measure_halo_traffic(FluidConfig.gpu_reference(
        nx=8192, ny=8192, pressure_iters=100, backend="cuda"), mesh)
    assert ref["exchange_pairs_per_step"] == 124
    assert kern["exchange_pairs_per_step"] == 18
    jmesh = sp.jax_mesh("rows")
    jref = jmeasure(JConfig.gpu_reference(nx=8192, ny=8192, pressure_iters=100,
                                          backend="ref"), jmesh)
    jkern = jmeasure(JConfig.gpu_reference(nx=8192, ny=8192, pressure_iters=100,
                                           backend="pallas"), jmesh)
    for got, exp in ((ref, jref), (kern, jkern)):
        for key in ("exchange_pairs_per_step", "all_gather_per_step",
                    "ici_bytes_per_step_per_device", "jacobi_sweeps_per_step"):
            assert got[key] == exp[key], key


def test_multigrid_exchange_schedule_pinned_like_jax():
    # tests/test_shardmap_mg.py: 55 pairs, no gather, at 8192², 2 V-cycles
    cfg = dict(nx=8192, ny=8192, pressure_iters=100, pressure_solver="multigrid",
               mg_cycles=2)
    got = halo.measure_halo_traffic(FluidConfig.gpu_reference(backend="cuda", **cfg),
                                    sp.port_mesh("rows"))
    exp = jmeasure(JConfig.gpu_reference(backend="pallas", **cfg), sp.jax_mesh("rows"))
    assert got["exchange_pairs_per_step"] == exp["exchange_pairs_per_step"] == 55
    assert got["all_gather_per_step"] == exp["all_gather_per_step"] == 0


def _step_pairs_jax(jcfg):
    jaxpr = sp.jax_step_jaxpr(jcfg, "rows")
    if jcfg.backend == "pallas":
        assert "pallas_call" in str(jaxpr)
    return sp.count_ppermute(jaxpr.jaxpr) // 2


def _step_pairs_port(jcfg):
    cfg = interop.config_from_jax(jcfg)
    return halo.measure_halo_traffic(cfg, sp.port_mesh("rows"))["exchange_pairs_per_step"]


@pytest.mark.parametrize("fast", [False, True])
def test_fast_diffuse_exchange_schedule(fast):
    # tests/test_sharded_fastmodes.py: 20 sweeps, d 15; the fast diffusion
    # swaps the bursts' exchanges for one
    jcfg = mild(backend="pallas", diffusion_iters=20, pressure_iters=8,
                max_displacement=15, fast_diffuse=fast)
    assert _step_pairs_port(jcfg) == _step_pairs_jax(jcfg)


def test_dry_run_schedules_pinned():
    # __graft_entry__.dryrun_multichip's cfg1p at 8 devices: 5 pairs a step
    jcfg = JConfig.gpu_reference(nx=128, ny=256, backend="pallas", max_displacement=8,
                                 diffusion_iters=4, pressure_iters=8, jacobi_burst=4)
    assert _step_pairs_port(jcfg) == _step_pairs_jax(jcfg) == 5
