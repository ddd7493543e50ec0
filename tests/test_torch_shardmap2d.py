"""The port's sharded rollout on a 2 x 4 (rows x cols) mesh against the
JAX package's 2-D shard_map step (8 CPU shards, 8 virtual CPU devices).

The same numpy-made state through both; fields within 1e-5 of scale over
at most 4 steps, scalars exact (see tests/test_torch_shardmap.py).  Both
bound advection taps by the halo in both axes (H1/H8 with ``x0``,
``w_phys`` and ``d_x = d``; JAX's flat kernel, which its 2-D mesh pins).
Also the exchange pairs a step against JAX's, the V-cycle counts of the
residual-targeted multigrid, the gathered bottom levels and the geometry
errors.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudafluidsimulation_tpu import FluidConfig as JConfig
from cudafluidsimulation_tpu.ops import multigrid as jmg

import shard_pairs as sp
from cudafluidsimulation_tpu_torch import FluidConfig, interop
from cudafluidsimulation_tpu_torch.ops import multigrid as tmg
from cudafluidsimulation_tpu_torch.parallel import halo, mesh as tmesh, shardmap2d as tss2
from cudafluidsimulation_tpu_torch.parallel import shardmap_step as tss
from test_torch_shardmap import jax_tol_tests, port_tol_tests

torch.set_num_threads(1)


def mild(**kw):
    base = dict(nx=128, ny=128, backend="ref", diffusion_iters=4, pressure_iters=10,
                vorticity=0.5, force_scale=500.0)
    base.update(kw)
    return JConfig.gpu_reference(**base)


def pallas(**kw):
    """The dry run's cfg2p geometry: 256 x 128 over 2 x 4, d 8, bursts of 4."""
    base = dict(nx=256, backend="pallas", max_displacement=8, diffusion_iters=4,
                pressure_iters=8, jacobi_burst=4)
    base.update(kw)
    return mild(**base)


CASES = {
    "gpu-ref": (mild(), 4),
    "cpu-ref": (JConfig.cpu_reference(nx=128, ny=128, backend="ref", vorticity=0.5), 3),
    "gpu-kernels": (pallas(), 3),
    "cpu-kernels": (JConfig.cpu_reference(nx=256, ny=128, backend="pallas",
                                          max_displacement=8, jacobi_burst=4), 2),
    "fast-all": (pallas(fast_velocity=True, fast_dye=True, fast_diffuse=True,
                        diffusion_iters=20), 2),
    "mg-fixed-ref": (mild(pressure_solver="multigrid", mg_cycles=2, diffusion_iters=3), 2),
    "mg-fixed-kernels": (pallas(pressure_solver="multigrid", mg_cycles=2), 2),
}


@pytest.mark.parametrize("name", list(CASES))
def test_step_matches_jax(name):
    jcfg, steps = CASES[name]
    if jcfg.backend == "pallas":
        sp.assert_jax_runs_pallas(jcfg, "2d")
    arrays = sp.numpy_state(jcfg)
    exp = sp.jax_run(jcfg, "2d", arrays, steps)
    got, _ = sp.port_run(jcfg, "2d", arrays, steps)
    sp.assert_close(got, exp, what=name)


@pytest.mark.parametrize("backend", ["ref", "pallas"])
def test_rollout_matches_jax(backend):
    jcfg = mild() if backend == "ref" else pallas()
    arrays = sp.numpy_state(jcfg, seed=1)
    exp = sp.jax_run(jcfg, "2d", arrays, 3, rollout=True)
    got, _ = sp.port_run(jcfg, "2d", arrays, 3, rollout=True)
    sp.assert_close(got, exp, what=backend)


@pytest.mark.parametrize("backend", ["ref", "pallas"])
def test_multigrid_tol_matches_jax_and_its_vcycles(monkeypatch, backend):
    jcfg = (mild if backend == "ref" else pallas)(
        pressure_solver="multigrid", mg_tol=0.05, mg_max_cycles=6, diffusion_iters=3)
    arrays = sp.numpy_state(jcfg, seed=5)
    exp, jax_tests = jax_tol_tests(monkeypatch, jcfg, "2d", arrays, 2)
    got, tests = port_tol_tests(jcfg, "2d", arrays, 2)
    sp.assert_close(got, exp, rtol=1e-4, what="mg tol")
    assert tests == jax_tests and min(tests) >= 2, (tests, jax_tests)


def test_multigrid_gathers_the_levels_below_the_shards():
    # tests/test_shardmap2d.py's geometry: 1088² over 4 x 2, both shard
    # extents stop halving before the global level count
    ny = nx = 1088
    hl, wl = ny // 4, nx // 2
    assert min(tmg.local_levels(hl), tmg.local_levels(wl)) < tmg._levels(ny, nx)
    div = np.random.default_rng(0).standard_normal((ny, nx)).astype(np.float32)
    exp = np.asarray(jmg.pressure_solve_mg(jnp.asarray(div), cycles=1))
    mesh = tmesh.make_mesh2d(4, 2, devices=["cpu"] * 8)
    ns = tss2.sharded_ops_2d("rows", "cols", ny, nx, 15)
    parts = [(torch.from_numpy(div[r * hl:(r + 1) * hl, c * wl:(c + 1) * wl].copy()),)
             for r in range(4) for c in range(2)]
    out, comms = tmesh.run(mesh, lambda dd: ns.pressure_solve_mg(dd, 1), parts)
    got = torch.cat([torch.cat(out[r * 2:(r + 1) * 2], dim=1) for r in range(4)]).numpy()
    np.testing.assert_allclose(got, exp, rtol=0, atol=1e-5 * max(np.abs(exp).max(), 1.0))
    assert comms[0].counts["all_gather"] > 0


def _step_pairs_jax(jcfg):
    jaxpr = sp.jax_step_jaxpr(jcfg, "2d")
    if jcfg.backend == "pallas":
        assert "pallas_call" in str(jaxpr)
    return sp.count_ppermute(jaxpr.jaxpr) // 2


def _step_pairs_port(jcfg):
    return halo.measure_halo_traffic(interop.config_from_jax(jcfg), sp.port_mesh("2d"),
                                     step_builder=tss2.make_shardmap2d_step)[
        "exchange_pairs_per_step"]


@pytest.mark.parametrize("fast", [False, True])
def test_fast_diffuse_exchange_schedule(fast):
    # 64 x 64 shards: JAX's Pallas advection takes them (flat_supported)
    jcfg = pallas(diffusion_iters=20, max_displacement=15, jacobi_burst=8,
                  fast_diffuse=fast)
    assert _step_pairs_port(jcfg) == _step_pairs_jax(jcfg)


def test_dry_run_schedule_pinned():
    # __graft_entry__.dryrun_multichip's cfg2p at 8 devices: 10 pairs a step
    assert _step_pairs_port(pallas()) == _step_pairs_jax(pallas()) == 10


def test_ref_schedule_pairs_like_jax():
    assert _step_pairs_port(mild()) == _step_pairs_jax(mild())


def test_geometry_errors_keep_jax_messages():
    mesh = sp.port_mesh("2d")
    with pytest.raises(ValueError, match="not divisible"):
        tss2.make_shardmap2d_step(FluidConfig.gpu_reference(nx=130, ny=128, backend="ref"),
                                  mesh)
    with pytest.raises(ValueError, match="max_displacement"):
        tss2.make_shardmap2d_step(FluidConfig.gpu_reference(nx=48, ny=128, backend="ref"),
                                  mesh)
    with pytest.raises(ValueError, match="need 8 devices, have 4"):
        tmesh.make_mesh2d(2, 4, devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="rows, cols"):
        tmesh.shard_state_2d(None, tmesh.make_mesh(2, devices=["cpu"] * 2))


def test_kernel_schedule_is_the_kernels():
    # a cuda config on CPU shards runs the kernel wrappers (their plain
    # versions): the kernel schedule's exchanges, not the ref one's
    cfg = interop.config_from_jax(pallas())
    ns = tss2._local_ops_2d(cfg, sp.port_mesh("2d"), kernels=tss.KERNELS)
    assert ns.pressure_project.__closure__ is not None
    assert _step_pairs_port(pallas()) < _step_pairs_port(pallas(backend="ref"))
