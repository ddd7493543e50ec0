"""The port's sharded rollout on the rows mesh against the JAX package's
shard_map step, on 8 CPU shards and 8 virtual CPU devices.

The same numpy-made state (``shard_pairs.numpy_state``) goes through both
(``interop``); fields agree within 1e-5 of each field's largest magnitude
over at most 4 steps, the scalars exactly.  The JAX ``ref`` path equals the
port's to float32 rounding; the ``pallas`` path runs its Pallas kernels in
interpret mode (the jaxpr holds ``pallas_call``, so no silent fallback to
its ref ops passes), against the port's kernel schedule (``cuda``) on CPU
shards, whose wrappers run their plain versions.  The JAX rows mesh bounds
horizontal taps only where its column-tiled advection engages; at the
shapes here ``advect_pallas._tile_plan`` is None (asserted), so both
backtrace rows without a bound.  Also: the exchange pairs a step against
the JAX jaxpr's ``ppermute`` count / 2, the V-cycle counts of the
residual-targeted multigrid, and the geometry errors.
"""

import jax
import numpy as np
import pytest
import torch

from cudafluidsimulation_tpu import FluidConfig as JConfig
from cudafluidsimulation_tpu.ops import advect_pallas
from cudafluidsimulation_tpu.ops import multigrid as jmg

import shard_pairs as sp
from cudafluidsimulation_tpu_torch import FluidConfig, Simulation, interop
from cudafluidsimulation_tpu_torch.parallel import mesh as tmesh, shardmap_step as tss
from cudafluidsimulation_tpu_torch.utils import impulse as timp

torch.set_num_threads(1)


def mild(**kw):
    """tests/test_shardmap.py's mild_cfg: 128², 8 shards of 16 rows."""
    base = dict(nx=128, ny=128, backend="ref", diffusion_iters=5, pressure_iters=10,
                vorticity=0.5, force_scale=500.0)
    base.update(kw)
    return JConfig.gpu_reference(**base)


def pallas(**kw):
    """The dry run's cfg1p geometry at 128²: d = 8, bursts of 4."""
    base = dict(backend="pallas", max_displacement=8, diffusion_iters=4, pressure_iters=8,
                jacobi_burst=4)
    base.update(kw)
    return mild(**base)


def _assert_flat_advect(jcfg, hl):
    # the JAX rows mesh's advect stays on its flat kernel (x unbounded)
    for c in (2, 3):
        assert advect_pallas._tile_plan(hl + 2 * jcfg.max_displacement, jcfg.nx, c,
                                        jcfg.max_displacement) is None


CASES = {
    "gpu-ref": (mild(), 4),
    "cpu-ref": (JConfig.cpu_reference(nx=128, ny=128, backend="ref"), 4),
    "gpu-kernels": (pallas(), 3),
    "cpu-kernels": (JConfig.cpu_reference(nx=128, ny=128, backend="pallas",
                                          max_displacement=8, jacobi_burst=4), 2),
    "gpu-kernels-short-shards": (pallas(pressure_iters=30, jacobi_burst=30), 2),
    "fast-vel": (pallas(fast_velocity=True), 2),
    "fast-dye": (pallas(fast_dye=True), 2),
    "fast-diffuse": (pallas(diffusion_iters=20, fast_diffuse=True), 2),
    "mg-fixed-ref": (mild(pressure_solver="multigrid", mg_cycles=2, diffusion_iters=3), 2),
    "mg-fixed-kernels": (pallas(pressure_solver="multigrid", mg_cycles=2), 2),
}


@pytest.mark.parametrize("name", list(CASES))
def test_step_matches_jax(name):
    jcfg, steps = CASES[name]
    if jcfg.backend == "pallas":
        sp.assert_jax_runs_pallas(jcfg, "rows")
        _assert_flat_advect(jcfg, jcfg.ny // 8)
        if jcfg.fast_velocity or jcfg.fast_dye:
            # JAX packs the taps only with every channel in one program
            hd = advect_pallas._halo(jcfg.max_displacement)
            hl = jcfg.ny // 8 + 2 * jcfg.max_displacement
            for c in (2, 3):
                assert advect_pallas._pad_geometry(hl, jcfg.nx, c, hd)[3] == c
    arrays = sp.numpy_state(jcfg)
    exp = sp.jax_run(jcfg, "rows", arrays, steps)
    got, _ = sp.port_run(jcfg, "rows", arrays, steps)
    sp.assert_close(got, exp, what=name)


@pytest.mark.parametrize("backend", ["ref", "pallas"])
def test_rollout_matches_jax(backend):
    jcfg = mild() if backend == "ref" else pallas()
    arrays = sp.numpy_state(jcfg, seed=1)
    exp = sp.jax_run(jcfg, "rows", arrays, 4, rollout=True)
    got, counts = sp.port_run(jcfg, "rows", arrays, 4, rollout=True)
    sp.assert_close(got, exp, what=backend)
    # the rollout's counts are every step's: 4 steps
    _, per_step = sp.port_run(jcfg, "rows", arrays, 1)
    assert counts[0]["exchanges"] == 4 * per_step[0]["exchanges"]


def test_rollout_equals_stepwise_bit_for_bit():
    cfg = interop.config_from_jax(pallas())
    arrays = sp.numpy_state(pallas(), seed=2)
    stream, _ = sp.impulses(cfg, 3)
    run, mesh = sp.port_step_fn(cfg, "rows", rollout=True)
    step, _ = sp.port_step_fn(cfg, "rows")
    a = tmesh.shard_state(interop.state_from_numpy(arrays), mesh)
    b = run(a, stream)
    for i in range(3):
        a = step(a, timp.slice_step(stream, i))
    for x, y in zip(interop.state_to_numpy(tmesh.gather_state(a)).values(),
                    interop.state_to_numpy(tmesh.gather_state(b)).values()):
        np.testing.assert_array_equal(x, y)


def test_ref_schedule_equals_one_device_bit_for_bit():
    # the ref schedule exchanges once a sweep: the same arithmetic as one
    # device, where no tap reaches past the halo
    jcfg = mild()
    cfg = interop.config_from_jax(jcfg)
    arrays = sp.numpy_state(jcfg, seed=3)
    got, _ = sp.port_run(jcfg, "rows", arrays, 2)
    sim = Simulation(cfg)
    state = interop.state_from_numpy(arrays)
    stream, _ = sp.impulses(cfg, 2)
    state = sim.run(state, stream)
    for name, exp in interop.state_to_numpy(state).items():
        np.testing.assert_array_equal(got[name], exp, err_msg=name)


def jax_tol_tests(monkeypatch, jcfg, kind, arrays, steps):
    """The JAX run, and its stopping tests (evaluations of its res_mean)
    in each step, on one device: counted by a debug callback around
    ``multigrid.run_cycles``'s res_mean_fn, which every device runs."""
    calls, per_step = [], []
    orig = jmg.run_cycles

    def counting(vcycle, probe_fn, finish_fn, res_mean_fn, *rest):
        def res_mean(r):
            m = res_mean_fn(r)
            jax.debug.callback(lambda: calls.append(1))
            return m

        return orig(vcycle, probe_fn, finish_fn, res_mean, *rest)

    def after_step(i):
        jax.effects_barrier()
        per_step.append(len(calls) // 8 - sum(per_step))

    monkeypatch.setattr(jmg, "run_cycles", counting)
    exp = sp.jax_run(jcfg, kind, arrays, steps, after_step=after_step)
    monkeypatch.setattr(jmg, "run_cycles", orig)
    return exp, per_step


def port_tol_tests(jcfg, kind, arrays, steps):
    """The port's run and its stopping tests in each step (one ``psum`` a
    test, the same on every shard)."""
    per_step = []

    def after_step(i, counts):
        tests = {c["psum"] for c in counts}
        assert len(tests) == 1
        per_step.append(tests.pop())

    got, _ = sp.port_run(jcfg, kind, arrays, steps, after_step=after_step)
    return got, per_step


@pytest.mark.parametrize("backend", ["ref", "pallas"])
def test_multigrid_tol_matches_jax_and_its_vcycles(monkeypatch, backend):
    jcfg = (mild if backend == "ref" else pallas)(
        pressure_solver="multigrid", mg_tol=0.05, mg_max_cycles=6, diffusion_iters=3)
    arrays = sp.numpy_state(jcfg, seed=4)
    exp, jax_tests = jax_tol_tests(monkeypatch, jcfg, "rows", arrays, 2)
    got, tests = port_tol_tests(jcfg, "rows", arrays, 2)
    sp.assert_close(got, exp, rtol=1e-4, what="mg tol")
    # a step of k V-cycles makes k + 1 tests
    assert tests == jax_tests and min(tests) >= 2, (tests, jax_tests)


def test_geometry_errors_keep_jax_messages():
    mesh = sp.port_mesh("rows")
    with pytest.raises(ValueError, match="not divisible by mesh axis 8"):
        tss.make_shardmap_step(FluidConfig.gpu_reference(nx=128, ny=132, backend="ref"),
                               mesh)
    with pytest.raises(ValueError, match="smaller than max_displacement=15"):
        tss.make_shardmap_step(FluidConfig.gpu_reference(nx=128, ny=64, backend="ref"),
                               mesh)
    with pytest.raises(ValueError, match="need 9 devices, have 8"):
        tmesh.make_mesh(9, devices=["cpu"] * 8)


def test_cuda_config_without_a_card_raises():
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        tss.make_shardmap_step(FluidConfig.gpu_reference(nx=128, ny=128, backend="cuda"),
                               sp.port_mesh("rows"))
