"""The port's multigrid (``ops/multigrid.py``), its kernel wrappers H5, H6
and the standalone ``pressure_solve`` entry of H4, against the JAX package
on the CPU.

Given CPU tensors a wrapper runs its plain version; the Pallas functions
run in interpret mode, exactly as ``tests/test_pallas.py`` calls them.
``chip_smoke.py`` holds the CUDA kernels against the same plain versions
on the card.

Tolerances (max |port - JAX| <= tol * max(max|JAX|, 1) unless stated):
- restriction, prolongation, level counts: exact (the same elementwise
  float32 operations, no sum of more than four terms);
- damped sweeps, divergence, projection, the Jacobi solve: 1e-6; the
  residual 1e-5 (4p - (L+R+B+T) cancels to a value far below p, so its
  rounding is relative to p, not to the residual);
- ``pressure_solve_mg`` 1e-5: V-cycles carry float32 association
  differences (XLA's scan against eager torch) through restriction and
  prolongation;
- ``pressure_project_mg`` against JAX's: ``test_pallas.py``'s own bounds
  for its fused-against-composed test (atol 5e-3, rtol 1e-5; stats rtol
  1e-4), as the pressure reaches ~500 and V-cycles amplify association
  noise; against the port's own composition: bit-equal (``torch.equal``),
  the same plain arithmetic in the same order;
- the pipeline against JAX's ref ``Simulation``: 1e-5 of each field's
  scale after a few mild steps, as ``test_torch_pipeline.py``.
The residual-targeted cases choose ``tol`` halfway between the residuals
of fixed cycle counts, so a last-bit difference in ``mean(res**2)`` cannot
change the number of cycles taken.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudafluidsimulation_tpu import FluidConfig as JConfig
from cudafluidsimulation_tpu import Simulation as JSimulation
from cudafluidsimulation_tpu.ops import jacobi_pallas
from cudafluidsimulation_tpu.ops import multigrid as jmg
from cudafluidsimulation_tpu.utils import impulse as jimp

from cudafluidsimulation_tpu_torch import FluidConfig, Simulation, interop
from cudafluidsimulation_tpu_torch.models.pipelines import make_step
from cudafluidsimulation_tpu_torch.ops import (
    backend, cuda_kernels, jacobi_cuda, multigrid, multigrid_cuda, ref)
from cudafluidsimulation_tpu_torch.utils import impulse as timp

torch.set_num_threads(1)

KERNELS = multigrid_cuda.KERNELS + (jacobi_cuda.STENCIL,
                                    jacobi_cuda.PRESSURE_SOLVE)
WRAPPER_SHAPES = [(64, 256), (64, 128)]  # test_pallas.py's, block_rows=32
BR = 32


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(got, exp, tol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    exp = np.asarray(exp)
    assert got.shape == exp.shape
    scale = max(float(np.max(np.abs(exp))), 1.0)
    np.testing.assert_allclose(got, exp, rtol=0, atol=tol * scale)


def _planes(rng, shape, n, scale=1.0):
    return [(rng.standard_normal(shape) * scale).astype(np.float32)
            for _ in range(n)]


def _div(rng, shape):
    d = rng.standard_normal(shape).astype(np.float32)
    return d - d.mean()  # a compatible right-hand side for the Neumann system


@pytest.fixture
def launches():
    """Launch counts before the test; the CPU path must not move them."""
    before = [k.launches for k in KERNELS]
    yield
    assert [k.launches for k in KERNELS] == before


# -- grid transfer and level geometry ----------------------------------------------


@pytest.mark.parametrize("shape", [(16, 16), (96, 192), (540, 960), (270, 480)])
def test_restrict_and_prolong_vs_jax(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    np.testing.assert_array_equal(multigrid._restrict(_t(x)).numpy(),
                                  np.asarray(jmg._restrict(jnp.asarray(x))))
    np.testing.assert_array_equal(multigrid._prolong(_t(x)).numpy(),
                                  np.asarray(jmg._prolong(jnp.asarray(x))))
    xp = rng.standard_normal((shape[0] + 2, shape[1] + 2)).astype(np.float32)
    np.testing.assert_array_equal(
        multigrid.bilinear_from_padded(_t(xp)).numpy(),
        np.asarray(jmg.bilinear_from_padded(jnp.asarray(xp))))


@pytest.mark.parametrize("shape,levels", [
    ((2048, 2048), 8), ((540, 960), 3), ((270, 480), 2), ((135, 240), 1),
    ((16, 16), 1), ((96, 192), 3), ((128, 128), 4), ((4096, 64), 3)])
def test_levels_vs_jax(shape, levels):
    assert multigrid._levels(*shape) == jmg._levels(*shape) == levels


def test_local_levels_vs_jax():
    for n in list(range(1, 70)) + [96, 540, 960, 1024, 2048, 3000]:
        assert multigrid.local_levels(n) == jmg.local_levels(n), n


# -- pressure_solve_mg (the ref backend's op) -----------------------------------------


@pytest.mark.parametrize("shape", [(128, 128), (96, 192)])
@pytest.mark.parametrize("cycles", [1, 2])
def test_pressure_solve_mg_vs_jax(rng, shape, cycles):
    div = _div(rng, shape)
    got = ref.pressure_solve_mg(_t(div), cycles)
    _close(got, jmg.pressure_solve_mg(jnp.asarray(div), cycles=cycles), 1e-5)


@pytest.mark.parametrize("shape", [(128, 128), (96, 192)])
def test_pressure_solve_mg_tol_vs_jax(rng, shape):
    div = _div(rng, shape)
    r1, r2, r3 = (float(multigrid.residual_norm(
        ref.pressure_solve_mg(_t(div), c), _t(div))) for c in (1, 2, 3))
    assert r3 < r2 < r1
    tol = 0.5 * (r1 + r2)
    got = ref.pressure_solve_mg(_t(div), tol=tol, max_cycles=8)
    exp = jmg.pressure_solve_mg(jnp.asarray(div), tol=tol, max_cycles=8)
    _close(got, exp, 1e-5)
    res = float(multigrid.residual_norm(got, _t(div)))
    assert r3 < res < tol  # stopped early, and met the target


@pytest.mark.parametrize("shape", [(128, 128), (96, 192)])
def test_pressure_solve_mg_capped_equals_fixed(rng, shape):
    div = _div(rng, shape)
    capped = ref.pressure_solve_mg(_t(div), tol=1e-20, max_cycles=3)
    assert torch.equal(capped, ref.pressure_solve_mg(_t(div), 3))
    _close(capped, jmg.pressure_solve_mg(jnp.asarray(div), tol=1e-20,
                                         max_cycles=3), 1e-5)


# -- H6 smoother ends, H5 and the pressure_solve entry against Pallas -----------------


@pytest.mark.parametrize("shape", WRAPPER_SHAPES)
@pytest.mark.parametrize("sweeps", [1, 2, 10])
def test_h6_smooth_damped_vs_pallas(rng, launches, shape, sweeps):
    p, rhs = _planes(rng, shape, 2)
    got = multigrid_cuda.smooth_damped(_t(p), _t(rhs), sweeps)
    exp = jacobi_pallas.smooth_damped(jnp.asarray(p), jnp.asarray(rhs), sweeps,
                                      block_rows=BR, burst=8)
    _close(got, exp, 1e-6)


@pytest.mark.parametrize("shape", WRAPPER_SHAPES)
@pytest.mark.parametrize("from_zero", [False, True])
def test_h6_smooth_res_vs_pallas(rng, launches, shape, from_zero):
    p, rhs = _planes(rng, shape, 2)
    assert jacobi_pallas.mg_ends_fusable(*shape, 2, BR)
    src = rhs if from_zero else p  # zero-start calls pass rhs for p
    gp, gr = multigrid_cuda.smooth_res(_t(src), _t(rhs), 2, from_zero=from_zero)
    ep, er = jacobi_pallas.smooth_res(jnp.asarray(src), jnp.asarray(rhs), 2, 0.8,
                                      block_rows=BR, from_zero=from_zero)
    _close(gp, ep, 1e-6)
    _close(gr, er, 1e-5)


@pytest.mark.parametrize("shape", WRAPPER_SHAPES)
@pytest.mark.parametrize("half", [True, False])
def test_h6_first_smooth_res_vs_pallas(rng, launches, shape, half):
    u, v = _planes(rng, shape, 2, 10.0)
    got = multigrid_cuda.first_smooth_res(_t(u), _t(v), 2, half)
    exp = jacobi_pallas.first_smooth_res(jnp.asarray(u), jnp.asarray(v), 2,
                                         half, 0.8, block_rows=BR)
    for g, e, tol in zip(got, exp, (1e-6, 1e-6, 1e-5)):
        _close(g, e, tol)


@pytest.mark.parametrize("shape", WRAPPER_SHAPES)
def test_h6_last_smooth_project_vs_pallas(rng, launches, shape):
    p, rhs = _planes(rng, shape, 2)
    u, v = _planes(rng, shape, 2, 10.0)
    got = multigrid_cuda.last_smooth_project(_t(p), _t(rhs), _t(u), _t(v), 2,
                                             return_stats=True)
    exp = jacobi_pallas.last_smooth_project(
        jnp.asarray(p), jnp.asarray(rhs), jnp.asarray(u), jnp.asarray(v), 2,
        0.8, block_rows=BR, return_stats=True)
    for g, e in zip(got, exp):  # (u', v', p', stats)
        _close(g, e, 1e-6)
    true = np.asarray([np.abs(got[0].numpy()).max(), np.abs(got[1].numpy()).max()])
    assert (got[3].numpy() >= true).all()
    assert len(multigrid_cuda.last_smooth_project(_t(p), _t(rhs), _t(u), _t(v),
                                                  2)) == 3


@pytest.mark.parametrize("shape", WRAPPER_SHAPES)
@pytest.mark.parametrize("half", [True, False])
def test_h5_divergence_vs_pallas(rng, launches, shape, half):
    u, v = _planes(rng, shape, 2, 10.0)
    assert jacobi_pallas.divergence_supported(*shape)
    _close(jacobi_cuda.divergence(_t(u), _t(v), half),
           jacobi_pallas.divergence(jnp.asarray(u), jnp.asarray(v), half,
                                    block_rows=BR), 1e-6)


@pytest.mark.parametrize("shape", WRAPPER_SHAPES)
def test_h5_project_vs_pallas(rng, launches, shape):
    p, = _planes(rng, shape, 1, 50.0)
    u, v = _planes(rng, shape, 2, 10.0)
    got = jacobi_cuda.project(_t(u), _t(v), _t(p), return_stats=True)
    exp = jacobi_pallas.project(jnp.asarray(u), jnp.asarray(v), jnp.asarray(p),
                                block_rows=BR, return_stats=True)
    for g, e in zip(got, exp):
        _close(g, e, 1e-6)
    true = np.asarray([np.abs(got[0].numpy()).max(), np.abs(got[1].numpy()).max()])
    assert (got[2].numpy() >= true).all()
    assert len(jacobi_cuda.project(_t(u), _t(v), _t(p))) == 2


@pytest.mark.parametrize("iters", [0, 1, 2, 12])
def test_h4_pressure_solve_vs_pallas(rng, launches, iters):
    div, = _planes(rng, (64, 128), 1)
    _close(jacobi_cuda.pressure_solve(_t(div), iters),
           jacobi_pallas.pressure_solve(jnp.asarray(div), iters, block_rows=BR,
                                        burst=8), 1e-6)


def _meta(*shape):
    return torch.empty(shape, dtype=torch.float32, device="meta")


@pytest.mark.parametrize("call", [
    lambda: multigrid_cuda.smooth_damped(_meta(8, 8), _meta(8, 8), 2),
    lambda: multigrid_cuda.smooth_res(_meta(8, 8), _meta(8, 8), 2),
    lambda: multigrid_cuda.first_smooth_res(_meta(8, 8), _meta(8, 8), 2, True),
    lambda: multigrid_cuda.last_smooth_project(_meta(8, 8), _meta(8, 8),
                                               _meta(8, 8), _meta(8, 8), 2),
    lambda: jacobi_cuda.divergence(_meta(8, 8), _meta(8, 8), True),
    lambda: jacobi_cuda.project(_meta(8, 8), _meta(8, 8), _meta(8, 8)),
    lambda: jacobi_cuda.pressure_solve(_meta(8, 8), 3),
    lambda: multigrid_cuda.smooth_res(torch.zeros(8, 8), torch.zeros(8, 8), 0),
], ids=["smooth_damped", "smooth_res", "first_smooth_res",
        "last_smooth_project", "divergence", "project", "pressure_solve",
        "smooth_res_no_sweeps"])
def test_wrappers_refuse_what_they_do_not_run(launches, call):
    # only CPU tensors take the plain version; anything else that is not a
    # CUDA tensor, and a sweep count the kernel does not take, is refused
    with pytest.raises(ValueError):
        call()


# -- pressure_project_mg (the cuda backend's hook) -------------------------------------


MG_KW = [dict(cycles=1), dict(cycles=2), dict(cycles=2, tol=0.05),
         dict(cycles=3, tol=1e-20, max_cycles=2)]  # test_pallas.py's cases


@pytest.mark.parametrize("kw", MG_KW)
def test_pressure_project_mg_vs_jax(rng, launches, kw):
    u, v = _planes(rng, (256, 256), 2, 20.0)
    got = multigrid.pressure_project_mg(_t(u), _t(v), half=True,
                                        return_stats=True, ends=multigrid_cuda.ENDS,
                                        **kw)
    exp = jmg.pressure_project_mg(jnp.asarray(u), jnp.asarray(v), half=True,
                                  return_stats=True, **kw)
    for g, e in zip(got[:3], exp[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), atol=5e-3, rtol=1e-5)
    np.testing.assert_allclose(got[3].numpy(), np.asarray(exp[3]), rtol=1e-4)


@pytest.mark.parametrize("shape", [(256, 256), (60, 200), (16, 16)])
@pytest.mark.parametrize("kw", MG_KW)
def test_pressure_project_mg_equals_composition(rng, launches, shape, kw):
    # (60, 200) has two levels; (16, 16) one, which runs the composition
    u, v = (_t(a) for a in _planes(rng, shape, 2, 20.0))
    ends = multigrid_cuda.ENDS
    got = multigrid.pressure_project_mg(u, v, half=True, return_stats=True,
                                        ends=ends, **kw)
    p = multigrid.pressure_solve_mg(
        jacobi_cuda.divergence(u, v, True), kw["cycles"], tol=kw.get("tol", 0.0),
        max_cycles=kw.get("max_cycles", 8), smoother=ends)
    eu, ev, est = jacobi_cuda.project(u, v, p, return_stats=True)
    for g, e in zip(got, (eu, ev, p, est)):
        assert torch.equal(g, e)
    plain = multigrid.pressure_project_mg(u, v, half=True, return_stats=True, **kw)
    for g, e in zip(got, plain):
        assert torch.equal(g, e)


def test_tol_loop_reads_the_residual_once_per_test():
    # k completed cycles take k + 1 stopping tests, each one host read
    reads = []

    def res_mean(r):
        reads.append(r)
        return torch.mean(r * r)

    res = iter([4.0, 2.0, 1.0, 0.5])

    def probe(q):
        return q + 1, torch.full((2, 2), next(res))

    p = multigrid.probed_tol_loop(probe, lambda q, r: q * 10, res_mean,
                                  torch.zeros(2, 2), probe(torch.zeros(2, 2)),
                                  tol=0.75, max_cycles=8)
    assert len(reads) == 4  # three cycles completed, the fourth probe met tol
    assert torch.equal(p, torch.full((2, 2), 1111.0))  # the probed iterate


# -- the pipeline ---------------------------------------------------------------------


MG_CONFIGS = {
    "quality": dict(pressure_solver="multigrid", mg_tol=0.05),
    "fixed": dict(pressure_solver="multigrid", mg_cycles=2),
}


@pytest.mark.parametrize("name", sorted(MG_CONFIGS))
def test_multigrid_pipeline_vs_jax_ref(name):
    jcfg = JConfig.gpu_reference(nx=128, ny=128, backend="ref", vorticity=0.5,
                                 force_scale=500.0, **MG_CONFIGS[name])
    jsim = JSimulation(jcfg)
    tsim = Simulation(interop.config_from_jax(jcfg))
    warm = jimp.orbit_impulse(4, jcfg.dt, center=(64.0, 64.0), radius=16.0)
    js = jsim.run(jsim.init(), warm)
    ts = interop.state_from_numpy({k: np.asarray(x) for k, x in js._asdict().items()})
    imp = jimp.constant_impulse(4, jcfg.dt, pos=(64.0, 64.0), last_pos=(60.0, 62.0))
    js = jsim.run(js, imp)
    ts = tsim.run(ts, timp.Impulse(*(torch.from_numpy(np.array(f)) for f in imp)))
    got = interop.state_to_numpy(ts)
    for field in ("u", "v", "dye", "pressure", "vel_stats"):
        _close(got[field], np.asarray(getattr(js, field)), 1e-5)


@pytest.mark.parametrize("name", sorted(MG_CONFIGS))
def test_kernel_namespace_multigrid_on_cpu_tensors_equals_ref(launches, name):
    # the cuda backend's hook over the wrappers, given CPU tensors, equals
    # the ref backend's composition bit for bit
    cfg = FluidConfig.gpu_reference(nx=64, ny=64, backend="ref", vorticity=0.5,
                                    force_scale=500.0, **MG_CONFIGS[name])
    kern_ops = backend._namespace(cuda_kernels.overrides(cfg))
    assert hasattr(kern_ops, "pressure_project_mg")
    assert not hasattr(backend.get_ops(cfg), "pressure_project_mg")
    kern_step, ref_step = make_step(cfg, kern_ops), make_step(cfg)
    imp = timp.orbit_impulse(3, cfg.dt, center=(32.0, 32.0), radius=8.0)
    a = b = Simulation(cfg).init()
    for i in range(3):
        a = kern_step(a, timp.slice_step(imp, i))
        b = ref_step(b, timp.slice_step(imp, i))
    for field in a._fields:
        assert torch.equal(getattr(a, field), getattr(b, field)), field
