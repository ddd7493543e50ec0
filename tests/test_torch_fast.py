"""The port's fast modes against the JAX package, on the CPU: the tap
design, kernel H7 (separable diffusion, ``fast_diffuse``), kernel H8
(bf16-tap advection, ``fast_velocity``/``fast_dye``) and the fast step.

Given CPU tensors a wrapper runs its plain version
(``ops/fastdiffuse.py``, ``ops/advect_packed.py``); the Pallas functions
run in interpret mode, as ``tests/test_fastdiffuse.py`` and
``tests/test_advect_pallas.py`` call them.  ``chip_smoke.py`` holds the
CUDA kernels against the same plain versions on the card.

Tolerances (max |port - JAX| <= tol * max(max|JAX|, 1) unless stated):
- the taps: bit-equal (the same numpy code and ``eigh`` on the same host);
- H7 1e-6: 40 multiply-adds a cell in the same order on both sides;
  XLA's interpret mode may still round a product-sum pair differently;
- H8 1e-5, as H1 (tests/test_torch_kernels_vs_pallas.py): both round the
  same tap values, but the Pallas cores sum the four taps as a masked
  shift-accumulation, another float32 order than the bilinear blend;
- the bf16 rounding helper: bit-equal to JAX's integer ops;
- one fast step against JAX's pallas fast step: 1e-5 of each field's
  scale, as the parity step (tests/test_torch_pipeline.py).
The envelopes of the fast ops against the port's exact ops are the JAX
package's own (tests/test_fastdiffuse.py, tests/test_advect_pallas.py),
plus a multi-step envelope for ``fast_diffuse`` defined here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudafluidsimulation_tpu import FluidConfig as JConfig
from cudafluidsimulation_tpu import Simulation as JSimulation
from cudafluidsimulation_tpu.ops import advect_pallas
from cudafluidsimulation_tpu.ops import fastdiffuse as jfd
from cudafluidsimulation_tpu.utils import impulse as jimp

from cudafluidsimulation_tpu_torch import FluidConfig, Simulation, interop
from cudafluidsimulation_tpu_torch.models.pipelines import make_step
from cudafluidsimulation_tpu_torch.ops import (
    advect_cuda, advect_packed, backend, cuda_kernels, fastdiffuse,
    fastdiffuse_cuda, jacobi_cuda, ref)
from cudafluidsimulation_tpu_torch.utils import impulse as timp

torch.set_num_threads(1)

DT = np.float32(1 / 60)
ALPHA = 0.8 * 0.8 * 60.0  # the reference coefficient set's Jacobi alpha
FAST = dict(fast_dye=True, fast_velocity=True, fast_diffuse=True)
KERNELS = (advect_cuda.KERNEL, advect_cuda.PACKED, fastdiffuse_cuda.SEP,
           jacobi_cuda.DIFFUSE)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(got, exp, tol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    exp = np.asarray(exp)
    assert got.shape == exp.shape
    scale = max(float(np.max(np.abs(exp))), 1.0)
    np.testing.assert_allclose(got, exp, rtol=0, atol=tol * scale)


def _vel(rng, h, w, scale):
    return ((rng.standard_normal((h, w)) * scale).astype(np.float32),
            (rng.standard_normal((h, w)) * scale).astype(np.float32))


@pytest.fixture
def launches():
    """Launch counts before the test; the CPU path must not move them."""
    before = [k.launches for k in KERNELS]
    yield
    assert [k.launches for k in KERNELS] == before


# -- the taps -------------------------------------------------------------------------

DESIGNS = [(ALPHA, 20), (ALPHA, 5), (ALPHA, 10), (0.5 ** 2 * 60.0, 20),
           (2.0 ** 2 * 60.0, 20), (0.8 ** 2 * 30.0, 20)]


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("alpha,iters", DESIGNS)
def test_design_taps_bit_equal(alpha, iters):
    jx, jy = jfd.design_taps(alpha, iters)
    tx, ty = fastdiffuse.design_taps(alpha, iters)
    assert len(tx) == len(jx) and len(ty) == len(jy)
    for a, b in zip(tx + ty, jx + jy):
        assert a.dtype == np.float32
        assert _bits_equal(a, b)


@pytest.mark.parametrize("alpha,iters", DESIGNS + [(ALPHA, 0)])
def test_tap_cost_and_worthwhile_equal(alpha, iters):
    if iters:
        assert fastdiffuse.tap_cost(alpha, iters) == jfd.tap_cost(alpha, iters)
    assert fastdiffuse.worthwhile([alpha], iters) == jfd.worthwhile([alpha], iters)


def test_shipped_design_is_rank_two_radii_five_four():
    xs, _ = fastdiffuse.design_taps(ALPHA, 20)
    assert [(len(x) - 1) // 2 for x in xs] == [5, 4]
    assert fastdiffuse.tap_cost(ALPHA, 20) == 40


@pytest.mark.parametrize("alphas", [[ALPHA] * 5, [ALPHA] * 2,
                                    [ALPHA, ALPHA, 0.5 ** 2 * 60.0],
                                    [2.0 ** 2 * 60.0] * 3])
def test_taps_array_bit_equal(alphas):
    got, exp = fastdiffuse._taps_array(alphas, 20, 2e-4), jfd._taps_array(alphas, 20, 2e-4)
    if exp is None:
        assert got is None
        return
    assert got[1] == exp[1]
    assert _bits_equal(got[0], exp[0])


@pytest.mark.parametrize("kw", [{}, dict(diffusion_iters=5), dict(diffusion_iters=0),
                                dict(velocity_diffusion=0.5),
                                dict(color_diffusion=2.0)])
def test_make_ops_returns_empty_where_jax_does(kw):
    got = fastdiffuse.make_ops(FluidConfig.gpu_reference(
        nx=128, ny=64, backend="ref", fast_diffuse=True, **kw))
    exp = jfd.make_ops(JConfig.gpu_reference(
        nx=128, ny=64, backend="pallas", fast_diffuse=True, **kw))
    assert sorted(got) == sorted(exp)


# -- H7 separable diffusion --------------------------------------------------------------


def _ops_pair(h, w):
    port = fastdiffuse.make_ops(FluidConfig.gpu_reference(
        nx=w, ny=h, backend="ref", fast_diffuse=True))
    jax_ops = jfd.make_ops(JConfig.gpu_reference(
        nx=w, ny=h, backend="pallas", fast_diffuse=True))
    return port, jax_ops


COEFFS5 = np.asarray([0.8] * 5, np.float32)
AMPS = np.asarray([1.0, -2.0, 0.3, 0.5, 0.2], np.float32)
LAST = np.asarray([100.3, 50.7], np.float32)


# (192, 256) is a whole strip geometry; (100, 130) is mirror-padded
@pytest.mark.parametrize("shape", [(192, 256), (100, 130)])
def test_h7_diffuse_multi_vs_pallas(rng, launches, shape):
    port, jax_ops = _ops_pair(*shape)
    f = rng.standard_normal((5,) + shape).astype(np.float32)
    got = port["diffuse_multi"](_t(f), DT, COEFFS5, 20)
    exp = jax_ops["diffuse_multi"](jnp.asarray(f), DT, jnp.asarray(COEFFS5), 20)
    _close(got, exp, 1e-6)


def test_h7_diffuse_multi_splat_vs_pallas(rng, launches):
    port, jax_ops = _ops_pair(192, 256)
    f = rng.standard_normal((5, 192, 256)).astype(np.float32)
    got = port["diffuse_multi_splat"](_t(f), DT, COEFFS5, 20, AMPS, LAST, 400.0)
    exp = jax_ops["diffuse_multi_splat"](
        jnp.asarray(f), DT, jnp.asarray(COEFFS5), 20, jnp.asarray(AMPS),
        (jnp.float32(LAST[0]), jnp.float32(LAST[1])), 400.0)
    _close(got, exp, 1e-6)


@pytest.mark.parametrize("channels", [(2,), ()])  # stacked (u, v); one plane
def test_h7_diffuse_velocity_vs_pallas(rng, launches, channels):
    port, jax_ops = _ops_pair(64, 128)
    f = rng.standard_normal(channels + (64, 128)).astype(np.float32)
    got = port["diffuse"](_t(f), DT, 0.8, 20)
    exp = jax_ops["diffuse"](jnp.asarray(f), DT, 0.8, 20)
    _close(got, exp, 1e-6)


def _sep_numpy(f, taps, radii, splat=None):
    """float64 reference: np.pad(mode='symmetric') is the half-sample
    symmetric extension, reflected again as often as the pad needs."""
    c, h, w = f.shape
    out = np.zeros((c, h, w))
    for ch in range(c):
        off = 0
        for r in radii:
            n = 2 * r + 1
            tx, ty = taps[ch, off:off + n], taps[ch, off + n:off + 2 * n]
            fe = np.pad(f[ch].astype(np.float64), r, mode="symmetric")
            xs = sum(tx[j] * fe[:, j:j + w] for j in range(n))
            out[ch] += sum(ty[j] * xs[j:j + h, :] for j in range(n))
            off += 2 * n
    if splat is not None:
        amps, last, radius = splat
        ys, xs = np.mgrid[0:h, 0:w]
        e = np.exp(-((xs - last[0]) ** 2 + (ys - last[1]) ** 2) / radius)
        out += np.asarray(amps)[:, None, None] * e[None]
    return out


# radius 5 against widths 8, 4 and 2: the taps reflect more than once
@pytest.mark.parametrize("shape", [(16, 16), (4, 8), (3, 2), (1, 1)])
@pytest.mark.parametrize("splat", [False, True])
def test_h7_reflects_past_the_grid(rng, launches, shape, splat):
    taps, radii = fastdiffuse._taps_array([ALPHA] * 3, 20, 2e-4)
    f = rng.standard_normal((3,) + shape).astype(np.float32)
    sp = (AMPS[:3], (1.5, 0.5), 4.0) if splat else None
    got = fastdiffuse_cuda.sep_apply(_t(f), taps, radii, sp)
    _close(got, _sep_numpy(f, taps, radii, sp), 1e-6)


@pytest.mark.parametrize("shape", [(192, 256), (4, 8)])
def test_h7_dc_preserved(launches, shape):
    port, _ = _ops_pair(*shape)
    f = torch.full((5,) + shape, 3.25)
    out = port["diffuse_multi"](f, DT, COEFFS5, 20)
    assert float((out - 3.25).abs().max()) < 1e-5


@pytest.mark.parametrize("change", ["dt", "coeffs", "iters"])
@pytest.mark.parametrize("op", ["diffuse", "diffuse_multi", "diffuse_multi_splat"])
def test_fast_diffuse_rejects_off_nominal_calls(op, change):
    # the taps are designed for the config's dt, coefficients and sweep
    # count; the JAX package ignores a call's values, the port refuses them
    port, _ = _ops_pair(32, 64)
    dt = np.float32(1 / 30) if change == "dt" else DT
    iters = 19 if change == "iters" else 20
    f = torch.zeros((5, 32, 64))
    if op == "diffuse":
        call = lambda coeff: port["diffuse"](f[:2], dt, coeff, iters)  # noqa: E731
        coeff = 0.7 if change == "coeffs" else 0.8
    else:
        coeff = COEFFS5.copy()
        if change == "coeffs":
            coeff[3] = 0.9
        extra = (AMPS, LAST, 400.0) if op == "diffuse_multi_splat" else ()
        call = lambda c: port[op](f, dt, c, iters, *extra)  # noqa: E731
    with pytest.raises(ValueError, match="taps designed for"):
        call(coeff)


def test_fast_diffuse_takes_the_pipelines_host_values():
    # the pipeline passes dt as a host float32 and the coefficients as a
    # float32 array: the nominal check is a host comparison that passes
    port, _ = _ops_pair(32, 64)
    cfg = FluidConfig.gpu_reference(nx=64, ny=32, backend="ref")
    dt = ref.f32(timp.no_impulse(1, cfg.dt).dt[0])
    f = torch.zeros((5, 32, 64))
    out = port["diffuse_multi_splat"](f, dt, COEFFS5, 20, AMPS, LAST, 400.0)
    assert out.shape == f.shape


# -- H8 bf16-tap advection ------------------------------------------------------------

# (shape, scale): driven reaches ~4 cells a step (d=31 keeps every Pallas
# tap exact), test_torch_kernels_vs_pallas's 64x128 H1 case, where the
# Pallas f32 core itself stays within 1e-5 of the bilinear blend (at 64x256
# its own f32 result is already 1.3e-5 away); quiet stays under one cell
# on both axes
FLOWS = {"driven": ((64, 128), 60.0), "quiet": ((64, 128), 8.0)}
STATS = ["given", "absent", "loose"]


def _flow(rng, flow):
    shape, scale = FLOWS[flow]
    u, v = _vel(rng, *shape, scale)
    assert (np.abs(np.stack([u, v])).max() * DT < 1) == (flow == "quiet")
    return u, v


def _stats(kind, u, v):
    if kind == "absent":
        return None, None
    st = np.asarray([np.abs(u).max(), np.abs(v).max()], np.float32)
    if kind == "loose":  # a bound far above the truth denies the quiet branch
        st = st + np.float32(1000.0)
    return _t(st), jnp.asarray(st)


@pytest.mark.parametrize("fast_path", [True, False])
@pytest.mark.parametrize("stats", STATS)
@pytest.mark.parametrize("flow", sorted(FLOWS))
def test_h8_advect_velocity_vs_pallas(rng, launches, flow, stats, fast_path):
    u, v = _flow(rng, flow)
    ts, js = _stats(stats, u, v)
    gu, gv, gst = advect_cuda.advect_velocity(
        _t(u), _t(v), DT, 1.2, vel_stats=ts, return_stats=True, packed=True,
        fast_path=fast_path)
    eu, ev, est = advect_pallas.advect_velocity(
        jnp.asarray(u), jnp.asarray(v), DT, 1.2, d=31, vel_stats=js,
        return_stats=True, packed=True, fast_path=fast_path)
    for g, e in ((gu, eu), (gv, ev), (gst, est)):
        _close(g, e, 1e-5)
    true = np.asarray([np.abs(gu.numpy()).max(), np.abs(gv.numpy()).max()])
    assert (gst.numpy() >= true).all()


@pytest.mark.parametrize("fast_path", [True, False])
@pytest.mark.parametrize("stats", STATS)
@pytest.mark.parametrize("flow", sorted(FLOWS))
def test_h8_advect_dye_vs_pallas(rng, launches, flow, stats, fast_path):
    u, v = _flow(rng, flow)
    dye = rng.uniform(0.0, 1.0, (3,) + u.shape).astype(np.float32)
    ts, js = _stats(stats, u, v)
    got = advect_cuda.advect_dye(_t(dye), _t(u), _t(v), DT, 1.2, vel_stats=ts,
                                 packed=True, fast_path=fast_path)
    exp = advect_pallas.advect_dye(jnp.asarray(dye), jnp.asarray(u), jnp.asarray(v),
                                   DT, 1.2, d=31, vel_stats=js, packed=True,
                                   fast_path=fast_path)
    _close(got, exp, 1e-5)


@pytest.mark.parametrize("stats", ["given", "absent"])
def test_h8_quiet_branch_is_the_f32_result(rng, launches, stats):
    # a quiet step takes the exact taps: equal to H1's plain version
    u, v = _flow(rng, "quiet")
    dye = rng.uniform(0.0, 1.0, (3,) + u.shape).astype(np.float32)
    ts, _ = _stats(stats, u, v)
    got = advect_packed.advect_velocity(_t(u), _t(v), DT, 1.2, vel_stats=ts,
                                        return_stats=True)
    exp = ref.advect_velocity(_t(u), _t(v), DT, 1.2, return_stats=True)
    for g, e in zip(got, exp):
        assert torch.equal(g, e)
    assert torch.equal(
        advect_packed.advect_dye(_t(dye), _t(u), _t(v), DT, 1.2, vel_stats=ts),
        ref.advect_dye(_t(dye), _t(u), _t(v), DT, 1.2))
    # the same flow with the quiet branch switched off rounds its taps
    off = advect_packed.advect_velocity(_t(u), _t(v), DT, 1.2, fast_path=False)
    assert not torch.equal(off[0], exp[0])


# bit patterns: signed zeros, denormals, halfway cases (0x8000 in the low
# half: ties round up in magnitude, also where nearest-even would not),
# the largest finite values (round to infinity), infinities, NaNs, and
# patterns whose + 0x8000 wraps around 32 bits
EDGE_BITS = [
    0x00000000, 0x80000000, 0x00000001, 0x00007FFF, 0x00008000, 0x007FFFFF,
    0x807FFFFF, 0x3F800000, 0x3F807FFF, 0x3F808000, 0x3F818000, 0xBF808000,
    0xBF807FFF, 0x7F7FFFFF, 0xFF7FFFFF, 0x7F7F7FFF, 0x7F800000, 0xFF800000,
    0x7FC00000, 0xFFC00000, 0x7F800001, 0x7FFFFFFF, 0xFFFFFFFF, 0xFFFF8000,
]


def test_bf16_round_equals_jax_bit_ops():
    bits = np.asarray(EDGE_BITS, np.uint32)
    got = advect_packed.bf16_round(torch.from_numpy(bits.view(np.float32).copy()))
    b = jax.lax.bitcast_convert_type(jnp.asarray(bits.view(np.int32)), jnp.int32)
    exp = jax.lax.bitcast_convert_type((b + 0x8000) & jnp.int32(-65536), jnp.float32)
    exp_bits = np.asarray(jax.lax.bitcast_convert_type(exp, jnp.int32)).view(np.uint32)
    got_bits = got.numpy().view(np.uint32)
    np.testing.assert_array_equal(got_bits, exp_bits)
    np.testing.assert_array_equal(got_bits, (bits.astype(np.uint64) + 0x8000 & 0xFFFF0000)
                                  .astype(np.uint32))
    # not round-to-nearest-even: 1 + 2^-8 ties away from 1.0
    tie = torch.from_numpy(np.asarray([0x3F808000], np.uint32).view(np.float32).copy())
    assert float(advect_packed.bf16_round(tie)) == 1.0078125
    assert float(tie.to(torch.bfloat16).float()) == 1.0


def test_h8_dye_clamps_where_exact_saturates(rng, launches):
    # zeros left of ones and a backtrace of 1.5 cells past x = 0: column 1
    # extrapolates to -0.5; the exact fade saturates it to 1 (pow NaN), the
    # packed one clamps it to 0, as JAX's packed core does
    h, w = 64, 128
    dye = rng.uniform(0.0, 1.0, (3, h, w)).astype(np.float32)
    dye[:, :, 0], dye[:, :, 1] = 0.0, 1.0
    u = np.full((h, w), 1.5 / DT, np.float32)
    v = np.zeros((h, w), np.float32)
    got = advect_cuda.advect_dye(_t(dye), _t(u), _t(v), DT, 1.2, packed=True)
    exact = advect_cuda.advect_dye(_t(dye), _t(u), _t(v), DT, 1.2)
    assert bool((got[:, :, 1] == 0.0).all()) and bool((exact[:, :, 1] == 1.0).all())
    exp = advect_pallas.advect_dye(jnp.asarray(dye), jnp.asarray(u), jnp.asarray(v),
                                   DT, 1.2, d=31, packed=True)
    _close(got, exp, 1e-5)


def test_h8_dye_nan_saturates_to_one(launches):
    # the clamp lets a NaN through, and fmin(1, NaN) is 1
    h, w = 16, 32
    dye = np.full((3, h, w), 0.5, np.float32)
    dye[:, 5, 7] = np.nan
    u = np.full((h, w), 2.0 / DT, np.float32)  # driven: the packed branch
    v = np.zeros((h, w), np.float32)
    got = advect_cuda.advect_dye(_t(dye), _t(u), _t(v), DT, 1.2, packed=True)
    assert not bool(torch.isnan(got).any())
    assert bool((got[:, 5, 9] == 1.0).all())  # samples x = 7 with weight ~1
    clean = dye.copy()
    clean[:, 5, 7] = 0.5
    hit = got != advect_cuda.advect_dye(_t(clean), _t(u), _t(v), DT, 1.2, packed=True)
    # only the cells whose four taps include the NaN changed, and to 1
    # (a zero weight times NaN is NaN: row 4 taps row 5 with weight 0)
    assert bool((got[hit] == 1.0).all())
    assert set(hit.nonzero()[:, 1].tolist()) <= {4, 5}


def _meta(*shape):
    return torch.empty(shape, dtype=torch.float32, device="meta")


@pytest.mark.parametrize("call", [
    lambda: advect_cuda.advect_velocity(_meta(8, 8), _meta(8, 8), DT, 1.2, packed=True),
    lambda: advect_cuda.advect_dye(_meta(3, 8, 8), _meta(8, 8), _meta(8, 8), DT, 1.2,
                                   packed=True),
    lambda: advect_cuda.advect_velocity(torch.zeros(8, 8), torch.zeros(8, 8), DT, 1.2,
                                        vel_stats=_meta(2), packed=True),
    lambda: fastdiffuse_cuda.sep_apply(_meta(5, 8, 8), np.zeros((5, 40), np.float32),
                                       (5, 4)),
], ids=["packed_velocity", "packed_dye", "mixed_vel_stats", "sepdiffuse"])
def test_fast_wrappers_raise_off_cpu_and_cuda(launches, call):
    with pytest.raises(ValueError):
        call()


# -- the fast step ---------------------------------------------------------------------


def test_fast_step_vs_pallas(launches):
    # a common start from 8 driven exact steps, then one driven step on the
    # JAX package's pallas fast path and on the port's kernel namespace
    h, w = 64, 128
    kw = dict(nx=w, ny=h, pressure_iters=40, max_displacement=31)
    jref = JSimulation(JConfig.gpu_reference(backend="ref", **kw))
    js = jref.run(jref.init(), jimp.orbit_impulse(8, 1 / 60, center=(64.0, 32.0),
                                                  radius=10.0, omega=3.0))
    assert 1.0 < float(np.max(np.asarray(js.vel_stats))) * DT < 31.0  # driven, unclamped
    jfast = JSimulation(JConfig.gpu_reference(backend="pallas", **kw, **FAST))
    imp = jimp.single((70.0, 30.0), (66.5, 31.0), True, 1 / 60)
    exp = jfast.step(js, imp)
    cfg = FluidConfig.gpu_reference(backend="ref", **kw, **FAST)
    step = make_step(cfg, backend._namespace(cuda_kernels.overrides(cfg)))
    got = interop.state_to_numpy(step(
        interop.state_from_numpy({k: np.asarray(x) for k, x in js._asdict().items()}),
        timp.Impulse(*(torch.from_numpy(np.array(f)) for f in imp))))
    for name in ("u", "v", "dye", "pressure", "vel_stats"):
        _close(got[name], np.asarray(getattr(exp, name)), 1e-5)


# -- envelopes of the fast ops against the port's exact ops ------------------------------


def _edge_max(err):
    return max(err[:, 0].max(), err[:, -1].max(), err[:, :, 0].max(), err[:, :, -1].max())


# tests/test_fastdiffuse.py's 5e-4 a application, edges included
@pytest.mark.parametrize("case", ["multi_192x256", "multi_100x130", "splat", "velocity"])
def test_fast_diffuse_envelope_per_application(rng, case):
    h, w = {"multi_100x130": (100, 130), "velocity": (64, 128)}.get(case, (192, 256))
    port, _ = _ops_pair(h, w)
    c = 2 if case == "velocity" else 5
    f = _t(rng.standard_normal((c, h, w)))
    if case == "velocity":
        fast, exact = port["diffuse"](f, DT, 0.8, 20), ref.diffuse(f, DT, 0.8, 20)
    elif case == "splat":
        fast = port["diffuse_multi_splat"](f, DT, COEFFS5, 20, AMPS, LAST, 400.0)
        exact = ref.diffuse_multi_splat(f, DT, COEFFS5, 20, AMPS, LAST, 400.0)
    else:
        fast, exact = port["diffuse_multi"](f, DT, COEFFS5, 20), ref.diffuse_multi(f, DT, COEFFS5, 20)
    err = (fast - exact).abs().numpy()
    assert err.max() < 5e-4
    assert _edge_max(err) < 5e-4


def test_fast_diffuse_envelope_per_step(rng):
    # tests/test_fastdiffuse.py::test_full_step_close_to_exact: 5e-3
    cfg = FluidConfig.gpu_reference(nx=256, ny=192, backend="ref", fast_diffuse=True)
    fast = make_step(cfg, backend._namespace(cuda_kernels.overrides(cfg)))
    exact = make_step(cfg)
    state = Simulation(cfg).init()._replace(
        u=_t(rng.standard_normal((192, 256)) * 2),
        v=_t(rng.standard_normal((192, 256)) * 2),
        dye=_t(rng.random((3, 192, 256))),
        vel_stats=_t([8.0, 8.0]))
    imp = timp.single((128.0, 96.0), (120.0, 90.0), True, cfg.dt)
    a, b = fast(state, imp), exact(state, imp)
    assert float((a.u - b.u).abs().max()) < 5e-3
    assert float((a.dye - b.dye).abs().max()) < 5e-3


def test_fast_advect_envelope_20_applications():
    # tests/test_advect_pallas.py::test_fast_mode_multi_step_error_envelope:
    # 20 advections through a fixed fast swirl (about 5.6 cells a step, the
    # packed branch): dye RMSE < 0.05, self-advected velocity relative
    # RMSE < 1%
    h, w, d = 64, 256, 8
    ys = np.arange(h, dtype=np.float32)[:, None]
    xs = np.arange(w, dtype=np.float32)[None, :]
    speed = d * 0.7 / 0.25
    u = _t(speed * np.sin(np.pi / h * ys) * np.cos(np.pi / w * xs))
    v = _t(-speed * np.cos(np.pi / h * ys) * np.sin(np.pi / w * xs))
    dye = _t(np.random.default_rng(0).uniform(size=(3, h, w)))
    ex = pk = dye
    for _ in range(20):
        ex = ref.advect_dye(ex, u, v, 0.25, 0.8)
        pk = advect_packed.advect_dye(pk, u, v, 0.25, 0.8)
    assert float(((ex - pk) ** 2).mean().sqrt()) < 0.05
    uv_ex = uv_pk = (u, v)
    for _ in range(20):
        uv_ex = ref.advect_velocity(*uv_ex, 0.25, 0.1)
        uv_pk = advect_packed.advect_velocity(*uv_pk, 0.25, 0.1)
    ex, pk = torch.stack(uv_ex), torch.stack(uv_pk)
    assert float(((ex - pk) ** 2).mean().sqrt() / ex.abs().max()) < 0.01


def test_fast_diffuse_envelope_repeated_applications(rng):
    """The multi-step envelope for ``fast_diffuse`` on the operator: the
    fast blur F and the exact blur M are both averaging operators that keep
    constants, so the error e_n = F^n x - M^n x obeys e_{n+1} = F e_n +
    (F - M) M^n x: it is damped by F while the per-application term shrinks
    with M^n x.  Envelope: over 20 applications every error stays inside
    the one-application bound 5e-4, and the error after 20 is no larger
    than after one (measured: 1.3e-4 after one, 6.4e-5 after 20)."""
    port, _ = _ops_pair(96, 128)
    f = _t(rng.standard_normal((5, 96, 128)))
    fast = exact = f
    errs = []
    for _ in range(20):
        fast = port["diffuse_multi"](fast, DT, COEFFS5, 20)
        exact = ref.diffuse_multi(exact, DT, COEFFS5, 20)
        errs.append(float((fast - exact).abs().max()))
    assert max(errs) < 5e-4
    assert errs[-1] <= errs[0]


@pytest.mark.parametrize("params,bound", [("mild", 1e-4), ("shipped", 1e-2)])
def test_fast_diffuse_envelope_rollout(params, bound):
    """The multi-step envelope for ``fast_diffuse`` through the pipeline:
    20 driven orbit steps on the kernel namespace with ``fast_diffuse``
    against the exact steps from the same start, relative RMSE (over each
    field's largest magnitude) of u, v and dye.  At mild parameters
    (vorticity 0.5, force 500; sub-cell flow) the flow is not chaotic and
    the bound is 1e-4 (measured 3.4e-6); at the shipped gpu-reference
    parameters (about 6 cells a step) the flow is chaotic, and the bound is
    the JAX packed-velocity envelope, 1% (measured 0.40%)."""
    extra = dict(vorticity=0.5, force_scale=500.0) if params == "mild" else {}
    cfg = FluidConfig.gpu_reference(nx=128, ny=96, backend="ref", fast_diffuse=True,
                                    **extra)
    fast = make_step(cfg, backend._namespace(cuda_kernels.overrides(cfg)))
    exact = make_step(cfg)
    imp = timp.orbit_impulse(20, cfg.dt, center=(64.0, 48.0), radius=16.0, omega=3.0)
    a = b = Simulation(cfg).init()
    for i in range(20):
        a = fast(a, timp.slice_step(imp, i))
        b = exact(b, timp.slice_step(imp, i))
    for name in ("u", "v", "dye"):
        x, y = getattr(a, name), getattr(b, name)
        rel = float(((x - y) ** 2).mean().sqrt() / y.abs().max())
        assert rel < bound, (name, rel)
