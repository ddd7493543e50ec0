"""H2's redesigned kernel and the step's 5-channel pack written in place, on
the CPU.

- H2 (``csrc/vorticity.cu``) runs only on the card (``chip_smoke.py``
  holds it there bit for bit against the plain version).  Here
  :func:`emulate` runs its schedule in plain torch: 128 x 16 tiles; u
  loaded with two ring rows and one ring column each side, v with one ring
  row and two ring columns, at clamped coordinates, the tile's columns in
  groups of 4 (one 16-byte load when the kernel's ``vec`` holds and the
  group starts inside the row, else 4 clamped scalar loads); the curl of
  the tile and its ring from those tiles; the force at each cell from the
  curl at clamped neighbours.  It must be bit-equal to
  ``ops.ref.vorticity_confinement_{gpu,cpu}``.
- ``out=`` of ``advect_dye`` and both confinement ops, on the plain
  versions and on the wrappers (meta tensors reach the wrappers' checks
  without a card, as tests/test_torch_kernels_vs_pallas.py does).
- One step with the pack written in place against the same step with the
  pack built by ``torch.cat`` (:func:`cat_form`): bit-equal on the parity,
  fast and cpu-variant paths; and against the JAX package's steps at the
  tolerances of tests/test_torch_pipeline.py and tests/test_torch_fast.py
  (1e-5 of each field's scale).
- ``init_state`` puts the state where the config's backend runs.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from cudafluidsimulation_tpu import FluidConfig as JConfig
from cudafluidsimulation_tpu import Simulation as JSimulation
from cudafluidsimulation_tpu.utils import impulse as jimp

from cudafluidsimulation_tpu_torch import FluidConfig, Simulation, interop
from cudafluidsimulation_tpu_torch.models.pipelines import make_step
from cudafluidsimulation_tpu_torch.ops import (
    advect_cuda, advect_packed, backend, cuda_kernels, jacobi_cuda, ref)
from cudafluidsimulation_tpu_torch.state import init_state
from cudafluidsimulation_tpu_torch.utils import impulse as timp

torch.set_num_threads(1)

DT = np.float32(1 / 60)
TH, TW = 16, 128  # csrc/vorticity.cu VORT_TH, VORT_TW
VORT = {"gpu": 50.0, "cpu": 0.35}
FAST = dict(fast_dye=True, fast_velocity=True, fast_diffuse=True)
FIELDS = ("u", "v", "dye", "pressure", "vel_stats")


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _vel(rng, h, w, scale):
    return (_t(rng.standard_normal((h, w)) * scale), _t(rng.standard_normal((h, w)) * scale))


@pytest.fixture
def launches():
    """Launch counts before the test; the CPU path must not move them."""
    kernels = (advect_cuda.KERNEL, advect_cuda.PACKED, jacobi_cuda.VORTICITY)
    before = [k.launches for k in kernels]
    yield
    assert [k.launches for k in kernels] == before


# -- H2's schedule, emulated ------------------------------------------------------------


def _clamp(i, n):
    return min(max(i, 0), n - 1)


def _tile(src, gy0, rows, x0, ring, vec):
    """The shared tile of ``src``: grid rows gy0 .. gy0 + rows - 1 and
    columns x0 - ring .. x0 + TW + ring - 1 at clamped coordinates, filled as
    the kernel fills it."""
    h, w = src.shape
    out = []
    for gy in range(gy0, gy0 + rows):
        row = src[_clamp(gy, h)]
        parts = [row[[_clamp(x0 + c, w) for c in range(-ring, 0)]]]
        for g in range(TW // 4):
            gx = x0 + 4 * g
            if vec and gx < w:
                seg = row[gx:gx + 4]  # one 16-byte load, inside the row
                assert seg.numel() == 4
            else:
                seg = row[[min(gx + j, w - 1) for j in range(4)]]
            parts.append(seg)
        parts.append(row[[_clamp(x0 + TW + c, w) for c in range(ring)]])
        out.append(torch.cat(parts))
    return torch.stack(out)


def emulate(u, v, dt, vorticity, variant, vec):
    """``vorticity_kernel``'s schedule in plain torch, tile by tile."""
    h, w = u.shape
    u2, v2 = torch.empty_like(u), torch.empty_like(v)
    dt, vort = float(ref.f32(dt)), float(ref.f32(vorticity))
    for y0 in range(0, h, TH):
        for x0 in range(0, w, TW):
            us = _tile(u, y0 - 2, TH + 4, x0, 1, vec)  # column c at c + 1
            vs = _tile(v, y0 - 1, TH + 2, x0, 2, vec)  # column c at c + 2
            # the curl of the tile and its ring: row r is grid row y0 - 1 + r,
            # column c + 1 is tile column c
            ws = 0.5 * (vs[:, 2:] - vs[:, :-2] - us[2:] + us[:-2])
            ys = torch.arange(y0, min(y0 + TH, h))
            xs = torch.arange(x0, min(x0 + TW, w))
            row, col = (ys - y0 + 1)[:, None], (xs - x0 + 1)[None, :]
            rt = (ys + 1).clamp(max=h - 1) - y0 + 1
            rb = (ys - 1).clamp(min=0) - y0 + 1
            cl = (xs - 1).clamp(min=0) - x0 + 1
            cr = (xs + 1).clamp(max=w - 1) - x0 + 1
            wc = ws[row, col]
            wl, wr = ws[row, cl[None, :]].abs(), ws[row, cr[None, :]].abs()
            wb, wt = ws[rb[:, None], col].abs(), ws[rt[:, None], col].abs()
            fx = 0.5 * (wt - wb)
            fy = 0.5 * (wr - wl) if variant == "cpu" else 0.5 * (wl - wr)
            ln = torch.sqrt(fx * fx + fy * fy) + (1e-4 if variant == "cpu" else 1e-3)
            s = wc * vort / ln
            fx, fy = (-fx * s, -fy * s) if variant == "cpu" else (fx * s, fy * s)
            uc, vc = us[row + 1, col], vs[row, col + 1]
            u2[ys[:, None], xs[None, :]] = uc + fx * dt
            v2[ys[:, None], xs[None, :]] = vc + fy * dt
    return u2, v2


SHAPES = [(37, 45), (16, 16), (4, 8), (3, 5), (1, 1), (33, 260), (20, 132), (17, 129)]


@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "unaligned"])
@pytest.mark.parametrize("variant", ["gpu", "cpu"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_h2_schedule_is_bit_equal(rng, shape, variant, aligned):
    h, w = shape
    u, v = _vel(rng, h, w, 50.0)
    # the kernel takes 16-byte accesses only where every row starts on 16
    # bytes: W a multiple of 4 and all four planes aligned
    vec = aligned and w % 4 == 0
    got = emulate(u, v, DT, VORT[variant], variant, vec)
    exp = getattr(ref, f"vorticity_confinement_{variant}")(u, v, DT, VORT[variant])
    assert torch.equal(got[0], exp[0]) and torch.equal(got[1], exp[1])


# -- out= ---------------------------------------------------------------------------------


def _dye_case(rng, h=12, w=20):
    u, v = _vel(rng, h, w, 90.0)
    dye = _t(rng.uniform(0.0, 1.0, (3, h, w)))
    return dye, u, v


DYE_OPS = {
    "ref": ref.advect_dye,
    "packed": advect_packed.advect_dye,
    "wrapper": advect_cuda.advect_dye,
    "wrapper_packed": lambda *a, **kw: advect_cuda.advect_dye(*a, packed=True, **kw),
}
VORT_OPS = {
    "ref_gpu": ref.vorticity_confinement_gpu,
    "ref_cpu": ref.vorticity_confinement_cpu,
    "wrapper_gpu": lambda *a, **kw: jacobi_cuda.vorticity_confinement(*a, variant="gpu", **kw),
    "wrapper_cpu": lambda *a, **kw: jacobi_cuda.vorticity_confinement(*a, variant="cpu", **kw),
}


def _nan_pack(h, w):
    return torch.full((5, h, w), float("nan"))


@pytest.mark.parametrize("op", sorted(DYE_OPS))
def test_advect_dye_into_the_pack(rng, launches, op):
    dye, u, v = _dye_case(rng)
    pack = _nan_pack(12, 20)
    got = DYE_OPS[op](dye, u, v, DT, 1.2, out=pack[2:])
    assert got.data_ptr() == pack[2].data_ptr() and got.shape == (3, 12, 20)
    assert torch.equal(pack[2:], DYE_OPS[op](dye, u, v, DT, 1.2))
    assert bool(pack[:2].isnan().all())


@pytest.mark.parametrize("op", sorted(VORT_OPS))
def test_vorticity_into_the_pack(rng, launches, op):
    u, v = _vel(rng, 12, 20, 5.0)
    pack = _nan_pack(12, 20)
    got = VORT_OPS[op](u, v, DT, 0.5, out=pack[:2])
    assert [t.data_ptr() for t in got] == [pack[0].data_ptr(), pack[1].data_ptr()]
    exp = VORT_OPS[op](u, v, DT, 0.5)
    assert torch.equal(pack[0], exp[0]) and torch.equal(pack[1], exp[1])
    assert bool(pack[2:].isnan().all())


def _bad_outs(like, shares):
    """(name, out, error) for each broken ``out`` of ``like``'s shape;
    ``shares`` is a tensor of that shape over an input's memory."""
    c, h, w = like.shape
    return [
        ("shape", torch.empty((c + 1, h, w)), ValueError),
        ("dtype", torch.empty((c, h, w), dtype=torch.float64), TypeError),
        ("contiguity", torch.empty((c, w, h)).transpose(1, 2), ValueError),
        ("alias", shares, ValueError),
    ]


@pytest.mark.parametrize("case", ["shape", "dtype", "contiguity", "alias"])
@pytest.mark.parametrize("op", sorted(DYE_OPS))
def test_advect_dye_out_contract(rng, launches, op, case):
    dye, u, v = _dye_case(rng)
    _, out, err = {n: (n, o, e) for n, o, e in _bad_outs(dye, dye)}[case]
    with pytest.raises(err, match="out"):
        DYE_OPS[op](dye, u, v, DT, 1.2, out=out)


@pytest.mark.parametrize("case", ["shape", "dtype", "contiguity", "alias"])
@pytest.mark.parametrize("op", sorted(VORT_OPS))
def test_vorticity_out_contract(rng, launches, op, case):
    uv = torch.stack(_vel(rng, 12, 20, 5.0))
    u, v = uv[0], uv[1]
    _, out, err = {n: (n, o, e) for n, o, e in _bad_outs(uv, uv)}[case]
    with pytest.raises(err, match="out"):
        VORT_OPS[op](u, v, DT, 0.5, out=out)


def test_out_overlapping_part_of_an_input_raises(rng):
    # out's first plane takes in the end of v; the planes right after v do not
    buf = _t(rng.standard_normal(4 * 240))
    u, v = buf[:240].view(12, 20), buf[240:480].view(12, 20)
    exp = ref.vorticity_confinement_gpu(u, v, DT, 0.5)
    for op in (ref.vorticity_confinement_gpu, VORT_OPS["wrapper_gpu"]):
        with pytest.raises(ValueError, match="shares memory"):
            op(u, v, DT, 0.5, out=buf[460:940].view(2, 12, 20))
        got = op(u, v, DT, 0.5, out=buf[480:960].view(2, 12, 20))
        assert torch.equal(got[0], exp[0]) and torch.equal(got[1], exp[1])


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("case,err,match", [
    ("shape", ValueError, "out: expected shape"), ("dtype", TypeError, "out: expected float32"),
    ("contiguity", ValueError, "out: expected a contiguous"), ("alias", ValueError, "out: shares"),
    ("device", ValueError, "several devices")])
@pytest.mark.parametrize("op", ["advect_dye", "advect_dye_packed", "vorticity"])
def test_wrappers_check_out(launches, op, case, err, match):
    # meta tensors reach the wrappers' checks without a card: each broken
    # out is refused before anything runs; an out on another device than
    # the inputs by the device rule
    c = 2 if op == "vorticity" else 3
    pack = _meta(5, 8, 8)
    make = (lambda *s: torch.zeros(s)) if case == "device" else _meta
    outs = {"shape": _meta(c + 1, 8, 8), "dtype": _meta(c, 8, 8, dtype=torch.float64),
            "contiguity": _meta(c, 8, 8).transpose(1, 2), "alias": pack[:c],
            "device": _meta(c, 8, 8)}
    if op == "vorticity":
        u, v = (pack[0], pack[1]) if case == "alias" else (make(8, 8), make(8, 8))
        call = lambda: jacobi_cuda.vorticity_confinement(u, v, DT, 1.0, out=outs[case])
    else:
        dye = pack[:3] if case == "alias" else make(3, 8, 8)
        call = lambda: advect_cuda.advect_dye(dye, make(8, 8), make(8, 8), DT, 1.2,
                                              packed=op.endswith("packed"), out=outs[case])
    with pytest.raises(err, match=match):
        call()


# -- the step's pack --------------------------------------------------------------------


def cat_form(ops):
    """``ops`` with the step's 5-channel pack built as it was before the dye
    advection and the confinement wrote into it: they return fresh tensors,
    and diffusion takes ``torch.cat`` of their results in place of the pack
    it is handed."""
    ns = types.SimpleNamespace(**vars(ops))
    made = {}

    def fresh(key, fn):
        def call(*args, out=None, **kw):
            made[key] = fn(*args, **kw)
            return made[key]
        return call

    def from_cat(fn):
        def call(pack, *args, **kw):
            return fn(torch.cat([torch.stack(made["uv"]), made["dye"]]), *args, **kw)
        return call

    ns.advect_dye = fresh("dye", ops.advect_dye)
    ns.vorticity_confinement_gpu = fresh("uv", ops.vorticity_confinement_gpu)
    ns.vorticity_confinement_cpu = fresh("uv", ops.vorticity_confinement_cpu)
    ns.diffuse_multi = from_cat(ops.diffuse_multi)
    ns.diffuse_multi_splat = from_cat(ops.diffuse_multi_splat)
    return ns


PATHS = {
    # the shipped gpu parity step; the fast step on the kernel namespace
    # (the plain versions of H7 and H8 on CPU tensors); the cpu variant with
    # colour diffusion (diffuse_multi, then splat_cpu)
    "parity": (FluidConfig.gpu_reference, dict(pressure_iters=40), False),
    "fast": (FluidConfig.gpu_reference, dict(pressure_iters=40, **FAST), True),
    "cpu_color": (FluidConfig.cpu_reference, dict(color_diffusion_enabled=True), False),
}


def _path(name, h=48, w=64):
    ctor, kw, kernels = PATHS[name]
    cfg = ctor(nx=w, ny=h, backend="ref", **kw)
    ops = backend._namespace(cuda_kernels.overrides(cfg)) if kernels else backend.get_ops(cfg)
    return cfg, ops


def _warm(cfg, steps=6):
    """A driven state from the exact ref steps, and an orbit stream."""
    sim = Simulation(dataclasses.replace(cfg, fast_dye=False, fast_velocity=False,
                                         fast_diffuse=False))
    imp = timp.orbit_impulse(steps + 4, cfg.dt, center=(cfg.nx / 2, cfg.ny / 2),
                             radius=cfg.ny / 6, omega=3.0)
    return sim.run(sim.init(), timp.Impulse(*(f[:steps] for f in imp))), imp


@pytest.mark.parametrize("name", sorted(PATHS))
def test_in_place_pack_equals_the_cat_form(launches, name):
    cfg, ops = _path(name)
    a, imp = _warm(cfg)
    b = a
    step, cat_step = make_step(cfg, ops), make_step(cfg, cat_form(ops))
    for i in range(6, 10):
        a, b = step(a, timp.slice_step(imp, i)), cat_step(b, timp.slice_step(imp, i))
    for name_ in FIELDS:
        assert torch.equal(getattr(a, name_), getattr(b, name_)), name_


@pytest.mark.parametrize("name", sorted(PATHS))
def test_step_hands_one_pack_to_its_producers_and_diffusion(name):
    cfg, ops = _path(name)
    state, imp = _warm(cfg, steps=2)
    seen = {}

    def spy(key, fn):
        def call(*args, **kw):
            seen[key] = kw.get("out") if key != "diffuse" else args[0]
            return fn(*args, **kw)
        return call

    ns = types.SimpleNamespace(**vars(ops))
    ns.advect_dye = spy("dye", ops.advect_dye)
    confine = "vorticity_confinement_" + ("cpu" if cfg.variant == "cpu" else "gpu")
    setattr(ns, confine, spy("uv", getattr(ops, confine)))
    diffuse = "diffuse_multi" if cfg.variant == "cpu" else "diffuse_multi_splat"
    setattr(ns, diffuse, spy("diffuse", getattr(ops, diffuse)))
    make_step(cfg, ns)(state, timp.slice_step(imp, 2))
    pack = seen["diffuse"]
    assert pack.shape == (5, cfg.ny, cfg.nx) and pack.is_contiguous()
    assert seen["uv"].data_ptr() == pack.data_ptr() and seen["uv"].shape[0] == 2
    assert seen["dye"].data_ptr() == pack[2].data_ptr() and seen["dye"].shape[0] == 3


@pytest.mark.parametrize("kw", [dict(), dict(diffusion_iters=0), dict(color_diffusion_enabled=False)],
                         ids=["five", "no_sweeps", "two"])
def test_paths_without_a_pack_take_no_out(kw):
    # the cpu variant builds a pack only when it diffuses five channels
    cfg = FluidConfig.cpu_reference(nx=32, ny=24, backend="ref",
                                    **{"color_diffusion_enabled": True, **kw})
    state, imp = _warm(cfg, steps=1)
    outs = []
    ns = types.SimpleNamespace(**vars(backend.get_ops(cfg)))
    plain = ns.advect_dye
    ns.advect_dye = lambda *a, **k: (outs.append(k.get("out")), plain(*a, **k))[1]
    make_step(cfg, ns)(state, timp.slice_step(imp, 1))
    five = cfg.color_diffusion_enabled and cfg.diffusion_iters > 0
    assert (outs[0] is not None) == five


def _close(ts, js, tol=1e-5):
    got = interop.state_to_numpy(ts)
    for name in FIELDS:
        exp = np.asarray(getattr(js, name))
        scale = max(float(np.abs(exp).max()), 1.0)
        np.testing.assert_allclose(got[name], exp, rtol=0, atol=tol * scale, err_msg=name)


@pytest.mark.parametrize("name,jbackend", [("parity", "ref"), ("parity", "pallas"),
                                           ("fast", "pallas"), ("cpu_color", "ref")])
def test_pack_step_vs_jax(launches, name, jbackend):
    # one driven step from a common state made by the JAX ref backend: the
    # port's step (its pack written in place; the kernel namespace on CPU
    # tensors against Pallas) against the JAX package's, its ref backend or
    # its Pallas kernels in interpret mode
    ctor, kw, _ = PATHS[name]
    jctor = JConfig.gpu_reference if ctor is FluidConfig.gpu_reference else JConfig.cpu_reference
    jcfg = jctor(nx=128, ny=64, backend=jbackend, max_displacement=31, **kw)
    jwarm = JSimulation(dataclasses.replace(jcfg, backend="ref"))
    js = jwarm.run(jwarm.init(), jimp.orbit_impulse(6, jcfg.dt, center=(64.0, 32.0),
                                                     radius=10.0, omega=3.0))
    if name == "fast":
        assert float(np.max(np.asarray(js.vel_stats))) * DT > 1.0  # H8 rounds
    ts = interop.state_from_numpy({k: np.asarray(x) for k, x in js._asdict().items()})
    cfg = dataclasses.replace(interop.config_from_jax(jcfg), backend="ref")
    ops = (backend._namespace(cuda_kernels.overrides(cfg)) if jbackend == "pallas"
           else backend.get_ops(cfg))
    imp = jimp.single((70.0, 30.0), (66.5, 31.0), True, jcfg.dt)
    got = make_step(cfg, ops)(ts, timp.Impulse(*(torch.from_numpy(np.array(f)) for f in imp)))
    _close(got, JSimulation(jcfg).step(js, imp))


# -- the state's device -----------------------------------------------------------------


def test_init_state_follows_the_backend():
    cfg = FluidConfig.gpu_reference(nx=16, ny=8, backend="ref")
    assert init_state(cfg).u.device.type == "cpu"
    assert init_state(FluidConfig(nx=16, ny=8), device="cpu").dye.shape == (3, 8, 16)


def test_init_state_on_a_cuda_config_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the state goes there")
    for b in ("cuda", "auto"):
        with pytest.raises(RuntimeError, match="CUDA device"):
            init_state(FluidConfig(nx=16, ny=8, backend=b))
