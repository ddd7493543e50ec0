"""The single step's prepared launches (``models/pipelines.py``), on the CPU.

No card is needed: a stand-in library takes the kernels' C calls, records
each call's arguments and writes a marker into every plane the call
outputs, and the device predicates are patched so that CPU tensors pass for
the card's.  A prepared stage's call (``<entry>_args``, one record) is
decoded into the arguments of its entry, so the two paths compare entry by
entry:

- over a short parity orbit with the press toggling and dt changing once,
  the prepared step passes each C entry the same arguments as the wrapper
  step (H1, H2, H3's two passes, H4's four; dt, the decay, the amplitudes,
  the centre, the plans), a pointer compared by the tensor it belongs to:
  the state the step takes, the state it returns, or else the place it
  first appears in the step;
- the counters: ``planned_stages`` is 4 x ``step_calls`` for parity, and
  H3's and H4's calls and passes and every kernel's launches are the same
  on both paths;
- the fallbacks take the wrappers: CPU tensors, the ref namespace, a
  misaligned plane, a second shape, the batched step, multigrid's
  pressure, the fast preset's H7 and H8 (H2 and H4 prepared there);
- a returned state shares no memory with what a later step writes, and
  keeps its values over 3 more steps;
- the records match the C structs of ``csrc/`` field by field.
"""

import contextlib
import ctypes
import functools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from cudafluidsimulation_tpu_torch import FluidConfig
from cudafluidsimulation_tpu_torch.models import pipelines
from cudafluidsimulation_tpu_torch.ops import (_build, advect_cuda, backend, fastdiffuse_cuda,
                                               jacobi_cuda, multigrid_cuda)
from cudafluidsimulation_tpu_torch.state import init_state
from cudafluidsimulation_tpu_torch.utils import trace
from cudafluidsimulation_tpu_torch.utils.impulse import Impulse

torch.set_num_threads(1)

H, W = 32, 40
STREAM = 7
CSRC = Path(pipelines.__file__).resolve().parents[1] / "csrc"
MODULES = (advect_cuda, jacobi_cuda, multigrid_cuda, fastdiffuse_cuda)
# entry -> its record, for the prepared calls
RECORDS = {"fluid_advect_rows": advect_cuda.RowsArgs, "fluid_vorticity": jacobi_cuda.VortArgs,
           "fluid_diffuse": jacobi_cuda.DiffuseArgs,
           "fluid_pressure_project": jacobi_cuda.PressureArgs}


def _parity(h=H, w=W, **kw):
    return FluidConfig.gpu_reference(nx=w, ny=h, pressure_iters=40, max_displacement=31, **kw)


def _values(entry, args):
    """{name: value} of an entry's arguments, host arrays read as tuples."""
    names = [n for n, _ in RECORDS[entry]._fields_]
    a = dict(zip(names, args))
    if entry in ("fluid_diffuse", "fluid_pressure_project"):
        for n in ("depths", "strips", "chunks"):
            a[n] = tuple((ctypes.c_int * a["npasses"]).from_address(a[n]))
    if entry == "fluid_diffuse":
        for n in ("alpha", "inv_beta", "amp"):
            if a[n] is not None:
                a[n] = tuple((ctypes.c_float * a["n"]).from_address(a[n]))
    return a


def _outputs(entry, a):
    """[(address, bytes)] an entry's call writes."""
    plane = 4 * a["h"] * a["w"]
    if entry == "fluid_advect_rows":
        out = [(a[n], plane) for n in ("ou", "ov", "o0", "o1", "o2")]
        return out + [(a["stats"], 8 * a["nb"])]
    if entry == "fluid_vorticity":
        return [(a["u2"], plane), (a["v2"], plane)]
    if entry == "fluid_diffuse":
        return [(a["out"], a["n"] * plane), (a["scratch"], a["n"] * plane)]
    return ([(a[n], plane) for n in ("u2", "v2", "p", "div", "scratch")]
            + [(a["stats"], 8)])


class StandIn:
    """The kernels' libraries: records ``(entry, {name: value}, prepared)``
    of each call of the four entries the single step makes (``other`` the
    rest's names) and writes a marker byte into every output."""

    def __init__(self):
        self.calls = []
        self.other = []
        self.writes = []
        self._marker = 0

    def fluid_error_string(self, code):
        return b"stand-in"

    def _record(self, entry, args, prepared):
        a = _values(entry, args)
        self.calls.append((entry, a, prepared))
        self._marker = self._marker % 250 + 1
        for addr, n in _outputs(entry, a):
            if addr is not None:
                ctypes.memset(addr, self._marker, n)
                self.writes.append((addr, n))
        return 0

    def __getattr__(self, entry):
        if entry.endswith("_args") and entry[:-5] in RECORDS:
            rec = RECORDS[entry[:-5]]

            def call(addr):
                r = rec.from_address(addr)
                return self._record(entry[:-5], [getattr(r, n) for n, _ in rec._fields_], True)
        elif entry in RECORDS:
            def call(*args):
                return self._record(entry, list(args), False)
        else:
            def call(*args):
                self.other.append(entry)
                return 0
        setattr(self, entry, call)
        return call


@pytest.fixture
def card(monkeypatch):
    """CPU tensors pass for the card's, every kernel's C calls go to one
    :class:`StandIn`, and no tensor the step allocates is freed (so no
    address is reused within a test)."""
    lib = StandIn()
    for mod in MODULES:
        monkeypatch.setattr(mod, "on_card", lambda *ts: True)
        monkeypatch.setattr(mod, "stream_of", lambda t: STREAM)
        for kern in vars(mod).values():
            if isinstance(kern, _build.Kernel):
                monkeypatch.setattr(kern, "_lib", lib)
    monkeypatch.setattr(_build, "launch_key", lambda t: (t.device, STREAM))
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    kept = []
    for name in ("empty", "empty_like"):
        make = getattr(torch, name)

        def keep(*a, _make=make, **k):
            t = _make(*a, **k)
            kept.append(t)
            return t

        monkeypatch.setattr(torch, name, keep)
    return lib


def _without_prepared(ns):
    """``ns`` with the same wrappers, none offering a prepared launch."""
    ns = backend.types.SimpleNamespace(**vars(ns))
    for name in pipelines._PREPARED:
        if hasattr(ns, name):
            setattr(ns, name, functools.partial(getattr(ns, name)))
    return ns


def _orbit(n, dt=1.0 / 60.0, h=H, w=W, dt_change=None):
    """n steps orbiting the centre, the press toggling, dt changed at step
    ``dt_change``."""
    t = np.arange(n + 1, dtype=np.float32)
    x = (w / 2 + 6 * np.cos(0.7 * t)).astype(np.float32)
    y = (h / 2 + 6 * np.sin(0.7 * t)).astype(np.float32)
    pos = np.stack([x, y], axis=1)
    pressed = np.array([True, True, False, True, False, False, True, True][:n] * (n // 8 + 1),
                       dtype=bool)[:n]
    dts = np.full(n, dt, np.float32)
    if dt_change is not None:
        dts[dt_change:] = np.float32(dt * 0.75)
    return [Impulse(torch.from_numpy(pos[i + 1]), torch.from_numpy(pos[i]),
                    torch.tensor(pressed[i]), torch.tensor(dts[i])) for i in range(n)]


def _labels(calls, before, after):
    """Each call's arguments with each pointer named by the tensor it
    belongs to: a plane of the state the step takes (``in.*``) or returns
    (``out.*``), else the place it first appears in the step."""
    named = {}
    for tag, s in (("in", before), ("out", after)):
        for f in ("u", "v", "pressure", "vel_stats"):
            named.setdefault(getattr(s, f).data_ptr(), f"{tag}.{f}")
        for c in range(s.dye.shape[0]):
            named.setdefault(s.dye[c].data_ptr(), f"{tag}.dye{c}")
    out = []
    for j, (entry, a, _) in enumerate(calls):
        rec = dict(RECORDS[entry]._fields_)
        b = {}
        for n, v in a.items():
            if rec[n] is ctypes.c_void_p and isinstance(v, int) and n != "stream":
                v = named.setdefault(v, f"{entry}:{j}.{n}")
            b[n] = v
        out.append((entry, b))
    return out


def _run(step, lib, imps, state):
    """The steps, each as (calls labelled, prepared flags); the last state."""
    out = []
    for imp in imps:
        k = len(lib.calls)
        nxt = step(state, imp)
        calls = lib.calls[k:]
        out.append((_labels(calls, state, nxt), [p for _, _, p in calls]))
        state = nxt
    return out, state


def _kernel_launches():
    return {(m.__name__, n): k.launches for m in MODULES for n, k in vars(m).items()
            if isinstance(k, _build.Kernel)}


def _counters():
    return dict(trace.counters())


def _delta(before, after):
    return {k: after[k] - before[k] for k in after}


@pytest.mark.parametrize("h,w", [(H, W), (24, 256), (19, 37)])
def test_prepared_step_passes_the_wrappers_arguments(card, h, w):
    cfg = _parity(h, w)
    ns = backend.kernel_ops(cfg)
    imps = _orbit(8, h=h, w=w, dt_change=5)
    runs, deltas, launches = [], [], []
    for space in (_without_prepared(ns), ns):
        c0, l0 = _counters(), _kernel_launches()
        runs.append(_run(pipelines.make_step(cfg, space), card, imps, init_state(cfg, "cpu"))[0])
        deltas.append(_delta(c0, _counters()))
        launches.append(_delta(l0, _kernel_launches()))
    (wrapped, planned) = runs
    assert len(wrapped) == len(planned) == 8
    for i, ((calls_w, flags_w), (calls_p, flags_p)) in enumerate(zip(wrapped, planned)):
        assert [e for e, _ in calls_w] == ["fluid_advect_rows", "fluid_vorticity",
                                           "fluid_diffuse", "fluid_pressure_project"]
        assert flags_w == [False] * 4 and flags_p == [True] * 4
        assert calls_p == calls_w, i
        h1, h2, h3, h4 = (a for _, a in calls_p)
        assert (h1["u"], h1["v"], h1["d0"]) == ("in.u", "in.v", "in.dye0")
        assert h2["u"] == h1["ou"] and h3["in_"] == h2["u2"]
        assert h3["npasses"] == 2 and h3["depths"] == (10, 10)
        assert h4["npasses"] == 4 and h4["depths"] == (10, 10, 10, 10)
        assert (h4["u"], h4["u2"], h4["v2"], h4["p"], h4["stats"]) == (
            h3["out"], "out.u", "out.v", "out.pressure", "out.vel_stats")
        assert h1["dt"] == h2["dt"] == float(imps[i].dt)
    # the press toggles the amplitudes; dt moves alpha and 1/beta once
    amps = [calls[2][1]["amp"] for calls, _ in planned]
    assert amps[2] == (0.0,) * 5 and amps[0] != amps[2] and amps[0] != amps[1]
    alphas = {calls[2][1]["alpha"] for calls, _ in planned}
    assert len(alphas) == 2
    wd, pd = deltas
    assert wd["step_calls"] == pd["step_calls"] == 8
    assert wd["planned_stages"] == 0 and pd["planned_stages"] == 4 * 8
    for k in ("diffuse_calls", "diffuse_passes", "pressure_calls", "pressure_passes"):
        assert wd[k] == pd[k] > 0, k
    assert launches[0] == launches[1]
    assert launches[1][("cudafluidsimulation_tpu_torch.ops.advect_cuda", "KERNEL")] == 8


def test_returned_states_keep_their_values(card):
    cfg = _parity()
    step = pipelines.make_step(cfg, backend.kernel_ops(cfg))
    state = init_state(cfg, "cpu")
    kept, marks = [], []
    for i, imp in enumerate(_orbit(9)):
        state = step(state, imp)
        kept.append((state, [t.clone() for t in state]))
        marks.append(len(card.writes))
        if i >= 3:  # state i - 3 over the 3 steps after it
            old, values = kept[i - 3]
            for t, was in zip(old, values):
                assert torch.equal(t, was)
    assert all(p for _, _, p in card.calls)
    # nothing written after a state's step lies in that state's memory
    for (s, _), mark in zip(kept, marks):
        spans = [(t.untyped_storage().data_ptr(), t.untyped_storage().nbytes())
                 for t in (s.u, s.v, s.dye, s.pressure, s.vel_stats)]
        for a, n in card.writes[mark:]:
            for lo, size in spans:
                assert a + n <= lo or lo + size <= a


def _entries(lib, k):
    return [(e, p) for e, _, p in lib.calls[k:]]


def test_cpu_tensors_take_the_plain_ops():
    cfg = _parity()
    c0 = _counters()
    out = pipelines.make_step(cfg, backend.kernel_ops(cfg))(init_state(cfg, "cpu"), _orbit(1)[0])
    ref = pipelines.make_step(cfg, backend.get_ops(_parity(backend="ref")))(
        init_state(cfg, "cpu"), _orbit(1)[0])
    d = _delta(c0, _counters())
    assert d["step_calls"] == d["planned_stages"] == 0
    for a, b in zip(out, ref):
        assert torch.equal(a, b)


def test_ref_namespace_on_the_card_takes_no_prepared_launch(card):
    cfg = _parity()
    c0 = _counters()
    pipelines.make_step(cfg, backend.get_ops(_parity(backend="ref")))(
        init_state(cfg, "cpu"), _orbit(1)[0])
    d = _delta(c0, _counters())
    assert d["step_calls"] == 1 and d["planned_stages"] == 0 and card.calls == []


def _misaligned(state):
    def shift(t):
        buf = torch.zeros(t.numel() + 1)
        return buf[1:].view(t.shape)

    return state._replace(u=shift(state.u))


def test_a_misaligned_plane_takes_the_wrappers(card):
    cfg = _parity()
    step = pipelines.make_step(cfg, backend.kernel_ops(cfg))
    imps = _orbit(3)
    state = step(init_state(cfg, "cpu"), imps[0])
    k = len(card.calls)
    state = step(_misaligned(state), imps[1])
    assert _entries(card, k) == [(e, False) for e in RECORDS]
    k = len(card.calls)
    step(state, imps[2])
    assert [p for _, p in _entries(card, k)] == [True] * 4


def test_a_second_shape_takes_the_wrappers(card):
    cfg = _parity()
    step = pipelines.make_step(cfg, backend.kernel_ops(cfg))
    imp = _orbit(1)[0]
    step(init_state(cfg, "cpu"), imp)
    k = len(card.calls)
    step(init_state(_parity(h=24, w=40), "cpu"), imp)
    assert _entries(card, k) == [(e, False) for e in RECORDS]
    k = len(card.calls)
    step(init_state(cfg, "cpu"), imp)
    assert [p for _, p in _entries(card, k)] == [True] * 4


def test_the_batched_step_takes_the_wrappers(monkeypatch):
    from cudafluidsimulation_tpu_torch.models import ensemble

    def refuse(*a, **k):
        raise AssertionError("a batched step took a prepared launch")

    monkeypatch.setattr(_build, "launch_key", lambda t: (t.device, STREAM))
    ns = backend.batched_namespace()
    for name in pipelines._PREPARED:
        if hasattr(ns, name):
            op = functools.partial(getattr(ns, name))
            op.prepare = refuse
            setattr(ns, name, op)
    cfg = _parity()
    c0 = _counters()
    pipelines.make_batched_step(cfg, ns)(ensemble.batched_state(cfg, 2, device="cpu"),
                                         ensemble.batched_impulse(_orbit(1)[0], 2))
    d = _delta(c0, _counters())
    assert d["step_calls"] == d["planned_stages"] == 0


def test_multigrid_pressure_takes_its_wrappers(card):
    cfg = _parity(pressure_solver="multigrid", mg_cycles=1)
    step = pipelines.make_step(cfg, backend.kernel_ops(cfg))
    c0 = _counters()
    k = len(card.other)
    step(init_state(cfg, "cpu"), _orbit(1)[0])
    d = _delta(c0, _counters())
    assert [(e, p) for e, _, p in card.calls] == [
        ("fluid_advect_rows", True), ("fluid_vorticity", True), ("fluid_diffuse", True)]
    assert d["planned_stages"] == 3 and d["pressure_calls"] == 0 and card.other[k:]


def test_fast_takes_prepared_h2_and_h4_beside_h7_and_h8(card):
    cfg = _parity(h=64, w=64, fast_dye=True, fast_velocity=True, fast_diffuse=True)
    ns = backend.kernel_ops(cfg)
    assert ns.diffuse_multi_splat is not jacobi_cuda.diffuse_multi_splat  # H7 granted
    step = pipelines.make_step(cfg, ns)
    c0 = _counters()
    state = init_state(cfg, "cpu")
    for imp in _orbit(2, h=64, w=64):
        state = step(state, imp)
    d = _delta(c0, _counters())
    assert [(e, p) for e, _, p in card.calls] == [
        ("fluid_advect_rows", False), ("fluid_advect_rows", False), ("fluid_vorticity", True),
        ("fluid_pressure_project", True)] * 2
    assert "fluid_sep_diffuse" in card.other
    assert d["step_calls"] == 2 and d["planned_stages"] == 4
    h4 = card.calls[-1][1]
    assert (h4["u2"], h4["stats"]) == (state.u.data_ptr(), state.vel_stats.data_ptr())


def _c_fields(struct: str):
    """[(name, kind)] of a C struct in ``csrc/``: kind "p" a pointer, else
    its type."""
    src = "\n".join(p.read_text() for p in CSRC.glob("*.cu"))
    body = re.search(r"struct %s \{(.*?)\};" % struct, src, re.S).group(1)
    fields = []
    for decl in body.split(";"):
        decl = decl.strip()
        if not decl:
            continue
        m = re.match(r"(const\s+)?(float|int|long long|void)\s*(.*)", decl)
        for name in m.group(3).split(","):
            name = name.strip()
            fields.append((name.lstrip("*").strip(), "p" if name.startswith("*") else m.group(2)))
    size = int(re.search(r"sizeof\(%s\) == (\d+)" % struct, src).group(1))
    return fields, size


@pytest.mark.parametrize("record,struct", [
    (advect_cuda.RowsArgs, "FluidAdvectRowsArgs"), (jacobi_cuda.VortArgs, "FluidVorticityArgs"),
    (jacobi_cuda.DiffuseArgs, "FluidDiffuseArgs"),
    (jacobi_cuda.PressureArgs, "FluidPressureProjectArgs")])
def test_records_mirror_the_c_structs(record, struct):
    kinds = {ctypes.c_void_p: "p", ctypes.c_int: "int", ctypes.c_float: "float",
             ctypes.c_longlong: "long long"}
    fields, size = _c_fields(struct)
    assert [(n.rstrip("_"), kinds[t]) for n, t in record._fields_] == fields
    assert ctypes.sizeof(record) == size
