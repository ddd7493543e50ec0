"""H1 and H8: semi-Lagrangian advection on the card (``csrc/advect.cu``).

**H1** replaces ``cudafluidsimulation_tpu/ops/advect_pallas.py``:
``_advect_kernel`` (via ``_advect_flat``) and ``_advect_kernel_tiled`` (via
``_advect_tiled``), their cores ``_advect_core`` and
``_advect_core_static``, and ``_emit_stats``.  The TPU has no fast gather,
so the Pallas kernel turns the bilinear gather into a shift-accumulation
over a bounded displacement window.  The card gathers natively: a thread
backtraces each of its cells, truncates the corner, clamps four taps and
blends them, as ``ops/ref.py`` does.  The backtrace is unbounded, like the
ref backend; the Pallas kernel's ``max_displacement`` clamp is not copied.

**H8** (``packed=True``, the ``fast_velocity`` and ``fast_dye`` modes)
replaces the bf16-tap cores ``_advect_core_packed`` and
``_advect_core_packed_vel``: the same gather over taps rounded as the TPU
kernels pack them, the dye clamped to >= 0 before the pow, and, with
``fast_path``, the exact H1 arithmetic on a quiet step, decided on the
device from ``vel_stats`` (or from max|u|, max|v| reduced first when it is
None), so the step reads nothing back.  Plain version:
``ops/advect_packed.py``.

**What bounds them: bytes**, each input read once and each output
written once (the taps are near the cell and hit L1 and L2):

- :func:`advect_both`, H1 as the step runs it (``make_step`` and
  ``make_batched_step`` take a namespace's ``advect_both``): velocity and
  dye in one launch.  The dye backtraces through u', v' at its own cell,
  which the thread has just computed, so u', v' are written once and
  never read back: u, v and the 3 dye planes in, u', v' and 3 dye planes
  out, 10 planes (168 MB at 2048², 0.050 ms at 3.35 TB/s).
- :func:`advect_velocity` reads u, v and writes u', v' (4 planes);
  :func:`advect_dye` reads u', v' and the dye and writes the dye (8
  planes).  H8 runs as these two passes, because its dye's quiet branch
  reads the grid-wide max of u', v', which is known only when every block
  of the velocity pass has finished (12 planes together).  H1's two
  passes serve the decomposed stage report (``utils/instrument.py``),
  and the checks hold the fused launch to them bit for bit.

The design (``csrc/advect.cu``'s ``ADVECT_CELLS``, ``ADVECT_ROWS``,
``ADVECT_TILES``, mirrored here as :data:`CELLS`, :data:`ROWS`,
:data:`TILES`): each thread takes 4 cells of a row with one 16-byte access
a plane where every plane's rows start on 16 bytes (a scalar access a cell
elsewhere); a block of 32 x 8 threads walks up to 4 tiles of rows, loading
the next tile's u, v while it gathers this one's, and prefetches the dye's
lines into L1 before the dye's gathers wait on u', v'.  The velocity
bound [max|u'|, max|v'|] needs no memset: a block writes its max into its
own slot and makes one arrival atomic on its member's count (in place of
two ``atomicMax`` a block on the member's two stats), and the member's
last block to arrive reduces the slots.  The slots and counts are kept per
stream by :class:`_Bounds`.

**Batched** (``*_batched``): B independent members (ensembles, the analog
of vmap over the JAX step) in one launch, member b on grid z; each
member's dt and decay come from its row of the step's device parameters
(``ops/member_params.py``) and its bound goes to row b of ``stats``
(B, 2).  H8's quiet branch is each member's, from its own row of
``vel_stats`` (B, 2) and its own dt, so a batch may mix quiet and driven
members and the step still reads nothing back.  The single entries are
the case B = 1, with dt and decay by value.

**H1 window and H8 window** (:func:`advect_window`, ``WINDOW``): the
sharded rollout (``parallel/``) advects each shard on a halo-padded local
view, as the JAX package's sharded step calls ``advect_pallas.advect`` with
``y0``, ``h_phys``, ``x0``, ``w_phys`` and ``d_x``.  One thread per interior
cell backtraces from the cell's global coordinates, clamps the corner to
the physical grid, bounds the tap's offset from the cell by the halo depth
(``ref.Window``) and reads the padded planes; only the interior, the rows
the caller keeps, is computed and bounds the velocity.  In the
rows-unbounded form (``Window.y_in``) the view is every row of the grid
and the interior a shard's rows of it: the global step of
``parallel.sharded``, whose taps reach any row.  Plain versions:
``ref.advect_window`` and ``advect_packed.advect_window``.

The wrappers take the plain versions (``ops.ref``, ``ops.advect_packed``)
for CPU tensors and launch the kernel or raise for CUDA tensors.
:class:`BothLaunch` is :func:`advect_both` as the single step prepares it
(``models/pipelines.py``): ``fluid_advect_rows_args`` takes the entry's
parameters as one record (:class:`RowsArgs`), filled once, so a prepared
call sets what changes and makes one C call.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from cudafluidsimulation_tpu_torch.ops import advect_packed, member_params, ref
from cudafluidsimulation_tpu_torch.ops._build import (
    Kernel, check_f32, check_planes, on_card, stream_of)

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong


class RowsArgs(ctypes.Structure):
    """``fluid_advect_rows``'s parameters in their order, as the record that
    ``fluid_advect_rows_args`` takes (``csrc/advect.cu``
    ``FluidAdvectRowsArgs``)."""

    _fields_ = ([(n, _P) for n in ("u", "v", "ou", "ov", "d0", "d1", "d2", "o0", "o1", "o2",
                                   "bound", "scratch", "stats", "slots", "counts")]
                + [(n, _I) for n in ("c", "h", "w", "mode", "packed", "fast_path")]
                + [("dt", _F), ("decay", _F), ("nb", _I)]
                + [(n, _L) for n in ("u_ms", "v_ms", "ouv_ms", "din_ms", "dout_ms")]
                + [("prm", _P), ("prm_stride", _I), ("slot_count", _L), ("stream", _P)])


_ROWS = {"fluid_advect_rows": [t for _, t in RowsArgs._fields_],
         "fluid_advect_rows_args": [_P]}
_VELOCITY, _DYE, _BOTH = 1, 2, 3
# the row kernels' design, as csrc/advect.cu defines it: cells a thread
# along a row, rows of 32 threads a block, tiles of rows a block walks
CELLS, ROWS, TILES = 4, 8, 4
# H1 as the step launches it, velocity and dye in one launch; single and
# B members a launch, each its own launch count
KERNEL = Kernel("advect", _ROWS)
BATCHED = Kernel("advect", _ROWS)
# H1's velocity and dye passes apart
VELOCITY_PASS = Kernel("advect", _ROWS)
DYE_PASS = Kernel("advect", _ROWS)
VELOCITY_PASS_BATCHED = Kernel("advect", _ROWS)
DYE_PASS_BATCHED = Kernel("advect", _ROWS)
# H8's two passes, single and batched
PACKED = Kernel("advect", _ROWS)
PACKED_BATCHED = Kernel("advect", _ROWS)
# fluid_advect_window(f0, f1, f2, o0, o1, o2, u, v, bound, scratch, stats,
#                     c, h, w, dye, packed, fast_path, dt, decay, y0, x0,
#                     h_phys, w_phys, d, d_x, yi, fw, uw, stream)
_WINDOW = {"fluid_advect_window": [_P] * 11 + [_I] * 6 + [_F, _F] + [_I] * 9 + [_P]}
# H1's window (the sharded rollout), and H8's (packed), each its own count
WINDOW = Kernel("advect", _WINDOW)
PACKED_WINDOW = Kernel("advect", _WINDOW)


class _Bounds:
    """The velocity bound's scratch: a slot (2 floats) a block and an
    arrival count (int32, zero) a member, kept for each (device, stream)
    and grown as needed.  Launches on one stream run one after another and
    each launch's last block resets its members' counts, so the next launch
    finds zeros and may reuse the slots; launches that may overlap (other
    streams, as the shard threads of ``parallel/mesh.py`` could use) get
    other scratch.  Made on the stream at its first use; the lock is taken
    only to make or grow it."""

    def __init__(self):
        self._by_stream = {}
        self._lock = threading.Lock()

    def get(self, device: torch.device, stream: int, n: int, slot_count: int):
        key = (device.index, stream)
        got = self._by_stream.get(key)
        if got is None or got[0].shape[0] < slot_count or got[1].numel() < n:
            with self._lock:
                got = self._by_stream.get(key)
                if got is None or got[0].shape[0] < slot_count or got[1].numel() < n:
                    slots, counts = got or (None, None)
                    if slots is None or slots.shape[0] < slot_count:
                        slots = torch.empty((max(slot_count, 4096), 2), dtype=torch.float32,
                                            device=device)
                    if counts is None or counts.numel() < n:
                        counts = torch.zeros((max(n, 256),), dtype=torch.int32, device=device)
                    got = self._by_stream[key] = (slots, counts)
        return got


_BOUNDS = _Bounds()


def _slot_count(h: int, w: int, n: int) -> int:
    """The bound's slots: one a block (``fluid_advect_rows``' rows_grid)."""
    blocks_y = -(-(-(-h // ROWS)) // TILES)  # ceil(ceil(h / ROWS) / TILES)
    return -(-w // (32 * CELLS)) * blocks_y * n


def _ptr(t):
    return t.data_ptr() if t is not None else None


def _ptrs(tensors):
    return [t.data_ptr() for t in tensors] + [None] * (3 - len(tensors))


def _launch(kern, mode, u, v, *, uv_out=None, dye=None, dye_out=None, stats=None,
            vel_stats=None, dt=0.0, decay_rate=0.0, params=None, packed=False,
            fast_path=False):
    """One launch of ``fluid_advect_rows``.  Single: u, v (H, W), ``uv_out``
    (2, H, W), ``dye``/``dye_out`` (C, H, W), ``stats`` (2,), dt and the
    decay by value.  Batched (u (B, H, W)): ``uv_out`` (2, B, H, W), the
    dye (B, C, H, W) at any member stride, ``stats`` (B, 2), each member's
    [dt, decay] from its row of ``params``."""
    batched = u.dim() == 3
    n = u.shape[0] if batched else 1
    h, w = u.shape[-2:]
    stream = stream_of(u)
    slots = counts = None
    slot_count = 0
    if stats is not None:
        slot_count = _slot_count(h, w, n)
        slots, counts = _BOUNDS.get(u.device, stream, n, slot_count)
    # H8 reduces max|u|, max|v| here when no bound is given
    scratch = (torch.empty((n, 2), dtype=torch.float32, device=u.device)
               if packed and fast_path and vel_stats is None else None)
    ou = ov = None
    if uv_out is not None:
        ou, ov = (uv_out[0, 0], uv_out[1, 0]) if batched else (uv_out[0], uv_out[1])
    c, planes, outs = 0, [], []
    if dye is not None:
        c = dye.shape[-3]
        planes, outs = (list(dye[0]), list(dye_out[0])) if batched else (list(dye), list(dye_out))
    if batched:
        ms = (u.stride(0), v.stride(0), h * w, dye.stride(0) if dye is not None else 0,
              dye_out.stride(0) if dye_out is not None else 0)
        dt_f, decay, prm, prm_stride = 0.0, 0.0, params.data_ptr(), params.stride(0)
    else:
        ms = (0, 0, 0, 0, 0)
        dt_f, decay = float(ref.f32(dt)), ref.decay_factor(dt, decay_rate)
        prm, prm_stride = None, 0
    with torch.cuda.device(u.device):
        kern.launch(
            "fluid_advect_rows", u.data_ptr(), v.data_ptr(), _ptr(ou), _ptr(ov), *_ptrs(planes),
            *_ptrs(outs), _ptr(vel_stats), _ptr(scratch), _ptr(stats), _ptr(slots),
            _ptr(counts), c, h, w, mode, int(bool(packed)), int(bool(fast_path)), dt_f, decay,
            n, *ms, prm, prm_stride, slot_count, stream)


def _given(*tensors):
    return [t for t in tensors if t is not None]


def _check_dye(dye, h, w):
    if dye.dim() != 3 or not 1 <= dye.shape[0] <= 3:
        raise ValueError(f"dye: expected (C<=3, H, W), got {tuple(dye.shape)}")
    check_f32("dye", dye, (dye.shape[0], h, w))


def _check_dye_batched(dye, n, h, w):
    if dye.dim() != 4 or dye.shape[0] != n or not 1 <= dye.shape[1] <= 3:
        raise ValueError(f"dye: expected ({n}, C<=3, H, W), got {tuple(dye.shape)}")
    check_planes("dye", dye, (n, dye.shape[1], h, w))


def advect_velocity(u, v, dt, decay_rate, *, vel_stats=None,
                    return_stats: bool = False, packed: bool = False,
                    fast_path: bool = True):
    """Self-advection of (u, v) with decay; ``ops.ref.advect_velocity``
    semantics, or ``ops.advect_packed.advect_velocity``'s with ``packed``
    (kernel H8; ``fast_path`` and ``vel_stats`` steer its quiet branch).
    ``return_stats`` also returns the kernel-emitted [max|u'|, max|v'|]."""
    if not on_card(*_given(u, v, vel_stats)):
        if packed:
            return advect_packed.advect_velocity(
                u, v, dt, decay_rate, vel_stats=vel_stats,
                return_stats=return_stats, fast_path=fast_path)
        return ref.advect_velocity(u, v, dt, decay_rate, vel_stats=vel_stats,
                                   return_stats=return_stats)
    check_f32("u", u, u.shape)
    check_f32("v", v, u.shape)
    if packed and vel_stats is not None:
        check_f32("vel_stats", vel_stats, (2,))
    out = torch.empty((2,) + tuple(u.shape), dtype=torch.float32, device=u.device)
    stats = torch.empty((2,), dtype=torch.float32, device=u.device)
    _launch(PACKED if packed else VELOCITY_PASS, _VELOCITY, u, v, uv_out=out, stats=stats,
            vel_stats=vel_stats if packed else None, dt=dt, decay_rate=decay_rate,
            packed=packed, fast_path=fast_path)
    if return_stats:
        return out[0], out[1], stats
    return out[0], out[1]


def advect_dye(dye, u, v, dt, decay_rate, *, vel_stats=None,
               packed: bool = False, fast_path: bool = True, out=None):
    """Dye advection through the advected velocity with the fade
    fmin(1, c^1.005 * decay); ``ops.ref.advect_dye`` semantics, or
    ``ops.advect_packed.advect_dye``'s with ``packed`` (kernel H8).  The
    kernel writes each channel through its own pointer, so ``out`` may be
    channels 2-4 of the step's 5-channel pack (``ref.check_out``)."""
    if out is not None:
        ref.check_out(out, dye.shape, dye, u, v, vel_stats)
    if not on_card(*_given(dye, u, v, vel_stats, out)):
        if packed:
            return advect_packed.advect_dye(dye, u, v, dt, decay_rate,
                                            vel_stats=vel_stats,
                                            fast_path=fast_path, out=out)
        return ref.advect_dye(dye, u, v, dt, decay_rate, vel_stats=vel_stats,
                              out=out)
    h, w = u.shape
    check_f32("u", u, (h, w))
    check_f32("v", v, (h, w))
    _check_dye(dye, h, w)
    if packed and vel_stats is not None:
        check_f32("vel_stats", vel_stats, (2,))
    out = torch.empty_like(dye) if out is None else out
    _launch(PACKED if packed else DYE_PASS, _DYE, u, v, dye=dye, dye_out=out,
            vel_stats=vel_stats if packed else None, dt=dt, decay_rate=decay_rate,
            packed=packed, fast_path=fast_path)
    return out


def advect_both(u, v, dye, dt, decay_rate, *, vel_stats=None, return_stats: bool = False,
                out=None):
    """H1's velocity and dye advection in one launch: :func:`advect_velocity`
    then :func:`advect_dye` through its result, bit for bit, without
    writing u', v' to read them back.  Returns u', v', the dye (into
    ``out`` when given, as :func:`advect_dye`) [and the kernel-emitted
    [max|u'|, max|v'|]].  ``vel_stats`` is accepted for signature parity
    with the step's namespaces and unused (H1 has no quiet branch)."""
    if out is not None:
        ref.check_out(out, dye.shape, dye, u, v, vel_stats)
    if not on_card(*_given(u, v, dye, vel_stats, out)):
        u2, v2, st = ref.advect_velocity(u, v, dt, decay_rate, return_stats=True)
        dye2 = ref.advect_dye(dye, u2, v2, dt, decay_rate, out=out)
        return (u2, v2, dye2, st) if return_stats else (u2, v2, dye2)
    h, w = u.shape
    check_f32("u", u, (h, w))
    check_f32("v", v, (h, w))
    _check_dye(dye, h, w)
    uv = torch.empty((2, h, w), dtype=torch.float32, device=u.device)
    stats = torch.empty((2,), dtype=torch.float32, device=u.device)
    out = torch.empty_like(dye) if out is None else out
    _launch(KERNEL, _BOTH, u, v, uv_out=uv, dye=dye, dye_out=out, stats=stats, dt=dt,
            decay_rate=decay_rate)
    return (uv[0], uv[1], out, stats) if return_stats else (uv[0], uv[1], out)


class BothLaunch:
    """:func:`advect_both` prepared for one (device, stream, H, W) and 3 dye
    channels: the single step's H1 (``models/pipelines.py``).  The record
    of its C call is filled once (shape, mode, the bound's slots and counts,
    the stream); u', v' and the bound go to buffers of its own, so a call
    sets the planes' addresses, dt and the decay and makes one C call, the
    same launch with the same arguments as :func:`advect_both`'s.  Its
    buffers are rewritten by its next call: a caller that hands u', v' on
    reads them on the stream before that."""

    def __init__(self, device: torch.device, stream: int, h: int, w: int):
        self.uv = torch.empty((2, h, w), dtype=torch.float32, device=device)
        self.u, self.v = self.uv[0], self.uv[1]
        self.stats = torch.empty((2,), dtype=torch.float32, device=device)
        slot_count = _slot_count(h, w, 1)
        self._bounds = _BOUNDS.get(device, stream, 1, slot_count)
        self._plane = 4 * h * w
        self._rec = RowsArgs(
            ou=self.u.data_ptr(), ov=self.v.data_ptr(), stats=self.stats.data_ptr(),
            slots=self._bounds[0].data_ptr(), counts=self._bounds[1].data_ptr(), c=3, h=h,
            w=w, mode=_BOTH, nb=1, slot_count=slot_count, stream=stream)
        self._addr = ctypes.addressof(self._rec)
        KERNEL.lib()  # loaded now, not in a step

    def __call__(self, u, v, dye, out, dt, decay_rate):
        """H1 on u, v (H, W) and the dye (3, H, W), contiguous on the
        launch's device, into ``out`` (3, H, W), contiguous and apart from
        them; returns u', v'."""
        r, plane = self._rec, self._plane
        r.u, r.v = u.data_ptr(), v.data_ptr()
        d, o = dye.data_ptr(), out.data_ptr()
        r.d0, r.d1, r.d2 = d, d + plane, d + 2 * plane
        r.o0, r.o1, r.o2 = o, o + plane, o + 2 * plane
        r.dt, r.decay = float(ref.f32(dt)), ref.decay_factor(dt, decay_rate)
        KERNEL.launch("fluid_advect_rows_args", self._addr)
        return self.u, self.v


# the single step's prepared launch of this op (``models/pipelines.py``)
advect_both.prepare = BothLaunch


def _params(params, dt, decay_rate, device):
    return (member_params.upload(member_params.advect_cols(dt, decay_rate), device)
            if params is None else params)


def advect_velocity_batched(u, v, dt, decay_rate, *, vel_stats=None,
                            return_stats: bool = False, params=None, packed: bool = False,
                            fast_path: bool = True):
    """H1's velocity pass over B members: u, v (B, H, W) (each plane
    contiguous), dt (B,); ``ops.ref.advect_velocity_batched`` semantics, or
    with ``packed`` H8's, ``ops.advect_packed.advect_velocity_batched``
    (``fast_path`` and each member's row of ``vel_stats`` (B, 2) steer its
    quiet branch).  ``params``: the step's (B, >= 2) device rows [dt, decay]
    (``ops/member_params.py``), uploaded here when None.  Returns u', v'
    (B, H, W) [and stats (B, 2)]."""
    if not on_card(*_given(u, v, vel_stats)):
        if packed:
            return advect_packed.advect_velocity_batched(
                u, v, dt, decay_rate, vel_stats=vel_stats, return_stats=return_stats,
                fast_path=fast_path)
        return ref.advect_velocity_batched(u, v, dt, decay_rate,
                                           return_stats=return_stats)
    n, h, w = u.shape
    check_planes("u", u, (n, h, w))
    check_planes("v", v, (n, h, w))
    if packed and vel_stats is not None:
        check_f32("vel_stats", vel_stats, (n, 2))
    params = _params(params, ref.member_vec(dt, n), decay_rate, u.device)
    member_params.check(params, n, member_params.ADVECT_COLS, u.device)
    out = torch.empty((2, n, h, w), dtype=torch.float32, device=u.device)
    stats = torch.empty((n, 2), dtype=torch.float32, device=u.device)
    _launch(PACKED_BATCHED if packed else VELOCITY_PASS_BATCHED, _VELOCITY, u, v,
            uv_out=out, stats=stats, vel_stats=vel_stats if packed else None, params=params,
            packed=packed, fast_path=fast_path)
    return (out[0], out[1], stats) if return_stats else (out[0], out[1])


def advect_dye_batched(dye, u, v, dt, decay_rate, *, vel_stats=None, params=None, out=None,
                       packed: bool = False, fast_path: bool = True):
    """H1's dye pass over B members: dye (B, C, H, W) and u, v (B, H, W),
    each plane contiguous (the dye of a step is channels 2-4 of the last
    one's pack); ``ops.ref.advect_dye_batched`` semantics, or with
    ``packed`` H8's (``ops.advect_packed.advect_dye_batched``, each
    member's quiet branch from its row of ``vel_stats``).  ``out``
    (B, C, H, W) with contiguous planes (``ref.check_out_planes``), for
    example channels 2-4 of the step's (B, 5, H, W) pack."""
    if out is not None:
        ref.check_out_planes(out, dye.shape, dye, u, v, vel_stats)
    if not on_card(*_given(dye, u, v, vel_stats, out)):
        if packed:
            return advect_packed.advect_dye_batched(dye, u, v, dt, decay_rate,
                                                    vel_stats=vel_stats,
                                                    fast_path=fast_path, out=out)
        return ref.advect_dye_batched(dye, u, v, dt, decay_rate, out=out)
    n, h, w = u.shape
    check_planes("u", u, (n, h, w))
    check_planes("v", v, (n, h, w))
    _check_dye_batched(dye, n, h, w)
    if packed and vel_stats is not None:
        check_f32("vel_stats", vel_stats, (n, 2))
    params = _params(params, ref.member_vec(dt, n), decay_rate, u.device)
    member_params.check(params, n, member_params.ADVECT_COLS, u.device)
    out = torch.empty_like(dye) if out is None else out
    _launch(PACKED_BATCHED if packed else DYE_PASS_BATCHED, _DYE, u, v, dye=dye, dye_out=out,
            vel_stats=vel_stats if packed else None, params=params, packed=packed,
            fast_path=fast_path)
    return out


def advect_both_batched(u, v, dye, dt, decay_rate, *, vel_stats=None,
                        return_stats: bool = False, params=None, out=None):
    """:func:`advect_both` over B members: u, v (B, H, W), dye (B, C, H, W),
    each plane contiguous, dt (B,), ``params`` and ``out`` as
    :func:`advect_dye_batched`'s; :func:`advect_velocity_batched` then
    :func:`advect_dye_batched` bit for bit, in one launch.  Returns u', v'
    (B, H, W), the dye [and stats (B, 2)]."""
    if out is not None:
        ref.check_out_planes(out, dye.shape, dye, u, v, vel_stats)
    if not on_card(*_given(u, v, dye, vel_stats, out)):
        u2, v2, st = ref.advect_velocity_batched(u, v, dt, decay_rate, return_stats=True)
        dye2 = ref.advect_dye_batched(dye, u2, v2, dt, decay_rate, out=out)
        return (u2, v2, dye2, st) if return_stats else (u2, v2, dye2)
    n, h, w = u.shape
    check_planes("u", u, (n, h, w))
    check_planes("v", v, (n, h, w))
    _check_dye_batched(dye, n, h, w)
    params = _params(params, ref.member_vec(dt, n), decay_rate, u.device)
    member_params.check(params, n, member_params.ADVECT_COLS, u.device)
    uv = torch.empty((2, n, h, w), dtype=torch.float32, device=u.device)
    stats = torch.empty((n, 2), dtype=torch.float32, device=u.device)
    out = torch.empty_like(dye) if out is None else out
    _launch(BATCHED, _BOTH, u, v, uv_out=uv, dye=dye, dye_out=out, stats=stats, params=params)
    return (uv[0], uv[1], out, stats) if return_stats else (uv[0], uv[1], out)


def _check_cells(name, t, shape):
    """(h, w) float32 cells at a row pitch (a view of a padded plane's
    interior): unit column stride; returns the pitch."""
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if t.stride(-1) != 1 or t.stride(0) < t.shape[1]:
        raise ValueError(f"{name}: expected rows of unit stride")
    return t.stride(0)


def advect_window(fields, u, v, dt, decay_rate, mode: str, window: ref.Window, *,
                  vel_stats=None, return_stats: bool = False, packed: bool = False,
                  fast_path: bool = True, out=None):
    """Advection of the interior of a shard's padded view (``ref.Window``):
    ``fields`` (C <= 3, h + 2d, w + 2d_x), or (C, h_phys, w + 2d_x) for a
    rows-unbounded window, each plane contiguous; ``u``,
    ``v`` the (h, w) cells' velocity, rows of unit stride at one pitch (the
    interior of a padded plane may be passed as it lies).  ``mode``
    "field" (decay; ``return_stats`` also returns the interior's
    [max|u'|, max|v'|]) or "dye" (the fade; ``out`` (C, h, w) receives it).
    ``packed`` takes H8's bf16 taps, with ``fast_path`` and ``vel_stats``
    steering its quiet branch.  Semantics: ``advect_packed.window_plain``,
    the plain version on CPU tensors."""
    if out is not None:
        ref.check_out(out, (fields.shape[0],) + tuple(u.shape), fields, u, v, vel_stats)
    if not on_card(*_given(fields, u, v, vel_stats, out)):
        return advect_packed.window_plain(
            fields, u, v, dt, decay_rate, mode, window, vel_stats=vel_stats,
            return_stats=return_stats, packed=packed, fast_path=fast_path, out=out)
    if mode not in ("field", "dye"):
        raise ValueError(f"mode must be 'field' or 'dye', got {mode!r}")
    if return_stats and mode != "field":
        raise ValueError("return_stats: the velocity bound is the 'field' mode's")
    h, w = u.shape
    fh, fw = ref.window_shape(window, h, w)
    yi, d = ref.window_rows(window)
    if yi + h > fh:
        raise ValueError(f"window {window}: rows [{yi}, {yi + h}) lie outside the view")
    if fields.dim() != 3 or not 1 <= fields.shape[0] <= 3:
        raise ValueError(f"fields: expected (C<=3, H, W), got {tuple(fields.shape)}")
    check_planes("fields", fields, (fields.shape[0], fh, fw))
    pitch = _check_cells("u", u, (h, w))
    if _check_cells("v", v, (h, w)) != pitch:
        raise ValueError(f"u, v: row pitches differ ({pitch}, {v.stride(0)})")
    if vel_stats is not None:
        check_f32("vel_stats", vel_stats, (2,))
    w_phys = window.w_phys or fw
    if window.d_x == 0 and (window.x0 > 0 or w_phys - window.x0 > fw):
        raise ValueError(f"window {window}: columns [0, {w_phys}) lie outside the view")
    c = fields.shape[0]
    out = torch.empty((c, h, w), dtype=torch.float32, device=u.device) if out is None else out
    stats = torch.empty((2,), dtype=torch.float32, device=u.device) if return_stats else None
    scratch = (torch.empty((2,), dtype=torch.float32, device=u.device)
               if packed and fast_path and vel_stats is None else None)
    kern = PACKED_WINDOW if packed else WINDOW
    with torch.cuda.device(u.device):
        kern.launch(
            "fluid_advect_window", *_ptrs(list(fields)), *_ptrs(list(out)),
            u.data_ptr(), v.data_ptr(),
            vel_stats.data_ptr() if vel_stats is not None else None,
            scratch.data_ptr() if scratch is not None else None,
            stats.data_ptr() if stats is not None else None,
            c, h, w, int(mode == "dye"), int(bool(packed)), int(bool(fast_path)),
            float(ref.f32(dt)), ref.decay_factor(dt, decay_rate), window.y0, window.x0,
            window.h_phys, w_phys, d, window.d_x, yi, fw, pitch, stream_of(u))
    if return_stats:
        return out, stats
    return out
