"""Spans for the profiler's trace, and the port's counters.

``span(name, ident)`` marks a stage of the step or a phase of a frame as a
range of the ``torch.profiler`` trace: the CLI's ``--profile-dir`` trace and
any other profiler session show it on the host's timeline, on the clock that
CUPTI puts the device's operations on, and each device operation launched
inside it is linked to it by its correlation id.  A span is recorded as an
operator's range (``RecordScope::FUNCTION``), not as a user annotation, so it
leaves no range of its own on the device's timeline, where a trace reader
would count it as device work.  The operator range is a private class of
PyTorch (``torch._C._profiler._RecordFunctionFast``); where a release lacks
it, every span is the no-op and the port runs on untraced.  Under
``torch.autograd.profiler.emit_nvtx()`` the gate is open as well, and the
profiler pushes each span as an NVTX range, for tools that read NVTX.

With no profiler running a span is one shared no-op context: the cost is one
call of ``torch.autograd._profiler_enabled()``, and ``ident`` (the step's or
frame's number, shared by its spans) is not even converted.  With a profiler
running, ``ident`` shows as the span's ``ident`` argument where the profiler
records shapes (``record_shapes=True``).

``counters()`` reads the seconds and counts of building and loading the
hand-written kernels' libraries (``ops._build.BUILD_STATS``): plain
counters, always on, that a library adds to once per process.
"""

from __future__ import annotations

import contextlib

import torch
from torch.autograd import _profiler_enabled

try:
    from torch._C._profiler import _RecordFunctionFast
except ImportError:  # a release without it: no spans
    _RecordFunctionFast = None

from cudafluidsimulation_tpu_torch.ops import _build

OFF = contextlib.nullcontext()


def span(name: str, ident=None):
    """A profiler range named ``name`` (letter for letter: trace readers join
    on it), or :data:`OFF` when no profiler runs.  ``ident``: an integer, or
    a tensor whose first element is one (a batched step's counter)."""
    if _RecordFunctionFast is None or not _profiler_enabled():
        return OFF
    if ident is None:
        return _RecordFunctionFast(name)
    if isinstance(ident, torch.Tensor):
        ident = ident.reshape(-1)[0]
    return _RecordFunctionFast(name, [], {"ident": int(ident)})


def counters() -> dict:
    """A snapshot, all in this process: ``build_s`` (seconds spent hashing
    sources, compiling and loading libraries), ``builds`` (libraries
    compiled) and ``loads`` (libraries loaded)."""
    return dict(_build.BUILD_STATS)
