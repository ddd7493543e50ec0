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
hand-written kernels' libraries (``ops._build.BUILD_STATS``), which a
library adds to once per process, H3's and H4's calls on the card and the
passes over device memory they made (``ops.jacobi_cuda.DIFFUSE_STATS``,
``PRESSURE_STATS``), which their wrappers and prepared launches add to at
each call, the single steps on the card and their stages that took a
prepared launch (``models.pipelines.STEP_STATS``), and the multigrid solves,
their V-cycles and their stopping reads (``ops.multigrid.MG_STATS``): plain
counters, always on.
"""

from __future__ import annotations

import contextlib

import torch
from torch.autograd import _profiler_enabled

try:
    from torch._C._profiler import _RecordFunctionFast
except ImportError:  # a release without it: no spans
    _RecordFunctionFast = None

from cudafluidsimulation_tpu_torch.ops import _build, jacobi_cuda

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
    compiled), ``loads`` (libraries loaded), ``diffuse_calls`` and
    ``pressure_calls`` (H3's and H4's calls on the card, single and batched,
    through a wrapper or a prepared launch), ``diffuse_passes`` and
    ``pressure_passes`` (the launches of a pass over device memory those
    calls made), ``step_calls`` (single steps whose state lies on the
    current card), ``planned_stages`` (the stage calls of those steps
    made through a prepared launch), ``mg_solves`` (multigrid solves on any
    device, one a call of a solve entry, single or batched), ``mg_cycles``
    (their completed V-cycles) and ``mg_reads`` (their residual-targeted
    stopping reads, k + 1 for a solve of k cycles)."""
    # both import this module
    from cudafluidsimulation_tpu_torch.models import pipelines
    from cudafluidsimulation_tpu_torch.ops import multigrid

    return {**_build.BUILD_STATS, **jacobi_cuda.DIFFUSE_STATS, **jacobi_cuda.PRESSURE_STATS,
            **pipelines.STEP_STATS, **multigrid.MG_STATS}
