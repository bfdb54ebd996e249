"""Spans at the program's layer boundaries, on the PyTorch profiler's clock.

``with span("serve.admit"): ...`` marks a stretch of the program. While a
``torch.profiler`` (or ``torch.autograd.profiler``) session records, the
span is a user range of the profiler, as ``torch.profiler.record_function``
opens one: it sits in the profiler's own event list beside the operators it
encloses and the device's kernels, on the same clock, so a gap in the
device's timeline can be put down to what the program was doing. The range
is opened by ``record_function``'s light form, ``_RecordFunctionFast``
(torch 2.2 on), which records the same event for about a tenth of
``record_function``'s host time under a profiler, so that a traced run is
slowed less; older torch falls back to ``record_function``. With no
profiler recording, ``span`` returns one shared no-op context manager after
a single flag read: it allocates nothing and costs well under a
microsecond, where a bare ``record_function`` costs some ten.

The span names are listed in ``README.md``'s section on the PyTorch/CUDA
port, and the metrics of ``perfbench/`` that read them in ``PERF.md``.
"""
from __future__ import annotations

import contextlib

import torch

_OFF = contextlib.nullcontext()
_ON = getattr(torch._C._profiler, "_RecordFunctionFast", None) or torch.profiler.record_function


def span(name: str):
    """A profiler range named ``name`` while a profiler records, else a
    shared no-op context manager."""
    if not torch._C._autograd._profiler_enabled():
        return _OFF
    return _ON(name)
