"""Named spans at the layer boundaries of the port's execute path.

``span(name)`` is ``torch.profiler.record_function("repro_torch." + name)``
while a profiler is active, and otherwise one shared no-op context, so a
span costs only the guard (``torch.autograd._profiler_enabled()``) when no
one traces.  The spans are recorded only under ``torch.profiler`` /
``torch.autograd.profiler``: that profiler is the recorder, so the spans
carry its clock and each is comparable with the CUPTI device intervals of
the same trace.  Kineto mirrors each span onto the device timeline as a
user annotation (``FunctionEvent.is_user_annotation``), which a reader of
device operations leaves out.
"""

from __future__ import annotations

import contextlib

import torch
from torch.profiler import record_function

__all__ = ["span"]

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context that records ``repro_torch.<name>`` while a profiler is
    active, else the shared no-op context."""
    if torch.autograd._profiler_enabled():
        return record_function("repro_torch." + name)
    return _OFF
