"""Named host spans of the search engines, on exactly while a profiler runs.

``span(name)`` is a ``torch.profiler.record_function`` range while a
``torch.profiler`` session is recording, so the spans land in the same
kineto trace, on the same clock, as the device's kernels and the CUDA
runtime calls; otherwise it is one shared no-op context, which costs about
what a bare ``nullcontext`` does. There is no switch: profiling turns the
spans on.
"""

from __future__ import annotations

import contextlib

import torch

_OFF = contextlib.nullcontext()


def span(name: str):
    """A ``record_function(name)`` range under a profiler, else a no-op."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF
