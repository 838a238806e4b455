"""Profiler ranges (port of ``legalrag_tpu/utils/tracing.py:20-23``).

``trace_span(name)`` marks a host range on ``torch.profiler``'s timeline,
as ``jax.profiler.TraceAnnotation`` does on JAX's; the device work launched
inside it is attributed to the range. The serving path's stages
(``retrieval.channels``, ``retrieval.dense``, ...) keep the JAX names.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch


@contextlib.contextmanager
def trace_span(name: str) -> Iterator[None]:
    with torch.profiler.record_function(name):
        yield
