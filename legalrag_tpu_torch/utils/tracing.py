"""Profiler ranges and sessions (port of ``legalrag_tpu/utils/tracing.py``).

``trace_span(name)`` marks a host range on ``torch.profiler``'s timeline,
as ``jax.profiler.TraceAnnotation`` does on JAX's; the device work launched
inside it is attributed to the range. The serving path's stages
(``retrieval.channels``, ``retrieval.dense``, ...) keep the JAX names.

``profile_session(logdir)`` records a ``torch.profiler`` trace of the host
and, where the process uses a card, of the card around a region and writes
it under ``logdir`` (or ``LEGALRAG_TRACE_DIR``) as a Chrome trace that
TensorBoard or Perfetto opens; with neither set it does nothing, as in JAX.
"""

from __future__ import annotations

import contextlib
import os
import time
from pathlib import Path
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def trace_span(name: str) -> Iterator[None]:
    with torch.profiler.record_function(name):
        yield


@contextlib.contextmanager
def profile_session(logdir: Optional[str] = None) -> Iterator[None]:
    """Capture a profiler trace around a region when a log dir is set
    (argument or ``LEGALRAG_TRACE_DIR``); a no-op otherwise."""
    logdir = logdir or os.environ.get("LEGALRAG_TRACE_DIR")
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(logdir)
    out.mkdir(parents=True, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(str(out / f"trace_{os.getpid()}_"
                                           f"{time.time_ns()}.json"))
