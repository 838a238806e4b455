"""Per-request id propagation (port of ``legalrag_tpu/llm/context.py``).

The server sets a request id per HTTP request; every LLM log line reads it
from the contextvar, which survives thread hops through
``contextvars.copy_context``.
"""

from __future__ import annotations

import contextvars
from typing import Optional

_request_id: contextvars.ContextVar[Optional[str]] = contextvars.ContextVar(
    "request_id", default=None)


def set_request_id(rid: Optional[str]):
    return _request_id.set(rid)


def get_request_id() -> Optional[str]:
    return _request_id.get()


def reset_request_id(token) -> None:
    _request_id.reset(token)
