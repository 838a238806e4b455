"""LLM gateway: timeout and retry wrapper (port of
``legalrag_tpu/llm/gateway.py``).

``chat`` runs on a worker thread (the contextvars copied, so request ids
survive the hop) with a hard timeout and exponential-backoff retries; when
they run out it returns the client's degraded answer rather than raising.
``chat_stream`` passes through untimed (the SSE layer owns the stream's
liveness).
"""

from __future__ import annotations

import contextvars
import time
from concurrent.futures import ThreadPoolExecutor, TimeoutError as FutureTimeout
from typing import List

from legalrag_tpu_torch.llm.client import LLMClient, Message
from legalrag_tpu_torch.llm.context import get_request_id
from legalrag_tpu_torch.utils import get_logger

log = get_logger("torch.llm.gateway")


class LLMGateway:
    def __init__(self, client: LLMClient, request_timeout: float = None,
                 max_retries: int = None, backoff: float = None):
        self.client = client
        cfg = client.cfg
        self.request_timeout = request_timeout or cfg.request_timeout
        self.max_retries = cfg.max_retries if max_retries is None else max_retries
        self.backoff = backoff or cfg.retry_backoff
        self._pool = ThreadPoolExecutor(max_workers=8,
                                        thread_name_prefix="llm-gateway")

    def chat(self, messages: List[Message], tag: str = "chat", **kw) -> str:
        ctx = contextvars.copy_context()
        last_err = None
        for attempt in range(self.max_retries + 1):
            future = self._pool.submit(ctx.run, self.client.chat, messages,
                                       tag, **kw)
            try:
                return future.result(timeout=self.request_timeout)
            except FutureTimeout as e:
                future.cancel()
                last_err = e
                log.warning("[%s] llm %s timed out (attempt %d/%d)",
                            get_request_id(), tag, attempt + 1,
                            self.max_retries + 1)
            except Exception as e:
                last_err = e
                log.warning("[%s] llm %s error: %s", get_request_id(), tag, e)
            if attempt < self.max_retries:
                time.sleep(self.backoff * (2 ** attempt))
        log.error("[%s] llm %s exhausted retries: %s", get_request_id(), tag,
                  last_err)
        return self.client.degraded_answer(messages)

    def close(self) -> None:
        """Shut the retry pool and close the client (the SIGTERM drain).
        Idempotent."""
        try:
            self._pool.shutdown(wait=False)
        finally:
            if hasattr(self.client, "close"):
                self.client.close()

    def chat_stream(self, messages: List[Message], tag: str = "chat", **kw):
        return self.client.chat_stream(messages, tag, **kw)

    @property
    def is_degraded(self) -> bool:
        return self.client.is_degraded

    def degraded_answer(self, messages: List[Message]) -> str:
        return self.client.degraded_answer(messages)
