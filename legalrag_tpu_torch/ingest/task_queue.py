"""Single-worker background task queue (port of
``legalrag_tpu/ingest/task_queue.py``).

One daemon worker drains ``(fn, args, kwargs)`` in order; a task that
raises is logged and never stops the worker. One worker means one writer:
the ingest jobs that grow a live bundle never run at the same time.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Optional

from legalrag_tpu_torch.utils import get_logger

log = get_logger("torch.task_queue")


class TaskQueue:
    def __init__(self, name: str = "ingest"):
        self._q: "queue.Queue" = queue.Queue()
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name=f"taskqueue-{name}")
        self._worker.start()

    def enqueue(self, fn: Callable, *args: Any, **kwargs: Any) -> None:
        self._q.put((fn, args, kwargs))

    def _run(self) -> None:
        while True:
            fn, args, kwargs = self._q.get()
            try:
                fn(*args, **kwargs)
            except Exception as e:
                log.error("task %s failed: %s", getattr(fn, "__name__", fn), e,
                          exc_info=True)
            finally:
                self._q.task_done()

    def join(self, timeout: Optional[float] = None) -> bool:
        """Wait until every task queued so far has run; False when
        ``timeout`` seconds pass first."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while not self._q.empty() or self._q.unfinished_tasks:
            if deadline is not None and time.monotonic() > deadline:
                return False
            time.sleep(0.02)
        return True
