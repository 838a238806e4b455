"""Cross-process file lock (fcntl flock).

The in-process concurrency model is single-writer-by-construction (one
TaskQueue worker), but split deployments run multiple processes against the
same index directory (docker-compose api/retrieval services). Index
publishes take this lock — the stdlib equivalent of the reference's
``filelock.FileLock`` usage around incremental writes
(``incremental_dense_builder.py:45-46``, ``orchestrator.py:45``).
"""

from __future__ import annotations

import contextlib
import fcntl
import os
from pathlib import Path
from typing import Iterator


@contextlib.contextmanager
def file_lock(path: str | Path) -> Iterator[None]:
    """Exclusive advisory lock on ``path`` (created if missing); blocks
    until acquired; released on exit even on error."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    fd = os.open(path, os.O_CREAT | os.O_RDWR, 0o644)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        yield
    finally:
        fcntl.flock(fd, fcntl.LOCK_UN)
        os.close(fd)
