"""Chunk JSONL IO: the reader and the writer of a bundle's
``chunks.jsonl``. The line format is the JAX package's byte for byte
(``LawChunk.to_json``).
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Iterable, Iterator

from legalrag_tpu_torch.schemas import LawChunk


def iter_chunks_from_file(path: str | Path) -> Iterator[LawChunk]:
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line:
                yield LawChunk.from_json(line)


def write_chunks_jsonl(chunks: Iterable[LawChunk], path: str | Path) -> int:
    """Atomic write (tmp + os.replace, matching the reference's publish
    pattern, e.g. ``graph_builder.py:204,461``)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(path.suffix + ".tmp")
    n = 0
    with open(tmp, "w", encoding="utf-8") as f:
        for c in chunks:
            f.write(c.to_json() + "\n")
            n += 1
    os.replace(tmp, path)
    return n
