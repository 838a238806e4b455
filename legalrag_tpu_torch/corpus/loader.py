"""Chunk JSONL IO (port of ``legalrag_tpu/corpus/loader.py``): the reader
and the writer of a bundle's ``chunks.jsonl``, of the processed corpora
(``law_{lang}.jsonl``) and of the ingested documents
(``ingested_<doc_id>.jsonl``). The line format is the JAX package's byte for
byte (``LawChunk.to_json``).

``load_chunks_from_dir`` streams every ``*.jsonl`` file of a processed
directory in name order, keeps the first chunk of each id, and optionally
only one language's.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Iterable, Iterator, List, Optional

from legalrag_tpu_torch.schemas import LawChunk


def iter_chunks_from_file(path: str | Path) -> Iterator[LawChunk]:
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line:
                yield LawChunk.from_json(line)


def load_chunks_from_dir(processed_dir: str | Path,
                         lang: Optional[str] = None) -> List[LawChunk]:
    seen: set[str] = set()
    out: List[LawChunk] = []
    d = Path(processed_dir)
    if not d.exists():
        return out
    for path in sorted(d.glob("*.jsonl")):
        for chunk in iter_chunks_from_file(path):
            if lang is not None and chunk.lang != lang:
                continue
            if chunk.id in seen:
                continue
            seen.add(chunk.id)
            out.append(chunk)
    return out


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
