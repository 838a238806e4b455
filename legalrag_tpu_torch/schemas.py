"""Core data model of the query path: ``LawChunk`` and ``RetrievalHit``.

Keyword-only dataclasses with the JAX package's field names, order and
defaults (``legalrag_tpu/schemas.py:19-49``). ``LawChunk.to_json`` writes
the same line as pydantic's ``model_dump_json(exclude_none=True)`` (fields
in declaration order, ``None`` fields left out, compact separators,
non-ASCII kept as is), so ``chunks.jsonl`` reads and writes identically in
both packages.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Any, Dict, List, Optional


@dataclass(kw_only=True)
class LawChunk:
    """One retrievable unit: a statutory article or an ingested text chunk."""

    id: str
    law_name: str
    chapter: Optional[str] = None
    section: Optional[str] = None
    article_no: str
    article_id: str  # normalized numeric / canonical key for article_no
    text: str
    lang: Optional[str] = "zh"
    source: Optional[str] = None
    start_char: Optional[int] = None
    end_char: Optional[int] = None

    def to_json(self) -> str:
        d = {k: v for k, v in dataclasses.asdict(self).items()
             if v is not None}
        return json.dumps(d, ensure_ascii=False, separators=(",", ":"))

    @classmethod
    def from_json(cls, line: str) -> "LawChunk":
        d = json.loads(line)
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


@dataclass(kw_only=True)
class RetrievalHit:
    """A scored chunk with provenance and explainability payload."""

    chunk: LawChunk
    score: float
    rank: Optional[int] = None
    source: str = "retriever"  # "retriever" | "graph" | "rerank"
    semantic_score: Optional[float] = None
    graph_depth: Optional[int] = None
    relations: Optional[List[str]] = None
    seed_article_id: Optional[str] = None
    score_breakdown: Optional[Dict[str, Any]] = None
