"""Extractive synthetic queries (port of ``scripts/generate_synthetic_data.py
:43-121``): the no-LLM generator that ``cli/train_encoder.py`` trains on by
default.

Questions are formed from article sentences: citations stripped, one
clause dropped, and with ``hardness`` that fraction of the remaining
tokens dropped too; the reference's quality gates reject the rest. The
rows (``{query, lang, role, article_id, score}``) are those of the JAX
script for the same chunks and seed: Python's ``random.Random`` in the
same order of draws, and the port's tokenizer, which is JAX's.
"""

from __future__ import annotations

import random
import re
from typing import Dict, List

from legalrag_tpu_torch.schemas import LawChunk
from legalrag_tpu_torch.tokenize import tokenize
from legalrag_tpu_torch.utils import detect_lang

_CITATION_ZH = re.compile(r"(本法|依照|根据)?第[零一二三四五六七八九十百千万\d]+条")
_CITATION_EN = re.compile(r"(§+\s*[\dA-Za-z.-]+|[Ss]ection\s+[\dA-Za-z.-]+)")
_DEICTIC = re.compile(r"^(这|那|该|此|it|this|that)\b", re.IGNORECASE)


def strip_citations(text: str) -> str:
    return _CITATION_EN.sub("", _CITATION_ZH.sub("", text)).strip()


def quality_ok(query: str, lang: str) -> bool:
    """The reference's gates: no citations, not deictic, not a verbatim
    article, bounded length."""
    q = query.strip()
    if not (8 <= len(q) <= 120):
        return False
    if _CITATION_ZH.search(q) or _CITATION_EN.search(q):
        return False
    if _DEICTIC.match(q):
        return False
    if lang == "zh" and re.match(r"^第.{1,8}条", q):
        return False  # article-like
    return True


def extractive_queries(chunks: List[LawChunk], n: int, seed: int,
                       per_article: int = 1, hardness: float = 0.0
                       ) -> List[Dict]:
    """Up to ``per_article`` queries from each article in a seeded order,
    at most ``n`` in all. ``hardness`` in [0, 1) drops that fraction of
    the remaining tokens, lowering the lexical overlap with the gold
    article."""
    rng = random.Random(seed)
    rows: List[Dict] = []
    order = list(range(len(chunks)))
    rng.shuffle(order)
    for idx in order:
        c = chunks[idx]
        lang = c.lang or detect_lang(c.text)
        body = strip_citations(c.text)
        sents = [s.strip() for s in re.split(r"[。；！？.\n;!?]", body)
                 if 10 <= len(s.strip()) <= 90]
        rng.shuffle(sents)
        added = 0
        for s in sents:
            # drop a random clause to avoid verbatim self-retrieval
            parts = re.split(r"[，,]", s)
            if len(parts) > 2:
                del parts[rng.randrange(len(parts))]
                s = "，".join(parts) if lang == "zh" else ", ".join(parts)
            if hardness > 0:
                kept = [t for t in tokenize(s, lang) if rng.random() >= hardness]
                if len(kept) < 4:
                    continue
                s = ("" if lang == "zh" else " ").join(kept)
            if not quality_ok(s, lang):
                continue
            rows.append({"query": s, "lang": lang, "role": "extractive",
                         "article_id": c.article_id, "score": None})
            added += 1
            if added >= per_article:
                break
        if len(rows) >= n:
            break
    return rows[:n]
