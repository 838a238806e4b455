"""Retrieval-quality metrics (port of ``legalrag_tpu/evals/metrics.py``,
host code; the same rankings give the same numbers, exactly).

- Hit@K: gold appears in the top-K
- Recall@K: identical to Hit@K under one gold article per query
- MRR@K: 1/rank of the first gold within top-K else 0
- nDCG@K: 1/log2(rank+1) for a single gold, normalized (ideal = 1)
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence


def hit_at_k(ranked_ids: Sequence[str], gold: str, k: int) -> float:
    return 1.0 if gold in list(ranked_ids)[:k] else 0.0


def recall_at_k(ranked_ids: Sequence[str], gold: str, k: int) -> float:
    return hit_at_k(ranked_ids, gold, k)


def mrr_at_k(ranked_ids: Sequence[str], gold: str, k: int) -> float:
    for rank, rid in enumerate(list(ranked_ids)[:k], start=1):
        if rid == gold:
            return 1.0 / rank
    return 0.0


def ndcg_at_k(ranked_ids: Sequence[str], gold: str, k: int) -> float:
    for rank, rid in enumerate(list(ranked_ids)[:k], start=1):
        if rid == gold:
            return 1.0 / math.log2(rank + 1)
    return 0.0


def evaluate_one(ranked_ids: Sequence[str], gold: str) -> Dict[str, float]:
    return {
        "hit@3": hit_at_k(ranked_ids, gold, 3),
        "hit@10": hit_at_k(ranked_ids, gold, 10),
        "recall@5": recall_at_k(ranked_ids, gold, 5),
        "recall@10": recall_at_k(ranked_ids, gold, 10),
        "mrr@10": mrr_at_k(ranked_ids, gold, 10),
        "ndcg@10": ndcg_at_k(ranked_ids, gold, 10),
    }


def aggregate(per_query: List[Dict[str, float]]) -> Dict[str, Dict[str, float]]:
    """mean ± std per metric."""
    if not per_query:
        return {}
    keys = per_query[0].keys()
    out: Dict[str, Dict[str, float]] = {}
    for k in keys:
        vals = [p[k] for p in per_query]
        mean = sum(vals) / len(vals)
        var = sum((v - mean) ** 2 for v in vals) / len(vals)
        out[k] = {"mean": mean, "std": math.sqrt(var), "n": len(vals)}
    return out
