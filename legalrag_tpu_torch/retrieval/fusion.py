"""Candidate fusion across retrieval channels (port of
``legalrag_tpu/retrieval/fusion.py``, pure Python on the host: the same
channel lists give the same candidates, scores and breakdowns, exactly).

Semantics parity with the reference ``HybridRetriever._fuse``
(``hybrid_retriever.py:389-551``): per-channel rank lists feed weighted RRF
with per-id per-channel contributions; per-channel scores are min-max
normalized over each channel's retrieved set; four methods are supported —
``rrf``, ``wrrf``, ``weighted_sum`` and the default ``rrf_norm_blend``:

    score = α · minmax(Σ_ch w_ch/(rrf_k + rank)) + (1−α) · Σ_ch w_ch · minmax(s_ch)

with α = ``rrf_alpha`` = 0.5 (the reference's *effective* behavior; its
``rrf_blend_alpha=0.6`` knob is dead — SURVEY.md §2.13.5). Every fused
candidate carries the full explainability payload (fusion method, weights,
channels sorted by contribution, rrf_norm, weighted_sum, per-channel norms)
matching ``hybrid_retriever.py:534-547``.

This host implementation operates on top-k candidate lists (tiny), keeping
rank semantics identical to the reference; the batched device path in
``ops/fused_query.py`` (``fused_hybrid_topk``) computes the same blend on
the device for the batched query engine.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence


@dataclass
class ChannelResult:
    """One channel's top-k: parallel arrays of corpus row ids and scores."""

    name: str
    weight: float
    rows: Sequence[int]
    scores: Sequence[float]


@dataclass
class FusedCandidate:
    row: int
    score: float
    breakdown: Dict = field(default_factory=dict)


def _minmax(values: Dict[int, float]) -> Dict[int, float]:
    if not values:
        return {}
    vals = list(values.values())
    lo, hi = min(vals), max(vals)
    if hi - lo < 1e-12:
        return {k: 1.0 for k in values}
    return {k: (v - lo) / (hi - lo) for k, v in values.items()}


def fuse(channels: List[ChannelResult], method: str = "rrf_norm_blend",
         rrf_k: int = 60, alpha: float = 0.5) -> List[FusedCandidate]:
    """Fuse channel top-k lists → candidates sorted by fused score desc."""
    chan_scores: Dict[str, Dict[int, float]] = {}
    chan_ranks: Dict[str, Dict[int, int]] = {}
    weights = {c.name: c.weight for c in channels}
    for c in channels:
        smap: Dict[int, float] = {}
        rmap: Dict[int, int] = {}
        for rank, (row, s) in enumerate(zip(c.rows, c.scores), start=1):
            row = int(row)
            if row not in smap:  # first (best) occurrence defines rank
                smap[row] = float(s)
                rmap[row] = rank
        chan_scores[c.name] = smap
        chan_ranks[c.name] = rmap

    all_rows = sorted({r for m in chan_scores.values() for r in m})
    if not all_rows:
        return []

    # weighted RRF totals + per-channel contributions
    rrf_total: Dict[int, float] = {}
    rrf_contrib: Dict[int, Dict[str, float]] = {r: {} for r in all_rows}
    plain_rrf: Dict[int, float] = {}
    for name, rmap in chan_ranks.items():
        w = weights[name]
        for row, rank in rmap.items():
            inc = 1.0 / (rrf_k + rank)
            plain_rrf[row] = plain_rrf.get(row, 0.0) + inc
            rrf_total[row] = rrf_total.get(row, 0.0) + w * inc
            rrf_contrib[row][name] = w * inc

    chan_norms = {name: _minmax(smap) for name, smap in chan_scores.items()}
    weighted_sum = {
        r: sum(weights[name] * chan_norms[name].get(r, 0.0)
               for name in chan_scores)
        for r in all_rows
    }
    rrf_norm = _minmax(rrf_total)

    out: List[FusedCandidate] = []
    for r in all_rows:
        if method == "rrf":
            score = plain_rrf.get(r, 0.0)
        elif method == "wrrf":
            score = rrf_total.get(r, 0.0)
        elif method == "weighted_sum":
            score = weighted_sum[r]
        else:  # rrf_norm_blend
            score = alpha * rrf_norm.get(r, 0.0) + (1 - alpha) * weighted_sum[r]
        per_channel = {
            name: {
                "score": chan_scores[name][r],
                "norm": chan_norms[name].get(r, 0.0),
                "rank": chan_ranks[name][r],
                "rrf": rrf_contrib[r].get(name, 0.0),
            }
            for name in chan_scores if r in chan_scores[name]
        }
        contrib = {name: weights[name] * chan_norms[name].get(r, 0.0)
                   + rrf_contrib[r].get(name, 0.0)
                   for name in per_channel}
        breakdown = {
            "fusion_method": method,
            "weights": {n: weights[n] for n in per_channel},
            "channels": sorted(per_channel, key=lambda n: -contrib[n]),
            "channel_contrib": contrib,
            "rrf_norm": rrf_norm.get(r, 0.0),
            "weighted_sum": weighted_sum[r],
            "per_channel": per_channel,
        }
        out.append(FusedCandidate(row=r, score=float(score), breakdown=breakdown))
    out.sort(key=lambda c: -c.score)
    return out
