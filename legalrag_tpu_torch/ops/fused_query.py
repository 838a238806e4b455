"""Fused hybrid query, map mode (port of
``legalrag_tpu/ops/fused_query.py:31-70, 73-203``).

A query batch enters as device tensors and leaves as the fused top-k rows
plus per-channel components at those rows. In order:

1. the hash sketch -> projection -> L2 norm (float32 matmul);
2. the BM25 query term counts, scattered on the device (duplicate ids add);
3. the dense channel's masked top-eff_k from the score+select kernel
   (``ops.topk.dense_topk``): the [B, N] dense map never exists;
4. BM25 as one [B, V] x [V, N] float32 matmul;
5. the full-corpus MaxSim map from the MaxSim kernel (``ops.maxsim``);
6. per channel: top-eff_k, 1-based ranks, weighted RRF ``w / (rrf_k + rank)``
   and weighted min-max over the channel's valid candidates;
7. ``alpha * minmax(rrf_total) + (1 - alpha) * sum of weighted min-max``
   over the union of candidates, non-candidates excluded, final top-k.

Ranking semantics are the JAX program's, with every ``lax.top_k`` replaced
by ``stable_topk`` (ties to the lower row). The packed ``dense`` component
at the final rows is the exact float32 dot of the store-dtype-rounded query
with those rows, the value the JAX program gathers from its dense map.

Not ported yet: CSR impact (large-corpus mode) and ``late_candidates > 0``
(MaxSim on dense-prefiltered candidates); both raise NotImplementedError.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from legalrag_tpu_torch.models.hash_encoder import project_norm
from legalrag_tpu_torch.ops.bm25 import bm25_scores_matmul, query_term_counts
from legalrag_tpu_torch.ops.maxsim import maxsim_full
from legalrag_tpu_torch.ops.topk import NEG_INF, dense_topk, stable_topk

# packed-component order along the last axis of ``packed`` (colbert present
# only when the late channel ran)
PACKED_NAMES = ("scores", "dense", "bm25", "rrf_norm", "weighted_sum",
                "colbert")


@dataclass(frozen=True)
class FusedParams:
    eff_k: int
    final_k: int
    rrf_k: float
    alpha: float
    w_dense: float
    w_bm25: float
    w_late: float
    # MaxSim on this many dense-prefiltered candidates (0 = full corpus);
    # only 0 is ported
    late_candidates: int = 0


def _components_from_top(top_s: torch.Tensor, top_i: torch.Tensor, n: int,
                         weight: float, rrf_k: float
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Candidate mask / weighted-RRF / weighted-minmax maps [B, n] from one
    channel's ordered top list (zeros outside it)."""
    b, eff_k = top_s.shape
    valid = top_s > NEG_INF / 2
    ranks = torch.arange(1, eff_k + 1, dtype=torch.float32,
                         device=top_s.device)[None, :]
    zero = torch.zeros((), dtype=torch.float32, device=top_s.device)
    # a float32 tensor numerator: ``python_float / tensor`` is computed as
    # reciprocal-then-multiply, 1 ulp off the IEEE quotient JAX produces
    w = torch.tensor(weight, dtype=torch.float32, device=top_s.device)
    rrf = torch.where(valid, w / (rrf_k + ranks), zero)
    lo = torch.where(valid, top_s, float("inf")).amin(dim=1, keepdim=True)
    hi = torch.where(valid, top_s, float("-inf")).amax(dim=1, keepdim=True)
    span = torch.clamp(hi - lo, min=1e-12)
    norm = torch.where(valid, torch.where(hi > lo, (top_s - lo) / span, 1.0),
                       zero)

    def scatter(vals: torch.Tensor) -> torch.Tensor:
        out = torch.zeros((b, n), dtype=torch.float32, device=top_s.device)
        return out.scatter_(1, top_i, vals)

    return scatter(valid.float()), scatter(rrf), scatter(weight * norm)


def channel_components(scores: torch.Tensor, eff_k: int, weight: float,
                       rrf_k: float
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``_channel_components`` of the JAX package: the same three [B, N]
    maps from a full score map."""
    n = scores.shape[1]
    top_s, top_i = stable_topk(scores, min(eff_k, n))
    return _components_from_top(top_s, top_i, n, weight, rrf_k)


def fused_hybrid_topk(emb: torch.Tensor, impact, doc_tok: Optional[torch.Tensor],
                      doc_mask: Optional[torch.Tensor], qvec, qtf,
                      q_tok: Optional[torch.Tensor],
                      q_mask: Optional[torch.Tensor], valid_n: int,
                      params: FusedParams) -> Dict[str, torch.Tensor]:
    """Final top-k ``rows`` [B, k] (int64) and ``packed`` [B, k, 5 or 6]
    components (``PACKED_NAMES`` order).

    ``qvec`` is ready [B, d] query embeddings or the pair (sketch [B, D0],
    projection [D0, d]); ``qtf`` a dense [B, V] count matrix or the pair
    (term_ids [B, L], term_mask [B, L])."""
    n = emb.shape[0]
    if isinstance(impact, (tuple, list)):
        raise NotImplementedError("CSR impact (large-corpus mode) is not "
                                  "ported yet")
    if doc_tok is not None and params.late_candidates > 0:
        raise NotImplementedError("late_candidates > 0 is not ported yet")
    if isinstance(qvec, (tuple, list)):
        qvec = project_norm(*qvec)
    if isinstance(qtf, (tuple, list)):
        qtf = query_term_counts(qtf[0], qtf[1], impact.shape[0])

    def mask_invalid(s: torch.Tensor) -> torch.Tensor:
        # channels pad the doc axis differently (impact: N rounded to 128,
        # dense capacity: to capacity_round); align to the dense capacity n
        if s.shape[1] < n:
            s = torch.nn.functional.pad(s, (0, n - s.shape[1]), value=NEG_INF)
        elif s.shape[1] > n:
            s = s[:, :n]
        col = torch.arange(n, device=s.device)[None, :]
        return torch.where(col < valid_n, s, torch.full_like(s, NEG_INF))

    eff_k = min(params.eff_k, n)
    d_s, d_i = dense_topk(emb, qvec, valid_n, eff_k)
    bm25_s = mask_invalid(bm25_scores_matmul(impact, qtf))
    comps = [_components_from_top(d_s, d_i, n, params.w_dense, params.rrf_k),
             channel_components(bm25_s, eff_k, params.w_bm25, params.rrf_k)]
    late_s = None
    if doc_tok is not None:
        late_s = mask_invalid(maxsim_full(doc_tok, doc_mask, q_tok, q_mask))
        comps.append(channel_components(late_s, eff_k, params.w_late,
                                        params.rrf_k))

    cand = torch.zeros((qvec.shape[0], n), dtype=torch.float32,
                       device=emb.device)
    rrf_total = torch.zeros_like(cand)
    weighted_sum = torch.zeros_like(cand)
    for m, rrf, wnorm in comps:
        cand = torch.maximum(cand, m)
        rrf_total = rrf_total + rrf
        weighted_sum = weighted_sum + wnorm

    is_cand = cand > 0
    lo = torch.where(is_cand, rrf_total, float("inf")).amin(dim=1, keepdim=True)
    hi = torch.where(is_cand, rrf_total, float("-inf")).amax(dim=1, keepdim=True)
    span = torch.clamp(hi - lo, min=1e-12)
    zero = torch.zeros((), dtype=torch.float32, device=emb.device)
    rrf_norm = torch.where(
        is_cand, torch.where(hi > lo, (rrf_total - lo) / span, 1.0), zero)
    final = torch.where(
        is_cand, params.alpha * rrf_norm + (1 - params.alpha) * weighted_sum,
        torch.full_like(rrf_norm, NEG_INF))
    top_s, top_i = stable_topk(final, min(params.final_k, n))

    # the dense map at the final rows: exact f32 dots (B * final_k * d)
    qf = qvec.to(emb.dtype).float()
    dense_at = torch.einsum("bd,bkd->bk", qf, emb[top_i].float())
    dense_at = torch.where(top_i < valid_n, dense_at,
                           torch.full_like(dense_at, NEG_INF))

    def gather(s: torch.Tensor) -> torch.Tensor:
        return torch.gather(s, 1, top_i)

    packed = [top_s, dense_at, gather(bm25_s), gather(rrf_norm),
              gather(weighted_sum)]
    if late_s is not None:
        packed.append(gather(late_s))
    return {"rows": top_i, "packed": torch.stack(packed, dim=-1)}
