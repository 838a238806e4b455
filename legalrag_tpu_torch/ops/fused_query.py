"""Fused hybrid query (port of ``legalrag_tpu/ops/fused_query.py:31-334``).

A query batch enters as device tensors and leaves as the fused top-k rows
plus per-channel components at those rows. Two modes, chosen as in JAX by
the form of ``impact``.

Map mode (``impact`` a dense [V, N] matrix), in order:

1. the hash sketch -> projection -> L2 norm (float32 matmul);
2. the BM25 query term counts, scattered on the device (duplicate ids add);
3. the dense channel's masked top-eff_k from the score+select kernel
   (``ops.topk.dense_topk``): the [B, N] dense map never exists;
4. BM25 as one [B, V] x [V, N] float32 matmul;
5. the late channel: the full-corpus MaxSim map from the MaxSim kernel
   (``ops.maxsim``), or, with ``late_candidates > 0``, MaxSim of the
   top-``late_candidates`` dense rows scattered into a NEG_INF map;
6. per channel: top-eff_k, 1-based ranks, weighted RRF ``w / (rrf_k + rank)``
   and weighted min-max over the channel's valid candidates;
7. ``alpha * minmax(rrf_total) + (1 - alpha) * sum of weighted min-max``
   over the union of candidates, non-candidates excluded, final top-k.

Large-corpus mode (``impact`` the CSR triple ``(offsets, post_docs,
post_w)`` of ``ops.bm25_sparse.build_postings``, ``qtf`` the pair
(term_ids, term_counts)): each channel gives a top-eff_k LIST and the lists
are fused (``fuse_candidate_lists``); no [B, N] fusion map exists.

1. the dense map (float32, or bf16 with ``dense_map_bf16``) and its masked
   top-eff_k, by the block-max two-pass selection from ``TWO_PASS_MIN_N``
   columns on; a bf16 map's winners are rescored exactly in float32;
2. BM25 from the postings (``ops.bm25_sparse.bm25_sparse_topk``, the
   hand-written CSR kernel on CUDA tensors);
3. exact MaxSim of the top ``late_candidates`` (default 128) dense rows,
   and its top-eff_k;
4. RRF + min-max over the concatenated lists per query, duplicate ids
   merged onto their first valid occurrence; the final top-k.

Ranking semantics are the JAX program's, with every ``lax.top_k`` replaced
by ``stable_topk`` (ties to the lower index). The map mode's packed
``dense`` component at the final rows is the exact float32 dot of the
store-dtype-rounded query with those rows, the value the JAX program
gathers from its dense map.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from legalrag_tpu_torch.models.hash_encoder import project_norm
from legalrag_tpu_torch.ops import topk as topk_ops
from legalrag_tpu_torch.ops.bm25 import bm25_scores_matmul, query_term_counts
from legalrag_tpu_torch.ops.bm25_sparse import bm25_sparse_topk
from legalrag_tpu_torch.ops.maxsim import maxsim_candidates, maxsim_full
from legalrag_tpu_torch.ops.topk import (
    NEG_INF,
    dense_scores,
    dense_scores_bf16,
    dense_topk,
    rescore_exact,
    stable_topk,
)

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
    # MaxSim on this many dense-prefiltered candidates (0 = full corpus in
    # map mode; the large-corpus mode takes 128 for 0)
    late_candidates: int = 0
    # postings gathered per query in the large-corpus mode (max_postings
    # // L per term slot)
    max_postings: int = 16384
    # large-corpus mode: select on a bf16 dense map, rescore the winners
    dense_map_bf16: bool = False


def _components_from_top(top_s: torch.Tensor, top_i: torch.Tensor, n: int,
                         weight: float, rrf_k: float
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Candidate mask / weighted-RRF / weighted-minmax maps [B, n] from one
    channel's ordered top list (zeros outside it)."""
    b, eff_k = top_s.shape
    valid = top_s > NEG_INF / 2
    rrf = torch.where(valid, _rrf_weights(weight, rrf_k, eff_k, top_s.device),
                      0.0)
    norm = _minmax(top_s, valid)

    def scatter(vals: torch.Tensor) -> torch.Tensor:
        out = torch.zeros((b, n), dtype=torch.float32, device=top_s.device)
        return out.scatter_(1, top_i, vals)

    return scatter(valid.float()), scatter(rrf), scatter(weight * norm)


def _rrf_weights(weight: float, rrf_k: float, k: int,
                 device: torch.device) -> torch.Tensor:
    """[1, k] ``weight / (rrf_k + rank)`` for ranks 1..k. The numerator is
    a float32 tensor: ``python_float / tensor`` is computed as
    reciprocal-then-multiply, 1 ulp off the IEEE quotient JAX produces."""
    ranks = torch.arange(1, k + 1, dtype=torch.float32, device=device)[None, :]
    w = torch.tensor(weight, dtype=torch.float32, device=device)
    return w / (rrf_k + ranks)


def _minmax(s: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Per-row min-max normalization over the valid entries (1.0 when they
    are all equal, 0.0 outside them)."""
    lo = torch.where(valid, s, float("inf")).amin(dim=-1, keepdim=True)
    hi = torch.where(valid, s, float("-inf")).amax(dim=-1, keepdim=True)
    span = torch.clamp(hi - lo, min=1e-12)
    return torch.where(valid, torch.where(hi > lo, (s - lo) / span, 1.0), 0.0)


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
    projection [D0, d]). ``impact`` is the dense [V, N] matrix (map mode,
    ``qtf`` a dense [B, V] count matrix or the pair (term_ids [B, L],
    term_mask [B, L])) or the CSR triple (large-corpus mode, ``qtf`` the pair
    (term_ids, term_counts))."""
    n = emb.shape[0]
    if isinstance(qvec, (tuple, list)):
        qvec = project_norm(*qvec)
    if isinstance(impact, (tuple, list)) and len(impact) == 3:
        raw = (dense_scores_bf16(emb, qvec) if params.dense_map_bf16
               else dense_scores(emb, qvec))
        return _fused_lists(raw, valid_n, emb, qvec, impact, doc_tok,
                            doc_mask, qtf, q_tok, q_mask, params)
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
    late_c = (min(params.late_candidates, n)
              if doc_tok is not None and params.late_candidates > 0 else 0)
    # one selection serves the dense channel and the late candidates: the
    # first k of a (score desc, row asc) list are the top k
    d_s, d_i = dense_topk(emb, qvec, valid_n, max(eff_k, late_c))
    bm25_s = mask_invalid(bm25_scores_matmul(impact, qtf))
    comps = [_components_from_top(d_s[:, :eff_k], d_i[:, :eff_k], n,
                                  params.w_dense, params.rrf_k),
             channel_components(bm25_s, eff_k, params.w_bm25, params.rrf_k)]
    late_s = None
    if late_c:
        cand = d_i[:, :late_c]
        late_s = torch.full((cand.shape[0], n), NEG_INF, dtype=torch.float32,
                            device=emb.device)
        late_s.scatter_(1, cand, maxsim_candidates(doc_tok, doc_mask, q_tok,
                                                   q_mask, cand))
        late_s = mask_invalid(late_s)
    elif doc_tok is not None:
        late_s = mask_invalid(maxsim_full(doc_tok, doc_mask, q_tok, q_mask))
    if late_s is not None:
        comps.append(channel_components(late_s, eff_k, params.w_late,
                                        params.rrf_k))

    cand_m = torch.zeros((qvec.shape[0], n), dtype=torch.float32,
                         device=emb.device)
    rrf_total = torch.zeros_like(cand_m)
    weighted_sum = torch.zeros_like(cand_m)
    for m, rrf, wnorm in comps:
        cand_m = torch.maximum(cand_m, m)
        rrf_total = rrf_total + rrf
        weighted_sum = weighted_sum + wnorm

    is_cand = cand_m > 0
    rrf_norm = _minmax(rrf_total, is_cand)
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


def fuse_candidate_lists(per: Sequence[Tuple[float, torch.Tensor, torch.Tensor]],
                         rrf_k: float, alpha: float, final_k: int
                         ) -> Dict[str, torch.Tensor]:
    """Candidate-list fusion, batched: ``per`` holds one ``(weight, scores
    [B, k_ch], ids [B, k_ch])`` per channel (lengths may differ; invalid
    slots score NEG_INF). Each list adds RRF at its own in-list rank and
    weighted min-max-normalized scores; a doc in several lists merges onto
    its first valid occurrence. Returns ``top_s``, ``rows``, ``pos`` [B,
    final_k] and the merged ``rrf_n`` and ``wsum_m`` [B, M] over the M
    concatenated slots."""
    ids = torch.cat([i for _, _, i in per], dim=1)                 # [B, M]
    valid = torch.cat([s > NEG_INF / 2 for _, s, _ in per], dim=1)
    dev = ids.device
    rrf = torch.where(valid, torch.cat(
        [_rrf_weights(w, rrf_k, s.shape[1], dev).expand_as(s)
         for w, s, _ in per], dim=1), 0.0)
    norms = torch.cat([w * _minmax(s, s > NEG_INF / 2) for w, s, _ in per],
                      dim=1)
    m = ids.shape[1]
    # eq[b, i, j]: slots i and j hold the same valid doc
    eq = ((ids[:, :, None] == ids[:, None, :]) & valid[:, :, None]
          & valid[:, None, :])
    slot = torch.arange(m, device=dev)
    first = (eq.to(torch.uint8).argmax(dim=2) == slot[None, :]) & valid
    rrf_m = torch.where(first, torch.where(eq, rrf[:, None, :], 0.0).sum(2),
                        0.0)
    wsum_m = torch.where(first, torch.where(eq, norms[:, None, :], 0.0).sum(2),
                         0.0)
    rrf_n = _minmax(rrf_m, first)
    score = torch.where(first, alpha * rrf_n + (1 - alpha) * wsum_m, NEG_INF)
    top_s, pos = stable_topk(score, final_k)
    return {"top_s": top_s, "rows": torch.gather(ids, 1, pos), "pos": pos,
            "rrf_n": rrf_n, "wsum_m": wsum_m}


def _fused_lists(dense_s: torch.Tensor, valid_n: int, emb: torch.Tensor,
                 qvec: torch.Tensor, sparse_impact, doc_tok, doc_mask,
                 qtf_pair, q_tok, q_mask, params: FusedParams
                 ) -> Dict[str, torch.Tensor]:
    """The large-corpus mode (see the module docstring). As in JAX, a
    channel with fewer than eff_k matches contributes only its real matches
    (the map mode pads such a channel with zero-score docs)."""
    n = dense_s.shape[1]
    eff_k = min(params.eff_k, n)
    offsets, post_docs, post_w = sparse_impact
    term_ids, term_counts = qtf_pair

    if n >= topk_ops.TWO_PASS_MIN_N:
        def dsel(kk: int):
            return topk_ops.topk_2pass_masked(dense_s, valid_n, kk)
    else:
        col = torch.arange(n, device=dense_s.device)[None, :]
        dense_masked = torch.where(col < valid_n, dense_s, NEG_INF)

        def dsel(kk: int):
            return stable_topk(dense_masked, kk)

    d_s, d_i = dsel(eff_k)
    if dense_s.dtype == torch.bfloat16:
        d_s, d_i = rescore_exact(emb, qvec, d_s, d_i)
    b_s, b_i = bm25_sparse_topk(term_ids, term_counts.to(torch.int32),
                                offsets, post_docs, post_w, eff_k,
                                max_postings=params.max_postings, n_docs=n)
    lists: List[Tuple[float, torch.Tensor, torch.Tensor]] = [
        (params.w_dense, d_s, d_i), (params.w_bm25, b_s, b_i)]
    if doc_tok is not None:
        c = min(params.late_candidates or 128, n)
        cand = d_i[:, :c] if c <= eff_k else dsel(c)[1]
        l_s, pos = stable_topk(maxsim_candidates(doc_tok, doc_mask, q_tok,
                                                 q_mask, cand), min(eff_k, c))
        lists.append((params.w_late, l_s, torch.gather(cand, 1, pos)))

    r = fuse_candidate_lists(lists, params.rrf_k, params.alpha,
                             min(params.final_k, n))
    rows, pos = r["rows"], r["pos"]

    def lookup(s_list: torch.Tensor, i_list: torch.Tensor) -> torch.Tensor:
        # the list's score of each final row, 0 where the row is not in it
        hit = ((rows[:, :, None] == i_list[:, None, :])
               & (s_list[:, None, :] > NEG_INF / 2))
        val = torch.where(hit, s_list[:, None, :], NEG_INF).amax(2)
        return torch.where(val > NEG_INF / 2, val, 0.0)

    comps = [r["top_s"], lookup(d_s, d_i), lookup(b_s, b_i),
             torch.gather(r["rrf_n"], 1, pos),
             torch.gather(r["wsum_m"], 1, pos)]
    if len(lists) > 2:
        comps.append(lookup(lists[2][1], lists[2][2]))
    return {"rows": rows, "packed": torch.stack(comps, dim=-1)}
