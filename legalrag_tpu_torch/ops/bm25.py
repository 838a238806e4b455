"""BM25 scoring math (port of ``legalrag_tpu/ops/bm25.py:35-81``).

Numeric parity with ``rank_bm25.BM25Okapi``:

- ``idf_t = ln(N - df_t + 0.5) - ln(df_t + 0.5)``, negative idfs floored to
  ``epsilon * mean(idf)`` (mean over the raw idfs, ``epsilon = 0.25``);
- ``score(q, d) = sum_{t in q} idf_t * tf_td (k1 + 1) / (tf_td + k1 (1 - b + b dl_d / avgdl))``.

The per-(term, doc) contribution is query-independent, so scoring is
``S = Q @ C`` with Q the [B, V] query term counts and C the dense [V, N]
impact matrix built here on the host (the same numpy code as the JAX
package, so the impact matrices are bit-equal). The product is one float32
``torch.matmul`` (the JAX package leaves it to XLA as well). ``bm25_topk``
selects from that map with ``topk_large``, whose order is ``lax.top_k``'s:
the many docs that score exactly 0 come lowest index first.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from legalrag_tpu_torch.ops.topk import mask_cols, topk_large


def compute_idf(df: np.ndarray, n_docs: int, epsilon: float = 0.25) -> np.ndarray:
    """Vocabulary idf vector with BM25Okapi's negative-idf epsilon floor."""
    df = np.asarray(df, np.float64)
    idf = np.log(n_docs - df + 0.5) - np.log(df + 0.5)
    if idf.size:
        avg = idf.mean()
        idf = np.where(idf < 0, epsilon * avg, idf)
    return idf


def build_impact_matrix(doc_term_ids: Sequence[np.ndarray],
                        doc_term_freqs: Sequence[np.ndarray],
                        vocab_size: int, k1: float = 1.5, b: float = 0.75,
                        epsilon: float = 0.25) -> np.ndarray:
    """Dense [V, N] float32 impact matrix from per-doc (term_id, tf) pairs."""
    n_docs = len(doc_term_ids)
    df = np.zeros(vocab_size, np.int64)
    doc_len = np.zeros(n_docs, np.float64)
    for d, (ids, tfs) in enumerate(zip(doc_term_ids, doc_term_freqs)):
        df[ids] += 1
        doc_len[d] = tfs.sum()
    avgdl = doc_len.mean() if n_docs else 1.0
    idf = compute_idf(df, n_docs, epsilon)
    impact = np.zeros((vocab_size, n_docs), np.float32)
    norm = k1 * (1.0 - b + b * doc_len / max(avgdl, 1e-9))
    for d, (ids, tfs) in enumerate(zip(doc_term_ids, doc_term_freqs)):
        tf = tfs.astype(np.float64)
        impact[ids, d] = (idf[ids] * tf * (k1 + 1.0) / (tf + norm[d])).astype(np.float32)
    return impact


def bm25_scores_matmul(impact: torch.Tensor, qtf: torch.Tensor) -> torch.Tensor:
    """S [B, N] = qtf [B, V] @ impact [V, N] (float32)."""
    return torch.matmul(qtf.to(impact.dtype), impact).float()


def bm25_topk(impact: torch.Tensor, qtf: torch.Tensor, valid_n: int, k: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k of ``qtf @ impact`` with columns >= ``valid_n`` scored NEG_INF
    (``legalrag_tpu/ops/bm25.py:73-81``): ([B, k] float32, [B, k] int64)."""
    scores = mask_cols(bm25_scores_matmul(impact, qtf), valid_n)
    return topk_large(scores, min(k, scores.shape[1]))


def query_term_counts(term_ids: torch.Tensor, term_mask: torch.Tensor,
                      vocab_size: int) -> torch.Tensor:
    """(term_ids [B, L], term_mask [B, L]) -> [B, V] float32 counts on the
    ids' device; duplicate ids add up (``fused_query.py:100-106``)."""
    qtf = torch.zeros((term_ids.shape[0], vocab_size), dtype=torch.float32,
                      device=term_ids.device)
    return qtf.scatter_add_(1, term_ids.long(), term_mask.float())
