"""FusedQueryEngine: batched serving facade over one IndexBundle (port of
``legalrag_tpu/retrieval/engine.py:23-198``).

The host tokenizes the queries and copies them to the device (``prepare``:
the hash encoder's sketches and token vectors, or the bert encoder's
instructed and bare token ids); the device runs the encoder's forward
passes, if any, and the fused hybrid query (``execute``: one stream of
launches, asynchronous on CUDA, where JAX runs one program); the host
fetches the rows and components and hydrates chunks (``collect``,
``search_hits``).
Batch sizes are bucketed as in the JAX package: padded rows are empty
queries whose results are dropped.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from legalrag_tpu_torch.config import AppConfig
from legalrag_tpu_torch.index.bundle import BundleState, IndexBundle
from legalrag_tpu_torch.ops.fused_query import (
    PACKED_NAMES,
    FusedParams,
    fused_hybrid_topk,
)
from legalrag_tpu_torch.ops.topk import bucket_k
from legalrag_tpu_torch.schemas import RetrievalHit

_BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128)


def bucket_batch(b: int) -> int:
    for s in _BATCH_BUCKETS:
        if b <= s:
            return s
    return b


class FusedQueryEngine:
    def __init__(self, bundle: IndexBundle, cfg: Optional[AppConfig] = None):
        self.bundle = bundle
        self.cfg = cfg or bundle.cfg

    def _params(self, top_k: int, st: Optional[BundleState] = None
                ) -> FusedParams:
        r = self.cfg.retrieval
        # eff_k from the DENSE capacity (the impact matrix pads N to 128,
        # the dense store to capacity_round), as in the JAX engine
        n = max((st or self.bundle.state).dense.capacity, 1)
        return FusedParams(
            eff_k=bucket_k(min(top_k * r.oversample_factor, n), n),
            final_k=bucket_k(min(top_k, n), n),
            rrf_k=float(r.rrf_k), alpha=float(r.rrf_alpha),
            w_dense=float(r.dense_weight), w_bm25=float(r.bm25_weight),
            w_late=float(r.colbert_weight),
            dense_map_bf16=(self.cfg.engine.dense_map_dtype == "bfloat16"))

    def _use_late(self, st: BundleState) -> bool:
        return (self.cfg.retrieval.enable_colbert
                and st.tokens.n == st.dense.n and st.tokens.n > 0)

    def prepare(self, questions: Sequence[str], top_k: int = 10):
        """Host work and host-to-device copies only, over one generation of
        the bundle (``BundleState``), which ``execute`` then runs on: the
        BM25 term ids, and the encoder's query inputs (the hash sketch and
        token view, or the bert ids)."""
        b = len(questions)
        qs = list(questions) + [""] * (bucket_batch(b) - b)
        st = self.bundle.state
        dev = self.bundle.device
        maxq = self.cfg.engine.max_query_tokens
        term_ids, term_mask = st.bm25.query_term_ids(qs, maxq)
        qtf = (torch.from_numpy(term_ids).to(dev),
               torch.from_numpy(term_mask).to(dev))
        inputs = st.encoder.query_inputs(qs, maxq, self._use_late(st))
        return (inputs, qtf), st, b, top_k

    def execute(self, prepared):
        """The encoder's device work (the bert forward passes) and the
        fused query on prepared inputs, one stream of launches
        (asynchronous on CUDA)."""
        (inputs, qtf), st, b, top_k = prepared
        qvec, q_tok, q_mask = st.encoder.query_views(inputs)
        late = q_tok is not None
        out = fused_hybrid_topk(
            st.dense.emb, st.bm25.impact,
            st.tokens.tok if late else None,
            st.tokens.mask if late else None,
            qvec, qtf, q_tok.to(st.tokens.query_dtype) if late else None,
            q_mask, st.dense.n, self._params(top_k, st))
        return out, b, top_k

    def dispatch(self, questions: Sequence[str], top_k: int = 10):
        return self.execute(self.prepare(questions, top_k))

    @staticmethod
    def collect(dispatched) -> Tuple[np.ndarray, np.ndarray, Dict[str, np.ndarray]]:
        out, b, top_k = dispatched
        rows = out["rows"][:b, :top_k].cpu().numpy()
        packed = out["packed"][:b, :top_k].cpu().numpy()
        host = {name: packed[..., i]
                for i, name in enumerate(PACKED_NAMES[: packed.shape[-1]])}
        return host.pop("scores"), rows, host

    def search_batch(self, questions: Sequence[str], top_k: int = 10
                     ) -> Tuple[np.ndarray, np.ndarray, Dict[str, np.ndarray]]:
        """Returns (scores [B, k], rows [B, k], component maps)."""
        return self.collect(self.dispatch(questions, top_k))

    def search_hits(self, questions: Sequence[str], top_k: int = 10
                    ) -> List[List[RetrievalHit]]:
        scores, rows, comps = self.search_batch(questions, top_k)
        results: List[List[RetrievalHit]] = []
        min_score = self.cfg.retrieval.min_final_score
        for qi in range(len(questions)):
            hits: List[RetrievalHit] = []
            for rank, (row, score) in enumerate(zip(rows[qi], scores[qi]),
                                                start=1):
                if score < min_score:
                    continue
                chunk = self.bundle.chunks[int(row)]
                breakdown = {
                    "fusion_method": self.cfg.retrieval.fusion_method,
                    "rrf_norm": float(comps["rrf_norm"][qi, rank - 1]),
                    "weighted_sum": float(comps["weighted_sum"][qi, rank - 1]),
                    "per_channel": {
                        name: {"score": float(comps[name][qi, rank - 1])}
                        for name in ("dense", "bm25", "colbert")
                        if name in comps
                    },
                }
                hits.append(RetrievalHit(
                    chunk=chunk, score=float(score), rank=rank,
                    semantic_score=float(comps["dense"][qi, rank - 1]),
                    score_breakdown=breakdown))
            results.append(hits)
        return results
