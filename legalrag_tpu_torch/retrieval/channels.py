"""Per-channel retrievers over an IndexBundle (port of
``legalrag_tpu/retrieval/channels.py``).

Each channel is a thin host wrapper around one index method; all channels
share corpus row ids, so fusion needs no id reconciliation. On the card the
dense channel launches the score+select kernel (``DenseIndex.topk``) and the
late channel's full scan the MaxSim kernel (``TokenIndex.topk``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from legalrag_tpu_torch.config import AppConfig
from legalrag_tpu_torch.graph.store import LawGraphStore
from legalrag_tpu_torch.index.bundle import IndexBundle
from legalrag_tpu_torch.schemas import RetrievalHit


def make_hits(bundle: IndexBundle, rows: Sequence[int], scores: Sequence[float],
              channel: str, source: str = "retriever") -> List[RetrievalHit]:
    hits = []
    for rank, (row, score) in enumerate(zip(rows, scores), start=1):
        chunk = bundle.chunks[int(row)]
        hits.append(RetrievalHit(
            chunk=chunk, score=float(score), rank=rank, source=source,
            semantic_score=float(score) if channel == "dense" else None,
            score_breakdown={"channel": channel},
        ))
    return hits


class DenseRetriever:
    """Exact dense search."""

    def __init__(self, bundle: IndexBundle):
        self.bundle = bundle

    def search_rows(self, questions: Sequence[str], top_k: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
        q = self.bundle.encoder.encode_queries(list(questions))
        return self.bundle.dense.topk(q, top_k)

    def search(self, question: str, top_k: int = 10) -> List[RetrievalHit]:
        s, rows = self.search_rows([question], top_k)
        return make_hits(self.bundle, rows[0], s[0], "dense")


class BM25Retriever:
    """Sparse channel."""

    def __init__(self, bundle: IndexBundle):
        self.bundle = bundle

    def search_rows(self, questions: Sequence[str], top_k: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
        return self.bundle.bm25.topk(list(questions), top_k)

    def search(self, question: str, top_k: int = 10) -> List[RetrievalHit]:
        s, rows = self.search_rows([question], top_k)
        return make_hits(self.bundle, rows[0], s[0], "bm25")


class LateInteractionRetriever:
    """Token-level MaxSim channel: a full-corpus scan up to
    ``FULL_SCAN_MAX`` docs, past it exact MaxSim of the top ``candidates``
    dense rows (the two-phase route), ranked on the host by numpy's
    ``argsort``, as in JAX."""

    FULL_SCAN_MAX = 16384

    def __init__(self, bundle: IndexBundle, candidates: int = 128):
        self.bundle = bundle
        self.candidates = candidates

    def _encode_queries(self, questions: Sequence[str]):
        maxlen = self.bundle.cfg.engine.max_query_tokens
        return self.bundle.encoder.encode_tokens(list(questions), maxlen,
                                                 query=True)

    def search_rows(self, questions: Sequence[str], top_k: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
        q_tok, q_mask = self._encode_queries(questions)
        if self.bundle.tokens.n <= self.FULL_SCAN_MAX:
            return self.bundle.tokens.topk(q_tok, q_mask, top_k)
        # two-phase: dense prefilter then exact MaxSim on candidates
        qd = self.bundle.encoder.encode_queries(list(questions))
        c = max(self.candidates, top_k)
        _, cand = self.bundle.dense.topk(qd, c)
        s = self.bundle.tokens.score_candidates(q_tok, q_mask, cand)
        order = np.argsort(-s, axis=1)[:, :top_k]
        return (np.take_along_axis(s, order, axis=1),
                np.take_along_axis(cand, order, axis=1))

    def search(self, question: str, top_k: int = 10) -> List[RetrievalHit]:
        s, rows = self.search_rows([question], top_k)
        return make_hits(self.bundle, rows[0], s[0], "colbert")


class GraphRetriever:
    """Graph-expansion channel: a host BFS over the law graph from seed
    articles; each reached article scores
    ``cos(q, doc_emb) · depth_decay(d) · relation_weight · edge_conf``."""

    def __init__(self, bundle: IndexBundle, store: LawGraphStore,
                 cfg: AppConfig):
        self.bundle = bundle
        self.store = store
        self.cfg = cfg
        self._aid2row: Optional[Dict[str, int]] = None
        self._aid_gen = -1

    def _article_rows(self) -> Dict[str, int]:
        """article id -> first row, rebuilt when the bundle's generation
        moves (``add_chunks``)."""
        st = self.bundle.state
        if self._aid2row is None or self._aid_gen != st.generation:
            aid2row: Dict[str, int] = {}
            for i, c in enumerate(st.chunks):
                aid2row.setdefault(c.article_id, i)
            self._aid2row, self._aid_gen = aid2row, st.generation
        return self._aid2row

    def search(self, question: str, seed_article_ids: Sequence[str],
               top_k: int = 10,
               query_emb: Optional[np.ndarray] = None) -> List[RetrievalHit]:
        """``query_emb`` (the query embedding) may come from the caller: the
        hybrid path passes the channels call's, saving an encode."""
        r = self.cfg.retrieval
        try:
            nodes = self.store.walk(
                seed_article_ids, limit=r.graph_limit,
                relation_max_depth=r.graph_relation_max_depth,
                min_conf=r.graph_min_conf)
        except FileNotFoundError:
            return []
        if not nodes:
            return []
        aid2row = self._article_rows()
        rows, metas = [], []
        for node in nodes:
            row = aid2row.get(node.article_id)
            if row is not None:
                rows.append(row)
                metas.append(node)
        if not rows:
            return []
        q = (query_emb if query_emb is not None
             else self.bundle.encoder.encode_queries([question])[0])
        cos = self.bundle.dense.score_rows(q, np.asarray(rows, np.int64))
        rel_w = r.graph_relation_weights
        hits: List[RetrievalHit] = []
        for row, node, c in zip(rows, metas, cos):
            depth = node.graph_depth or 1
            decay = 1.0 / (1.0 + depth) ** r.graph_depth_decay
            rels = node.relations or []
            w = max((rel_w.get(rel, rel_w.get("default", 1.0)) for rel in rels),
                    default=rel_w.get("default", 1.0))
            conf = float(node.meta.get("_edge_conf", 1.0)) if node.meta else 1.0
            score = float(c) * decay * w * conf
            chunk = self.bundle.chunks[row]
            hits.append(RetrievalHit(
                chunk=chunk, score=score, source="graph",
                semantic_score=float(c), graph_depth=depth, relations=rels,
                seed_article_id=node.graph_parent,
                score_breakdown={
                    "channel": "graph", "cos": float(c), "depth_decay": decay,
                    "relation_weight": w, "edge_conf": conf,
                }))
        hits.sort(key=lambda h: -h.score)
        for rank, h in enumerate(hits, start=1):
            h.rank = rank
        return hits[:top_k] if top_k else hits
