"""HybridRetriever: the single-query serving path's retrieval layer (port of
``legalrag_tpu/retrieval/hybrid.py``).

``search`` runs: every channel's top ``top_k × oversample_factor`` list
from one device call (``ops.fused_query.fused_channels_topk``, through the
micro-batcher, so concurrent requests share it) → host fusion with the full
explainability payload (``retrieval.fusion.fuse``) → the min-score filter →
graph expansion for ``RoutingMode.GRAPH_AUGMENTED`` → rerank of the top N
with the β blend → dedup-keep-best with provenance union → the per-stage ms
log line → top-k. With HyDE on and an LLM present, the dense query is
expanded and the channels run one by one instead.

On the card one channels call runs the encoder's device work (for a bert
bundle the forward passes of both query views), then launches the
score+select kernel once (the dense list) and the MaxSim kernel once (the
late list). The per-channel APIs and HyDE encode through
``encode_queries`` / ``encode_tokens``. A channels call
reads one ``BundleState`` of the bundle, so an ingest that grows the bundle
meanwhile gives it the lists from before or from after the append.

When the bundle is sharded (``engine.n_index_shards``, ``IndexBundle.
enable_sharding``), the same lists come from ``parallel.sharded_search``
over that state's ``shard_views``: kernel 1 and MaxSim once per shard a
channels call, then the merge on the mesh's lead device. A bert bundle's
query forward and every shard's channels come from one call
(``_bert_sharded_oneshot``).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import torch

from legalrag_tpu_torch.config import AppConfig
from legalrag_tpu_torch.graph.store import LawGraphStore
from legalrag_tpu_torch.index.bundle import IndexBundle
from legalrag_tpu_torch.models.hash_encoder import HashEncoder
from legalrag_tpu_torch.ops.fused_query import fused_channels_topk
from legalrag_tpu_torch.ops.topk import bucket_k
from legalrag_tpu_torch.parallel.sharded_search import (
    make_sharded_bert_channels_step,
    sharded_channels_topk,
)
from legalrag_tpu_torch.retrieval.batcher import MicroBatcher
from legalrag_tpu_torch.retrieval.channels import (
    BM25Retriever,
    DenseRetriever,
    GraphRetriever,
    LateInteractionRetriever,
)
from legalrag_tpu_torch.retrieval.engine import bucket_batch
from legalrag_tpu_torch.retrieval.fusion import ChannelResult, fuse
from legalrag_tpu_torch.retrieval.rerankers import (
    RerankerFactory,
    rerank_candidates,
)
from legalrag_tpu_torch.schemas import RetrievalHit, RoutingDecision, RoutingMode
from legalrag_tpu_torch.utils import get_logger, has_chinese
from legalrag_tpu_torch.utils.tracing import trace_span

log = get_logger("torch.retrieval.hybrid")


class HybridRetriever:
    def __init__(self, bundle: IndexBundle, cfg: AppConfig,
                 graph_store: Optional[LawGraphStore] = None, llm=None):
        self.bundle = bundle
        self.cfg = cfg
        self.llm = llm
        self.dense = DenseRetriever(bundle)
        self.bm25 = BM25Retriever(bundle)
        self.late = (LateInteractionRetriever(bundle, cfg.engine.late_candidates)
                     if cfg.retrieval.enable_colbert else None)
        self.graph: Optional[GraphRetriever] = None
        if cfg.retrieval.enable_graph and graph_store is not None:
            self.graph = GraphRetriever(bundle, graph_store, cfg)
        self._bert_sharded = {}  # (mesh, kb, use_late) -> sharded call
        e = cfg.engine
        self._batcher = MicroBatcher(
            self._channels_topk_batch,
            window_s=e.microbatch_window_ms / 1000.0,
            max_batch=min(e.microbatch_max, e.max_query_batch))

    def _bert_sharded_oneshot(self, kb: int, use_late: bool, q_dtype=None):
        """The encoder-fused sharded channels call of a bert bundle, cached
        per (mesh, k bucket, late); ``q_dtype``: the shard views'."""
        key = (self.bundle.mesh, kb, use_late)
        fn = self._bert_sharded.get(key)
        if fn is None:
            fn = self._bert_sharded[key] = make_sharded_bert_channels_step(
                self.bundle.mesh, kb, use_late, self.bundle.encoder, q_dtype)
        return fn

    def _channels_topk_all(self, question: str, eff_k: int):
        """All channels' top-eff_k for ONE question, through the
        micro-batcher; arrays keep a leading batch dim of 1."""
        return self._batcher.run(question, eff_k)

    def _channels_topk_batch(self, questions: Sequence[str], eff_k: int):
        """All channels' top-eff_k for a question batch from one
        ``fused_channels_topk`` call: ``{"dense"|"bm25"|"colbert": (scores
        [B, eff_k], rows [B, eff_k]), "qvec": [B, d]}`` on the host, or None
        for an empty index. The batch is padded with empty questions to a
        bucket size, as in JAX; their rows are dropped."""
        # one generation of the bundle for the whole call: an ingest that
        # publishes meanwhile cannot hand it one store's rows with
        # another's vocabulary or count
        st = self.bundle.state
        if st.dense.n == 0:
            return None
        dev = self.bundle.device
        use_late = (self.late is not None
                    and st.tokens.n == st.dense.n
                    and st.tokens.n > 0)
        eff_k = min(eff_k, st.dense.n)
        kb = bucket_k(eff_k, st.dense.capacity)
        nb = len(questions)
        qs = list(questions) + [""] * (bucket_batch(nb) - nb)
        maxlen = self.cfg.engine.max_query_tokens
        ids, mask = st.bm25.query_term_ids(qs, maxlen)
        qtf = (torch.from_numpy(ids).to(dev), torch.from_numpy(mask).to(dev))
        inputs = st.encoder.query_inputs(qs, maxlen, use_late)
        views = self.bundle.shard_views(st)
        if views is None:
            # both query views from one encoder call (bert: one forward
            # pass of the instructed batch and one of the bare batch)
            qvec, q_tok, q_mask = st.encoder.query_views(inputs)
            out = fused_channels_topk(
                st.dense.emb, st.bm25.impact,
                st.tokens.tok if use_late else None,
                st.tokens.mask if use_late else None, qvec, qtf,
                q_tok.to(st.tokens.query_dtype) if use_late else None,
                q_mask, st.dense.n, kb)
        elif isinstance(st.encoder, HashEncoder):
            qvec, q_tok, q_mask = st.encoder.query_views(inputs)
            out = sharded_channels_topk(
                self.bundle.mesh, kb, views["emb"], views["impact"],
                views["tok"] if use_late else None,
                views["mask"] if use_late else None, qvec, qtf,
                q_tok.to(views["q_dtype"]) if use_late else None, q_mask,
                st.dense.n)
        else:
            *lists, qvec = self._bert_sharded_oneshot(
                kb, use_late, views.get("q_dtype"))(
                inputs, views["emb"], views["impact"],
                views["tok"] if use_late else None,
                views["mask"] if use_late else None, qtf[0], qtf[1],
                st.dense.n)
            out = dict(zip(("dense", "bm25", "colbert"), lists), qvec=qvec)
        res = {"qvec": out.pop("qvec")[:nb].cpu().numpy()}
        for name, (s, i) in out.items():
            res[name] = (s[:nb, :eff_k].cpu().numpy(),
                         i[:nb, :eff_k].cpu().numpy())
        return res

    def _hyde_expansion(self, question: str) -> Optional[str]:
        """HyDE: one hypothetical statutory answer, embedded alongside the
        query for the dense channel. Skipped silently without a live LLM."""
        if self.llm is None or getattr(self.llm, "is_degraded", True):
            return None
        prompt = ("请用一段法言法语写出最可能回答该问题的法条内容（不超过80字，"
                  "不要条文编号）：" if has_chinese(question) else
                  "Write one statutory-style paragraph (max 60 words, no "
                  "section numbers) that would answer: ")
        try:
            text = self.llm.chat(
                [{"role": "user", "content": prompt + question}], tag="hyde")
            return (text or "").strip()[:400] or None
        except Exception:  # an LLM failure leaves the plain dense query
            return None

    # ------------------------------------------------------ channel APIs
    def search_dense(self, question: str, top_k: int = 10) -> List[RetrievalHit]:
        return self.dense.search(question, top_k)

    def search_bm25(self, question: str, top_k: int = 10) -> List[RetrievalHit]:
        return self.bm25.search(question, top_k)

    def search_colbert(self, question: str, top_k: int = 10) -> List[RetrievalHit]:
        if self.late is None:
            return []
        return self.late.search(question, top_k)

    def search_graph(self, question: str, seeds: Sequence[str],
                     top_k: int = 0) -> List[RetrievalHit]:
        if self.graph is None:
            return []
        return self.graph.search(question, seeds, top_k)

    # ------------------------------------------------------------- search
    def search(self, question: str, top_k: Optional[int] = None,
               decision: Optional[RoutingDecision] = None) -> List[RetrievalHit]:
        r = self.cfg.retrieval
        top_k = top_k or r.top_k
        eff_k = max(top_k, top_k * r.oversample_factor)
        t: Dict[str, float] = {}
        t0 = time.perf_counter()

        def clock(name: str, start: float) -> float:
            now = time.perf_counter()
            t[name] = (now - start) * 1000
            return now

        mark = t0
        dense_query = question
        if r.enable_hyde:
            hyde = self._hyde_expansion(question)
            if hyde:
                dense_query = f"{question}\n{hyde}"
                mark = clock("hyde", mark)
        one_shot = None
        if dense_query == question:
            with trace_span("retrieval.channels"):
                one_shot = self._channels_topk_all(question, eff_k)
        if one_shot is not None:
            mark = clock("channels", mark)
            channels = [
                ChannelResult("dense", r.dense_weight,
                              one_shot["dense"][1][0], one_shot["dense"][0][0]),
                ChannelResult("bm25", r.bm25_weight,
                              one_shot["bm25"][1][0], one_shot["bm25"][0][0]),
            ]
            if "colbert" in one_shot:
                channels.append(ChannelResult(
                    "colbert", r.colbert_weight,
                    one_shot["colbert"][1][0], one_shot["colbert"][0][0]))
        else:
            with trace_span("retrieval.dense"):
                dense_s, dense_rows = self.dense.search_rows([dense_query],
                                                             eff_k)
            mark = clock("dense", mark)
            with trace_span("retrieval.bm25"):
                bm25_s, bm25_rows = self.bm25.search_rows([question], eff_k)
            mark = clock("bm25", mark)
            channels = [
                ChannelResult("dense", r.dense_weight, dense_rows[0], dense_s[0]),
                ChannelResult("bm25", r.bm25_weight, bm25_rows[0], bm25_s[0]),
            ]
            if self.late is not None:
                with trace_span("retrieval.colbert"):
                    late_s, late_rows = self.late.search_rows([question], eff_k)
                channels.append(ChannelResult("colbert", r.colbert_weight,
                                              late_rows[0], late_s[0]))
                mark = clock("colbert", mark)

        fused = fuse(channels, method=r.fusion_method, rrf_k=r.rrf_k,
                     alpha=r.rrf_alpha)
        hits: List[RetrievalHit] = []
        for cand in fused:
            chunk = self.bundle.chunks[cand.row]
            sem = cand.breakdown.get("per_channel", {}).get("dense", {}).get("score")
            hits.append(RetrievalHit(chunk=chunk, score=cand.score,
                                     source="retriever", semantic_score=sem,
                                     score_breakdown=cand.breakdown))
        mark = clock("fuse", mark)

        hits = [h for h in hits if h.score >= r.min_final_score]

        if (decision is not None and decision.mode == RoutingMode.GRAPH_AUGMENTED
                and self.graph is not None):
            seeds = [h.chunk.article_id for h in hits[: r.graph_seed_k]]
            qv = one_shot["qvec"][0] if one_shot is not None else None
            hits.extend(self.graph.search(question, seeds, top_k=0,
                                          query_emb=qv))
            mark = clock("graph", mark)

        if r.enable_rerank and hits:
            head = hits[: r.rerank_top_n]
            tail = hits[r.rerank_top_n:]
            reranker = RerankerFactory.create(self.cfg, self.bundle,
                                              llm=self.llm, top_k=r.rerank_top_n)
            head = rerank_candidates(question, head, reranker,
                                     beta=r.rerank_beta, norm=r.rerank_norm)
            hits = head + tail
            mark = clock("rerank", mark)

        hits = dedup_keep_best(hits)
        t["total"] = (time.perf_counter() - t0) * 1000
        log.info("[retrieval] %s",
                 " ".join(f"{k}={v:.1f}ms" for k, v in t.items()))
        for rank, h in enumerate(hits[:top_k], start=1):
            h.rank = rank
        return hits[:top_k]


def dedup_keep_best(hits: List[RetrievalHit]) -> List[RetrievalHit]:
    """Keep the best-scoring hit per chunk id; union channel provenance and
    sum channel contributions (a stable sort on the host, as in JAX)."""
    best: Dict[str, RetrievalHit] = {}
    order: List[str] = []
    for h in hits:
        cid = h.chunk.id
        cur = best.get(cid)
        if cur is None:
            best[cid] = h
            order.append(cid)
            continue
        keep, drop = (h, cur) if h.score > cur.score else (cur, h)
        kb = dict(keep.score_breakdown or {})
        db = drop.score_breakdown or {}
        merged_channels = list(dict.fromkeys(
            (kb.get("channels") or ([kb["channel"]] if "channel" in kb else []))
            + (db.get("channels") or ([db["channel"]] if "channel" in db else []))))
        if merged_channels:
            kb["channels"] = merged_channels
        contrib = dict(kb.get("channel_contrib") or {})
        for k, v in (db.get("channel_contrib") or {}).items():
            contrib[k] = contrib.get(k, 0.0) + v
        if contrib:
            kb["channel_contrib"] = contrib
        keep.score_breakdown = kb
        if keep.graph_depth is None:
            keep.graph_depth = drop.graph_depth
        best[cid] = keep
    return sorted((best[c] for c in order), key=lambda h: -h.score)
