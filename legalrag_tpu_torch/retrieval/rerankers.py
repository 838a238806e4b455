"""Second-stage rerankers (port of ``legalrag_tpu/retrieval/rerankers.py``).

The reranker rescores the top-N fused candidates and the final score is
``(1−β)·fused + β·norm(rerank)``. Backends:

- ``CrossEncoderReranker``: a BERT-family pair classifier
  (``models/bert.py:TorchBertCrossEncoder``) over the candidates in
  batches of 32, for bert bundles whose ``reranker_model`` loads;
- ``MaxSimReranker``: exact token-level MaxSim between the query and each
  candidate, from the token store (``TokenIndex.score_candidates``, one
  gather + product on the device) or, for a hit outside the store, from
  re-encoded candidate texts on the host;
- ``LLMReranker``: a strict-JSON scoring prompt through the LLM client,
  with regex fallback extraction.

Candidates are scored on their clean chunk text.
"""

from __future__ import annotations

import json
import re
from typing import List, Optional, Protocol, Sequence

import numpy as np

from legalrag_tpu_torch.config import AppConfig
from legalrag_tpu_torch.index.bundle import IndexBundle
from legalrag_tpu_torch.schemas import RetrievalHit
from legalrag_tpu_torch.utils import get_logger

log = get_logger("torch.retrieval.rerankers")


class Reranker(Protocol):
    name: str

    def score(self, question: str, docs: List[str]) -> List[float]:
        ...


class MaxSimReranker:
    name = "maxsim"

    def __init__(self, bundle: IndexBundle):
        self.bundle = bundle

    def score_hits(self, question: str,
                   hits: List[RetrievalHit]) -> Optional[List[float]]:
        """Scores from the token store; None when a hit is not in it (the
        text path applies then)."""
        bundle = self.bundle
        if bundle.tokens.n == 0:
            return None
        rows = [bundle.id2row.get(h.chunk.id, -1) for h in hits]
        if any(r < 0 or r >= bundle.tokens.n for r in rows):
            return None
        q_tok, q_mask = bundle.encoder.encode_tokens(
            [question], bundle.cfg.engine.max_query_tokens)
        s = bundle.tokens.score_candidates(
            q_tok, q_mask, np.asarray([rows], np.int64))
        return [float(x) for x in s[0]]

    def score(self, question: str, docs: List[str]) -> List[float]:
        enc = self.bundle.encoder
        maxlen = self.bundle.cfg.engine.late_doc_maxlen
        q_tok, q_mask = enc.encode_tokens([question],
                                          self.bundle.cfg.engine.max_query_tokens)
        d_tok, d_mask = enc.encode_tokens(docs, maxlen)
        # host einsum: N <= rerank_top_n (30) docs
        sim = np.einsum("qd,nld->nql", q_tok[0], d_tok)
        sim = np.where(d_mask[:, None, :], sim, -np.inf)
        best = sim.max(axis=-1)
        best = np.where(np.isfinite(best), best, 0.0)
        best = np.where(q_mask[0][None, :], best, 0.0)
        return best.sum(axis=-1).astype(float).tolist()


class CrossEncoderReranker:
    name = "cross_encoder"

    def __init__(self, model_name: str, device=None, max_length: int = 512,
                 batch_size: int = 32):
        from legalrag_tpu_torch.models.bert import TorchBertCrossEncoder

        self.model = TorchBertCrossEncoder.from_pretrained(model_name,
                                                           device=device)
        self.max_length = max_length
        self.batch_size = batch_size

    def score(self, question: str, docs: List[str]) -> List[float]:
        out: List[float] = []
        for i in range(0, len(docs), self.batch_size):
            out.extend(self.model.score_pairs(
                [(question, d) for d in docs[i:i + self.batch_size]],
                max_length=self.max_length))
        return out


class LLMReranker:
    name = "llm"

    PROMPT = (
        "You are a legal retrieval relevance judge. Score how relevant each "
        "candidate provision is to the question on [0,1].\n"
        "Question: {question}\n\nCandidates:\n{candidates}\n\n"
        'Answer with STRICT JSON only: {{"scores": [s1, s2, ...]}} with one '
        "score per candidate, in order."
    )

    def __init__(self, llm):
        self.llm = llm

    def score(self, question: str, docs: List[str]) -> List[float]:
        cands = "\n".join(f"[{i + 1}] {d[:600]}" for i, d in enumerate(docs))
        raw = self.llm.chat(
            [{"role": "user",
              "content": self.PROMPT.format(question=question, candidates=cands)}],
            tag="rerank")
        try:
            scores = json.loads(raw).get("scores", [])
        except (json.JSONDecodeError, AttributeError):
            scores = [float(x) for x in re.findall(r"(?<![\d.])(?:0?\.\d+|1\.0|0|1)(?![\d.])", raw or "")]
        scores = [max(0.0, min(1.0, float(s))) for s in scores[: len(docs)]]
        scores += [0.0] * (len(docs) - len(scores))
        return scores


class RerankerFactory:
    """Backend selection (``legalrag_tpu/retrieval/rerankers.py:141-158``):
    the LLM when configured and the candidate count is within its
    threshold; else, for the bert backend, the cross-encoder of
    ``reranker_model``, cached per model and device (a CPU twin in the
    process of a card's retriever gets its own); else, or when that
    checkpoint does not load (missing files or keys, a tokenizer the port
    does not have), the MaxSim reranker. An error while scoring reaches
    the caller."""

    _cache: dict = {}

    @classmethod
    def create(cls, cfg: AppConfig, bundle: IndexBundle, llm=None,
               top_k: Optional[int] = None) -> Reranker:
        r = cfg.retrieval
        if (r.rerank_use_llm and llm is not None
                and (top_k or r.rerank_top_n) <= r.rerank_llm_top_k_threshold):
            return LLMReranker(llm)
        if r.embedding_backend == "bert":
            key = ("ce", r.reranker_model, str(bundle.device))
            if key in cls._cache:
                return cls._cache[key]
            try:
                ce = CrossEncoderReranker(r.reranker_model,
                                          device=bundle.device)
            except (OSError, KeyError, NotImplementedError) as e:
                log.warning("cross-encoder unavailable (%s); using MaxSim", e)
            else:
                cls._cache[key] = ce
                return ce
        return MaxSimReranker(bundle)


def normalize_scores(scores: Sequence[float], method: str = "minmax") -> List[float]:
    arr = np.asarray(scores, np.float64)
    if arr.size == 0:
        return []
    if method == "minmax":
        lo, hi = arr.min(), arr.max()
        if hi - lo < 1e-12:
            return [1.0] * len(arr)
        return ((arr - lo) / (hi - lo)).tolist()
    if method == "sigmoid":
        return (1.0 / (1.0 + np.exp(-arr))).tolist()
    return arr.tolist()


def rerank_candidates(question: str, hits: List[RetrievalHit],
                      reranker: Reranker, beta: float = 0.35,
                      norm: str = "minmax") -> List[RetrievalHit]:
    """Score hits with the reranker and blend:
    ``score = (1−β)·fused + β·norm(rerank)``. Hits are updated in place and
    re-sorted (a stable sort on the host, as in JAX)."""
    if not hits:
        return hits
    raw = None
    if hasattr(reranker, "score_hits"):
        raw = reranker.score_hits(question, hits)
    if raw is None:
        raw = reranker.score(question, [h.chunk.text for h in hits])
    normed = normalize_scores(raw, norm)
    for h, r_raw, r_norm in zip(hits, raw, normed):
        fused = h.score
        h.score = (1.0 - beta) * fused + beta * float(r_norm)
        h.source = "rerank"
        bd = dict(h.score_breakdown or {})
        bd.update({"fused": fused, "rerank_raw": float(r_raw),
                   "rerank_norm": float(r_norm), "rerank_beta": beta,
                   "reranker": reranker.name})
        h.score_breakdown = bd
    hits.sort(key=lambda h: -h.score)
    for rank, h in enumerate(hits, start=1):
        h.rank = rank
    return hits
