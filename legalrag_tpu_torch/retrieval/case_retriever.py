"""Case-law retrieval channel (port of
``legalrag_tpu/retrieval/case_retriever.py:29-164``).

Hybrid dense + BM25 search with fusion over case records, metadata
filters (court / cause / date range), device-resident indexes (the port's
``DenseIndex`` and ``BM25Index``, as the statute engine's) and incremental
``add_cases``. Each query is one B=1 ``DenseIndex.topk`` (score+select,
``csrc/score_select.cu``, below ``TWO_PASS_MIN_N`` rows) and one BM25
impact matmul over the case store.

JAX's behaviour is kept as it is, quirks included:

- ``add_cases`` skips ids it already has, fits the encoder's IDF on the
  fresh texts only (document frequencies accumulate) and encodes only the
  fresh cases, so earlier rows keep the vectors their IDF gave them. The
  first add builds BM25, a later one goes through ``add_texts``.
- ``search`` takes each channel's top ``eff = min(max(top_k *
  oversample_factor, top_k), n)`` *before* the metadata filter drops the
  rows it does not allow: a narrow filter can return fewer than ``top_k``
  hits, or none, although matching cases exist.
- ``court`` matches exactly, ``cause`` as a substring; dates compare as
  strings, a missing date as "" under ``date_from`` and "9999" under
  ``date_to``.

``save`` writes ``cases.jsonl`` (pydantic's lines, ``CaseEntry.to_json``),
``case_dense.npz``, ``case_bm25.npz`` and ``case_encoder.npz`` in JAX's
formats: each package loads the other's. Entry points run on ``cuda``
unless given ``device="cpu"``, and raise without CUDA.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from legalrag_tpu_torch.config import AppConfig
from legalrag_tpu_torch.index.bm25_index import BM25Index
from legalrag_tpu_torch.index.dense_index import DenseIndex
from legalrag_tpu_torch.retrieval.fusion import ChannelResult, fuse
from legalrag_tpu_torch.schemas import CaseEntry, CaseRetrievalHit
from legalrag_tpu_torch.utils import detect_lang, get_logger
from legalrag_tpu_torch.utils.device import DeviceLike, resolve_device

log = get_logger("torch.case_retriever")


def case_text(c: CaseEntry) -> str:
    """The text both channels index for a case."""
    return f"{c.title}\n{c.text}"


class CaseRetriever:
    def __init__(self, cfg: AppConfig, lang: str = "zh",
                 device: DeviceLike = None, encoder=None):
        from legalrag_tpu_torch.models.encoder import get_encoder

        self.cfg = cfg
        self.lang = lang
        self.device = resolve_device(device)
        self.encoder = encoder or get_encoder(cfg, lang, self.device)
        r, e = cfg.retrieval, cfg.engine
        self.cases: List[CaseEntry] = []
        self.id2row: Dict[str, int] = {}
        self.dense = DenseIndex(r.embedding_dim, e.dtype, e.capacity_round,
                                self.device)
        self.bm25 = BM25Index(lang, r.bm25_k1, r.bm25_b, r.bm25_epsilon,
                              self.device)

    # ----------------------------------------------------------------- build
    def add_cases(self, cases: Sequence[CaseEntry]) -> int:
        fresh = [c for c in cases if c.case_id not in self.id2row]
        if not fresh:
            return 0
        texts = [case_text(c) for c in fresh]
        if hasattr(self.encoder, "fit_idf"):
            self.encoder.fit_idf(texts)
        vecs = self.encoder.encode_passages(texts)
        for c in fresh:
            self.id2row[c.case_id] = len(self.cases)
            self.cases.append(c)
        self.dense.add(np.asarray(vecs))
        if self.bm25.n:
            self.bm25.add_texts(texts)
        else:
            self.bm25.build_from_texts([case_text(c) for c in self.cases])
        log.info("case index: +%d cases (n=%d)", len(fresh), len(self.cases))
        return len(fresh)

    @classmethod
    def from_jsonl(cls, path: str | Path, cfg: AppConfig,
                   lang: Optional[str] = None, device: DeviceLike = None
                   ) -> "CaseRetriever":
        cases = []
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if line:
                    cases.append(CaseEntry.from_json(line))
        lang = lang or (detect_lang(cases[0].text) if cases else "zh")
        retriever = cls(cfg, lang, device)
        retriever.add_cases(cases)
        return retriever

    # ---------------------------------------------------------------- search
    def search(self, query: str, top_k: int = 10,
               court: Optional[str] = None, cause: Optional[str] = None,
               date_from: Optional[str] = None, date_to: Optional[str] = None
               ) -> List[CaseRetrievalHit]:
        if not self.cases:
            return []
        allowed = self._filter_rows(court, cause, date_from, date_to)
        if not allowed:
            return []
        r = self.cfg.retrieval
        eff = min(max(top_k * r.oversample_factor, top_k), len(self.cases))
        qv = self.encoder.encode_queries([query])
        d_s, d_rows = self.dense.topk(qv, eff)
        b_s, b_rows = self.bm25.topk([query], eff)

        def keep(rows, scores):
            pairs = [(int(i), float(s)) for i, s in zip(rows[0], scores[0])
                     if int(i) in allowed]
            return [p[0] for p in pairs], [p[1] for p in pairs]

        dr, ds = keep(d_rows, d_s)
        br, bs = keep(b_rows, b_s)
        fused = fuse([
            ChannelResult("dense", r.dense_weight, dr, ds),
            ChannelResult("bm25", r.bm25_weight, br, bs),
        ], method=r.fusion_method, rrf_k=r.rrf_k, alpha=r.rrf_alpha)
        return [CaseRetrievalHit(case=self.cases[cand.row], score=cand.score,
                                 rank=rank, score_breakdown=cand.breakdown)
                for rank, cand in enumerate(fused[:top_k], start=1)]

    def _filter_rows(self, court, cause, date_from, date_to) -> set:
        rows = set()
        for i, c in enumerate(self.cases):
            if court and (c.court or "") != court:
                continue
            if cause and cause not in (c.cause or ""):
                continue
            if date_from and (c.date or "") < date_from:
                continue
            if date_to and (c.date or "9999") > date_to:
                continue
            rows.add(i)
        return rows

    # -------------------------------------------------------------- persist
    def save(self, index_dir: str | Path) -> None:
        d = Path(index_dir)
        d.mkdir(parents=True, exist_ok=True)
        with (d / "cases.jsonl").open("w", encoding="utf-8") as f:
            for c in self.cases:
                f.write(c.to_json() + "\n")
        self.dense.save(d / "case_dense.npz")
        self.bm25.save(d / "case_bm25.npz")
        if hasattr(self.encoder, "state"):
            np.savez_compressed(d / "case_encoder.npz", **self.encoder.state())

    @classmethod
    def load(cls, index_dir: str | Path, cfg: AppConfig, lang: str = "zh",
             device: DeviceLike = None) -> "CaseRetriever":
        from legalrag_tpu_torch.models.hash_encoder import HashEncoder

        d = Path(index_dir)
        device = resolve_device(device)
        enc = None
        enc_path = d / "case_encoder.npz"
        if enc_path.exists():
            z = np.load(enc_path, allow_pickle=False)
            enc = HashEncoder.from_state({k: z[k] for k in z.files}, device)
        retriever = cls(cfg, lang, device, encoder=enc)
        with (d / "cases.jsonl").open("r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if line:
                    c = CaseEntry.from_json(line)
                    retriever.id2row[c.case_id] = len(retriever.cases)
                    retriever.cases.append(c)
        e = cfg.engine
        retriever.dense = DenseIndex.load(d / "case_dense.npz", e.dtype,
                                          e.capacity_round, device)
        retriever.bm25 = BM25Index.load(d / "case_bm25.npz", device)
        return retriever
