"""Ingest orchestration: apply an upload's chunks to the live per-language
bundles (port of ``legalrag_tpu/ingest/orchestrator.py``).

The dense, BM25 and token channels live in one ``IndexBundle``, so one
*index job* appends to all three (``IndexBundle.add_chunks``, which builds
the grown state aside and publishes it in one step, so a request served
meanwhile reads the bundle from before or from after the append), saves
the bundle (its generation moves on) and installs it in the serving cache.
The *graph job* rebuilds each language's law graph over the whole
processed directory (the base corpora and every ingested document); the
serving graph store reloads the file when its mtime changes.

Each document's status keeps the four keys ``faiss``, ``bm25``,
``colbert`` and ``graph``: ``scheduled``, then ``added`` (``disabled`` for
a channel that is off), or ``error: <message>`` when the job raised.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict
from typing import Dict, List

from legalrag_tpu_torch.config import AppConfig
from legalrag_tpu_torch.corpus import load_chunks_from_dir
from legalrag_tpu_torch.graph import GraphBuilder
from legalrag_tpu_torch.retrieval.by_lang import BundleCache
from legalrag_tpu_torch.schemas import LawChunk
from legalrag_tpu_torch.utils import get_logger

log = get_logger("torch.ingest.orchestrator")


class IngestOrchestrator:
    def __init__(self, cfg: AppConfig, cache: BundleCache):
        self.cfg = cfg
        self.cache = cache
        self.status: Dict[str, Dict[str, str]] = {}
        self._lock = threading.Lock()

    def init_status(self, doc_id: str) -> None:
        with self._lock:
            self.status[doc_id] = {k: "scheduled" for k in
                                   ("faiss", "bm25", "colbert", "graph")}

    def get_status(self, doc_id: str) -> Dict[str, str]:
        with self._lock:
            return dict(self.status.get(doc_id, {}))

    def _set(self, doc_id: str, key: str, value: str) -> None:
        with self._lock:
            self.status.setdefault(doc_id, {})[key] = value

    def index_job(self, doc_id: str, chunks: List[LawChunk]) -> None:
        """Append the chunks to each language's bundle, save it, install
        it."""
        by_lang = defaultdict(list)
        for c in chunks:
            by_lang[c.lang or "zh"].append(c)
        try:
            for lang, lang_chunks in by_lang.items():
                bundle = self.cache.get(lang)
                t0 = time.perf_counter()
                added = bundle.add_chunks(lang_chunks)
                t1 = time.perf_counter()
                bundle.save(self.cache.index_dir(lang))
                self.cache.put(lang, bundle)
                log.info("[%s] ingest %s: +%d chunks (n=%d), append %.6fs, "
                         "save %.6fs", lang, doc_id, added, bundle.n_docs,
                         t1 - t0, time.perf_counter() - t1)
            for key in ("faiss", "bm25", "colbert"):
                enabled = key != "colbert" or self.cfg.retrieval.enable_colbert
                self._set(doc_id, key, "added" if enabled else "disabled")
        except Exception as e:
            log.error("index job failed for %s: %s", doc_id, e, exc_info=True)
            for key in ("faiss", "bm25", "colbert"):
                self._set(doc_id, key, f"error: {e}")

    def graph_job(self, doc_id: str) -> None:
        if not self.cfg.pdf.ingest_rebuild_graph:
            self._set(doc_id, "graph", "disabled")
            return
        try:
            chunks = load_chunks_from_dir(self.cfg.paths.processed_dir)
            by_lang = defaultdict(list)
            for c in chunks:
                by_lang[c.lang or "zh"].append(c)
            for lang, lang_chunks in by_lang.items():
                out = self.cfg.with_lang(lang).paths.graph_file
                t0 = time.perf_counter()
                GraphBuilder().build_to_file(lang_chunks, out)
                log.info("[%s] graph %s: rebuilt over %d chunks, %.6fs", lang,
                         doc_id, len(lang_chunks), time.perf_counter() - t0)
            self._set(doc_id, "graph", "added")
        except Exception as e:
            log.error("graph job failed for %s: %s", doc_id, e, exc_info=True)
            self._set(doc_id, "graph", f"error: {e}")
