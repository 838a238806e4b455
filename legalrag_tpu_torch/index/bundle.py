"""IndexBundle: the per-language index artifact set (port of
``legalrag_tpu/index/bundle.py:69-332``, without the sharding).

One directory holds the same files as the JAX package's, in the same
formats, so a bundle saved by either package loads in the other:

- ``manifest.json`` — schema version, tokenize fingerprint, counts, dims,
  generation counter
- ``chunks.jsonl``  — row-ordered LawChunk records (row id = line number)
- ``dense.npz`` / ``bm25.npz`` / ``tokens.npz`` — channel payloads
- ``encoder.npz``  — hash-encoder state (sketch df table)

Host featurization depends on whether jieba is installed
(``tokenize/tokenizers.py``) and the fingerprint does not record it, so a
bundle is built on the machine that serves it.
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from legalrag_tpu_torch.config import AppConfig
from legalrag_tpu_torch.corpus.loader import iter_chunks_from_file, write_chunks_jsonl
from legalrag_tpu_torch.index.bm25_index import BM25Index
from legalrag_tpu_torch.index.dense_index import DenseIndex
from legalrag_tpu_torch.index.token_index import TokenIndex
from legalrag_tpu_torch.models.hash_encoder import HashEncoder
from legalrag_tpu_torch.schemas import LawChunk
from legalrag_tpu_torch.tokenize.tokenizers import TOKENIZE_FINGERPRINT
from legalrag_tpu_torch.utils import get_logger
from legalrag_tpu_torch.utils.device import DeviceLike, resolve_device
from legalrag_tpu_torch.utils.filelock import file_lock

log = get_logger("torch.index.bundle")

SCHEMA_VERSION = 1


class StaleIndexError(RuntimeError):
    """The stored index was built with a different host featurization
    (``TOKENIZE_FINGERPRINT``) than this code emits at query time; serving
    it would skew every channel. Rebuild it."""


def _check_backend(cfg: AppConfig) -> None:
    if cfg.retrieval.embedding_backend != "hash":
        raise NotImplementedError("only the hash embedding backend is "
                                  "ported yet")


class IndexBundle:
    def __init__(self, lang: str, cfg: AppConfig, device: DeviceLike = None):
        self.lang = lang
        self.cfg = cfg
        self.device = resolve_device(device)
        self.chunks: List[LawChunk] = []
        self.id2row: Dict[str, int] = {}
        r, e = cfg.retrieval, cfg.engine
        self.encoder: Optional[HashEncoder] = None  # set in build/load
        self.dense = DenseIndex(r.embedding_dim, e.dtype, e.capacity_round,
                                self.device)
        self.bm25 = BM25Index(lang, r.bm25_k1, r.bm25_b, r.bm25_epsilon,
                              self.device)
        self.tokens = TokenIndex(e.late_dim, e.late_doc_maxlen,
                                 e.token_dtype or e.dtype, e.capacity_round,
                                 self.device)
        self.generation = 0

    # ----------------------------------------------------------------- build
    @classmethod
    def build_from_chunks(cls, chunks: Sequence[LawChunk], cfg: AppConfig,
                          lang: str, device: DeviceLike = None,
                          encoder: Optional[HashEncoder] = None
                          ) -> "IndexBundle":
        _check_backend(cfg)
        b = cls(lang, cfg, device)
        b.encoder = encoder or HashEncoder(
            lang=lang, dim=cfg.retrieval.embedding_dim,
            token_dim=cfg.engine.late_dim, device=b.device)
        b.encoder.fit_idf([c.text for c in chunks])
        b._append(list(chunks))
        return b

    def _append(self, chunks: List[LawChunk]) -> int:
        """Append chunks new to this bundle; returns the number added."""
        fresh = [c for c in chunks if c.id not in self.id2row]
        if not fresh:
            return 0
        texts = [c.text for c in fresh]
        t0 = time.time()
        vecs = self.encoder.encode_passages(texts)
        if self.cfg.retrieval.enable_colbert:
            tok, mask = self.encoder.encode_tokens(texts, self.tokens.doc_maxlen)
        t_enc = time.time() - t0
        for c in fresh:
            self.id2row[c.id] = len(self.chunks)
            self.chunks.append(c)
        self.dense.add(vecs)
        if self.cfg.retrieval.enable_colbert:
            self.tokens.add(tok, mask)
        t0 = time.time()
        self.bm25.build_from_texts([c.text for c in self.chunks])
        log.info("[%s] appended %d chunks (encode %.2fs, bm25 %.2fs) -> n=%d",
                 self.lang, len(fresh), t_enc, time.time() - t0,
                 len(self.chunks))
        self.generation += 1
        return len(fresh)

    @property
    def n_docs(self) -> int:
        return len(self.chunks)

    # --------------------------------------------------------------- persist
    def save(self, index_dir: str | Path) -> None:
        d = Path(index_dir)
        d.mkdir(parents=True, exist_ok=True)
        with file_lock(d / ".lock"):
            # meta before payloads: a crash can leave extra meta but never
            # a payload row without meta
            write_chunks_jsonl(self.chunks, d / "chunks.jsonl")
            self.dense.save(d / "dense.npz")
            self.bm25.save(d / "bm25.npz")
            if self.cfg.retrieval.enable_colbert:
                self.tokens.save(d / "tokens.npz")
            np.savez_compressed(d / "encoder.npz", **self.encoder.state())
            manifest = {
                "schema_version": SCHEMA_VERSION,
                "tokenize_fingerprint": TOKENIZE_FINGERPRINT,
                "lang": self.lang,
                "n_docs": self.n_docs,
                "dim": self.dense.dim,
                "token_dim": self.tokens.token_dim,
                "doc_maxlen": self.tokens.doc_maxlen,
                "generation": self.generation,
                "embedding_backend": self.cfg.retrieval.embedding_backend,
                "created_unix": time.time(),
            }
            tmp = d / "manifest.json.tmp"
            tmp.write_text(json.dumps(manifest, indent=2), encoding="utf-8")
            os.replace(tmp, d / "manifest.json")
        log.info("[%s] saved index (n=%d) -> %s", self.lang, self.n_docs, d)

    @classmethod
    def load(cls, index_dir: str | Path, cfg: AppConfig, lang: str,
             device: DeviceLike = None) -> "IndexBundle":
        _check_backend(cfg)
        d = Path(index_dir)
        manifest = json.loads((d / "manifest.json").read_text(encoding="utf-8"))
        stored = manifest.get("tokenize_fingerprint", "v1")
        if stored != TOKENIZE_FINGERPRINT:
            raise StaleIndexError(
                f"index {d} was built with tokenize fingerprint '{stored}' "
                f"but this code emits '{TOKENIZE_FINGERPRINT}': rebuild it")
        if manifest.get("embedding_backend", "hash") != "hash":
            raise NotImplementedError("only hash-encoder bundles load in the "
                                      "port yet")
        b = cls(lang, cfg, device)
        b.generation = int(manifest.get("generation", 0))
        b.chunks = list(iter_chunks_from_file(d / "chunks.jsonl"))
        b.id2row = {c.id: i for i, c in enumerate(b.chunks)}
        z = np.load(d / "encoder.npz", allow_pickle=False)
        b.encoder = HashEncoder.from_state({k: z[k] for k in z.files},
                                           device=b.device)
        e = cfg.engine
        b.dense = DenseIndex.load(d / "dense.npz", e.dtype, e.capacity_round,
                                  b.device)
        b.bm25 = BM25Index.load(d / "bm25.npz", b.device)
        tok_path = d / "tokens.npz"
        if cfg.retrieval.enable_colbert and tok_path.exists():
            b.tokens = TokenIndex.load(tok_path, e.token_dtype or e.dtype,
                                       e.capacity_round, b.device)
        # chunks.jsonl may lead payload rows after a crash (meta-first
        # write ordering); trim the view to the payload row count
        n = min(b.n_docs, b.dense.n)
        if n < b.n_docs:
            log.warning("[%s] trimming %d meta rows without payload",
                        lang, b.n_docs - n)
            b.chunks = b.chunks[:n]
            b.id2row = {c.id: i for i, c in enumerate(b.chunks)}
        return b
