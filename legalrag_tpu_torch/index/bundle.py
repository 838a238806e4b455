"""IndexBundle: the per-language index artifact set (port of
``legalrag_tpu/index/bundle.py:69-332``).

One directory holds the same files as the JAX package's, in the same
formats, so a bundle saved by either package loads in the other:

- ``manifest.json`` — schema version, tokenize fingerprint, counts, dims,
  generation counter
- ``chunks.jsonl``  — row-ordered LawChunk records (row id = line number)
- ``dense.npz`` / ``bm25.npz`` / ``tokens.npz`` — channel payloads
- ``encoder.npz``  — hash-encoder state (sketch df table); a bert bundle
  has none: its encoder is the configured checkpoint
  (``models/encoder.py:get_encoder``), named in the config, not the bundle

Host featurization depends on whether jieba is installed
(``tokenize/tokenizers.py``) and the fingerprint does not record it, so a
bundle is built on the machine that serves it.

A live bundle grows while requests read it (the ingest path,
``add_chunks``). Its encoder, stores, chunks and generation form one
``BundleState``, and the bundle holds one reference to the current state.
An append builds the next state aside (the encoder's statistics copied and
grown, each store grown in a shallow copy, the chunk list and id map
copied) and publishes it by replacing that one reference. A reader that
takes ``bundle.state`` once sees one generation, its stores consistent
with each other. A reader that reads ``bundle.dense``, ``bundle.bm25``, ...
one at a time gets each from the state current at that moment; states
only grow, so rows that an earlier read gave it are valid in every later
one. A store grown in place writes only rows past the ``n`` of the states
that readers may hold, and readers mask those rows. Those fields are
read-only: a state is published whole, by a build, a load or an append.

Doc-sharded serving (``engine.n_index_shards``): ``enable_sharding(mesh)``
makes ``shard_views(state)`` return per-shard copies of one state's dense
rows, impact columns and tokens, padded to a doc capacity that the shards
split evenly; they are rebuilt when the state's ``(generation, n)`` moves
on, and only the newest state's views are kept.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from legalrag_tpu_torch.config import AppConfig
from legalrag_tpu_torch.corpus.loader import iter_chunks_from_file, write_chunks_jsonl
from legalrag_tpu_torch.index.bm25_index import BM25Index
from legalrag_tpu_torch.index.dense_index import DenseIndex, store_dtype
from legalrag_tpu_torch.index.token_index import (
    Residual4TokenIndex,
    TokenIndex,
    make_token_index,
)
from legalrag_tpu_torch.models.encoder import EncoderBackend, get_encoder
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


@dataclasses.dataclass(frozen=True)
class BundleState:
    """One generation of a bundle, which a reader takes at once. Nothing in
    a published state changes (a store's rows past its ``n`` aside)."""

    encoder: Optional[EncoderBackend]
    dense: DenseIndex
    bm25: BM25Index
    tokens: TokenIndex | Residual4TokenIndex
    chunks: List[LawChunk]
    id2row: Dict[str, int]
    generation: int


def _published(name: str) -> property:
    """A read-only field of the bundle's current ``BundleState``."""
    return property(lambda self: getattr(self.state, name),
                    doc=f"``state.{name}``")


class IndexBundle:
    encoder = _published("encoder")
    dense = _published("dense")
    bm25 = _published("bm25")
    tokens = _published("tokens")
    chunks = _published("chunks")
    id2row = _published("id2row")
    generation = _published("generation")

    def __init__(self, lang: str, cfg: AppConfig, device: DeviceLike = None):
        self.lang = lang
        self.cfg = cfg
        self.device = resolve_device(device)
        r, e = cfg.retrieval, cfg.engine
        # empty stores; build, load and convert.bundle_from_arrays publish
        # the first full state
        self.state = BundleState(
            encoder=None,
            dense=DenseIndex(r.embedding_dim, e.dtype, e.capacity_round,
                             self.device),
            bm25=BM25Index(lang, r.bm25_k1, r.bm25_b, r.bm25_epsilon,
                           self.device),
            tokens=make_token_index(e.late_dim, e.late_doc_maxlen,
                                    e.token_dtype or e.dtype,
                                    e.capacity_round, self.device),
            chunks=[], id2row={}, generation=0)
        # one append at a time: each grows the state the last one published
        self._append_lock = threading.Lock()
        # doc-sharded serving: enable_sharding() sets the mesh; the views of
        # the last state asked for are kept, keyed on (generation, n)
        self.mesh = None
        self._shard_views = None
        self._views_lock = threading.Lock()

    # ----------------------------------------------------------------- build
    @classmethod
    def build_from_chunks(cls, chunks: Sequence[LawChunk], cfg: AppConfig,
                          lang: str, device: DeviceLike = None,
                          encoder: Optional[EncoderBackend] = None
                          ) -> "IndexBundle":
        """A bundle of ``chunks`` built with ``encoder``, else the
        configured one (``get_encoder``). The encoder's dims win over the
        config's (a bert model's hidden size need not be
        ``retrieval.embedding_dim``), as in JAX."""
        b = cls(lang, cfg, device)
        enc = encoder or get_encoder(cfg, lang, b.device)
        st, e = b.state, cfg.engine
        dense, tokens = st.dense, st.tokens
        if enc.dim != dense.dim:
            dense = DenseIndex(enc.dim, e.dtype, e.capacity_round, b.device)
        if enc.token_dim != tokens.token_dim:
            tokens = make_token_index(enc.token_dim, e.late_doc_maxlen,
                                      e.token_dtype or e.dtype,
                                      e.capacity_round, b.device)
        b.state = dataclasses.replace(st, encoder=enc, dense=dense,
                                      tokens=tokens)
        b.add_chunks(chunks)
        return b

    def add_chunks(self, chunks: Sequence[LawChunk]) -> int:
        """Append the chunks new to this bundle (deduplicated by chunk id)
        and publish the grown state; returns the number added. The hash
        encoder's idf takes in the fresh chunks first
        (``legalrag_tpu/index/bundle.py:135-142``); at build time they are
        the whole corpus. A bert encoder has no corpus statistics and
        serves on unchanged. The grown encoder and stores are built aside:
        requests served meanwhile read the state from before the append."""
        with self._append_lock:
            cur = self.state
            fresh = [c for c in chunks if c.id not in cur.id2row]
            if not fresh:
                return 0
            texts = [c.text for c in fresh]
            enc = (cur.encoder.with_idf(texts)
                   if isinstance(cur.encoder, HashEncoder) else cur.encoder)
            colbert = self.cfg.retrieval.enable_colbert
            t0 = time.time()
            vecs = enc.encode_passages(texts)
            if colbert:
                tok, mask = enc.encode_tokens(texts, cur.tokens.doc_maxlen)
            t_enc = time.time() - t0
            chunks_after = cur.chunks + fresh
            id2row = dict(cur.id2row)
            for row, c in enumerate(fresh, start=len(cur.chunks)):
                id2row[c.id] = row
            dense = copy.copy(cur.dense)
            dense.add(vecs)
            tokens = cur.tokens
            if colbert:
                tokens = copy.copy(tokens)
                tokens.add(tok, mask)
            t0 = time.time()
            bm25 = copy.copy(cur.bm25)
            if bm25.n:
                bm25.add_texts(texts)
            else:
                bm25.build_from_texts([c.text for c in chunks_after])
            t_bm25 = time.time() - t0
            self.state = BundleState(enc, dense, bm25, tokens, chunks_after,
                                     id2row, cur.generation + 1)
        log.info("[%s] appended %d chunks (encode %.6fs, bm25 %.6fs) -> n=%d "
                 "capacity=%d generation=%d", self.lang, len(fresh), t_enc,
                 t_bm25, len(chunks_after), dense.capacity, cur.generation + 1)
        return len(fresh)

    def row_chunks(self, rows: Sequence[int]) -> List[LawChunk]:
        return [self.chunks[r] for r in rows]

    @property
    def n_docs(self) -> int:
        return len(self.chunks)

    # --------------------------------------------------------------- sharding
    def enable_sharding(self, mesh) -> None:
        """Serve this bundle's indexes split over ``mesh``'s model axis. The
        stores stay as they are, so appends keep working; ``shard_views``
        builds the split copies of the state it is given."""
        self.mesh = mesh
        self._shard_views = None

    def shard_views(self, state: Optional[BundleState] = None
                    ) -> Optional[Dict]:
        """Per-model-shard copies of ``state``'s (default: the current
        state's) dense rows (``emb``), impact columns (``impact``) and, when
        the late channel serves, tokens and mask (``tok``, ``mask``), shard
        ``j`` on ``mesh.devices[0][j]``, with ``q_dtype``, the dtype of the
        MaxSim queries over ``tok``. None when sharding is off or the state
        is empty. The shared doc capacity ``ceil(max(dense capacity, impact
        columns, 1) / s) * s`` covers both doc axes (they round
        independently) and splits evenly; an int8 dense store rounds it to
        ``8 * s`` (``int8_dot`` takes rows in multiples of 8). An nbit4
        store is reconstructed per shard slice on the host, in the engine
        dtype (bf16 for an int8 engine), so the whole store is never
        dequantized at once."""
        if self.mesh is None:
            return None
        st = state if state is not None else self.state
        if st.dense.n == 0:
            return None
        key = (st.generation, st.dense.n)
        with self._views_lock:
            cached = self._shard_views
            if cached is not None and cached[0] == key:
                return cached[1]
            if cached is None or cached[0] < key:
                views = self._build_views(st)
                self._shard_views = (key, views)
                return views
        # a state older than the cached views' (a call that took it before
        # an ingest published): its own views, built and not kept, so the
        # newer views stay cached
        return self._build_views(st)

    def _build_views(self, st: BundleState) -> Dict:
        from legalrag_tpu_torch.parallel.mesh import MODEL_AXIS

        s = self.mesh.shape[MODEL_AXIS]
        unit = s * (8 if st.dense.emb.dtype == torch.int8 else 1)
        n_impact = st.bm25.impact.shape[1]
        cap = -(-max(st.dense.capacity, n_impact, 1) // unit) * unit
        n_local = cap // s
        devs = [self.mesh.devices[0, j] for j in range(s)]

        def pad(t: torch.Tensor, dim: int) -> torch.Tensor:
            short = n_local - t.shape[dim]
            if short == 0:
                return t
            shape = list(t.shape)
            shape[dim] = short
            return torch.cat([t, t.new_zeros(shape)], dim=dim)

        def shard(t: torch.Tensor, j: int, dim: int = 0) -> torch.Tensor:
            part = t.narrow(dim, min(j * n_local, t.shape[dim]),
                            max(0, min(n_local, t.shape[dim] - j * n_local)))
            return pad(part, dim).contiguous().to(devs[j])

        views = {"emb": [shard(st.dense.emb, j) for j in range(s)],
                 "impact": [shard(st.bm25.impact, j, 1) for j in range(s)]}
        if (self.cfg.retrieval.enable_colbert and st.tokens.n
                and st.tokens.n == st.dense.n):
            tokens = st.tokens
            if isinstance(tokens, Residual4TokenIndex):
                dtype = store_dtype(self.cfg.engine.dtype)
                if dtype == torch.int8:
                    dtype = torch.bfloat16
                tok = []
                for j in range(s):
                    rows, _ = tokens.dequantized_rows(j * n_local,
                                                      (j + 1) * n_local)
                    tok.append(pad(torch.from_numpy(rows).to(dtype), 0)
                               .to(devs[j]))
            else:
                tok = [shard(tokens.tok, j) for j in range(s)]
            views["tok"] = tok
            views["mask"] = [shard(tokens.mask, j) for j in range(s)]
            views["q_dtype"] = (torch.float32 if tok[0].dtype == torch.int8
                                else tok[0].dtype)
        log.info("[%s] sharded index views over %d shards (cap=%d)",
                 self.lang, s, cap)
        return views

    # --------------------------------------------------------------- persist
    def save(self, index_dir: str | Path) -> None:
        st = self.state  # one generation, whatever an append publishes
        d = Path(index_dir)
        d.mkdir(parents=True, exist_ok=True)
        with file_lock(d / ".lock"):
            # meta before payloads: a crash can leave extra meta but never
            # a payload row without meta
            write_chunks_jsonl(st.chunks, d / "chunks.jsonl")
            st.dense.save(d / "dense.npz")
            st.bm25.save(d / "bm25.npz")
            if self.cfg.retrieval.enable_colbert:
                st.tokens.save(d / "tokens.npz")
            if isinstance(st.encoder, HashEncoder):
                np.savez_compressed(d / "encoder.npz", **st.encoder.state())
            manifest = {
                "schema_version": SCHEMA_VERSION,
                "tokenize_fingerprint": TOKENIZE_FINGERPRINT,
                "lang": self.lang,
                "n_docs": len(st.chunks),
                "dim": st.dense.dim,
                "token_dim": st.tokens.token_dim,
                "doc_maxlen": st.tokens.doc_maxlen,
                "generation": st.generation,
                "embedding_backend": self.cfg.retrieval.embedding_backend,
                "created_unix": time.time(),
            }
            tmp = d / "manifest.json.tmp"
            tmp.write_text(json.dumps(manifest, indent=2), encoding="utf-8")
            os.replace(tmp, d / "manifest.json")
        log.info("[%s] saved index (n=%d) -> %s", self.lang, len(st.chunks), d)

    @classmethod
    def load(cls, index_dir: str | Path, cfg: AppConfig, lang: str,
             device: DeviceLike = None) -> "IndexBundle":
        d = Path(index_dir)
        manifest = json.loads((d / "manifest.json").read_text(encoding="utf-8"))
        stored = manifest.get("tokenize_fingerprint", "v1")
        if stored != TOKENIZE_FINGERPRINT:
            raise StaleIndexError(
                f"index {d} was built with tokenize fingerprint '{stored}' "
                f"but this code emits '{TOKENIZE_FINGERPRINT}': rebuild it")
        b = cls(lang, cfg, device)
        chunks = list(iter_chunks_from_file(d / "chunks.jsonl"))
        enc_path = d / "encoder.npz"
        # as JAX decides (legalrag_tpu/index/bundle.py:305-313): a hash
        # bundle's saved encoder, else the configured one
        if (manifest.get("embedding_backend", "hash") == "hash"
                and enc_path.exists()):
            z = np.load(enc_path, allow_pickle=False)
            encoder = HashEncoder.from_state({k: z[k] for k in z.files},
                                             device=b.device)
        else:
            encoder = get_encoder(cfg, lang, b.device)
        e = cfg.engine
        dense = DenseIndex.load(d / "dense.npz", e.dtype, e.capacity_round,
                                b.device)
        tokens = b.tokens
        tok_path = d / "tokens.npz"
        if cfg.retrieval.enable_colbert and tok_path.exists():
            # the payload decides, as in JAX (bundle.py:313-314): int8 and
            # nbit4 payloads load as they were saved, a float one in
            # engine.dtype
            tokens = TokenIndex.load(tok_path, e.dtype, e.capacity_round,
                                     b.device)
        # chunks.jsonl may lead payload rows after a crash (meta-first
        # write ordering); trim the view to the payload row count
        if dense.n < len(chunks):
            log.warning("[%s] trimming %d meta rows without payload",
                        lang, len(chunks) - dense.n)
            chunks = chunks[:dense.n]
        b.state = BundleState(
            encoder, dense, BM25Index.load(d / "bm25.npz", b.device), tokens,
            chunks, {c.id: i for i, c in enumerate(chunks)},
            int(manifest.get("generation", 0)))
        return b

    @staticmethod
    def exists(index_dir: str | Path) -> bool:
        return (Path(index_dir) / "manifest.json").exists()
