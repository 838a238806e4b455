"""Configuration of the query path.

Dataclass copies of the fields of ``legalrag_tpu/config.py`` (``PathsConfig``,
``EngineConfig``, ``RetrievalConfig``, ``AppConfig.with_lang``) that the
batched hybrid query path reads, with the same names and defaults, so a
config tuned for one package means the same in the other.

Left out on purpose: ``engine.kernel_backend`` and ``engine.dense_tile_n``
(declared in the JAX package, read nowhere). The port picks a kernel by the
device of its tensors: a CUDA tensor goes to the hand-written kernel, a CPU
tensor to its plain PyTorch version. There is no routing knob.
"""

from __future__ import annotations

import copy
import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

DEFAULT_ROOT = Path(os.environ.get("LEGALRAG_ROOT",
                                   Path(__file__).resolve().parent.parent))


@dataclass
class PathsConfig:
    root: Path = DEFAULT_ROOT
    data_dir: Path = DEFAULT_ROOT / "data"
    raw_dir: Path = DEFAULT_ROOT / "data" / "raw"
    processed_dir: Path = DEFAULT_ROOT / "data" / "processed"
    index_dir: Path = DEFAULT_ROOT / "data" / "index"
    # per-language (resolved by AppConfig.with_lang)
    corpus_file: Path = DEFAULT_ROOT / "data" / "processed" / "law_zh.jsonl"
    lang_index_dir: Path = DEFAULT_ROOT / "data" / "index" / "zh"


@dataclass
class EngineConfig:
    # storage dtype of the dense / token embedding matrices on the device
    # ("bfloat16" | "float32"; the int8 dense store is not ported yet)
    dtype: str = "bfloat16"
    # index capacity is rounded up to a multiple of this
    capacity_round: int = 1024
    # late interaction
    late_doc_maxlen: int = 220
    late_dim: int = 128
    # token-store storage: "" = engine dtype, or "int8" (the nbit4 store is
    # not ported yet)
    token_dtype: str = ""
    # query tokens kept per query (BM25 term ids and late-interaction tokens)
    max_query_tokens: int = 64


@dataclass
class RetrievalConfig:
    embedding_backend: str = "hash"  # the bert backend is not ported yet
    embedding_dim: int = 768

    top_k: int = 10
    oversample_factor: int = 4  # per-channel candidate depth = top_k * factor
    dense_weight: float = 0.6
    bm25_weight: float = 0.4
    colbert_weight: float = 0.35
    min_final_score: float = 0.2

    # fusion (reference hybrid_retriever.py:389-551)
    fusion_method: str = "rrf_norm_blend"
    rrf_k: int = 60
    rrf_alpha: float = 0.5

    # BM25 (rank_bm25.BM25Okapi math)
    bm25_k1: float = 1.5
    bm25_b: float = 0.75
    bm25_epsilon: float = 0.25

    # late interaction channel
    enable_colbert: bool = True


@dataclass
class AppConfig:
    lang: str = "zh"
    paths: PathsConfig = field(default_factory=PathsConfig)
    engine: EngineConfig = field(default_factory=EngineConfig)
    retrieval: RetrievalConfig = field(default_factory=RetrievalConfig)
    index_version: Optional[str] = None

    def with_lang(self, lang: str) -> "AppConfig":
        """Deep copy with the corpus and index paths swapped per language
        (``legalrag_tpu/config.py:384-406``)."""
        cfg = copy.deepcopy(self)
        cfg.lang = lang
        p = cfg.paths
        p.corpus_file = Path(p.processed_dir) / f"law_{lang}.jsonl"
        base = Path(p.index_dir) / lang
        if cfg.index_version:
            base = base / "versions" / cfg.index_version
        else:
            # the registry's ACTIVE pointer (index/registry.py), if present
            active = base / "ACTIVE"
            v = (active.read_text(encoding="utf-8").strip()
                 if active.exists() else "")
            if v and (base / "versions" / v).exists():
                base = base / "versions" / v
        p.lang_index_dir = base
        return cfg
