"""Configuration of the query path, the RAG pipeline and the server.

Dataclass copies of the fields of ``legalrag_tpu/config.py`` (``PathsConfig``,
``EngineConfig``, ``RetrievalConfig``, ``LLMConfig``, ``RoutingConfig``,
``PDFConfig``, ``ServerConfig``, ``AppConfig.load``/``with_lang``) that the
batched hybrid query path, the single-query serving path
(``retrieval/hybrid.py``, ``retrieval/by_lang.py``), the HTTP server with its
pipeline (``api/server.py``, ``pipeline/rag_pipeline.py``,
``llm/client.py``), the offline build CLIs (``cli/``) and PDF ingestion
(``ingest/``) read, with the same names and defaults, so a config tuned for
one package means the same in the other. ``with_lang`` resolves a
language's index directory through the registry's ``ACTIVE`` pointer
(``index/registry.py``), as the JAX package does.

``LLMConfig`` has every field of the JAX package's, the knobs of the local
decoder engines included: the single-stream engine's are read, and the
others' make the ``local-jax`` engine's load fail when set (the port lacks
those engines), so that none is ignored. ``AppConfig.load`` overlays a
JSON (or, where ``yaml`` imports, YAML) file on the defaults as pydantic's
``model_validate`` does: keys the port does not have are ignored, and
``engine.mesh_data_axis`` / ``mesh_model_axis``, whose names the mesh fixes,
are refused at any value but their default.

Left out on purpose: ``engine.kernel_backend``, ``engine.dense_tile_n``,
``retrieval.graph_weight``, ``retrieval.colbert_model`` and
``pdf.ingest_rebuild_colbert`` (declared in the JAX package, read
nowhere).
The port picks a kernel by the device of its tensors: a CUDA tensor goes to
the hand-written kernel, a CPU tensor to its plain PyTorch version. There is
no routing knob.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, Optional

from legalrag_tpu_torch.index.registry import IndexRegistry

DEFAULT_ROOT = Path(os.environ.get("LEGALRAG_ROOT",
                                   Path(__file__).resolve().parent.parent))


@dataclass
class PathsConfig:
    root: Path = DEFAULT_ROOT
    data_dir: Path = DEFAULT_ROOT / "data"
    raw_dir: Path = DEFAULT_ROOT / "data" / "raw"
    processed_dir: Path = DEFAULT_ROOT / "data" / "processed"
    index_dir: Path = DEFAULT_ROOT / "data" / "index"
    graph_dir: Path = DEFAULT_ROOT / "data" / "graph"
    eval_dir: Path = DEFAULT_ROOT / "data" / "eval"
    upload_dir: Path = DEFAULT_ROOT / "data" / "uploads"
    # per-language (resolved by AppConfig.with_lang)
    corpus_file: Path = DEFAULT_ROOT / "data" / "processed" / "law_zh.jsonl"
    lang_index_dir: Path = DEFAULT_ROOT / "data" / "index" / "zh"
    graph_file: Path = DEFAULT_ROOT / "data" / "graph" / "law_graph_zh.jsonl"

    def ensure_tree(self) -> None:
        for p in (self.data_dir, self.raw_dir, self.processed_dir,
                  self.index_dir, self.graph_dir, self.eval_dir,
                  self.upload_dir):
            Path(p).mkdir(parents=True, exist_ok=True)


@dataclass
class EngineConfig:
    # storage dtype of the dense / token embedding matrices on the device:
    # "bfloat16", "float32", or "int8": the unit-int8 dense store
    # (round(127 * e) of unit rows, implicit scale 1/127), scored s8 x s8 ->
    # s32 (ops.topk.dense_scores); it halves the bf16 store's bytes
    dtype: str = "bfloat16"
    # index capacity is rounded up to a multiple of this
    capacity_round: int = 1024
    # late interaction
    late_doc_maxlen: int = 220
    late_dim: int = 128
    # token-store storage: "" = engine dtype, "bfloat16", "int8" (unit
    # vectors * 127) or "nbit4" (the PLAID-class residual store: a centroid
    # id and dt / 2 bytes of 4-bit residuals a token, ~4x smaller than bf16)
    token_dtype: str = ""
    # dense-prefiltered candidates for MaxSim (the late channel's two-phase
    # route past LateInteractionRetriever.FULL_SCAN_MAX docs)
    late_candidates: int = 128
    # large-corpus mode only: write the [B, N] dense score map in bf16 and
    # rescore the winners exactly in float32 ("float32" keeps the exact
    # selection; never applied to an int8 dense store)
    dense_map_dtype: str = "float32"
    # query batching for the serving engine
    max_query_batch: int = 64
    # query tokens kept per query (BM25 term ids and late-interaction tokens)
    max_query_tokens: int = 64
    # serving micro-batch (retrieval/batcher.py): concurrent request
    # threads' channel executions are coalesced into one device call. The
    # window is how long a leader waits for followers before launching;
    # 0 still coalesces requests that arrive while an execution runs.
    microbatch_window_ms: float = 2.0
    microbatch_max: int = 32
    # device mesh (parallel/mesh.py): the axis names are fixed, so
    # AppConfig.load refuses any other value
    mesh_data_axis: str = "data"
    mesh_model_axis: str = "model"
    # doc-sharded serving: split every index's doc axis over this many
    # devices (the mesh's model axis); 1 = one device; -1 = every visible
    # device. A grid may name one card more than once
    # (retrieval/by_lang.py, parallel/sharded_search.py)
    n_index_shards: int = 1


@dataclass
class RetrievalConfig:
    # embedding backends: "hash" (self-contained, deterministic) or "bert":
    # the language's model, a local HF checkpoint directory or a name in
    # the offline HF cache (BGE semantics: the query instruction for
    # queries only, L2-normalized)
    embedding_backend: str = "hash"
    embedding_model_zh: str = "BAAI/bge-base-zh-v1.5"
    embedding_model_en: str = "BAAI/bge-base-en-v1.5"
    embedding_dim: int = 768
    query_instruction_zh: str = "为这个法律问题生成表示以用于检索相关条文："
    query_instruction_en: str = "Represent this legal question for retrieving relevant provisions: "

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

    # graph channel (reference config.py:75-88)
    enable_graph: bool = True
    graph_seed_k: int = 30
    graph_limit: int = 800
    graph_min_conf: float = 0.5
    graph_relation_max_depth: Dict[str, int] = field(default_factory=lambda: {
        "defined_by": 4, "defines_term": 3, "cite": 1, "cited_by": 1,
        "prev": 2, "next": 2, "default": 2,
    })
    graph_depth_decay: float = 0.7
    graph_relation_weights: Dict[str, float] = field(default_factory=lambda: {
        "defined_by": 1.20, "cite": 1.15, "defines_term": 1.10,
        "prev": 0.95, "next": 0.95, "default": 1.0,
    })

    # late interaction channel
    enable_colbert: bool = True

    # HyDE: expand the dense query with an LLM-written hypothetical answer
    enable_hyde: bool = False

    # rerank (reference config.py:119-124); the cross-encoder serves bert
    # bundles when reranker_model loads (a WordPiece checkpoint), MaxSim
    # otherwise
    enable_rerank: bool = True
    rerank_top_n: int = 30
    rerank_beta: float = 0.35
    reranker_model: str = "BAAI/bge-reranker-v2-m3"
    rerank_use_llm: bool = False
    rerank_llm_top_k_threshold: int = 30
    rerank_norm: str = "minmax"  # minmax | sigmoid | none


@dataclass
class LLMConfig:
    provider: str = "disabled"  # openai | local | local-jax | disabled
    model: str = "gpt-4o-mini"
    api_key: Optional[str] = field(
        default_factory=lambda: os.environ.get("OPENAI_API_KEY"))
    base_url: Optional[str] = field(
        default_factory=lambda: os.environ.get("OPENAI_BASE_URL"))
    temperature: float = 0.3
    top_p: float = 0.9
    # local-jax sampling warpers, in HF's order temperature -> top_k ->
    # top_p -> min_p; 0 turns each off (top_k 1 or min_p 1.0 is greedy)
    top_k: int = 0
    min_p: float = 0.0
    # local-jax: HF's repetition penalty over prompt and output; 1.0 = off
    repetition_penalty: float = 1.0
    max_new_tokens: int = 1024
    # local providers: the prompt is truncated to this many tokens
    max_context_tokens: int = 4096
    request_timeout: float = 30.0
    max_retries: int = 2
    retry_backoff: float = 0.6
    # local-jax, the single-stream engine (models/decoder.py): tokens
    # decoded per host round trip; prompts longer than prefill_chunk
    # prefill in chunks at cache offsets; the KV rows of prefix_cache
    # recent prompts kept for exact prefix reuse (0 = off)
    decode_chunk: int = 8
    prefill_chunk: int = 1024
    prefix_cache: int = 0
    # the single-stream engine's quantization (models/quant.py): int8
    # (W8A8) or grouped int4 weights (weight_bits 8 / 4; weight_bits
    # without weight_quant changes nothing, as in JAX) and the int8 KV cache
    weight_quant: bool = False
    weight_bits: int = 8
    kv_quant: bool = False
    # local-jax knobs of the JAX package's other engines, read so that a
    # config tuned for it means the same here: the batched and paged
    # engines are served; the TP and DP ones are not yet, and a knob that
    # would select one, or that JAX ignores in the engine selected, makes
    # the engine's load fail (llm/client.py: unported_engine_knobs), so the
    # answer degrades instead of ignoring it
    batch_slots: int = 0            # > 1: the continuous-batching engine
    paged_kv: bool = False          # with batch_slots: the paged KV pool
    kv_block_size: int = 64         # the pool's block, in tokens
    kv_pool_blocks: int = 0         # 0: (batch_slots + 1) contexts
    spec_k: int = 0                 # > 0: speculative decoding
    spec_adaptive: float = 2.0
    draft_model: str = ""
    ngram_draft_path: str = ""
    shared_prefix_text: str = ""    # the batched engine's pinned prelude
    constrain_json: bool = False    # schema-constrained JSON decoding
    tp_shards: int = 0              # > 1: tensor-parallel decoder
    dp_replicas: int = 0            # > 1: data-parallel replicas


@dataclass
class RoutingConfig:
    llm_based: bool = False
    issue_llm_refine: bool = False


@dataclass
class PDFConfig:
    enable_docling: bool = False
    enable_ocr: bool = False
    # the generic chunker: ~chunk_chars per chunk, chunk_overlap carried over
    chunk_chars: int = 650
    chunk_overlap: int = 90
    # the statute-quality gate (ingest/ingestor.py)
    min_statute_records: int = 20
    statute_coverage_min: float = 0.3
    statute_gap_ratio_max: float = 0.5
    statute_avg_len_ratio_max: float = 0.12
    ingest_rebuild_graph: bool = True


@dataclass
class ServerConfig:
    host: str = "0.0.0.0"
    port: int = field(default_factory=lambda: int(os.environ.get("PORT", "8000")))
    retrieve_cache_ttl: float = 900.0  # 15 min
    cors_allow_all: bool = True
    # startup warmup runs one channels call at every micro-batch bucket up to
    # this batch size (powers of two) before /ready flips; 0 disables
    prewarm_buckets: int = 16
    # graceful SIGTERM drain: /ready flips to 503 at once, in-flight
    # requests get this many seconds, then the listener stops
    drain_grace_s: float = 5.0


def _overlay(obj, data: Dict[str, Any]):
    """Set the fields of dataclass ``obj`` that ``data`` names, recursing
    into sub-configs and making ``Path`` fields paths; other keys are
    ignored, as pydantic ignores extra fields."""
    for f in dataclasses.fields(obj):
        if f.name not in data:
            continue
        value, cur = data[f.name], getattr(obj, f.name)
        if dataclasses.is_dataclass(cur) and isinstance(value, dict):
            _overlay(cur, value)
        elif isinstance(cur, Path) and value is not None:
            setattr(obj, f.name, Path(value))
        else:
            setattr(obj, f.name, copy.deepcopy(value))
    return obj


def _refuse_mesh_axis_names(engine: EngineConfig) -> None:
    """The mesh's axis names are fixed (``parallel/mesh.py``); a config
    that names others is refused rather than ignored."""
    for name in ("mesh_data_axis", "mesh_model_axis"):
        value, fixed = getattr(engine, name), getattr(EngineConfig, name)
        if value != fixed:
            raise ValueError(f"engine.{name}={value!r}: the mesh's axis "
                             f"names are fixed; use {fixed!r} or leave it "
                             "out")


@dataclass
class AppConfig:
    lang: str = "zh"
    paths: PathsConfig = field(default_factory=PathsConfig)
    engine: EngineConfig = field(default_factory=EngineConfig)
    retrieval: RetrievalConfig = field(default_factory=RetrievalConfig)
    llm: LLMConfig = field(default_factory=LLMConfig)
    routing: RoutingConfig = field(default_factory=RoutingConfig)
    pdf: PDFConfig = field(default_factory=PDFConfig)
    server: ServerConfig = field(default_factory=ServerConfig)
    index_version: Optional[str] = None

    @classmethod
    def load(cls, path: Optional[str | Path] = None, *,
             mkdirs: bool = True) -> "AppConfig":
        """Defaults, overlaid field by field with a JSON (or YAML) file;
        the index version from ``LEGALRAG_INDEX_VERSION`` when set; the
        data tree created unless ``mkdirs`` is false
        (``legalrag_tpu/config.py:357-383``)."""
        data: Dict[str, Any] = {}
        if path is not None:
            text = Path(path).read_text(encoding="utf-8")
            if str(path).endswith((".yaml", ".yml")):
                try:
                    import yaml  # type: ignore

                    data = yaml.safe_load(text) or {}
                except ImportError as e:
                    raise RuntimeError("YAML config requires pyyaml; use "
                                       "JSON instead") from e
            else:
                data = json.loads(text)
        cfg = _overlay(cls(), data)
        _refuse_mesh_axis_names(cfg.engine)
        cfg.index_version = os.environ.get("LEGALRAG_INDEX_VERSION",
                                           cfg.index_version)
        cfg._apply_lang_paths(cfg.lang)
        if mkdirs:
            cfg.paths.ensure_tree()
        return cfg

    def with_lang(self, lang: str) -> "AppConfig":
        """Deep copy with the corpus, index and graph paths swapped per
        language (``legalrag_tpu/config.py:384-406``)."""
        cfg = copy.deepcopy(self)
        cfg.lang = lang
        cfg._apply_lang_paths(lang)
        return cfg

    def _apply_lang_paths(self, lang: str) -> None:
        p = self.paths
        p.corpus_file = Path(p.processed_dir) / f"law_{lang}.jsonl"
        base = Path(p.index_dir) / lang
        if self.index_version:
            base = base / "versions" / self.index_version
        else:
            base = IndexRegistry(base).active_index_dir()
        p.lang_index_dir = base
        p.graph_file = Path(p.graph_dir) / f"law_graph_{lang}.jsonl"
