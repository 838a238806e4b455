"""Language routing + serving-side bundle cache (port of
``legalrag_tpu/retrieval/by_lang.py``).

``ByLangRetriever`` detects the query language and lazily owns one
``HybridRetriever`` (and one law-graph store) per language over
``cfg.with_lang(lang)``.

``BundleCache`` reloads a language's bundle when the manifest generation on
disk moves past the one in memory, checking at most every
``check_interval`` seconds: a live server picks up incremental ingests and
newly activated index versions without a restart. A version whose
generation is not above the one in memory is not picked up, as in JAX.
``put`` installs a bundle grown in this process (the ingest path).

The device is fixed when the cache is made: ``cuda`` unless the caller
asks for another, and without CUDA that raises. A CUDA error while serving
propagates to the caller; nothing fails over to the CPU (so JAX's
``failed_over`` guard has no counterpart).

``engine.n_index_shards`` other than 1 serves every bundle the cache loads
or is given doc-sharded (``IndexBundle.enable_sharding``) over one mesh:
N >= 2 takes the first N visible devices of the cache's device type, -1
every visible device (``make_global_mesh``); 0, < -1 and more shards than
visible devices are refused, as in JAX.
"""

from __future__ import annotations

import json
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

from legalrag_tpu_torch.config import AppConfig
from legalrag_tpu_torch.graph.store import LawGraphStore
from legalrag_tpu_torch.index.bundle import IndexBundle
from legalrag_tpu_torch.parallel import mesh as mesh_mod
from legalrag_tpu_torch.retrieval.hybrid import HybridRetriever
from legalrag_tpu_torch.schemas import RetrievalHit, RoutingDecision
from legalrag_tpu_torch.utils import detect_lang, get_logger
from legalrag_tpu_torch.utils.device import DeviceLike, resolve_device

log = get_logger("torch.retrieval.by_lang")


class BundleCache:
    """Loads bundles per language; reloads when the on-disk manifest
    generation moves past the in-memory one. Checks are throttled."""

    def __init__(self, cfg: AppConfig, device: DeviceLike = None,
                 check_interval: float = 2.0):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.check_interval = check_interval
        self._bundles: Dict[str, IndexBundle] = {}
        self._last_check: Dict[str, float] = {}
        self._mesh = None

    def _serving_mesh(self) -> mesh_mod.Mesh:
        """The (1, n_index_shards) serving mesh, made at first use."""
        if self._mesh is None:
            mesh_mod.init_multihost()  # refuses a multi-host config
            s = self.cfg.engine.n_index_shards
            if s == 0 or s < -1:
                raise ValueError(
                    f"engine.n_index_shards={s} is meaningless — use 1 "
                    "(off), N>=2 (N shards), or -1 (every visible device)")
            devs = mesh_mod.local_devices(self.device.type)
            if s == -1:
                self._mesh = mesh_mod.make_global_mesh(devs)
            elif len(devs) < s:
                raise RuntimeError(
                    f"engine.n_index_shards={s} but only {len(devs)} "
                    "devices visible")
            else:
                self._mesh = mesh_mod.make_mesh(devs[:s], data=1, model=s)
        return self._mesh

    def index_dir(self, lang: str) -> Path:
        return Path(self.cfg.with_lang(lang).paths.lang_index_dir)

    def get(self, lang: str) -> IndexBundle:
        now = time.monotonic()
        bundle = self._bundles.get(lang)
        if bundle is not None and now - self._last_check.get(lang, 0) < self.check_interval:
            return bundle
        d = self.index_dir(lang)
        manifest = d / "manifest.json"
        if not manifest.exists():
            raise FileNotFoundError(
                f"no index for lang={lang} at {d}; build and save one first")
        self._last_check[lang] = now
        gen = json.loads(manifest.read_text(encoding="utf-8")).get("generation", 0)
        if bundle is None or gen > bundle.generation:
            lang_cfg = self.cfg.with_lang(lang)
            log.info("[%s] (re)loading index generation=%s from %s", lang, gen, d)
            bundle = IndexBundle.load(d, lang_cfg, lang, device=self.device)
            if self.cfg.engine.n_index_shards != 1:
                bundle.enable_sharding(self._serving_mesh())
            self._bundles[lang] = bundle
        return bundle

    def put(self, lang: str, bundle: IndexBundle) -> None:
        """Install a live bundle (the in-process ingest path)."""
        if self.cfg.engine.n_index_shards != 1 and bundle.mesh is None:
            bundle.enable_sharding(self._serving_mesh())
        self._bundles[lang] = bundle
        self._last_check[lang] = time.monotonic()


class ByLangRetriever:
    def __init__(self, cfg: AppConfig, device: DeviceLike = None, llm=None,
                 cache: Optional[BundleCache] = None):
        self.cfg = cfg
        self.llm = llm
        self.cache = cache or BundleCache(cfg, device=device)
        self._retrievers: Dict[str, HybridRetriever] = {}
        self._graphs: Dict[str, LawGraphStore] = {}
        # request threads look up (and, after a reload, replace) the
        # per-language retriever: one lookup at a time, so two threads never
        # build two retrievers, each with its own micro-batcher, for one
        # bundle
        self._lock = threading.Lock()

    def graph_store(self, lang: str) -> LawGraphStore:
        if lang not in self._graphs:
            lang_cfg = self.cfg.with_lang(lang)
            self._graphs[lang] = LawGraphStore(lang_cfg.paths.graph_file)
        return self._graphs[lang]

    def retriever(self, lang: str) -> HybridRetriever:
        with self._lock:
            bundle = self.cache.get(lang)
            hr = self._retrievers.get(lang)
            if hr is None or hr.bundle is not bundle:
                hr = HybridRetriever(bundle, self.cfg.with_lang(lang),
                                     graph_store=self.graph_store(lang),
                                     llm=self.llm)
                self._retrievers[lang] = hr
            return hr

    def search(self, question: str, top_k: Optional[int] = None,
               decision: Optional[RoutingDecision] = None) -> List[RetrievalHit]:
        return self.retriever(detect_lang(question)).search(
            question, top_k=top_k, decision=decision)
