"""HTTP server of the RAG system (port of ``legalrag_tpu/api/server.py``,
the request path).

- ``POST /rag/retrieve``: route + hybrid search; caches {question,
  decision, hits} under a ``retrieval_id`` with a 15-minute TTL
- ``POST /rag/retrieve_batch``: a batch of questions through the fused
  query engine (``FusedQueryEngine.search_hits``), per language
- ``POST /rag/answer``: JSON, or SSE when ``stream`` is true: ``meta``,
  per-chunk ``token`` (with dt), incremental ``section``/``item``/
  ``sentence`` structure events, keep-alive pings, ``citations``,
  ``done``/``error``
- ``POST /rag/query``: retrieve + answer in one call
- ``POST /ingest/pdf``: a multipart upload (``file``: a PDF or a text
  file) extracted and chunked in the request, then appended to the live
  bundles by a background worker (``ingest/service.py``); 422 without a
  file, 400 when no text can be extracted
- ``GET /ingest/status/{doc_id}``: the upload's four-key status (404 for
  an unknown id); ``GET /debug/ingest/preview?doc_id=``: its first chunks
- ``GET /``, ``/health``, ``/ready``, ``/metrics``, ``/ui``

The JSON is the JAX server's: the same keys in the same order, ``None``
fields of hits left out, enums as their values.

Behaviours kept: a startup build (in a thread unless ``build_async`` is
false) whose warmup flips ``/ready``; per-request ids through the
contextvar; a per-request LLM through the ``X-OpenAI-Api-Key`` header
when the provider is keyless; a remote retrieval service through the
``RETRIEVAL_URL`` environment variable (``api/retrieval_api.py``); a
graceful drain on SIGTERM.

The retrieval runs on ``cuda`` unless the caller names another device:
``create_app`` raises without CUDA when no device is given. A CUDA error
while serving reaches the caller as a 500 (or an SSE ``error`` event);
nothing fails over to the CPU. ``/ready`` reports the torch backend
(``cuda`` or ``cpu``) and the card names.
"""

from __future__ import annotations

import asyncio
import json
import os
import threading
import time
import urllib.request
import uuid
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch

from legalrag_tpu_torch.api.answer_scanner import StructuredAnswerScanner
from legalrag_tpu_torch.api.webcore import (
    App,
    HTTPError,
    Request,
    Response,
    StreamingResponse,
    sse_event,
)
from legalrag_tpu_torch.config import AppConfig
from legalrag_tpu_torch.ingest.service import IngestService
from legalrag_tpu_torch.llm.client import LLMClient
from legalrag_tpu_torch.llm.context import set_request_id
from legalrag_tpu_torch.llm.gateway import LLMGateway
from legalrag_tpu_torch.parallel.mesh import init_multihost
from legalrag_tpu_torch.pipeline.citations import verify_citations
from legalrag_tpu_torch.pipeline.rag_pipeline import RagPipeline
from legalrag_tpu_torch.retrieval.by_lang import BundleCache, ByLangRetriever
from legalrag_tpu_torch.retrieval.engine import FusedQueryEngine
from legalrag_tpu_torch.schemas import RetrievalHit, RoutingDecision, dump
from legalrag_tpu_torch.utils import detect_lang, get_logger
from legalrag_tpu_torch.utils.device import DeviceLike, resolve_device
from legalrag_tpu_torch.utils.metrics import METRICS

log = get_logger("torch.api.server")

UI_PATH = Path(__file__).resolve().parents[2] / "ui" / "index.html"


class RetrieveCache:
    """retrieval_id → {question, decision, hits}; TTL purge on access."""

    def __init__(self, ttl: float = 900.0):
        self.ttl = ttl
        self._data: Dict[str, tuple] = {}
        self._lock = threading.Lock()

    def put(self, payload: Dict[str, Any]) -> str:
        rid = uuid.uuid4().hex
        with self._lock:
            self._purge()
            self._data[rid] = (time.monotonic(), payload)
        return rid

    def get(self, rid: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            self._purge()
            entry = self._data.get(rid)
            return entry[1] if entry else None

    def _purge(self) -> None:
        cutoff = time.monotonic() - self.ttl
        for k in [k for k, (t, _) in self._data.items() if t < cutoff]:
            del self._data[k]


def device_names(device: torch.device) -> List[str]:
    """The names of the devices behind ``device``'s backend."""
    if device.type == "cuda":
        return [torch.cuda.get_device_name(i)
                for i in range(torch.cuda.device_count())]
    return [str(device)]


class ServerState:
    def __init__(self, cfg: AppConfig, device: DeviceLike = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.pipeline: Optional[RagPipeline] = None
        self.ingest: Optional[IngestService] = None
        self.ready = False
        self.warmup_done = False
        self.draining = False  # SIGTERM received: /ready 503, drain, stop
        self.error: Optional[str] = None
        self.cache = RetrieveCache(cfg.server.retrieve_cache_ttl)
        self.retrieval_url = os.environ.get("RETRIEVAL_URL")
        self._engines: Dict[str, FusedQueryEngine] = {}
        self._engines_lock = threading.Lock()

    def engine_for(self, lang: str, bundle) -> FusedQueryEngine:
        """The language's FusedQueryEngine, kept while its bundle is the
        live one (a reload makes a new one). Locked: concurrent request
        threads share one engine."""
        with self._engines_lock:
            cached = self._engines.get(lang)
            if cached is None or cached.bundle is not bundle:
                cached = FusedQueryEngine(bundle, self.cfg.with_lang(lang))
                self._engines[lang] = cached
            return cached

    # ----------------------------------------------------------- lifecycle
    def build(self) -> None:
        try:
            client = LLMClient.from_config(self.cfg, device=self.device)
            gateway = LLMGateway(client)
            cache = BundleCache(self.cfg, device=self.device)
            retriever = ByLangRetriever(self.cfg, llm=gateway, cache=cache)
            self.pipeline = RagPipeline(self.cfg, llm=gateway,
                                        retriever=retriever)
            # uploads grow the bundles of the cache the retriever serves
            self.ingest = IngestService(self.cfg, cache)
            self.ready = True
            self._warmup()
        except Exception as e:
            self.error = str(e)
            log.error("pipeline build failed: %s", e, exc_info=True)

    def _warmup(self) -> None:
        # the default top_k: the k bucket that real requests use
        k = self.cfg.retrieval.top_k
        try:
            self.pipeline.retriever.search("法律条文", top_k=k)
        except Exception as e:
            log.warning("zh warmup skipped: %s", e)
        try:
            self.pipeline.retriever.search("legal provision", top_k=k)
        except Exception as e:
            log.warning("en warmup skipped: %s", e)
        self._prewarm_buckets()
        self.warmup_done = True
        log.info("warmup complete; /ready now true")

    def _prewarm_buckets(self) -> None:
        """One channels call at every micro-batch bucket (powers of two up
        to ``server.prewarm_buckets``) before /ready flips. Nothing
        compiles per shape on CUDA, but the first calls build the kernel
        library (``kernels.build``, nvcc) and warm cuBLAS's handles and
        PyTorch's caching allocator at each bucket's sizes, which the
        first concurrent burst would otherwise pay in-request."""
        limit = self.cfg.server.prewarm_buckets
        if limit <= 0:
            return
        r = self.cfg.retrieval
        eff_k = max(r.top_k, r.top_k * r.oversample_factor)
        for lang, q in (("zh", "法律条文"), ("en", "legal provision")):
            try:
                hr = self.pipeline.retriever.retriever(lang)
            except FileNotFoundError:
                continue  # the language has no index (warmup logged it)
            b = 2
            while b <= min(limit, hr._batcher._max):
                t0 = time.monotonic()
                try:
                    hr._channels_topk_batch([q] * b, eff_k)
                except Exception as e:
                    log.warning("[%s] bucket-%d prewarm failed: %s",
                                lang, b, str(e)[:200])
                    break
                log.info("[%s] bucket %d warm (%.1fs)", lang, b,
                         time.monotonic() - t0)
                b *= 2

    def require_ready(self) -> None:
        if not self.ready or self.pipeline is None:
            raise HTTPError(503, self.error or "pipeline is still building")

    # ------------------------------------------------------------- helpers
    def llm_for_request(self, req: Request):
        """A client for the request's own key, when the server has none."""
        user_key = req.headers.get("x-openai-api-key")
        if user_key and (self.cfg.llm.provider == "disabled"
                         or not self.cfg.llm.api_key):
            return LLMGateway(LLMClient.from_config_with_key(self.cfg, user_key))
        return None

    def retrieve(self, question: str, top_k: Optional[int]):
        if self.retrieval_url:
            body = json.dumps({"question": question, "top_k": top_k}).encode()
            r = urllib.request.Request(
                self.retrieval_url.rstrip("/") + "/retrieve", data=body,
                headers={"Content-Type": "application/json"}, method="POST")
            with urllib.request.urlopen(r, timeout=30) as resp:
                obj = json.loads(resp.read().decode("utf-8"))
            hits = [RetrievalHit.from_dict(h) for h in obj["hits"]]
            decision = RoutingDecision.from_dict(obj["decision"])
            return hits, decision
        return self.pipeline.retrieve(question, top_k=top_k)


def _hit_payload(h: RetrievalHit) -> Dict[str, Any]:
    return dump(h, exclude_none=True)


def _int_or_422(value, name: str):
    """Body params arrive as arbitrary JSON; a string top_k would reach
    deep into the engine before failing (e.g. "5" * oversample)."""
    if value is None:
        return None
    if isinstance(value, bool) or not isinstance(value, (int, float)) \
            or int(value) != value:
        raise HTTPError(422, f"{name} must be an integer")
    return int(value)


def create_app(cfg: Optional[AppConfig] = None, *, build_async: bool = True,
               state: Optional[ServerState] = None,
               device: DeviceLike = None) -> App:
    """The server's app over ``cfg``; its retrieval runs on ``device``
    (``cuda`` when None, and without CUDA that raises here)."""
    cfg = cfg or AppConfig.load()
    st = state or ServerState(cfg, device)
    app = App(cors_allow_all=cfg.server.cors_allow_all)
    app.state = st

    if build_async:
        threading.Thread(target=st.build, daemon=True,
                         name="pipeline-build").start()
    else:
        st.build()

    # ------------------------------------------------------------- basics
    @app.get("/")
    def root(req: Request) -> Response:
        return Response({"name": "legalrag-tpu", "ready": st.ready,
                         "endpoints": ["/rag/retrieve", "/rag/answer",
                                       "/rag/query", "/ingest/pdf",
                                       "/ingest/status/{doc_id}", "/health",
                                       "/ready", "/ui"]})

    @app.get("/health")
    def health(req: Request) -> Response:
        return Response({"status": "ok"})

    @app.get("/metrics")
    def metrics(req: Request) -> Response:
        return Response(METRICS.render(),
                        media_type="text/plain; version=0.0.4")

    @app.get("/ready")
    def ready(req: Request) -> Response:
        ok = st.ready and st.warmup_done and not st.draining
        return Response({
            "ready": ok,
            "pipeline_ready": st.ready,
            "warmup_done": st.warmup_done,
            "draining": st.draining,
            "error": st.error,
            "provider": cfg.llm.provider,
            "backend": st.device.type,
            "devices": device_names(st.device),
        }, status=200 if not st.draining else 503)

    @app.get("/ui")
    def ui(req: Request) -> Response:
        if UI_PATH.exists():
            return Response(UI_PATH.read_text(encoding="utf-8"),
                            media_type="text/html; charset=utf-8")
        return Response({"detail": "ui not bundled"}, status=404)

    # ------------------------------------------------------------ retrieve
    @app.post("/rag/retrieve")
    def rag_retrieve(req: Request) -> Response:
        st.require_ready()
        set_request_id(uuid.uuid4().hex[:12])
        body = req.json()
        question = (body.get("question") or "").strip()
        if not question:
            raise HTTPError(422, "question is required")
        top_k = _int_or_422(body.get("top_k"), "top_k")
        METRICS.inc("legalrag_requests", endpoint="retrieve")
        with METRICS.timed("legalrag_retrieve_seconds"):
            hits, decision = st.retrieve(question, top_k)
        rid = st.cache.put({"question": question, "decision": decision,
                            "hits": hits})
        return Response({
            "retrieval_id": rid,
            "question": question,
            "decision": dump(decision),
            "hits": [_hit_payload(h) for h in hits],
        })

    @app.post("/rag/retrieve_batch")
    def rag_retrieve_batch(req: Request) -> Response:
        """Batched retrieval through the fused query engine (one device call
        per language and batch; no graph or rerank stages: /rag/retrieve
        runs the full per-query pipeline)."""
        st.require_ready()
        body = req.json()
        raw_qs = body.get("questions")
        if not isinstance(raw_qs, list):  # a string would iterate per CHAR
            raise HTTPError(422, "questions must be a list of strings")
        questions = [q.strip() for q in raw_qs
                     if isinstance(q, str) and q.strip()]
        if not questions:
            raise HTTPError(422, "questions (non-empty list) is required")
        if len(questions) > cfg.engine.max_query_batch * 4:
            raise HTTPError(422, f"at most {cfg.engine.max_query_batch * 4} "
                            "questions per call")
        top_k = _int_or_422(body.get("top_k"), "top_k") or cfg.retrieval.top_k
        METRICS.inc("legalrag_requests", endpoint="retrieve_batch")
        METRICS.inc("legalrag_batch_queries", value=len(questions))

        by_lang: Dict[str, list] = {}
        for i, q in enumerate(questions):
            by_lang.setdefault(detect_lang(q), []).append((i, q))
        results: list = [None] * len(questions)
        for lang, items in by_lang.items():
            try:
                bundle = st.pipeline.retriever.cache.get(lang)
            except FileNotFoundError:
                # one language having no index must not fail the whole
                # mixed batch: those questions get empty hit lists
                log.warning("retrieve_batch: no %s index; %d question(s) "
                            "get empty results", lang, len(items))
                for i, _q in items:
                    results[i] = []
                continue
            engine = st.engine_for(lang, bundle)
            hits = engine.search_hits([q for _, q in items], top_k)
            for (i, _q), hs in zip(items, hits):
                results[i] = [_hit_payload(h) for h in hs]
        return Response({"results": results})

    # -------------------------------------------------------------- answer
    def _resolve_answer_inputs(body: Dict[str, Any]):
        rid = body.get("retrieval_id")
        if rid:
            entry = st.cache.get(rid)
            if entry is None:
                raise HTTPError(404, "retrieval_id not found or expired")
            return entry["question"], entry["hits"], entry["decision"]
        question = (body.get("question") or "").strip()
        if not question:
            raise HTTPError(422, "retrieval_id or question is required")
        hits, decision = st.retrieve(question, body.get("top_k"))
        return question, hits, decision

    def _sse_stream(question, hits, decision, llm):
        loop = asyncio.new_event_loop()
        t0 = time.time()
        fut = agen = None
        try:
            yield b":" + b" " * 2048 + b"\n\n"  # anti-buffering padding
            yield sse_event("meta", {
                "question": question,
                "decision": dump(decision) if decision else None,
                "hits": [_hit_payload(h) for h in hits],
            })
            agen = st.pipeline.answer_stream_from_hits(
                question, hits, decision, llm=llm)
            scanner = StructuredAnswerScanner()
            answer_buf = []
            last_ping = time.time()
            gen = agen.__aiter__()
            while True:
                # await the next chunk in 1 s slices, so keep-alive pings
                # flow during an LLM stall (proxies drop idle connections);
                # asyncio.wait leaves the pending __anext__ task intact
                fut = asyncio.ensure_future(gen.__anext__(), loop=loop)
                try:
                    while True:
                        done, _ = loop.run_until_complete(
                            asyncio.wait({fut}, timeout=1.0))
                        if done:
                            chunk = fut.result()
                            break
                        yield b": ping\n\n"
                        last_ping = time.time()
                except StopAsyncIteration:
                    break
                now = time.time()
                if now - last_ping > 1.0:
                    yield b": ping\n\n"
                    last_ping = now
                if not chunk:
                    continue
                answer_buf.append(chunk)
                yield sse_event("token", {"text": chunk,
                                          "dt": round(now - t0, 3)})
                for ev, payload in scanner.feed(chunk):
                    yield sse_event(ev, payload)
            # which article refs of the whole streamed answer the hits
            # support
            yield sse_event("citations",
                            verify_citations("".join(answer_buf), hits))
            yield sse_event("done", {"ok": True,
                                     "dt": round(time.time() - t0, 3)})
        except Exception as e:
            log.error("SSE stream failed: %s", e, exc_info=True)
            yield sse_event("error", {"detail": str(e)})
        finally:
            # A disconnecting client raises GeneratorExit at a yield (not
            # caught above): cancel the in-flight __anext__ and close the
            # LLM stream generator BEFORE closing the loop, else the
            # pending task and the provider's HTTP stream leak per
            # dropped streaming client.
            try:
                if fut is not None and not fut.done():
                    fut.cancel()
                    loop.run_until_complete(
                        asyncio.gather(fut, return_exceptions=True))
                if agen is not None:
                    loop.run_until_complete(agen.aclose())
            except Exception:
                log.debug("SSE cleanup error", exc_info=True)
            loop.close()

    @app.post("/rag/answer")
    def rag_answer(req: Request):
        st.require_ready()
        set_request_id(uuid.uuid4().hex[:12])
        body = req.json()
        question, hits, decision = _resolve_answer_inputs(body)
        llm = st.llm_for_request(req)
        if body.get("stream"):
            return StreamingResponse(_sse_stream(question, hits, decision, llm))
        ans = st.pipeline.answer_from_hits(question, hits, decision, llm=llm)
        return Response({"question": question, "answer": ans.answer,
                         "citations": ans.citations,
                         "decision": dump(decision) if decision else None,
                         "hits": [_hit_payload(h) for h in hits]})

    @app.post("/rag/query")
    def rag_query(req: Request):
        st.require_ready()
        set_request_id(uuid.uuid4().hex[:12])
        body = req.json()
        question = (body.get("question") or "").strip()
        if not question:
            raise HTTPError(422, "question is required")
        hits, decision = st.retrieve(question, body.get("top_k"))
        llm = st.llm_for_request(req)
        if body.get("stream"):
            return StreamingResponse(_sse_stream(question, hits, decision, llm))
        ans = st.pipeline.answer_from_hits(question, hits, decision, llm=llm)
        return Response({"question": question, "answer": ans.answer,
                         "citations": ans.citations,
                         "decision": dump(decision),
                         "hits": [_hit_payload(h) for h in hits]})

    # -------------------------------------------------------------- ingest
    @app.post("/ingest/pdf")
    def ingest_pdf(req: Request) -> Response:
        st.require_ready()
        form = req.form()
        f = form.get("file")
        if not isinstance(f, dict) or not f.get("content"):
            raise HTTPError(422, "multipart field 'file' is required")
        try:
            doc_id, n = st.ingest.ingest_upload_and_schedule(
                f.get("filename") or "upload.bin", f["content"])
        except (ValueError, RuntimeError) as e:
            raise HTTPError(400, str(e))
        return Response({"doc_id": doc_id, "chunks": n,
                         "status_url": f"/ingest/status/{doc_id}"})

    @app.get("/ingest/status/{doc_id}")
    def ingest_status(req: Request) -> Response:
        st.require_ready()
        status = st.ingest.get_status(req.params["doc_id"])
        if not status:
            raise HTTPError(404, "unknown doc_id")
        return Response({"doc_id": req.params["doc_id"], "status": status})

    @app.get("/debug/ingest/preview")
    def ingest_preview(req: Request) -> Response:
        """The first chunks of an ingested document, as written."""
        st.require_ready()
        doc_id = req.query.get("doc_id", "")
        path = Path(cfg.paths.processed_dir) / f"ingested_{doc_id}.jsonl"
        if not doc_id or not path.exists():
            raise HTTPError(404, "unknown doc_id")
        chunks = [json.loads(l) for l in
                  path.read_text(encoding="utf-8").splitlines() if l.strip()]
        return Response({"doc_id": doc_id, "n_chunks": len(chunks),
                         "chunks": chunks[:5]})

    return app


def shutdown_gracefully(st: ServerState, server, grace: float) -> None:
    """Graceful drain (SIGTERM / Ctrl-C): flip /ready to 503 so load
    balancers stop routing, give in-flight requests ``grace`` seconds,
    stop the listener and close its socket (new connections are refused),
    and close the LLM client."""
    st.draining = True
    log.info("draining: /ready now 503; %.1fs grace", grace)
    time.sleep(max(grace, 0.0))
    server.shutdown()
    server.server_close()
    try:
        pipe = st.pipeline
        if pipe is not None and getattr(pipe, "llm", None) is not None \
                and hasattr(pipe.llm, "close"):
            pipe.llm.close()
    except Exception:
        log.warning("LLM close during drain failed", exc_info=True)
    log.info("drained; listener stopped")


def main() -> None:
    import argparse
    import signal

    ap = argparse.ArgumentParser(description="legalrag_tpu_torch API server")
    ap.add_argument("--host", default=None)
    ap.add_argument("--port", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the retrieval (default cuda)")
    args = ap.parse_args()
    # before anything touches a device, as JAX's server does: a multi-host
    # config is refused here (the port serves one host)
    init_multihost()
    cfg = AppConfig.load()
    app = create_app(cfg, device=args.device)
    server = app.serve(args.host or cfg.server.host,
                       args.port if args.port is not None
                       else cfg.server.port)
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda s_, f_: stop.set())
    try:
        while not stop.is_set():
            stop.wait(3600)
    except KeyboardInterrupt:
        pass
    shutdown_gracefully(app.state, server, cfg.server.drain_grace_s)


if __name__ == "__main__":
    main()
