"""Port HTTP server (``api/server.py``, ``api/webcore.py``,
``api/retrieval_api.py``) vs the JAX server on the CPU.

The JAX package builds the zh and en bundles (100 chunks each) and their
law graphs and saves them; the JAX app and the port's app
(``device="cpu"``) serve the SAME directories. Every endpoint must answer
with the same status and the same JSON: the same keys in the same order,
floats within ATOL, everything else (hit ids, ranks, sources, strings)
exactly. Left out: ``retrieval_id`` (random), ``dt`` (clock) and
``/ready``'s ``backend``/``devices`` (JAX's and torch's own names). SSE
streams must carry the same events with the same payloads. No test reaches
the network: the LLM is disabled, a stub on 127.0.0.1, or a closed
loopback port."""

import json
import shutil
import socket
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest

from chip_smoke import OpenAIStub
from legalrag_tpu.api.server import create_app as jax_create_app
from legalrag_tpu.api.webcore import TestClient as JaxTestClient
from legalrag_tpu.config import AppConfig as JaxConfig
from legalrag_tpu.config import LLMConfig as JaxLLMConfig
from legalrag_tpu.corpus import write_chunks_jsonl as jax_write_chunks
from legalrag_tpu.graph import GraphBuilder as JaxGraphBuilder
from legalrag_tpu.index.bundle import IndexBundle as JaxBundle
from legalrag_tpu.llm.client import LLMClient as JaxLLMClient
from legalrag_tpu.llm.gateway import LLMGateway as JaxGateway
from legalrag_tpu_torch.api import retrieval_api
from legalrag_tpu_torch.api.server import create_app, shutdown_gracefully
from legalrag_tpu_torch.api.webcore import (
    App,
    Request,
    Response,
    StreamingResponse,
    TestClient,
    sse_event,
)
from legalrag_tpu_torch.config import AppConfig, LLMConfig
from legalrag_tpu_torch.index.bundle import IndexBundle
from legalrag_tpu_torch.ingest.minipdf import build_pdf
from legalrag_tpu_torch.llm.client import LLMClient
from legalrag_tpu_torch.llm.gateway import LLMGateway
from legalrag_tpu_torch.retrieval.hybrid import HybridRetriever
from legalrag_tpu_torch.schemas import LawChunk

ATOL = 1e-4   # every float of a response body
PATHS = ("data_dir", "raw_dir", "processed_dir", "index_dir", "graph_dir",
         "eval_dir", "upload_dir")


def closed_port() -> int:
    """A loopback port with nothing listening (bound, then released)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def small_config(cfg, root):
    cfg.llm.provider = "disabled"
    cfg.llm.api_key = None
    # a keyed request (X-OpenAI-Api-Key) goes here: refused at once
    cfg.llm.base_url = f"http://127.0.0.1:{closed_port()}/v1"
    cfg.engine.capacity_round = 256
    cfg.engine.late_doc_maxlen = 64
    cfg.server.prewarm_buckets = 0
    for name in PATHS:
        setattr(cfg.paths, name, root / name)
    return cfg


@pytest.fixture(scope="module")
def served(en_chunks, zh_chunks, tmp_path_factory):
    """(JAX client, port client, port config) over one index directory."""
    root = tmp_path_factory.mktemp("torch_srv")
    jcfg = small_config(JaxConfig(), root)
    cfg = small_config(AppConfig(), root)
    cfg.llm.base_url = jcfg.llm.base_url
    jcfg.paths.ensure_tree()
    for lang, chunks in (("en", en_chunks[:100]), ("zh", zh_chunks[:100])):
        lc = jcfg.with_lang(lang)
        JaxBundle.build_from_chunks(chunks, lc, lang).save(lc.paths.lang_index_dir)
        JaxGraphBuilder().build_to_file(chunks, lc.paths.graph_file)
    japp = jax_create_app(jcfg, build_async=False)
    app = create_app(cfg, build_async=False, device="cpu")
    assert app.state.error is None and japp.state.error is None
    return JaxTestClient(japp), TestClient(app), cfg


def assert_same_json(got, want, path="$"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), \
            (path, list(got), list(want))
        for k in want:
            assert_same_json(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), \
            (path, got, want)
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same_json(g, w, f"{path}[{i}]")
    elif isinstance(want, float) or isinstance(got, float):
        assert not isinstance(got, bool) and abs(got - want) <= ATOL, \
            (path, got, want)
    else:
        assert got == want, (path, got, want)


def without(body, *keys):
    return {k: v for k, v in body.items() if k not in keys}


def sse(resp):
    """A stream's events, ``dt`` left out."""
    return [[e, without(p, "dt") if isinstance(p, dict) else p]
            for e, p in resp.sse_events()]


def both(served, method, path, **kw):
    jc, pc, _cfg = served
    return (getattr(pc, method)(path, **kw), getattr(jc, method)(path, **kw))


@pytest.fixture
def llm_on_both(served):
    """Install one stub LLM object (or a pair) on both apps for a test."""
    jc, pc, _cfg = served
    olds = (jc.app.state.pipeline.llm, pc.app.state.pipeline.llm)

    def install(port_llm, jax_llm=None):
        pc.app.state.pipeline.llm = port_llm
        jc.app.state.pipeline.llm = jax_llm or port_llm

    yield install
    jc.app.state.pipeline.llm, pc.app.state.pipeline.llm = olds


class StreamLLM:
    """Streams a canned answer in 7-char chunks; the same in chat."""

    is_degraded = False

    def __init__(self, text):
        self.text = text

    def chat(self, messages, tag="chat", **kw):
        return self.text

    def chat_stream(self, messages, tag="chat", **kw):
        for i in range(0, len(self.text), 7):
            yield self.text[i:i + 7]

    def degraded_answer(self, messages):
        return "degraded"


def sections_citing(article_id: str) -> str:
    return json.dumps({"sections": [
        {"title": "结论", "items": [f"依据第{article_id}条，可以。另见第99999条。"]},
        {"title": "分析", "items": ["理由一。理由二。"]}]}, ensure_ascii=False)


# ---------------------------------------------------------------- basics

def test_health_root_and_ready(served):
    got, want = both(served, "get", "/health")
    assert got.status == want.status == 200 and got.json() == want.json()
    got, want = both(served, "get", "/")
    assert got.json() == want.json()
    assert "/ingest/pdf" in got.json()["endpoints"]
    got, want = both(served, "get", "/ready")
    assert got.status == want.status == 200
    assert list(got.json()) == list(want.json())
    assert without(got.json(), "backend", "devices") == \
        without(want.json(), "backend", "devices")
    assert got.json()["backend"] == "cpu" and got.json()["devices"] == ["cpu"]
    assert got.json()["ready"] is True


def test_ui_is_served_as_by_jax(served):
    got, want = both(served, "get", "/ui")
    assert got.status == want.status and got.body == want.body


RETRIEVE = [("合同解除的条件", None), ("民法典第十条如何理解", None),
            ("自然人的民事权利能力有哪些", 5), ("buyer in ordinary course of business", None),
            ("what is the meaning of good faith", None), ("security interest", 3)]


@pytest.mark.parametrize("question,top_k", RETRIEVE,
                         ids=["zh", "zh_article_ref", "zh_broad_k5", "en",
                              "en_interpretive", "en_k3"])
def test_retrieve_matches_jax(served, question, top_k):
    got, want = both(served, "post", "/rag/retrieve",
                     json_body={"question": question, "top_k": top_k})
    assert got.status == want.status == 200, got.text
    g, w = got.json(), want.json()
    assert g["retrieval_id"] and len(g["retrieval_id"]) == 32
    assert_same_json(without(g, "retrieval_id"), without(w, "retrieval_id"))
    assert g["hits"] and "per_channel" in g["hits"][0]["score_breakdown"]


def test_retrieve_graph_augmented_by_wording_reaches_the_graph(served):
    got, want = both(served, "post", "/rag/retrieve",
                      json_body={"question": "民法典第十三条如何理解"})
    assert got.json()["decision"]["mode"] == "GRAPH_AUGMENTED"
    assert_same_json(without(got.json(), "retrieval_id"),
                     without(want.json(), "retrieval_id"))


@pytest.mark.parametrize("top_k", [None, 3])
def test_retrieve_batch_matches_jax(served, top_k):
    questions = ["buyer in ordinary course", "离婚后财产分割", "negotiable instrument",
                 "自然人的民事行为能力", "  ", "letter of credit", "监护人的职责",
                 "合同解除"]
    got, want = both(served, "post", "/rag/retrieve_batch",
                     json_body={"questions": questions, "top_k": top_k})
    assert got.status == want.status == 200, got.text
    assert_same_json(got.json(), want.json())
    results = got.json()["results"]
    assert len(results) == 7 and all(results)
    assert results[0][0]["chunk"]["lang"] == "en"
    assert results[1][0]["chunk"]["lang"] == "zh"


def test_errors_match_jax(served):
    cases = [
        ("post", "/rag/retrieve", dict(json_body={})),
        ("post", "/rag/retrieve", dict(json_body={"question": "x", "top_k": "5"})),
        ("post", "/rag/retrieve", dict(json_body={"question": "x", "top_k": True})),
        ("post", "/rag/retrieve", dict(body=b"not json")),
        ("post", "/rag/answer", dict(json_body={"retrieval_id": "nope"})),
        ("post", "/rag/answer", dict(json_body={})),
        ("post", "/rag/query", dict(json_body={"question": "  "})),
        ("post", "/rag/retrieve_batch", dict(json_body={"questions": "a string"})),
        ("post", "/rag/retrieve_batch", dict(json_body={"questions": []})),
        ("post", "/rag/retrieve_batch", dict(json_body={"questions": ["q"] * 257})),
        ("post", "/rag/retrieve_batch", dict(json_body={"questions": ["q"],
                                                        "top_k": 2.5})),
        ("get", "/nope", {}),
        ("get", "/rag/retrieve", {}),
        ("post", "/health", {}),
    ]
    statuses = []
    for method, path, kw in cases:
        got, want = both(served, method, path, **kw)
        assert (got.status, got.json()) == (want.status, want.json()), path
        statuses.append(got.status)
    assert statuses == [422, 422, 422, 400, 404, 422, 422, 422, 422, 422, 422,
                        404, 405, 405]


# ---------------------------------------------------------------- answers

def test_answer_json_degraded_matches_jax(served):
    jc, pc, _cfg = served
    bodies = []
    for c in (pc, jc):
        r = c.post("/rag/retrieve", json_body={"question": "lease rent default"})
        a = c.post("/rag/answer", json_body={"retrieval_id": r.json()["retrieval_id"]})
        d = c.post("/rag/answer", json_body={"question": "租赁合同的租金"})
        assert a.status == d.status == 200
        bodies.append((a.json(), d.json()))
    (pa, pd), (ja, jd) = bodies
    assert_same_json(pa, ja)
    assert_same_json(pd, jd)
    assert "showing retrieved provisions only" in pa["answer"]
    assert pa["citations"] == {"supported": [], "unsupported": []}


def test_keyed_request_degrades_as_jax(served):
    """X-OpenAI-Api-Key on a keyless server: a keyed openai client, here
    pointed at a closed loopback port, so the degraded answer comes back
    (never a 500)."""
    got, want = both(served, "post", "/rag/query",
                     json_body={"question": "lease termination"},
                     headers={"X-OpenAI-Api-Key": "sk-test-override"})
    assert got.status == want.status == 200
    assert_same_json(got.json(), want.json())
    assert got.json()["answer"]


@pytest.mark.parametrize("endpoint", ["answer", "query"])
def test_sse_stream_matches_jax(served, llm_on_both, endpoint):
    """meta, tokens, section/item/sentence, citations (the cited article
    supported, an invented one not), done: the same events as JAX."""
    jc, pc, _cfg = served
    q = "合同解除的条件"
    top = pc.post("/rag/retrieve", json_body={"question": q}).json()
    llm_on_both(StreamLLM(sections_citing(top["hits"][0]["chunk"]["article_id"])))
    events = []
    for c in (pc, jc):
        body = {"question": q, "stream": True}
        if endpoint == "answer":
            body = {"retrieval_id": c.post("/rag/retrieve", json_body={
                "question": q}).json()["retrieval_id"], "stream": True}
        r = c.post(f"/rag/{endpoint}", json_body=body)
        assert r.status == 200 and r.raw.media_type == "text/event-stream"
        assert r.text.startswith(":" + " " * 2048)
        events.append(sse(r))
    got, want = events
    assert_same_json(got, want)
    kinds = [e for e, _ in got]
    assert kinds[0] == "meta" and kinds[-2:] == ["citations", "done"]
    assert kinds.count("section") == 2 and kinds.count("item") == 2
    assert kinds.count("sentence") == 4 and "token" in kinds
    cit = got[-2][1]
    assert [c["ref"] for c in cit["supported"]] == \
        [top["hits"][0]["chunk"]["article_id"]]
    assert cit["unsupported"] == ["99999"]


def test_openai_provider_through_the_server_matches_jax(served, llm_on_both):
    """The openai provider against a loopback stub, through /rag/answer as
    JSON and as SSE: same answers, events and stub requests."""
    q = "what is a security interest"
    stub = OpenAIStub(lambda msgs: "Answer: see § 1-201 and § 9-999.", chunk=6)
    try:
        kw = dict(provider="openai", api_key="sk-stub", base_url=stub.url)
        llm_on_both(LLMGateway(LLMClient(LLMConfig(**kw))),
                    JaxGateway(JaxLLMClient(JaxLLMConfig(**kw))))
        got, want = both(served, "post", "/rag/query", json_body={"question": q})
        assert_same_json(got.json(), want.json())
        assert got.json()["answer"] == "Answer: see § 1-201 and § 9-999."
        got, want = both(served, "post", "/rag/query",
                         json_body={"question": q, "stream": True})
        assert_same_json(sse(got), sse(want))
        tokens = [p["text"] for e, p in sse(got) if e == "token"]
        assert "".join(tokens) == "Answer: see § 1-201 and § 9-999." and len(tokens) > 2
        assert stub.requests[0] == stub.requests[1]      # JSON: port, JAX
        assert stub.requests[2] == stub.requests[3]      # SSE: port, JAX
    finally:
        stub.close()


def test_sse_error_event_and_interrupted_tail_match_jax(served, llm_on_both):
    class Dying(StreamLLM):
        def chat_stream(self, messages, tag="chat", **kw):
            yield "第一段"
            raise RuntimeError("stub stream lost")

    llm_on_both(Dying(""))
    got, want = both(served, "post", "/rag/query",
                     json_body={"question": "违约责任", "stream": True})
    assert_same_json(sse(got), sse(want))
    assert [e for e, _ in sse(got)][-1] == "error"
    # through a real client, a dying provider stream ends with the tail
    cfg = LLMConfig(provider="openai", api_key="sk-x")
    client = LLMClient(cfg)
    client._stream_openai = lambda m, n: Dying("").chat_stream(m)
    llm_on_both(client, client)
    got = sse(served[1].post("/rag/query", json_body={"question": "违约责任",
                                                      "stream": True}))
    text = "".join(p["text"] for e, p in got if e == "token")
    assert text.startswith("第一段") and "生成中断" in text
    assert got[-1][0] == "done"


def test_sse_pings_flow_during_an_llm_stall(served, llm_on_both):
    class Stalling(StreamLLM):
        def chat_stream(self, messages, tag="chat", **kw):
            yield "first"
            time.sleep(2.6)        # > 2 ping intervals
            yield "second"

    llm_on_both(Stalling(""))
    r = served[1].post("/rag/query", json_body={"question": "解除合同",
                                                 "stream": True})
    raw = r.text
    assert raw[raw.index("first"):raw.index("second")].count(": ping") >= 2
    assert [e for e, _ in r.sse_events()][-1] == "done"


def test_sse_client_disconnect_cleans_up(served, llm_on_both):
    """Dropping the stream mid-answer cancels the in-flight iteration,
    closes the LLM's stream and leaves no thread behind."""
    closed = threading.Event()

    class Endless(StreamLLM):
        def chat_stream(self, messages, tag="chat", **kw):
            try:
                while True:
                    yield "tok "
            finally:
                closed.set()

    llm_on_both(Endless(""))
    app = served[1].app
    rid = served[1].post("/rag/retrieve", json_body={
        "question": "解除合同"}).json()["retrieval_id"]
    before = threading.active_count()
    resp = app.dispatch(Request(
        method="POST", path="/rag/answer",
        headers={"content-type": "application/json"}, query={},
        body=json.dumps({"retrieval_id": rid, "stream": True}).encode()))
    it = resp.iterator
    for _ in range(4):
        next(it)
    it.close()
    assert closed.wait(5.0), "the LLM stream was never closed"
    deadline = time.monotonic() + 5.0
    while threading.active_count() > before and time.monotonic() < deadline:
        time.sleep(0.01)
    assert threading.active_count() <= before


# ---------------------------------------------------------------- metrics

def test_metrics_and_micro_batcher_counters(served):
    _jc, pc, _cfg = served
    batchers = [pc.app.state.pipeline.retriever.retriever(lang)._batcher
                for lang in ("zh", "en")]

    def counter(text, name):
        line = [l for l in text.splitlines() if l.startswith(name + " ")]
        return float(line[0].split()[1]) if line else 0.0

    m0 = pc.get("/metrics").text
    e0 = sum(b.executions for b in batchers)
    for q in ("security interest", "合同的订立", "lease"):
        assert pc.post("/rag/retrieve", json_body={"question": q}).status == 200
    m1 = pc.get("/metrics")
    assert m1.status == 200 and m1.raw.media_type.startswith("text/plain")
    text = m1.text
    calls = sum(b.executions for b in batchers) - e0
    assert calls == 3
    for name in ("legalrag_microbatch_executions_total",
                 "legalrag_microbatch_batched_requests_total"):
        assert counter(text, name) - counter(m0, name) == 3, name
    assert 'legalrag_requests_total{endpoint="retrieve"}' in text
    assert "legalrag_retrieve_seconds_count" in text
    assert 'legalrag_microbatch_wait_seconds_bucket{le="+Inf"}' in text
    assert "legalrag_microbatch_exec_seconds_count" in text


# ------------------------------------------------- other apps and sockets

def test_split_deployment_matches_the_in_process_server(served, monkeypatch):
    """The main server with RETRIEVAL_URL delegates to the port's retrieval
    service over a real socket: the same /rag/retrieve JSON as the
    in-process server, and the answer stage takes the remote hits."""
    _jc, pc, cfg = served
    service = retrieval_api.create_app(cfg, device="cpu")
    server = service.serve("127.0.0.1", 0)
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        monkeypatch.setenv("RETRIEVAL_URL", url)
        main = TestClient(create_app(cfg, build_async=False, device="cpu"))
        monkeypatch.delenv("RETRIEVAL_URL")
        for q in ("buyer in ordinary course", "民法典第十条如何理解"):
            got = main.post("/rag/retrieve", json_body={"question": q})
            want = pc.post("/rag/retrieve", json_body={"question": q})
            assert got.status == 200
            assert_same_json(without(got.json(), "retrieval_id"),
                             without(want.json(), "retrieval_id"))
        a = main.post("/rag/answer", json_body={
            "retrieval_id": got.json()["retrieval_id"]})
        assert a.status == 200 and a.json()["hits"] == got.json()["hits"]
        req = urllib.request.Request(
            url + "/retrieve", data=json.dumps({"question": "离婚后的财产"}).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=60) as resp:
            obj = json.loads(resp.read())
        assert obj["hits"] and obj["hits"][0]["chunk"]["lang"] == "zh"
    finally:
        server.shutdown()
        server.server_close()


def test_warmup_prewarms_every_bucket(en_chunks, tmp_path, monkeypatch):
    """server.prewarm_buckets: the warmup runs one channels call at batch 2
    and 4 (en only; zh has no index and is skipped) before /ready."""
    cfg = small_config(AppConfig(), tmp_path)
    cfg.engine.capacity_round = 64
    cfg.engine.late_doc_maxlen = 32
    cfg.server.prewarm_buckets = 4
    cfg.paths.ensure_tree()
    chunks = [LawChunk.from_dict(c.model_dump()) for c in en_chunks[:40]]
    IndexBundle.build_from_chunks(chunks, cfg.with_lang("en"), "en",
                                  device="cpu").save(tmp_path / "index_dir" / "en")
    seen = []
    orig = HybridRetriever._channels_topk_batch

    def spy(self, questions, eff_k):
        seen.append(len(questions))
        return orig(self, questions, eff_k)

    monkeypatch.setattr(HybridRetriever, "_channels_topk_batch", spy)
    app = create_app(cfg, build_async=False, device="cpu")
    assert [b for b in seen if b > 1] == [2, 4]
    assert app.state.warmup_done and app.state.error is None
    r = TestClient(app).post("/rag/retrieve", json_body={
        "question": "delivery of the goods", "top_k": 3})
    assert r.status == 200 and r.json()["hits"]


@pytest.fixture(scope="module")
def toy_url():
    app = App()

    @app.get("/ping")
    def ping(req: Request) -> Response:
        return Response({"pong": True, "q": req.query.get("x")})

    @app.post("/echo/{name}")
    def echo(req: Request) -> Response:
        return Response({"name": req.params["name"], "body": req.json()})

    @app.post("/stream")
    def stream(req: Request) -> StreamingResponse:
        def gen():
            for i in range(3):
                yield sse_event("tick", {"i": i})
            yield sse_event("done", {})
        return StreamingResponse(gen())

    @app.get("/boom")
    def boom(req: Request) -> Response:
        raise RuntimeError("CUDA error: an illegal memory access")

    server = app.serve("127.0.0.1", 0)
    yield f"http://127.0.0.1:{server.server_address[1]}"
    server.shutdown()
    server.server_close()


def http(url, data=None, method=None):
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, r.headers, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.headers, e.read().decode()


def test_webcore_over_a_socket(toy_url):
    """Routing, query and path params, JSON, chunked SSE, CORS, and the
    error paths: 404, 405, a malformed body 400, a handler's error 500."""
    status, headers, body = http(toy_url + "/ping?x=42")
    assert status == 200 and json.loads(body) == {"pong": True, "q": "42"}
    assert headers["Access-Control-Allow-Origin"] == "*"
    status, _h, body = http(toy_url + "/echo/alice", json.dumps({"k": 1}).encode())
    assert json.loads(body) == {"name": "alice", "body": {"k": 1}}
    status, headers, body = http(toy_url + "/stream", b"{}")
    assert headers["Content-Type"].startswith("text/event-stream")
    assert [l.split(": ", 1)[1] for l in body.splitlines()
            if l.startswith("event: ")] == ["tick", "tick", "tick", "done"]
    assert http(toy_url + "/nope")[0] == 404
    assert http(toy_url + "/stream")[0] == 405
    status, _h, body = http(toy_url + "/echo/bob", b"not json")
    assert status == 400 and "invalid JSON" in body
    status, _h, body = http(toy_url + "/boom")
    assert status == 500 and json.loads(body) == {"detail": "internal server error"}
    assert http(toy_url + "/ping", method="OPTIONS")[0] == 204


def test_graceful_drain_over_a_socket(served):
    """shutdown_gracefully: /ready answers 503 during the grace window, the
    listener stops after it (connections refused), and the LLM client is
    closed. Runs last: it drains the module's app (reset afterwards)."""
    app = served[1].app
    server = app.serve("127.0.0.1", 0)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    closed, flipped = [], []
    llm = app.state.pipeline.llm
    old_close = llm.close
    llm.close = lambda: closed.append(True)
    try:
        assert http(base + "/ready")[0] == 200
        probe = threading.Thread(target=lambda: (time.sleep(0.15), flipped.append(
            http(base + "/ready")[0])))
        probe.start()
        shutdown_gracefully(app.state, server, grace=0.6)
        probe.join(timeout=10)
        assert not probe.is_alive()
        assert flipped == [503] and closed == [True]
        with pytest.raises(urllib.error.URLError):
            urllib.request.urlopen(base + "/health", timeout=3)
    finally:
        llm.close = old_close
        app.state.draining = False


# ---------------------------------------------------------------- ingest

@pytest.fixture(scope="module")
def ingest_served(served, en_chunks, zh_chunks, tmp_path_factory):
    """(JAX client, port client, port config), each app over its own copy
    of ``served``'s bundles and graphs, with the base corpora in its
    processed directory (the graph job rebuilds over it)."""
    base = served[2].paths.index_dir.parent
    clients = []
    for name, cfg, create, client in (
            ("jax", JaxConfig(), jax_create_app, JaxTestClient),
            ("port", AppConfig(), create_app, TestClient)):
        root = tmp_path_factory.mktemp(f"ingest_{name}")
        for d in ("index_dir", "graph_dir"):
            shutil.copytree(base / d, root / d)
        cfg = small_config(cfg, root)
        cfg.llm.base_url = served[2].llm.base_url
        cfg.paths.ensure_tree()
        for lang, chunks in (("en", en_chunks[:100]), ("zh", zh_chunks[:100])):
            jax_write_chunks(chunks, root / "processed_dir" / f"law_{lang}.jsonl")
        kw = {"device": "cpu"} if name == "port" else {}
        app = create(cfg, build_async=False, **kw)
        assert app.state.error is None
        clients.append(client(app))
    return clients[0], clients[1], cfg


def multipart(filename: str, content: bytes, field: str = "file"):
    boundary = "torchingestboundary"
    body = (f"--{boundary}\r\nContent-Disposition: form-data; "
            f'name="{field}"; filename="{filename}"\r\n'
            "Content-Type: application/octet-stream\r\n\r\n").encode() \
        + content + f"\r\n--{boundary}--\r\n".encode()
    return {"body": body, "headers": {
        "content-type": f"multipart/form-data; boundary={boundary}"}}


WIDGET_ACT = ("Model Widget Act\n"
              "§ 1-101. Definitions. In this act, \"widget\" means a purple "
              "gadget used for testing ingestion pipelines.\n"
              "§ 1-102. Widget Registration. Every widget must be registered "
              "with the widget registry within thirty days.\n")


def test_ingest_routes_match_jax(ingest_served, zh_chunks, monkeypatch):
    """Two uploads through both servers (a generic text, a zh statute as
    PDF bytes): the same responses, statuses and previews; then the live
    indexes answer ``/rag/retrieve`` and ``/rag/retrieve_batch`` as the
    JAX server's do."""
    monkeypatch.setitem(sys.modules, "pdfplumber", None)
    jc, pc, _cfg = ingest_served
    statute = "测试统一法\n" + "\n".join(c.text for c in zh_chunks[100:130])
    doc_ids = []
    for name, content in (("widget_act.txt", WIDGET_ACT.encode()),
                          ("test_statute.pdf", build_pdf([statute]))):
        got, want = both(ingest_served, "post", "/ingest/pdf",
                         **multipart(name, content))
        assert got.status == want.status == 200, got.text
        assert got.json() == want.json()
        doc_ids.append(got.json()["doc_id"])
    assert got.json()["chunks"] == 30
    assert jc.app.state.ingest.queue.join(timeout=120)
    assert pc.app.state.ingest.queue.join(timeout=120)
    for doc_id in doc_ids:
        got, want = both(ingest_served, "get", f"/ingest/status/{doc_id}")
        assert (got.status, got.json()) == (want.status, want.json())
        assert set(got.json()["status"].values()) == {"added"}
        got, want = both(ingest_served, "get",
                         f"/debug/ingest/preview?doc_id={doc_id}")
        assert (got.status, got.json()) == (want.status, want.json())
    assert got.json()["n_chunks"] == 30 and len(got.json()["chunks"]) == 5

    for q in ("purple gadget widget registry", statute.splitlines()[5][:40],
              "buyer in ordinary course of business"):
        got, want = both(ingest_served, "post", "/rag/retrieve",
                         json_body={"question": q})
        assert got.status == want.status == 200, got.text
        assert_same_json(without(got.json(), "retrieval_id"),
                         without(want.json(), "retrieval_id"))
    got = pc.post("/rag/retrieve",
                  json_body={"question": "purple gadget widget registry"})
    assert got.json()["hits"][0]["chunk"]["source"] == f"ingest:{doc_ids[0]}"
    got, want = both(ingest_served, "post", "/rag/retrieve_batch",
                     json_body={"questions": ["widget registration",
                                              statute.splitlines()[9][:30]]})
    assert got.status == want.status == 200
    assert_same_json(got.json(), want.json())


def test_ingest_errors_match_jax(ingest_served, monkeypatch):
    monkeypatch.setitem(sys.modules, "pdfplumber", None)
    cases = [
        ("post", "/ingest/pdf", {"body": b"not multipart",
                                 "headers": {"content-type": "text/plain"}}),
        ("post", "/ingest/pdf", multipart("a.txt", b"text", field="upload")),
        ("post", "/ingest/pdf", multipart("blank.txt", b"  \t ")),
        ("post", "/ingest/pdf", multipart("scan.pdf", build_pdf([""]))),
        ("get", "/ingest/status/0123456789abcdef", {}),
        ("get", "/debug/ingest/preview?doc_id=0123456789abcdef", {}),
        ("get", "/debug/ingest/preview", {}),
    ]
    statuses = []
    for method, path, kw in cases:
        got, want = both(ingest_served, method, path, **kw)
        assert (got.status, got.json()) == (want.status, want.json()), path
        statuses.append(got.status)
    assert statuses == [422, 422, 400, 400, 404, 404, 404]
