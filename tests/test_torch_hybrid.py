"""Port HybridRetriever / ByLangRetriever vs the JAX ones on one carried
index: the JAX bundle's arrays go to the port through ``convert``, both
retrievers serve the same questions over the same law-graph file, and
their hits must agree: chunk ids, ranks, sources and graph fields equal,
scores and every number of the breakdown within ATOL, rows whose JAX
scores tie within TIE may swap."""

import json

import numpy as np
import pytest
import torch

from legalrag_tpu.config import AppConfig as JaxConfig
from legalrag_tpu.graph import GraphBuilder as JaxGraphBuilder
from legalrag_tpu.graph import LawGraphStore as JaxGraphStore
from legalrag_tpu.index.bundle import IndexBundle as JaxBundle
from legalrag_tpu.retrieval import channels as jax_channels
from legalrag_tpu.retrieval import rerankers as jax_rerankers
from legalrag_tpu.retrieval.by_lang import BundleCache as JaxBundleCache
from legalrag_tpu.retrieval.by_lang import ByLangRetriever as JaxByLang
from legalrag_tpu.retrieval.hybrid import HybridRetriever as JaxHybrid
from legalrag_tpu.retrieval.hybrid import dedup_keep_best as jax_dedup
from legalrag_tpu.schemas import IssueType as JaxIssueType
from legalrag_tpu.schemas import LawChunk as JaxChunk
from legalrag_tpu.schemas import RetrievalHit as JaxHit
from legalrag_tpu.schemas import RoutingDecision as JaxDecision
from legalrag_tpu.schemas import RoutingMode as JaxMode
from legalrag_tpu.schemas import TaskType as JaxTaskType
from legalrag_tpu.utils import detect_lang as jax_detect_lang
from legalrag_tpu_torch.config import AppConfig
from legalrag_tpu_torch.graph import LawGraphStore
from legalrag_tpu_torch.index.bundle import IndexBundle
from legalrag_tpu_torch.retrieval import channels, rerankers
from legalrag_tpu_torch.retrieval.by_lang import BundleCache, ByLangRetriever
from legalrag_tpu_torch.retrieval.hybrid import HybridRetriever, dedup_keep_best
from legalrag_tpu_torch.schemas import (
    IssueType,
    LawChunk,
    RetrievalHit,
    RoutingDecision,
    RoutingMode,
    TaskType,
)
from legalrag_tpu_torch.utils import detect_lang
from test_torch_engine import carry, sample_queries

ATOL = 1e-5   # scores and breakdown numbers
TIE = 1e-6    # JAX scores closer than this may come in either order

QUERIES = ["buyer in ordinary course of business security interest",
           "negotiable instrument payable to bearer",
           "scope of article general provisions",
           "security interest attaches when value is given"]


def small_configs():
    jcfg, cfg = JaxConfig(), AppConfig()
    for c in (jcfg, cfg):
        c.engine.capacity_round = 256
        c.engine.late_doc_maxlen = 64
    return jcfg, cfg


@pytest.fixture(scope="module")
def pair(en_chunks, tmp_path_factory):
    """(JAX retriever, port retriever) over en[:150], the small config."""
    jcfg, cfg = small_configs()
    chunks = en_chunks[:150]
    jb = JaxBundle.build_from_chunks(chunks, jcfg, "en")
    gpath = tmp_path_factory.mktemp("graph") / "g.jsonl"
    JaxGraphBuilder().build_to_file(chunks, gpath)
    return (JaxHybrid(jb, jcfg, graph_store=JaxGraphStore(gpath)),
            HybridRetriever(carry(jb, cfg), cfg,
                            graph_store=LawGraphStore(gpath)))


def decisions(mode: str):
    return (JaxDecision(task_type=JaxTaskType.JUDGE_STYLE,
                        issue_type=JaxIssueType.OTHER, mode=JaxMode(mode)),
            RoutingDecision(task_type=TaskType.JUDGE_STYLE,
                            issue_type=IssueType.OTHER, mode=RoutingMode(mode)))


def assert_close_tree(got, want, path="bd"):
    """Nested breakdown dicts: same keys and strings, numbers within ATOL."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (path, got, want)
        for k in want:
            assert_close_tree(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), (path, got, want)
        for i, (g, w) in enumerate(zip(got, want)):
            assert_close_tree(g, w, f"{path}[{i}]")
    elif isinstance(want, (float, np.floating)) and not isinstance(want, bool):
        assert abs(float(got) - float(want)) <= ATOL, (path, got, want)
    else:
        assert got == want, (path, got, want)


def assert_same_hits(got, want):
    """Hit lists equal up to swaps of JAX scores within TIE; each hit's
    fields compared to the JAX hit of the same chunk."""
    assert len(got) == len(want), ([h.chunk.id for h in got],
                                   [h.chunk.id for h in want])
    want_ids = [h.chunk.id for h in want]
    by_id = {h.chunk.id: h for h in want}
    for p, (g, w) in enumerate(zip(got, want)):
        assert g.rank == w.rank == p + 1
        if g.chunk.id != w.chunk.id:
            assert g.chunk.id in by_id, (p, g.chunk.id, want_ids)
            assert abs(by_id[g.chunk.id].score - w.score) < TIE, (p, want_ids)
        ref = by_id[g.chunk.id]
        assert g.chunk.to_json() == ref.chunk.model_dump_json(exclude_none=True)
        assert (g.source, g.graph_depth, g.relations, g.seed_article_id) == \
            (ref.source, ref.graph_depth, ref.relations, ref.seed_article_id)
        assert abs(g.score - ref.score) <= ATOL
        if ref.semantic_score is None:
            assert g.semantic_score is None
        else:
            assert abs(g.semantic_score - ref.semantic_score) <= ATOL
        assert_close_tree(g.score_breakdown, ref.score_breakdown)


def questions(chunks):
    return QUERIES + sample_queries(chunks, 4, seed=3)


@pytest.mark.parametrize("mode", ["RAG", "GRAPH_AUGMENTED"])
@pytest.mark.parametrize("rerank", [True, False])
def test_search_hits_match_jax(pair, mode, rerank):
    jhr, thr = pair
    jd, td = decisions(mode)
    for c in (jhr.cfg, thr.cfg):
        c.retrieval.enable_rerank = rerank
    try:
        for q in questions(jhr.bundle.chunks):
            want = jhr.search(q, top_k=10, decision=jd)
            got = thr.search(q, top_k=10, decision=td)
            assert got, q
            assert_same_hits(got, want)
            if rerank:
                assert got[0].score_breakdown["reranker"] == "maxsim"
            if mode == "GRAPH_AUGMENTED":
                assert thr.graph is not None
    finally:
        for c in (jhr.cfg, thr.cfg):
            c.retrieval.enable_rerank = True


def test_graph_augmented_brings_graph_hits(pair):
    """At top_k 400 the list reaches past the reranked head and the fused
    tail into the graph stage's own hits (source "graph"), on both sides
    alike."""
    jhr, thr = pair
    jd, td = decisions("GRAPH_AUGMENTED")
    sources = set()
    for q in QUERIES:
        want = jhr.search(q, top_k=400, decision=jd)
        got = thr.search(q, top_k=400, decision=td)
        assert_same_hits(got, want)
        sources |= {h.source for h in got}
    assert sources == {"rerank", "retriever", "graph"}


@pytest.mark.parametrize("api", ["dense", "bm25", "colbert", "graph"])
def test_channel_apis_match_jax(pair, api):
    jhr, thr = pair
    for q in QUERIES:
        if api == "graph":
            want = jhr.search_graph(q, ["1-201", "2-103"], 8)
            got = thr.search_graph(q, ["1-201", "2-103"], 8)
            assert got and all(h.source == "graph" for h in got)
        else:
            want = getattr(jhr, f"search_{api}")(q, 12)
            got = getattr(thr, f"search_{api}")(q, 12)
            assert len(got) == 12
        assert_same_hits(got, want)


def test_one_shot_matches_per_channel_and_jax(pair):
    jhr, thr = pair
    q = "security interest attaches when value is given"
    for eff_k in (16, 40):
        one = thr._channels_topk_all(q, eff_k)
        want = jhr._channels_topk_all(q, eff_k)
        assert set(one) == set(want) == {"dense", "bm25", "colbert", "qvec"}
        np.testing.assert_allclose(one["qvec"], want["qvec"], atol=1e-6)
        per = {"dense": thr.dense, "bm25": thr.bm25, "colbert": thr.late}
        for name, ret in per.items():
            s, r = ret.search_rows([q], eff_k)
            np.testing.assert_array_equal(one[name][1], r)
            np.testing.assert_allclose(one[name][0], s, atol=ATOL)
            np.testing.assert_array_equal(one[name][1], want[name][1])
            np.testing.assert_allclose(one[name][0], want[name][0], atol=ATOL)


def test_padded_batch_gives_the_solo_rows(pair):
    """Three questions run padded to a batch of 4 (one empty question)."""
    _, thr = pair
    batch = thr._channels_topk_batch(QUERIES[:3], 40)
    for i, q in enumerate(QUERIES[:3]):
        solo = thr._channels_topk_batch([q], 40)
        for name in ("dense", "bm25", "colbert"):
            np.testing.assert_array_equal(batch[name][1][i], solo[name][1][0])
            np.testing.assert_allclose(batch[name][0][i], solo[name][0][0],
                                       atol=ATOL)


def chunk_pair(i):
    kw = dict(id=f"c{i}", law_name="L", article_no=f"§ {i}",
              article_id=str(i), text=f"t{i}", lang="en")
    return JaxChunk(**kw), LawChunk(**kw)


def test_dedup_keep_best_matches_jax():
    rng = np.random.default_rng(0)
    chunks = [chunk_pair(i) for i in range(6)]
    for _ in range(20):
        jh, th = [], []
        for _ in range(12):
            i = int(rng.integers(6))
            score = float(rng.choice([0.25, 0.5, rng.random()]))
            bd = {"channel": str(rng.choice(["dense", "graph", "bm25"])),
                  "channel_contrib": {str(rng.choice(["dense", "graph"])):
                                      float(rng.random())}}
            if rng.random() < 0.3:
                bd["channels"] = ["colbert", bd["channel"]]
            depth = int(rng.integers(1, 3)) if rng.random() < 0.5 else None
            jh.append(JaxHit(chunk=chunks[i][0], score=score, graph_depth=depth,
                             score_breakdown=json.loads(json.dumps(bd))))
            th.append(RetrievalHit(chunk=chunks[i][1], score=score,
                                   graph_depth=depth,
                                   score_breakdown=json.loads(json.dumps(bd))))
        want, got = jax_dedup(jh), dedup_keep_best(th)
        assert [(h.chunk.id, h.score, h.graph_depth, h.score_breakdown)
                for h in got] == [(h.chunk.id, h.score, h.graph_depth,
                                   h.score_breakdown) for h in want]


def test_min_score_filter_matches_jax(pair):
    jhr, thr = pair
    for c in (jhr.cfg, thr.cfg):
        c.retrieval.min_final_score = 0.6
    try:
        for q in QUERIES + ["completely unrelated zebra astronomy query"]:
            want = jhr.search(q, top_k=10)
            got = thr.search(q, top_k=10)
            assert_same_hits(got, want)
    finally:
        for c in (jhr.cfg, thr.cfg):
            c.retrieval.min_final_score = 0.2


class FakeLLM:
    """An LLM client double: HyDE text, and JSON (or loose) rerank scores."""

    is_degraded = False

    def __init__(self, rerank_reply=None):
        self.calls = []
        self.rerank_reply = rerank_reply

    def chat(self, messages, tag=None, **kw):
        self.calls.append(tag)
        if tag == "hyde":
            return "A buyer in ordinary course takes free of security interests."
        n = messages[-1]["content"].count("\n[")
        if self.rerank_reply is not None:
            return self.rerank_reply
        return json.dumps({"scores": [round(0.9 - 0.05 * i, 2)
                                      for i in range(n)]})


def test_hyde_expands_dense_query_as_jax(pair):
    jhr, thr = pair
    jhr.llm, thr.llm = FakeLLM(), FakeLLM()
    for c in (jhr.cfg, thr.cfg):
        c.retrieval.enable_hyde = True
    try:
        for q in QUERIES[:2]:
            want = jhr.search(q, top_k=5)
            got = thr.search(q, top_k=5)
            assert_same_hits(got, want)
        assert thr.llm.calls == jhr.llm.calls and "hyde" in thr.llm.calls
    finally:
        for c in (jhr.cfg, thr.cfg):
            c.retrieval.enable_hyde = False
        jhr.llm = thr.llm = None


@pytest.mark.parametrize("reply", [None, "scores: 0.7, 1.0, .25 and 0",
                                   "not json at all"])
def test_llm_reranker_matches_jax(pair, reply):
    jhr, thr = pair
    for c in (jhr.cfg, thr.cfg):
        c.retrieval.rerank_use_llm = True
    jhr.llm, thr.llm = FakeLLM(reply), FakeLLM(reply)
    try:
        rr = rerankers.RerankerFactory.create(thr.cfg, thr.bundle,
                                              llm=thr.llm, top_k=5)
        assert rr.name == "llm"
        docs = ["doc a", "doc b", "doc c"]
        assert rr.score("q", docs) == jax_rerankers.RerankerFactory.create(
            jhr.cfg, jhr.bundle, llm=jhr.llm, top_k=5).score("q", docs)
        # above the threshold the MaxSim reranker serves
        assert rerankers.RerankerFactory.create(
            thr.cfg, thr.bundle, llm=thr.llm, top_k=31).name == "maxsim"
        want = jhr.search(QUERIES[1], top_k=8)
        got = thr.search(QUERIES[1], top_k=8)
        assert_same_hits(got, want)
        assert got[0].score_breakdown["reranker"] == "llm"
    finally:
        for c in (jhr.cfg, thr.cfg):
            c.retrieval.rerank_use_llm = False
        jhr.llm = thr.llm = None


@pytest.mark.parametrize("method", ["minmax", "sigmoid", "none"])
def test_normalize_scores_matches_jax(method):
    rng = np.random.default_rng(1)
    for scores in ([], [3.0], [2.0, 2.0], list(rng.normal(size=9) * 4)):
        assert rerankers.normalize_scores(scores, method) == \
            jax_rerankers.normalize_scores(scores, method)


def test_store_reranker_matches_text_path_and_jax(pair):
    jhr, thr = pair
    q = "security interest attaches when value is given"
    hits = thr.search(q, top_k=8)
    rr = rerankers.MaxSimReranker(thr.bundle)
    store = rr.score_hits(q, hits)
    text = rr.score(q, [h.chunk.text for h in hits])
    assert store is not None
    np.testing.assert_allclose(store, text, rtol=0.03, atol=0.05)
    jrr = jax_rerankers.MaxSimReranker(jhr.bundle)
    jhits = [JaxHit(chunk=JaxChunk.model_validate_json(h.chunk.to_json()),
                    score=h.score) for h in hits]
    np.testing.assert_allclose(store, jrr.score_hits(q, jhits), atol=ATOL)
    np.testing.assert_allclose(text, jrr.score(q, [h.chunk.text for h in hits]),
                               atol=ATOL)
    fake = RetrievalHit(chunk=LawChunk(id="nope", law_name="x", text="y",
                                       article_no="§ 0-000", article_id="0",
                                       lang="en"), score=0.1)
    assert rr.score_hits(q, hits + [fake]) is None


def test_two_phase_late_route_matches_jax(pair, monkeypatch):
    """Past FULL_SCAN_MAX docs the late channel scores the top dense
    candidates and ranks them by numpy's argsort on the host."""
    jhr, thr = pair
    monkeypatch.setattr(channels.LateInteractionRetriever, "FULL_SCAN_MAX", 8)
    monkeypatch.setattr(jax_channels.LateInteractionRetriever,
                        "FULL_SCAN_MAX", 8)
    for late in (thr.late, jhr.late):
        late.candidates = 24
    try:
        for q in QUERIES:
            ws, wr = jhr.late.search_rows([q], 12)
            gs, gr = thr.late.search_rows([q], 12)
            np.testing.assert_allclose(gs, ws, atol=ATOL)
            for p in np.nonzero(gr[0] != wr[0])[0]:
                j = np.nonzero(wr[0] == gr[0, p])[0]
                assert len(j) and abs(ws[0, j[0]] - ws[0, p]) < TIE
            full_s, _ = thr.late.bundle.tokens.topk(
                *thr.late._encode_queries([q]), 12)
            assert (gs[0] <= full_s[0] + ATOL).all()
    finally:
        for late in (thr.late, jhr.late):
            late.candidates = 128


def test_by_lang_serves_through_the_cache_as_jax(pair, tmp_path):
    """Each package saves its bundle and serves it as its cache loads it."""
    jhr, thr = pair
    jcfg, cfg = small_configs()
    for c, b in ((jcfg, jhr.bundle), (cfg, thr.bundle)):
        c.paths.index_dir = tmp_path / type(c).__module__
        b.save(c.with_lang("en").paths.lang_index_dir)
    jbl = JaxByLang(jcfg, cache=JaxBundleCache(jcfg, check_interval=1e9))
    tbl = ByLangRetriever(cfg, cache=BundleCache(cfg, device="cpu",
                                                 check_interval=1e9))
    jbl._graphs["en"] = jhr.graph.store
    tbl._graphs["en"] = thr.graph.store
    jd, td = decisions("GRAPH_AUGMENTED")
    for q in QUERIES[:2]:
        assert_same_hits(tbl.search(q, decision=td), jbl.search(q, decision=jd))
    assert tbl.retriever("en") is tbl.retriever("en")
    for text in ("", "abc", "第三条　合同", "Section 2-201 的规定",
                 "buyer 买受人 seller", "买"):
        assert detect_lang(text) == jax_detect_lang(text)


def test_bundle_cache_reloads_on_generation_bump(en_chunks, tmp_path):
    """A saved bundle grows by add_chunks and is saved again; the cache
    serves the new generation after its check interval, in both packages."""
    jcfg, cfg = small_configs()
    for c in (jcfg, cfg):
        c.paths.index_dir = tmp_path / type(c).__module__
    first, more = en_chunks[:40], en_chunks[40:60]
    tb = IndexBundle.build_from_chunks(
        [LawChunk.from_json(c.model_dump_json(exclude_none=True))
         for c in first], cfg, "en", device="cpu")
    jb = JaxBundle.build_from_chunks(first, jcfg, "en")
    tb.save(cfg.with_lang("en").paths.lang_index_dir)
    jb.save(jcfg.with_lang("en").paths.lang_index_dir)
    tcache = BundleCache(cfg, device="cpu", check_interval=0.0)
    jcache = JaxBundleCache(jcfg, check_interval=0.0)
    t1, j1 = tcache.get("en"), jcache.get("en")
    assert (t1.n_docs, t1.generation) == (j1.n_docs, j1.generation) == (40, 1)
    assert tcache.get("en") is t1  # same generation: no reload
    assert tb.add_chunks([LawChunk.from_json(c.model_dump_json(
        exclude_none=True)) for c in first[:5] + more]) == 20
    assert jb.add_chunks(first[:5] + more) == 20
    tb.save(cfg.with_lang("en").paths.lang_index_dir)
    jb.save(jcfg.with_lang("en").paths.lang_index_dir)
    t2, j2 = tcache.get("en"), jcache.get("en")
    assert t2 is not t1
    assert (t2.n_docs, t2.generation) == (j2.n_docs, j2.generation) == (60, 2)
    assert t2.bm25.vocab == j2.bm25.vocab
    assert IndexBundle.exists(cfg.with_lang("en").paths.lang_index_dir)
    assert not IndexBundle.exists(tmp_path / "nowhere")


def test_by_lang_needs_a_device_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ByLangRetriever(AppConfig())
    assert ByLangRetriever(AppConfig(), device="cpu").cache.device.type == "cpu"


def test_full_width_zh_matches_jax(zh_chunks, tmp_path):
    """d 768, sketch 16384, token_dim 128, doc_maxlen 220, bf16 stores:
    the zh Civil Code (1,260 articles) and its law graph."""
    jcfg, cfg = JaxConfig(), AppConfig()
    jb = JaxBundle.build_from_chunks(zh_chunks, jcfg, "zh")
    gpath = tmp_path / "law_graph_zh.jsonl"
    JaxGraphBuilder().build_to_file(zh_chunks, gpath)
    jhr = JaxHybrid(jb, jcfg, graph_store=JaxGraphStore(gpath))
    thr = HybridRetriever(carry(jb, cfg), cfg, graph_store=LawGraphStore(gpath))
    assert thr.bundle.tokens.tok.shape[1:] == (220, 128)
    for i, q in enumerate(sample_queries(jb.chunks, 4, seed=5)):
        jd, td = decisions("GRAPH_AUGMENTED" if i % 2 else "RAG")
        want = jhr.search(q, decision=jd)
        got = thr.search(q, decision=td)
        assert got, q
        assert_same_hits(got, want)
