"""Port RAG pipeline and its parts (``pipeline/rag_pipeline.py``,
``pipeline/citations.py``, ``prompts/``, ``api/answer_scanner.py``,
``utils/metrics.py``, the schema dumps and ``AppConfig.load``) vs the JAX
package's on the CPU. Everything here is host Python on strings and small
dicts, so everything compares exactly: prompts, messages, answers,
citations, scanner event lists, metric text and JSON."""

import asyncio
import json
import threading
import time

import numpy as np
import pytest

from legalrag_tpu.api import answer_scanner as jax_scanner
from legalrag_tpu.config import AppConfig as JaxConfig
from legalrag_tpu.pipeline import citations as jax_citations
from legalrag_tpu.pipeline.rag_pipeline import RagPipeline as JaxPipeline
from legalrag_tpu.prompts import load_prompts as jax_load_prompts
from legalrag_tpu.schemas import IssueType as JaxIssueType
from legalrag_tpu.schemas import LawChunk as JaxChunk
from legalrag_tpu.schemas import RetrievalHit as JaxHit
from legalrag_tpu.schemas import RoutingDecision as JaxDecision
from legalrag_tpu.schemas import RoutingMode as JaxMode
from legalrag_tpu.schemas import TaskType as JaxTaskType
from legalrag_tpu.utils.metrics import Metrics as JaxMetrics
from legalrag_tpu_torch.api import answer_scanner
from legalrag_tpu_torch.config import AppConfig
from legalrag_tpu_torch.pipeline import citations
from legalrag_tpu_torch.pipeline.rag_pipeline import RagPipeline
from legalrag_tpu_torch.prompts import load_prompts
from legalrag_tpu_torch.schemas import (
    IssueType,
    LawChunk,
    RetrievalHit,
    RoutingDecision,
    RoutingMode,
    TaskType,
    dump,
)
from legalrag_tpu_torch.utils.metrics import Metrics

ZH_REPLY = "前言。结论：可以解除。依据第五百六十三条与第九十九条。"
EN_REPLY = "  Under § 2-201 and Article 2 the contract is enforceable.  "


class EchoLLM:
    """Records messages; returns a canned reply; streams it in 5-char
    chunks (one stub class serves both packages)."""

    def __init__(self, reply):
        self.reply = reply
        self.messages = []

    def chat(self, messages, tag="chat", **kw):
        self.messages.append(messages)
        return self.reply

    def chat_stream(self, messages, tag="chat", **kw):
        self.messages.append(messages)
        for i in range(0, len(self.reply), 5):
            yield self.reply[i:i + 5]

    def degraded_answer(self, messages):
        return "degraded"

    is_degraded = False


def hit_pair(aid, lang="zh", rank=None, **chunk):
    """The same hit in both packages."""
    kw = dict(id=f"{lang}:x:{aid}", law_name=chunk.pop("law_name", "中华人民共和国民法典"),
              article_no=chunk.pop("article_no", f"第{aid}条"),
              article_id=str(aid), text=chunk.pop("text", f"第{aid}条　条文。"),
              lang=lang, **chunk)
    return (JaxHit(chunk=JaxChunk(**kw), score=0.9, rank=rank),
            RetrievalHit(chunk=LawChunk(**kw), score=0.9, rank=rank))


def decision_pair(task="judge_style", issue="contract", mode="RAG"):
    return (JaxDecision(task_type=JaxTaskType(task), issue_type=JaxIssueType(issue),
                        mode=JaxMode(mode)),
            RoutingDecision(task_type=TaskType(task), issue_type=IssueType(issue),
                            mode=RoutingMode(mode)))


def pipelines(reply):
    """(JAX pipeline, port pipeline), each with its own echo LLM and no
    retriever (the prompt and answer stages only)."""
    jp = JaxPipeline.__new__(JaxPipeline)
    jp.cfg, jp.llm = JaxConfig(), EchoLLM(reply)
    pp = RagPipeline.__new__(RagPipeline)
    pp.cfg, pp.llm = AppConfig(), EchoLLM(reply)
    return jp, pp


ZH_HITS = [hit_pair("563", chapter="第三编 合同", section="第七章",
                    text="第五百六十三条　有下列情形之一的，当事人可以解除合同。"),
           hit_pair("1079", rank=2)]
EN_HITS = [hit_pair("2-201", lang="en", law_name="Uniform Commercial Code",
                    article_no="§ 2-201", text="Formal requirements; statute "
                    "of frauds. {braces} stay.")]


@pytest.mark.parametrize("lang", ["zh", "en", "fr"])
def test_prompt_registries_are_copies_of_jax(lang):
    assert load_prompts(lang) == jax_load_prompts(lang)


@pytest.mark.parametrize("task", [t.value for t in TaskType])
def test_build_messages_match_jax(task):
    jp, pp = pipelines(ZH_REPLY)
    for question, pairs in (("合同可以解除吗？{x}", ZH_HITS),
                            ("Is an oral contract enforceable?", EN_HITS),
                            ("无检索结果的问题", [])):
        for issue in ("contract", "divorce", "other"):
            jd, pd = decision_pair(task, issue)
            want = jp._build_messages(question, [j for j, _ in pairs], jd)
            got = pp._build_messages(question, [p for _, p in pairs], pd)
            assert got == want
    assert pp._build_messages("问题", [], None) == jp._build_messages("问题", [], None)


def test_select_example_and_trim_match_jax():
    for lang in ("zh", "en"):
        pool = load_prompts(lang)["example_pool"] + [
            {"lang": lang, "tags": ["task:risk_alert"], "content": "{a}"}]
        for task in [t.value for t in TaskType] + ["nope"]:
            for issue in ("contract", "divorce", "nope"):
                assert RagPipeline._select_example(pool, lang, task, issue) == \
                    JaxPipeline._select_example(pool, lang, task, issue)
    for raw in ("", "结论：x", "  前言 结论：y ", "  no marker  ", ZH_REPLY, EN_REPLY):
        assert RagPipeline._trim_to_answer(raw) == JaxPipeline._trim_to_answer(raw)


@pytest.mark.parametrize("lang", ["zh", "en"])
def test_answer_from_hits_matches_jax(lang):
    reply, pairs, q = ((ZH_REPLY, ZH_HITS, "合同可以解除吗") if lang == "zh"
                       else (EN_REPLY, EN_HITS, "Is an oral contract enforceable?"))
    jp, pp = pipelines(reply)
    jd, pd = decision_pair("statute_exegesis")
    want = jp.answer_from_hits(q, [j for j, _ in pairs], jd)
    got = pp.answer_from_hits(q, [p for _, p in pairs], pd)
    assert (got.question, got.answer, got.citations) == \
        (want.question, want.answer, want.citations)
    assert pp.llm.messages == jp.llm.messages
    assert dump(got.hits, exclude_none=True) == \
        [h.model_dump(exclude_none=True) for h in want.hits]
    assert got.citations["supported"]


def test_stream_bridge_matches_jax():
    jp, pp = pipelines(ZH_REPLY)
    jd, pd = decision_pair()

    async def collect(pipe, hits, d):
        return [c async for c in pipe.answer_stream_from_hits("问题", hits, d)]

    want = asyncio.run(collect(jp, [j for j, _ in ZH_HITS], jd))
    got = asyncio.run(collect(pp, [p for _, p in ZH_HITS], pd))
    assert got == want and "".join(got) == ZH_REPLY
    assert pp.llm.messages == jp.llm.messages


def test_stream_bridge_releases_its_threads_when_the_consumer_leaves():
    """A consumer that stops after two chunks (a client that disconnects)
    stops the worker, which closes the LLM stream, and leaves no thread
    behind."""
    closed = threading.Event()

    class Endless(EchoLLM):
        def chat_stream(self, messages, tag="chat", **kw):
            try:
                while True:
                    yield "tok "
            finally:
                closed.set()

    pp = RagPipeline.__new__(RagPipeline)
    pp.cfg, pp.llm = AppConfig(), Endless("")
    before = threading.active_count()

    async def two_then_leave():
        agen = pp.answer_stream_from_hits("问题", [], None)
        out = [await agen.__anext__(), await agen.__anext__()]
        await agen.aclose()
        return out

    loop = asyncio.new_event_loop()
    try:
        assert loop.run_until_complete(two_then_leave()) == ["tok ", "tok "]
        loop.run_until_complete(loop.shutdown_default_executor())
    finally:
        loop.close()
    assert closed.wait(5.0)
    deadline = time.monotonic() + 5.0
    while threading.active_count() > before and time.monotonic() < deadline:
        time.sleep(0.01)
    assert threading.active_count() <= before


class Recorder:
    """A retriever that records the top_k it was asked for."""

    def __init__(self):
        self.calls = []

    def search(self, question, top_k=None, decision=None):
        self.calls.append((question, top_k, decision.mode.value))
        return []


def test_retrieve_routes_and_scales_top_k_as_jax():
    """eff_top_k = max(3, min(30, round(k · factor))), factor from the
    router (1.35 for broad questions without an article ref)."""
    jp, pp = pipelines("")
    jp.retriever, pp.retriever = Recorder(), Recorder()
    for q in ("继承人有哪些", "第十条有哪些规定", "what are the remedies", "随便问问"):
        for k in (None, 1, 2, 7, 10, 23, 40):
            _h, jd = jp.retrieve(q, top_k=k)
            _h, pd = pp.retrieve(q, top_k=k)
            assert dump(pd) == json.loads(json.dumps(jd.model_dump()))
    assert pp.retriever.calls == jp.retriever.calls
    assert {c[1] for c in pp.retriever.calls} >= {3, 10, 14, 30}


CITATION_TEXTS = [
    "依据第一千零七十九条和第5条，可以解除。又见第一千零七十九条。",
    "Under § 2-201 and Section 9-109(a), see also Article 2.",
    "根据第一千零七十九条与第5条；另见第99条。",
    "The statute of frauds in § 2-201 controls; § 9-610 does not apply.",
    "Under § 2–201 and Article 2; but Article 9 does not apply.",
    "本案应当综合判断。",
]


def test_citations_match_jax():
    pairs = ZH_HITS + EN_HITS + [hit_pair("5", rank=3)]
    for text in CITATION_TEXTS:
        assert citations.extract_article_refs(text) == \
            jax_citations.extract_article_refs(text)
        assert citations.verify_citations(text, [p for _, p in pairs]) == \
            jax_citations.verify_citations(text, [j for j, _ in pairs])
    assert citations.verify_citations(CITATION_TEXTS[2], [p for _, p in pairs]) \
        == {"supported": [{"ref": "1079", "article_id": "1079", "rank": 2},
                          {"ref": "5", "article_id": "5", "rank": 3}],
            "unsupported": ["99"]}


SECTIONS = ('{"sections": ['
            '{"title": "结论", "items": ["可以解除。理由充分。"]},'
            '{"title": "分析", "items": [{"text": "第一点。第二点。"}, "尾项。"]},'
            '{"title": "t", "items": ["quote \\" and brace { inside. done."]}'
            ']}')


@pytest.mark.parametrize("step", [len(SECTIONS), 7, 1])
def test_scanner_events_match_jax(step):
    port, jax = (answer_scanner.StructuredAnswerScanner(),
                 jax_scanner.StructuredAnswerScanner())
    for i in range(0, len(SECTIONS), step):
        piece = SECTIONS[i:i + step]
        assert port.feed(piece) == jax.feed(piece)
    for text in ("甲。乙！丙？", "One. Two! ", "", "no end"):
        assert answer_scanner.sentence_split(text) == jax_scanner.sentence_split(text)


def test_metrics_render_matches_jax():
    port, jax = Metrics(), JaxMetrics()
    for m in (port, jax):
        m.inc("legalrag_requests", endpoint="retrieve")
        m.inc("legalrag_requests", 2, endpoint="retrieve_batch")
        m.set_gauge("legalrag_pool", 3.5, kind="x")
        for s in (0.001, 0.03, 0.7, 20.0):
            m.observe("legalrag_retrieve_seconds", s)
    assert port.render() == jax.render()
    with port.timed("legalrag_t", a="b"):
        pass
    assert 'legalrag_t_count{a="b"} 1' in port.render()


def test_schema_dumps_and_validation_match_pydantic():
    """dump = model_dump (exclude_none on dataclasses, not inside plain
    dicts; enums as values; numpy scalars as Python numbers); from_dict =
    model_validate."""
    jh, ph = hit_pair("563", rank=1)
    bd = {"fusion_method": "rrf", "none_kept": None,
          "per_channel": {"dense": {"score": 0.5}}}
    jh.score_breakdown, ph.score_breakdown = dict(bd), dict(bd)
    ph.semantic_score = np.float32(0.25)
    jh.semantic_score = 0.25
    assert json.dumps(dump(ph, exclude_none=True)) == \
        json.dumps(jh.model_dump(exclude_none=True))
    jd, pd = decision_pair("risk_alert", "deposit", "GRAPH_AUGMENTED")
    pd.signals = jd.signals = {"has_article_ref": True}
    assert json.dumps(dump(pd)) == json.dumps(jd.model_dump())
    wire = json.loads(json.dumps(dump(ph, exclude_none=True)))
    assert dump(RetrievalHit.from_dict(wire), exclude_none=True) == \
        JaxHit.model_validate(wire).model_dump(exclude_none=True)
    wire = json.loads(json.dumps(dump(pd)))
    assert json.dumps(dump(RoutingDecision.from_dict(wire))) == \
        json.dumps(JaxDecision.model_validate(wire).model_dump())
    assert LawChunk.from_json(ph.chunk.to_json()) == ph.chunk


def test_app_config_load_matches_jax(tmp_path, monkeypatch):
    overlay = {"lang": "en", "paths": {"data_dir": str(tmp_path / "d"),
                                       "index_dir": str(tmp_path / "i"),
                                       "eval_dir": str(tmp_path / "e")},
               "llm": {"provider": "openai", "temperature": 0.0,
                       "decode_chunk": 4},
               "routing": {"llm_based": True},
               "server": {"port": 9001, "prewarm_buckets": 0},
               "retrieval": {"top_k": 7}, "pdf": {"chunk_chars": 10}}
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(overlay), encoding="utf-8")
    monkeypatch.setenv("LEGALRAG_INDEX_VERSION", "v3")
    got = AppConfig.load(path, mkdirs=False)
    want = JaxConfig.load(path, mkdirs=False)
    for section in ("paths", "engine", "retrieval", "llm", "routing", "server"):
        mine = vars(getattr(got, section))
        theirs = getattr(want, section).model_dump()
        assert mine == {k: theirs[k] for k in mine}, section
    assert (got.lang, got.index_version) == (want.lang, want.index_version) == \
        ("en", "v3")
    assert got.paths.lang_index_dir == tmp_path / "i" / "en" / "versions" / "v3"
    got.paths.ensure_tree()
    assert (tmp_path / "e").is_dir() and (tmp_path / "d").is_dir()
    yml = tmp_path / "cfg.yaml"
    yml.write_text("retrieval:\n  top_k: 4\n", encoding="utf-8")
    assert AppConfig.load(yml, mkdirs=False).retrieval.top_k == 4
    monkeypatch.setitem(__import__("sys").modules, "yaml", None)
    with pytest.raises(RuntimeError, match="pyyaml"):
        AppConfig.load(yml, mkdirs=False)
