"""The port's ``MultistepPipeline`` (``pipeline/multistep.py``) and
``LegalAgent`` (``agents/legal_agent.py``) against the JAX package's on the
CPU:

- the heuristic split on zh and en questions (a trailing ？, each
  conjunction, parts under 6 characters, more parts than ``max_steps``);
- the LLM decomposition through a fake client (valid, fenced and junk
  JSON, an empty list, blank entries, a client that raises, a degraded
  one): the same sub-questions and the same prompt sent;
- over small hash-encoder bundles that JAX built and saved and both
  packages load, with an LLM that is degraded (so decomposition takes the
  heuristic) and records what it is asked: ``answer_complex`` and
  ``answer_auto`` send the same framed prompt and return the same answer
  and merged hits, article ids equal and scores within ATOL. The port's
  hash encoder serves with JAX's projection (``use_projection``), as
  every carried bundle does.
"""

import json

import numpy as np
import pytest

from legalrag_tpu.agents import LegalAgent as JaxAgent
from legalrag_tpu.config import AppConfig as JaxConfig
from legalrag_tpu.graph import GraphBuilder as JaxGraphBuilder
from legalrag_tpu.index.bundle import IndexBundle as JaxBundle
from legalrag_tpu.pipeline import MultistepPipeline as JaxMultistep
from legalrag_tpu.pipeline.multistep import DECOMPOSE_PROMPT as JAX_PROMPT
from legalrag_tpu.pipeline.rag_pipeline import RagPipeline as JaxPipeline
from legalrag_tpu_torch.agents import LegalAgent
from legalrag_tpu_torch.config import AppConfig
from legalrag_tpu_torch.pipeline import MultistepPipeline
from legalrag_tpu_torch.pipeline.multistep import DECOMPOSE_PROMPT
from legalrag_tpu_torch.pipeline.rag_pipeline import RagPipeline

ATOL = 1e-5
PATHS = ("data_dir", "raw_dir", "processed_dir", "index_dir", "graph_dir",
         "eval_dir", "upload_dir")

QUESTIONS = [
    "合同无效的情形有哪些；另外，无效后财产如何处理？",
    "什么是善意取得",
    "借款合同的利息如何计算；保证人在什么情况下承担保证责任；"
    "另外，借款人逾期还款应当承担什么责任？",
    "离婚时夫妻共同财产如何分割？子女抚养权如何确定？",
    "离婚时夫妻共同财产如何分割？子女抚养权如何确定",
    "房屋租赁合同到期后如何处理，同时押金能否退还，以及违约金如何计算",
    "承租人拖欠租金怎么办，还有出租人能否解除合同，其次如何主张损失赔偿",
    "并且，出卖人应当交付标的物；同时，买受人应当支付价款",
    "甲;乙;丙丁戊己庚辛;壬癸",
    "一；二三四五六七八；九十百千万亿兆京；垓秭穰沟涧正载；极恒河沙阿僧祇；"
    "那由他不可思议；无量大数的情形",
    "When does a security interest attach to the collateral? Who has "
    "priority between conflicting security interests?",
    "What are the seller's obligations on delivery; and also what remedies "
    "does the buyer have if the goods are nonconforming?",
    "Is an oral contract enforceable in addition to a written one?",
    "a;b;c?",
    "Define goods; define merchant; define sale; define lease; define "
    "security agreement; define financing statement",
    "What is a negotiable instrument?",
]


class FakePipeline:
    """A pipeline stub: ``llm`` and nothing else (decomposition only)."""

    def __init__(self, llm=None):
        self.llm = llm


class RawLLM:
    """Returns ``raw`` for every chat (or raises it, an exception); records
    the messages."""

    is_degraded = False

    def __init__(self, raw):
        self.raw = raw
        self.messages = []

    def chat(self, messages, tag=None, **kw):
        self.messages.append((messages, tag))
        if isinstance(self.raw, Exception):
            raise self.raw
        return self.raw


class DegradedLLM(RawLLM):
    """A degraded client: never asked to decompose; its answer is fixed
    and it records every prompt."""

    is_degraded = True

    def __init__(self):
        super().__init__("结论：见检索结果。")

    def degraded_answer(self, messages):
        return self.raw


@pytest.mark.parametrize("max_steps", [2, 4])
def test_heuristic_split_matches_jax(max_steps):
    assert DECOMPOSE_PROMPT == JAX_PROMPT
    for q in QUESTIONS:
        want = JaxMultistep(FakePipeline(), max_steps=max_steps)
        got = MultistepPipeline(FakePipeline(), max_steps=max_steps)
        assert got._heuristic_split(q) == want._heuristic_split(q), q
        assert got.decompose(q) == want.decompose(q), q
    counts = {len(MultistepPipeline(FakePipeline(), max_steps=9)
                  ._heuristic_split(q)) for q in QUESTIONS}
    assert {1, 2, 3} <= counts and max(counts) > 4


RAWS = [
    json.dumps({"sub_questions": ["问题甲如何处理", "问题乙如何处理"]},
               ensure_ascii=False),
    "```json\n" + json.dumps({"sub_questions": ["a", " b ", "", 7, None,
                                                "c", "d", "e"]}) + "\n```",
    'Sure: {"sub_questions": ["only one"]} -- done',
    "no json at all",
    "{not json}",
    json.dumps({"sub_questions": []}),
    json.dumps({"other": ["x"]}),
    "[1, 2]",
    RuntimeError("provider down"),
]


@pytest.mark.parametrize("raw", RAWS, ids=range(len(RAWS)))
def test_llm_decompose_matches_jax(raw):
    for q in (QUESTIONS[0], QUESTIONS[1], QUESTIONS[10]):
        jl, tl = RawLLM(raw), RawLLM(raw)
        want = JaxMultistep(FakePipeline(jl), max_steps=4).decompose(q)
        got = MultistepPipeline(FakePipeline(tl), max_steps=4).decompose(q)
        assert got == want, (raw, q)
        assert tl.messages == jl.messages
    # a degraded client (or none) is never asked
    for llm in (DegradedLLM(), None):
        got = MultistepPipeline(FakePipeline(llm)).decompose(QUESTIONS[0])
        assert got == JaxMultistep(FakePipeline(llm)).decompose(QUESTIONS[0])
        assert not getattr(llm, "messages", [])
    # an llm passed to decompose wins over the pipeline's
    jl, tl = RawLLM(RAWS[0]), RawLLM(RAWS[0])
    assert MultistepPipeline(FakePipeline()).decompose("q", llm=tl) == \
        JaxMultistep(FakePipeline()).decompose("q", llm=jl)


def small_config(cfg, root):
    cfg.llm.provider = "disabled"
    cfg.llm.api_key = None
    cfg.engine.capacity_round = 256
    cfg.engine.late_doc_maxlen = 64
    for name in PATHS:
        setattr(cfg.paths, name, root / name)
    return cfg


@pytest.fixture(scope="module")
def pipelines(zh_chunks, en_chunks, tmp_path_factory):
    """(JAX pipeline, port pipeline) over one saved index directory, each
    with its own degraded recording LLM."""
    root = tmp_path_factory.mktemp("multistep")
    jcfg, cfg = small_config(JaxConfig(), root), small_config(AppConfig(), root)
    jcfg.paths.ensure_tree()
    for lang, chunks in (("zh", zh_chunks[:400]), ("en", en_chunks[:200])):
        lc = jcfg.with_lang(lang)
        JaxBundle.build_from_chunks(chunks, lc, lang).save(
            lc.paths.lang_index_dir)
        JaxGraphBuilder().build_to_file(chunks, lc.paths.graph_file)
    jp = JaxPipeline(jcfg, llm=DegradedLLM())
    tp = RagPipeline(cfg, llm=DegradedLLM(), device="cpu")
    for lang in ("zh", "en"):
        tp.retriever.retriever(lang).bundle.encoder.use_projection(np.asarray(
            jp.retriever.retriever(lang).bundle.encoder._projection()))
    return jp, tp


def assert_same_answer(got, want):
    assert got.question == want.question
    assert got.answer == want.answer
    assert [h.chunk.article_id for h in got.hits] == \
        [h.chunk.article_id for h in want.hits]
    for g, w in zip(got.hits, want.hits):
        assert abs(g.score - w.score) <= ATOL, (g.chunk.id, g.score, w.score)
        assert g.source == w.source and g.rank == w.rank
        assert (g.score_breakdown or {}).get("channels") == \
            (w.score_breakdown or {}).get("channels")


@pytest.mark.parametrize("qi", [0, 2, 3, 10, 11, 1])
def test_answer_complex_and_auto_match_jax(pipelines, qi):
    jp, tp = pipelines
    q = QUESTIONS[qi]
    for max_steps in (4, 2):
        want = JaxMultistep(jp, max_steps=max_steps)
        got = MultistepPipeline(tp, max_steps=max_steps)
        assert got.retrieve_multi(q)[0] == want.retrieve_multi(q)[0]
        n0, m0 = len(jp.llm.messages), len(tp.llm.messages)
        assert_same_answer(got.answer_complex(q), want.answer_complex(q))
        assert tp.llm.messages[m0:] == jp.llm.messages[n0:]
    n0, m0 = len(jp.llm.messages), len(tp.llm.messages)
    ja, ta = JaxAgent(jp.cfg, jp), LegalAgent(tp.cfg, tp)
    assert_same_answer(ta.answer_auto(q), ja.answer_auto(q))
    assert_same_answer(ta.answer(q, top_k=4), ja.answer(q, top_k=4))
    assert tp.llm.messages[m0:] == jp.llm.messages[n0:]
    framed = tp.llm.messages[m0][0][-1]["content"]
    multi = len(ta.multistep.decompose(q)) > 1
    assert (("已分解为" in framed or "Decomposed into" in framed) == multi)


def test_agent_without_a_pipeline_needs_cuda_unless_told_cpu(tmp_path):
    import torch

    cfg = small_config(AppConfig(), tmp_path)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            LegalAgent(cfg)
    agent = LegalAgent(cfg, device="cpu")
    assert agent.pipeline.retriever.cache.device.type == "cpu"
    assert agent.multistep.max_steps == 4
