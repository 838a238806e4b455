"""Port routing (``routing/router.py``, ``routing/issue_extractor.py``) vs the
JAX package's on the CPU: the same questions give the same decisions and
issue results, field for field, as the JSON the server sends; one stub LLM,
shared by both packages, drives the LLM routing, its fallback on garbage
and the issue refinement, whose prompts must be equal too. Routing is
exact string and keyword work, so everything compares exactly."""

import json

import pytest

from legalrag_tpu.config import AppConfig as JaxConfig
from legalrag_tpu.routing import issue_extractor as jax_issue
from legalrag_tpu.routing import router as jax_router
from legalrag_tpu.routing import has_article_ref as jax_has_article_ref
from legalrag_tpu_torch.config import AppConfig
from legalrag_tpu_torch.routing import (
    LegalIssueExtractor,
    QueryRouter,
    has_article_ref,
    issue_extractor,
    router,
)
from legalrag_tpu_torch.schemas import IssueType, RoutingMode, TaskType, dump
from legalrag_tpu_torch.utils import detect_lang

# zh and en questions that reach every rule of the ladder: article refs,
# interpretive and broad wording, every task type, fine issues and the
# part-level fallback, and questions that match nothing
QUESTIONS = [
    "民法典第一千零四十五条如何规定亲属范围？",
    "我想买一套二手房需要注意什么",
    "违约责任的构成要件有哪些",
    "我是否可以解除合同",
    "什么是善意取得",
    "签合同有什么风险",
    "定金和订金的区别",
    "起诉离婚需要什么证据材料清单",
    "随便问问",
    "继承人有哪些",
    "第十条有哪些规定",
    "违约金过高怎么办",
    "房屋抵押登记",
    "离婚后财产怎么分",
    "遗产分配纠纷如何处理遗产",
    "今天天气不错",
    "第五百零二条第一款",
    "What does Article 9 say about security interests?",
    "what is unjust enrichment",
    "Can I terminate the lease if the goods are nonconforming?",
    "What are the elements of a valid contract formation?",
    "compare a negotiable instrument versus a letter of credit",
    "what evidence is needed in the procedure for a tort claim",
    "risk alert for a product liability claim",
    "How to interpret the meaning of good faith",
    "buyer in ordinary course of business",
    "",
]


def as_json(obj):
    """What the server would send for ``obj``: a JAX pydantic model's
    ``model_dump``, or a port dataclass's ``dump``, through json."""
    data = obj.model_dump() if hasattr(obj, "model_dump") else dump(obj)
    return json.loads(json.dumps(data, ensure_ascii=False, default=str))


class StubLLM:
    """Returns one canned reply and records every chat call."""

    def __init__(self, reply):
        self.reply = reply
        self.calls = []

    def chat(self, messages, tag=None, **kw):
        self.calls.append((messages, tag))
        return self.reply


@pytest.mark.parametrize("lang", ["zh", "en"])
def test_rule_route_matches_jax(lang):
    qs = [q for q in QUESTIONS if (detect_lang(q) == lang) or not q]
    assert len(qs) >= 10
    for q in qs:
        got = QueryRouter().route(q)
        want = jax_router.QueryRouter().route(q)
        assert as_json(got) == as_json(want), q
        assert isinstance(got.mode, RoutingMode)
        assert isinstance(got.task_type, TaskType)


def test_issue_extraction_and_article_refs_match_jax():
    for q in QUESTIONS:
        got = LegalIssueExtractor().extract(q)
        want = jax_issue.LegalIssueExtractor().extract(q)
        assert as_json(got) == as_json(want), q
        assert isinstance(got.issue_type, IssueType)
        assert has_article_ref(q) == jax_has_article_ref(q)


def test_rule_tables_match_jax():
    as_values = lambda rules: [(t.value, kws) for t, kws in rules]  # noqa: E731
    assert as_values(issue_extractor.ISSUE_RULES) == as_values(jax_issue.ISSUE_RULES)
    assert as_values(issue_extractor.PART_RULES.items()) == \
        as_values(jax_issue.PART_RULES.items())
    assert {k: sorted(v.value for v in s)
            for k, s in issue_extractor.PART_TAGS.items()} == \
        {k: sorted(v.value for v in s) for k, s in jax_issue.PART_TAGS.items()}
    for name in ("INTERPRETIVE_KEYWORDS", "ELEMENTS_KEYWORDS",
                 "JUDGE_KEYWORDS", "EXEGESIS_KEYWORDS", "RISK_KEYWORDS",
                 "COMPARATIVE_KEYWORDS", "PROCEDURE_KEYWORDS",
                 "BROAD_KEYWORDS"):
        assert getattr(router, name) == getattr(jax_router, name), name


@pytest.mark.parametrize("reply", [
    json.dumps({"task_type": "risk_alert", "mode": "GRAPH_AUGMENTED",
                "top_k_factor": 1.2}),
    "routing: " + json.dumps({"task_type": "comparative_rules", "mode": "RAG",
                              "top_k_factor": 9}) + " (done)",
    json.dumps({"task_type": "no_such_task", "mode": "sideways",
                "top_k_factor": 0.2}),
    "not json at all",
    json.dumps({"top_k_factor": "many"}),
], ids=["valid", "wrapped_clamped", "unknown_values", "garbage",
        "bad_factor"])
def test_llm_route_and_fallback_match_jax(reply):
    """LLM routing with one stub shared by both packages: the same decision
    (parsed, clamped, or the rules' on garbage) and the same prompt."""
    for q in ("我是否可以解除合同", "什么是善意取得", "What does Article 9 say"):
        llm = StubLLM(reply)
        got = QueryRouter(llm=llm, llm_based=True).route(q)
        want = jax_router.QueryRouter(llm=llm, llm_based=True).route(q)
        assert as_json(got) == as_json(want), q
        (port_msgs, port_tag), (jax_msgs, jax_tag) = llm.calls
        assert port_msgs == jax_msgs and port_tag == jax_tag == "route"


@pytest.mark.parametrize("reply", [
    json.dumps({"issue_type": "deposit", "tags": ["x", "", 3]}),
    json.dumps({"issue_type": "bogus", "tags": "not a list"}),
    "garbage",
], ids=["valid", "invalid_fields", "garbage"])
def test_issue_llm_refine_matches_jax(reply):
    """The refinement prompt carries the heuristic result as JSON: the
    dataclass ``IssueResult`` must dump as the pydantic one does."""
    jcfg, cfg = JaxConfig(), AppConfig()
    jcfg.routing.issue_llm_refine = cfg.routing.issue_llm_refine = True
    for q in ("第五百零二条 合同的效力", "lease termination notice"):
        llm = StubLLM(reply)
        got = LegalIssueExtractor(llm=llm, cfg=cfg).extract(q)
        want = jax_issue.LegalIssueExtractor(llm=llm, cfg=jcfg).extract(q)
        assert as_json(got) == as_json(want)
        (port_msgs, _), (jax_msgs, _) = llm.calls
        assert port_msgs == jax_msgs
        assert json.loads(port_msgs[1]["content"])["heuristic"]["issue_type"]


def test_extract_json_matches_jax():
    for text in ("", "{}", "x {\"a\": 1} y", "} {", "{\"a\": {\"b\": 2}} tail }"):
        assert issue_extractor.extract_json(text) == jax_issue.extract_json(text)
