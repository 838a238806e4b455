"""Query routing: retrieval mode, task type, oversampling factor (port of
``legalrag_tpu/routing/router.py``).

GRAPH_AUGMENTED iff the query carries an article reference or interpretive
keywords; task type by keyword ladder (elements → judge_style → exegesis →
risk → comparative → procedure, default judge_style); ``top_k_factor`` 1.35
for broad questions without an article reference.

LLM routing (``routing.llm_based``): strict-JSON classification with
task-type definitions, falling back to the rules on any error.
"""

from __future__ import annotations

import json
from typing import Optional

from legalrag_tpu_torch.routing.issue_extractor import (
    IssueResult,
    LegalIssueExtractor,
    extract_json,
)
from legalrag_tpu_torch.schemas import RoutingDecision, RoutingMode, TaskType
from legalrag_tpu_torch.utils import get_logger

log = get_logger("torch.router")

INTERPRETIVE_KEYWORDS = ["如何理解", "解释", "适用", "构成要件", "要件", "定义",
                         "what is", "interpret", "meaning of", "article"]

ELEMENTS_KEYWORDS = [
    "构成要件", "成立要件", "构成要素", "要件有哪些", "要件是什么", "要素有哪些",
    "要素是什么", "需要哪些条件", "需要什么条件", "需要哪些要件", "需要什么要件",
    "适用前提", "适用条件", "前提是什么", "前提条件", "条件是什么", "条件有哪些",
    "elements of", "elements for", "requirements for", "prerequisites for",
    "conditions for", "what are the elements", "what are the requirements",
    "what are the conditions",
]
JUDGE_KEYWORDS = ["是否可以", "能否", "可以", "能不能", "是否能", "can i",
                  "can we", "is it possible"]
EXEGESIS_KEYWORDS = ["什么是", "定义", "含义", "如何理解", "本法所称", "本条所称",
                     "interpret", "meaning of"]
RISK_KEYWORDS = ["风险", "风险点", "注意事项", "提示", "risk", "alert"]
COMPARATIVE_KEYWORDS = ["区别", "对比", "比较", "差异", "versus", "compare"]
PROCEDURE_KEYWORDS = ["证据", "举证", "证明", "程序", "流程", "起诉", "立案",
                      "evidence", "procedure"]
BROAD_KEYWORDS = ["有哪些", "如何", "怎么办", "what are", "how to", "can i",
                  "should i", "是否可以"]

_TASK_DEFS = {
    TaskType.JUDGE_STYLE: "practical yes/no or how-to answer in a judge's reasoning style",
    TaskType.STATUTE_EXEGESIS: "explain the meaning/interpretation of a statutory provision or term",
    TaskType.RISK_ALERT: "surface legal risks and cautions for a plan or situation",
    TaskType.ELEMENTS_CHECKLIST: "enumerate the legal elements/requirements that must be satisfied",
    TaskType.COMPARATIVE_RULES: "compare two or more legal concepts/rules",
    TaskType.PROCEDURE_EVIDENCE_LIST: "list procedure steps and required evidence",
    TaskType.OTHER: "anything else",
}


class QueryRouter:
    def __init__(self, llm=None, llm_based: bool = False, cfg=None):
        self.llm = llm
        self.llm_based = llm_based
        self.cfg = cfg
        self.extractor = LegalIssueExtractor(llm=llm, cfg=cfg)

    # ------------------------------------------------------------------
    def route(self, question: str) -> RoutingDecision:
        issue = self.extractor.extract(question)
        if self.llm_based and self.llm is not None:
            try:
                return self._llm_route(question, issue)
            except Exception as e:
                log.warning("llm routing failed (%s); falling back to rules", e)
        return self._rule_route(question, issue)

    # ------------------------------------------------------------------
    def _rule_route(self, question: str, issue: IssueResult) -> RoutingDecision:
        return RoutingDecision(
            task_type=self._decide_task_type(question),
            issue_type=issue.issue_type,
            mode=self._decide_mode(question, issue),
            top_k_factor=self._top_k_factor(question, issue),
            explain=f"rule_based; {issue.explain}",
            tags=issue.tags,
            signals=issue.signals,
        )

    def _decide_mode(self, q: str, issue: IssueResult) -> RoutingMode:
        s = q.lower()
        if issue.signals.get("has_article_ref") or any(
                k in s for k in INTERPRETIVE_KEYWORDS):
            return RoutingMode.GRAPH_AUGMENTED
        return RoutingMode.RAG

    def _decide_task_type(self, q: str) -> TaskType:
        s = q.lower()
        for task, kws in ((TaskType.ELEMENTS_CHECKLIST, ELEMENTS_KEYWORDS),
                          (TaskType.JUDGE_STYLE, JUDGE_KEYWORDS),
                          (TaskType.STATUTE_EXEGESIS, EXEGESIS_KEYWORDS),
                          (TaskType.RISK_ALERT, RISK_KEYWORDS),
                          (TaskType.COMPARATIVE_RULES, COMPARATIVE_KEYWORDS),
                          (TaskType.PROCEDURE_EVIDENCE_LIST, PROCEDURE_KEYWORDS)):
            if any(k in s for k in kws):
                return task
        return TaskType.JUDGE_STYLE

    def _top_k_factor(self, q: str, issue: IssueResult) -> float:
        s = q.lower()
        broad = any(k in s for k in BROAD_KEYWORDS)
        if broad and not issue.signals.get("has_article_ref"):
            return 1.35
        return 1.0

    # ------------------------------------------------------------------
    def _llm_route(self, question: str, issue: IssueResult) -> RoutingDecision:
        defs = "\n".join(f"- {t.value}: {d}" for t, d in _TASK_DEFS.items())
        sys_msg = (
            "You are a query router for a legal RAG system. Classify the "
            "question. Task type definitions:\n" + defs + "\n"
            "mode: GRAPH_AUGMENTED when the question names a specific article "
            "or asks to interpret/define a provision or term; RAG otherwise. "
            "Tie-breakers: elements_checklist beats statute_exegesis when the "
            "question asks for requirements; judge_style is the default.\n"
            'Return STRICT JSON: {"task_type": "...", "mode": "RAG"|'
            '"GRAPH_AUGMENTED", "top_k_factor": float in [1.0, 1.5]}'
        )
        raw = self.llm.chat(
            [{"role": "system", "content": sys_msg},
             {"role": "user", "content": question}],
            tag="route")
        obj = json.loads(extract_json(raw))
        task = str(obj.get("task_type", ""))
        mode = str(obj.get("mode", ""))
        factor = float(obj.get("top_k_factor", 1.0))
        return RoutingDecision(
            task_type=TaskType(task) if task in {t.value for t in TaskType}
            else self._decide_task_type(question),
            issue_type=issue.issue_type,
            mode=RoutingMode(mode) if mode in {m.value for m in RoutingMode}
            else self._decide_mode(question, issue),
            top_k_factor=min(1.5, max(1.0, factor)),
            explain=f"llm_route; {issue.explain}",
            tags=issue.tags,
            signals=issue.signals,
        )
