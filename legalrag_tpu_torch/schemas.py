"""Core data model of the query, serving and answer paths.

Keyword-only dataclasses and string enums with the JAX package's field
names, order and defaults (``legalrag_tpu/schemas.py:19-150, 173-199``):
``LawChunk``, ``RetrievalHit``, the routing axes (``TaskType``,
``IssueType``, ``RoutingMode``, ``RoutingDecision``), ``RagAnswer``, the
case-law ``CaseEntry`` and ``CaseRetrievalHit`` (``:152-171``) and the
law graph's ``Neighbor`` and ``LawNode``.

:func:`dump` is pydantic's ``model_dump`` (``exclude_none`` drops the
``None`` fields of every dataclass in the tree, not the ``None`` values of
a plain dict) with the result ready for ``json.dumps``: enums as their
values, numpy scalars as Python numbers. The ``from_dict`` class methods
are ``model_validate`` for what the server reads back from JSON.
``LawChunk.to_json`` writes the same line as pydantic's
``model_dump_json(exclude_none=True)`` (fields in declaration order,
compact separators, non-ASCII kept as is), so ``chunks.jsonl`` reads and
writes identically in both packages; ``CaseEntry.to_json`` does the same
for ``cases.jsonl``.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Dict, List, Optional

import numpy as np


def dump(obj: Any, *, exclude_none: bool = False) -> Any:
    """``obj`` as plain JSON data: dataclasses as dicts in field order
    (their ``None`` fields left out under ``exclude_none``), lists and dict
    values converted in turn, enums as their values, numpy scalars as
    Python numbers."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        out = {}
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if v is None and exclude_none:
                continue
            out[f.name] = dump(v, exclude_none=exclude_none)
        return out
    if isinstance(obj, Enum):
        return obj.value
    if isinstance(obj, dict):
        return {k: dump(v, exclude_none=exclude_none) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [dump(v, exclude_none=exclude_none) for v in obj]
    if isinstance(obj, np.generic):
        return obj.item()
    return obj


@dataclass(kw_only=True)
class LawChunk:
    """One retrievable unit: a statutory article or an ingested text chunk."""

    id: str
    law_name: str
    chapter: Optional[str] = None
    section: Optional[str] = None
    article_no: str
    article_id: str  # normalized numeric / canonical key for article_no
    text: str
    lang: Optional[str] = "zh"
    source: Optional[str] = None
    start_char: Optional[int] = None
    end_char: Optional[int] = None

    def to_json(self) -> str:
        return json.dumps(dump(self, exclude_none=True), ensure_ascii=False,
                          separators=(",", ":"))

    @classmethod
    def from_json(cls, line: str) -> "LawChunk":
        return cls.from_dict(json.loads(line))

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "LawChunk":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


@dataclass(kw_only=True)
class RetrievalHit:
    """A scored chunk with provenance and explainability payload."""

    chunk: LawChunk
    score: float
    rank: Optional[int] = None
    source: str = "retriever"  # "retriever" | "graph" | "rerank"
    semantic_score: Optional[float] = None
    graph_depth: Optional[int] = None
    relations: Optional[List[str]] = None
    seed_article_id: Optional[str] = None
    score_breakdown: Optional[Dict[str, Any]] = None

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "RetrievalHit":
        names = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in d.items() if k in names}
        kw["chunk"] = LawChunk.from_dict(d["chunk"])
        kw["score"] = float(d["score"])
        if kw.get("semantic_score") is not None:
            kw["semantic_score"] = float(kw["semantic_score"])
        return cls(**kw)


class TaskType(str, Enum):
    """Task / output-structure axis for prompting."""

    JUDGE_STYLE = "judge_style"
    STATUTE_EXEGESIS = "statute_exegesis"
    RISK_ALERT = "risk_alert"
    ELEMENTS_CHECKLIST = "elements_checklist"
    COMPARATIVE_RULES = "comparative_rules"
    PROCEDURE_EVIDENCE_LIST = "procedure_evidence_list"
    OTHER = "other"


class IssueType(str, Enum):
    """Legal-issue axis for semantic classification (PRC civil-law taxonomy)."""

    GENERAL_CIVIL = "general_civil"
    CIVIL_CAPACITY = "civil_capacity"
    CIVIL_ACT_VALIDITY = "civil_act_validity"
    AGENCY = "agency"
    CIVIL_LIABILITY = "civil_liability"
    LIMITATION_PERIOD = "limitation_period"

    PROPERTY = "property"
    OWNERSHIP = "ownership"
    POSSESSION = "possession"
    REGISTRATION = "registration"
    NEIGHBOR_RELATION = "neighbor_relation"
    PROPERTY_USE_RIGHT = "property_use_right"
    MORTGAGE = "mortgage"
    PLEDGE = "pledge"
    LIEN = "lien"

    CONTRACT = "contract"
    CONTRACT_FORMATION = "contract_formation"
    CONTRACT_VALIDITY = "contract_validity"
    CONTRACT_INTERPRETATION = "contract_interpretation"
    CONTRACT_PERFORMANCE = "contract_performance"
    PERFORMANCE_DEFENSE = "performance_defense"
    DEFECTIVE_PERFORMANCE = "defective_performance"
    CONTRACT_TERMINATION = "contract_termination"
    BREACH_REMEDY = "breach_remedy"
    PENALTY_LIQUIDATED = "penalty_liquidated"
    DEPOSIT = "deposit"
    GUARANTEE = "guarantee"
    CONTRACT_TRANSFER = "contract_transfer"

    QUASI_CONTRACT = "quasi_contract"
    NEGOTIORUM_GESTIO = "negotiorum_gestio"
    UNJUST_ENRICHMENT = "unjust_enrichment"

    PERSONALITY = "personality"
    NAME_RIGHT = "name_right"
    PORTRAIT_RIGHT = "portrait_right"
    REPUTATION_RIGHT = "reputation_right"
    PRIVACY_INFO = "privacy_info"
    PERSONALITY_INFRINGEMENT = "personality_infringement"

    MARRIAGE_FAMILY = "marriage_family"
    MARRIAGE = "marriage"
    DIVORCE = "divorce"
    FAMILY_PROPERTY = "family_property"
    CUSTODY_SUPPORT = "custody_support"

    INHERITANCE = "inheritance"
    INHERITANCE_WILL = "inheritance_will"
    INHERITANCE_STATUTORY = "inheritance_statutory"
    INHERITANCE_SHARE = "inheritance_share"

    TORT = "tort"
    TORT_LIABILITY = "tort_liability"
    PERSONAL_INJURY = "personal_injury"
    PRODUCT_LIABILITY = "product_liability"
    MEDICAL_TORT = "medical_tort"
    OTHER = "other"


class RoutingMode(str, Enum):
    RAG = "RAG"
    GRAPH_AUGMENTED = "GRAPH_AUGMENTED"


@dataclass(kw_only=True)
class RoutingDecision:
    task_type: TaskType
    issue_type: IssueType
    mode: RoutingMode
    top_k_factor: float = 1.0
    explain: Optional[str] = None
    tags: List[str] = field(default_factory=list)
    signals: Dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "RoutingDecision":
        names = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in d.items() if k in names}
        kw.update(task_type=TaskType(d["task_type"]),
                  issue_type=IssueType(d["issue_type"]),
                  mode=RoutingMode(d["mode"]))
        if "top_k_factor" in kw:
            kw["top_k_factor"] = float(kw["top_k_factor"])
        return cls(**kw)


@dataclass(kw_only=True)
class RagAnswer:
    question: str
    answer: str
    hits: List[RetrievalHit]
    # which article refs in the answer the retrieved hits support
    # (pipeline/citations.py); None when verification was not run
    citations: Optional[Dict[str, Any]] = None


@dataclass(kw_only=True)
class CaseEntry:
    """A case-law record (``legalrag_tpu/schemas.py:152-163``)."""

    case_id: str
    title: str
    court: Optional[str] = None
    date: Optional[str] = None           # ISO yyyy-mm-dd
    cause: Optional[str] = None          # cause of action / 案由
    text: str
    cited_articles: List[str] = field(default_factory=list)
    meta: Dict[str, Any] = field(default_factory=dict)

    def to_json(self) -> str:
        """pydantic's ``model_dump_json(exclude_none=True)`` line (the
        empty ``cited_articles`` and ``meta`` kept: they are not None). A
        float inside ``meta`` is written as ``json`` writes it, which
        pydantic does not always do (1.5e-05 against 0.000015)."""
        return json.dumps(dump(self, exclude_none=True), ensure_ascii=False,
                          separators=(",", ":"))

    @classmethod
    def from_json(cls, line: str) -> "CaseEntry":
        return cls.from_dict(json.loads(line))

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "CaseEntry":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


@dataclass(kw_only=True)
class CaseRetrievalHit:
    case: CaseEntry
    score: float
    rank: Optional[int] = None
    score_breakdown: Optional[Dict[str, Any]] = None


@dataclass(kw_only=True)
class Neighbor:
    """A directed edge from one article node to another."""

    article_id: str
    relation: str = "neighbor"
    conf: float = 1.0
    evidence: Optional[Dict[str, Any]] = None


@dataclass(kw_only=True)
class LawNode:
    """In-memory law-graph node. Query-time fields are never persisted."""

    article_id: str
    article_no: str = ""
    law_name: Optional[str] = None
    title: Optional[str] = None
    chapter: Optional[str] = None
    section: Optional[str] = None
    neighbors: List[Neighbor] = field(default_factory=list)
    meta: Dict[str, Any] = field(default_factory=dict)

    # query-time fields (set on the copies that LawGraphStore.walk returns)
    graph_depth: Optional[int] = None
    graph_parent: Optional[str] = None
    relations: Optional[List[str]] = None
