"""Legal-issue extraction: heuristic bilingual classifier (port of
``legalrag_tpu/routing/issue_extractor.py``).

~40 fine-grained issue rules checked in priority order, then part-level
rules scored by keyword count; signals include the article-reference regex;
tags are ``part:…`` / ``issue:…`` / ``article_ref``. Optional LLM
refinement behind ``cfg.routing.issue_llm_refine``, whose prompt carries
the heuristic result as the same JSON as the JAX package's.
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass, field
from typing import Any, Dict, List

from legalrag_tpu_torch.schemas import IssueType, dump

I = IssueType

# priority-ordered fine-grained rules: first rule with any keyword hit wins
ISSUE_RULES: List[tuple] = [
    (I.PENALTY_LIQUIDATED, ["违约金", "liquidated", "penalty"]),
    (I.DEPOSIT, ["定金", "订金", "deposit", "earnest"]),
    (I.CONTRACT_TERMINATION, ["解除", "终止", "rescission", "terminate", "termination"]),
    (I.DEFECTIVE_PERFORMANCE, ["瑕疵", "不合格", "缺陷", "defective", "nonconforming"]),
    (I.PERFORMANCE_DEFENSE, ["先履行", "同时履行", "不安抗辩", "抗辩", "defense of performance", "concurrent"]),
    (I.CONTRACT_FORMATION, ["订立", "成立", "要约", "承诺", "formation", "offer", "acceptance"]),
    (I.CONTRACT_VALIDITY, ["效力", "无效", "可撤销", "validity", "void", "voidable"]),
    (I.CONTRACT_INTERPRETATION, ["解释", "条款", "理解", "term", "clause", "interpret"]),
    (I.CONTRACT_PERFORMANCE, ["履行", "交付", "付款", "performance", "delivery"]),
    (I.BREACH_REMEDY, ["违约", "赔偿", "损害", "damages", "breach", "remedy"]),
    (I.CONTRACT_TRANSFER, ["变更", "转让", "让与", "assignment", "transfer", "novation"]),
    (I.GUARANTEE, ["保证", "担保", "surety", "guarantee"]),
    (I.NEGOTIORUM_GESTIO, ["无因管理", "negotiorum"]),
    (I.UNJUST_ENRICHMENT, ["不当得利", "unjust enrichment"]),
    (I.OWNERSHIP, ["所有权", "ownership"]),
    (I.POSSESSION, ["占有", "possession"]),
    (I.REGISTRATION, ["登记", "registration"]),
    (I.NEIGHBOR_RELATION, ["相邻关系", "neighbor"]),
    (I.PROPERTY_USE_RIGHT, ["用益物权", "建设用地", "宅基地", "居住权", "地役权", "usufruct"]),
    (I.MORTGAGE, ["抵押", "mortgage"]),
    (I.PLEDGE, ["质押", "pledge"]),
    (I.LIEN, ["留置", "lien"]),
    (I.CIVIL_CAPACITY, ["民事权利能力", "民事行为能力", "capacity"]),
    (I.CIVIL_ACT_VALIDITY, ["民事法律行为", "意思表示", "行为效力", "legal act", "juridical act"]),
    (I.AGENCY, ["代理", "委托", "授权", "表见代理", "agency", "power of attorney", "apparent authority"]),
    (I.CIVIL_LIABILITY, ["民事责任", "责任形式", "liability"]),
    (I.LIMITATION_PERIOD, ["诉讼时效", "时效", "limitation period"]),
    (I.NAME_RIGHT, ["姓名权", "名称权", "name right"]),
    (I.PORTRAIT_RIGHT, ["肖像权", "portrait"]),
    (I.REPUTATION_RIGHT, ["名誉权", "reputation"]),
    (I.PRIVACY_INFO, ["隐私", "个人信息", "privacy", "personal information"]),
    (I.PERSONALITY_INFRINGEMENT, ["人格权", "肖像", "名誉", "隐私", "personality", "defamation"]),
    (I.MARRIAGE, ["结婚", "婚姻", "marriage"]),
    (I.DIVORCE, ["离婚", "divorce"]),
    (I.FAMILY_PROPERTY, ["夫妻共同财产", "家庭财产", "marital property"]),
    (I.CUSTODY_SUPPORT, ["抚养", "监护", "扶养", "赡养", "custody", "support"]),
    (I.INHERITANCE_WILL, ["遗嘱", "will"]),
    (I.INHERITANCE_STATUTORY, ["法定继承", "statutory succession"]),
    (I.INHERITANCE_SHARE, ["继承份额", "继承顺序", "share", "order of succession"]),
    (I.PERSONAL_INJURY, ["人身损害", "personal injury", "injury"]),
    (I.PRODUCT_LIABILITY, ["产品责任", "缺陷产品", "product liability"]),
    (I.MEDICAL_TORT, ["医疗损害", "medical"]),
    (I.TORT_LIABILITY, ["侵权", "tort", "liability"]),
]

# part-level fallback: highest keyword count wins
PART_RULES: Dict[IssueType, List[str]] = {
    I.CONTRACT: ["合同", "违约", "履行", "定金", "违约金", "解除", "合同条款", "contract", "breach", "performance"],
    I.PROPERTY: ["物权", "所有权", "占有", "不动产", "动产", "登记", "抵押", "质押", "留置", "相邻关系", "用益物权", "property", "ownership"],
    I.PERSONALITY: ["人格权", "名誉", "隐私", "肖像", "姓名权", "个人信息", "personality", "reputation", "privacy"],
    I.MARRIAGE_FAMILY: ["婚姻", "结婚", "离婚", "夫妻", "抚养", "监护", "收养", "赡养", "marriage", "divorce", "custody"],
    I.INHERITANCE: ["继承", "遗嘱", "遗产", "继承人", "法定继承", "inheritance", "will", "succession"],
    I.TORT: ["侵权", "过错", "人身损害", "精神损害", "产品责任", "医疗损害", "tort", "liability", "injury"],
    I.QUASI_CONTRACT: ["无因管理", "不当得利", "negotiorum", "unjust enrichment"],
    I.GENERAL_CIVIL: ["民事", "自然人", "法人", "非法人组织", "民事权利", "意思表示", "代理", "民事责任", "诉讼时效", "期间", "capacity", "legal act"],
}

PART_TAGS: Dict[str, set] = {
    "contract": {I.CONTRACT, I.CONTRACT_FORMATION, I.CONTRACT_VALIDITY,
                 I.CONTRACT_INTERPRETATION, I.CONTRACT_PERFORMANCE,
                 I.PERFORMANCE_DEFENSE, I.DEFECTIVE_PERFORMANCE,
                 I.CONTRACT_TERMINATION, I.BREACH_REMEDY, I.PENALTY_LIQUIDATED,
                 I.DEPOSIT, I.GUARANTEE, I.CONTRACT_TRANSFER},
    "property": {I.PROPERTY, I.OWNERSHIP, I.POSSESSION, I.REGISTRATION,
                 I.NEIGHBOR_RELATION, I.PROPERTY_USE_RIGHT, I.MORTGAGE,
                 I.PLEDGE, I.LIEN},
    "personality": {I.PERSONALITY, I.NAME_RIGHT, I.PORTRAIT_RIGHT,
                    I.REPUTATION_RIGHT, I.PRIVACY_INFO,
                    I.PERSONALITY_INFRINGEMENT},
    "marriage_family": {I.MARRIAGE_FAMILY, I.MARRIAGE, I.DIVORCE,
                        I.FAMILY_PROPERTY, I.CUSTODY_SUPPORT},
    "inheritance": {I.INHERITANCE, I.INHERITANCE_WILL,
                    I.INHERITANCE_STATUTORY, I.INHERITANCE_SHARE},
    "tort": {I.TORT, I.TORT_LIABILITY, I.PERSONAL_INJURY,
             I.PRODUCT_LIABILITY, I.MEDICAL_TORT},
    "general": {I.GENERAL_CIVIL, I.CIVIL_CAPACITY, I.CIVIL_ACT_VALIDITY,
                I.AGENCY, I.CIVIL_LIABILITY, I.LIMITATION_PERIOD},
    "quasi_contract": {I.QUASI_CONTRACT, I.NEGOTIORUM_GESTIO,
                       I.UNJUST_ENRICHMENT},
}

_ARTICLE_REF = re.compile(r"第[一二三四五六七八九十百千万零0-9]{1,12}[条款项目]")
_ARTICLE_REF_EN = re.compile(r"\barticle\s+\d{1,4}\b", re.IGNORECASE)


@dataclass
class IssueResult:
    issue_type: IssueType = IssueType.OTHER
    tags: List[str] = field(default_factory=list)
    explain: str = ""
    signals: Dict[str, Any] = field(default_factory=dict)


def has_article_ref(q: str) -> bool:
    return bool(_ARTICLE_REF.search(q) or _ARTICLE_REF_EN.search(q))


def part_tag_of(issue: IssueType) -> str:
    for tag, members in PART_TAGS.items():
        if issue in members:
            return tag
    return ""


class LegalIssueExtractor:
    def __init__(self, llm=None, cfg=None):
        self.llm = llm
        self.cfg = cfg

    def extract(self, question: str) -> IssueResult:
        q = (question or "").strip()
        s = q.lower()
        signals = {"has_article_ref": has_article_ref(q)}

        issue = IssueType.OTHER
        for candidate, kws in ISSUE_RULES:
            if any(k.lower() in s for k in kws):
                issue = candidate
                break
        if issue is IssueType.OTHER:
            scores = {it: sum(1 for k in kws if k.lower() in s)
                      for it, kws in PART_RULES.items()}
            top, top_score = max(scores.items(), key=lambda x: x[1])
            if top_score > 0:
                issue = top

        tags: List[str] = []
        part = part_tag_of(issue)
        if part:
            tags.append(f"part:{part}")
        tags.append(f"issue:{issue.value}")
        if signals["has_article_ref"]:
            tags.append("article_ref")

        out = IssueResult(issue_type=issue, tags=tags,
                          explain=f"heuristic_issue_type={issue.value}",
                          signals=signals)
        if (self.llm is not None and self.cfg is not None
                and getattr(self.cfg.routing, "issue_llm_refine", False)):
            try:
                out = self._llm_refine(question, out)
            except Exception:
                pass
        return out

    def _llm_refine(self, question: str, base: IssueResult) -> IssueResult:
        sys_msg = ("Classify the user question into a civil-law issue type. "
                   "Return ONLY JSON with keys: issue_type, tags. issue_type "
                   f"must be one of: {[e.value for e in IssueType]}.")
        raw = self.llm.chat(
            [{"role": "system", "content": sys_msg},
             {"role": "user", "content": json.dumps(
                 {"question": question, "heuristic": dump(base)},
                 ensure_ascii=False, default=str)}],
            tag="issue_refine")
        obj = json.loads(extract_json(raw))
        t = str(obj.get("issue_type", "")).strip()
        if t in {e.value for e in IssueType}:
            base.issue_type = IssueType(t)
        tags = obj.get("tags")
        if isinstance(tags, list):
            base.tags = [str(x) for x in tags if str(x)]
        base.explain = (base.explain + "; llm_refine_ok").strip("; ")
        return base


def extract_json(text: str) -> str:
    t = (text or "").strip()
    start, end = t.find("{"), t.rfind("}")
    if start >= 0 and end > start:
        return t[start:end + 1]
    return "{}"
