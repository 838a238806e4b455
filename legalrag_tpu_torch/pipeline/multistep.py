"""Multistep pipeline: decompose -> retrieve per sub-question -> synthesize
(port of ``legalrag_tpu/pipeline/multistep.py:25-95``, host code over the
port's ``RagPipeline``).

A complex question (several issues joined by conjunctions, or explicitly
multi-part) decomposes into sub-questions: through the LLM, as strict
JSON, when the client is not degraded, else (or when that gives nothing)
by the conjunction-splitting heuristic. Each sub-question retrieves on its
own (one channels call: score+select and MaxSim on the card), the hits
merge with ``dedup_keep_best``, and one synthesis prompt answers over the
merged context, framed with the numbered sub-questions.
"""

from __future__ import annotations

import json
import re
from typing import List, Tuple

from legalrag_tpu_torch.pipeline.rag_pipeline import RagPipeline
from legalrag_tpu_torch.retrieval.hybrid import dedup_keep_best
from legalrag_tpu_torch.routing.issue_extractor import extract_json
from legalrag_tpu_torch.schemas import RagAnswer, RetrievalHit
from legalrag_tpu_torch.utils import get_logger, has_chinese

log = get_logger("torch.multistep")

_ZH_SPLIT = re.compile(r"[；;]|？(?!$)|，(?=(?:另外|同时|以及|还有|其次))")
_CONJ_ZH = re.compile(r"(?:另外|同时|以及|还有|其次|并且)[，,]?")
_EN_SPLIT = re.compile(r"[;?](?!$)|\band also\b|\bin addition\b", re.IGNORECASE)

DECOMPOSE_PROMPT = (
    "Decompose the legal question into at most {max_steps} independent "
    "sub-questions, each answerable from statutes alone. Return STRICT "
    'JSON: {{"sub_questions": ["...", "..."]}}. If the question is already '
    "atomic, return it as the single element.\nQuestion: {question}"
)


class MultistepPipeline:
    def __init__(self, pipeline: RagPipeline, max_steps: int = 4,
                 per_step_top_k: int = 5):
        self.pipeline = pipeline
        self.max_steps = max_steps
        self.per_step_top_k = per_step_top_k

    # ------------------------------------------------------------ decompose
    def decompose(self, question: str, llm=None) -> List[str]:
        client = llm or self.pipeline.llm
        if client is not None and not getattr(client, "is_degraded", True):
            try:
                raw = client.chat(
                    [{"role": "user", "content": DECOMPOSE_PROMPT.format(
                        max_steps=self.max_steps, question=question)}],
                    tag="decompose")
                subs = json.loads(extract_json(raw)).get("sub_questions", [])
                subs = [str(s).strip() for s in subs if str(s).strip()]
                if subs:
                    return subs[: self.max_steps]
            except Exception as e:
                log.warning("llm decompose failed (%s); heuristic split", e)
        return self._heuristic_split(question)

    def _heuristic_split(self, question: str) -> List[str]:
        splitter = _ZH_SPLIT if has_chinese(question) else _EN_SPLIT
        parts = [p.strip(" ，,") for p in splitter.split(question)]
        parts = [_CONJ_ZH.sub("", p).strip() for p in parts
                 if p and len(p.strip()) >= 6]
        return parts[: self.max_steps] if len(parts) > 1 else [question]

    # --------------------------------------------------------------- answer
    def retrieve_multi(self, question: str
                       ) -> Tuple[List[str], List[List[RetrievalHit]]]:
        subs = self.decompose(question)
        all_hits = []
        for sub in subs:
            hits, _decision = self.pipeline.retrieve(sub,
                                                     top_k=self.per_step_top_k)
            all_hits.append(hits)
        return subs, all_hits

    def answer_complex(self, question: str) -> RagAnswer:
        subs, per_step = self.retrieve_multi(question)
        merged = dedup_keep_best([h for hits in per_step for h in hits])
        if len(subs) > 1:
            zh = has_chinese(question)
            label = "子问题" if zh else "Sub-question"
            preamble = "\n".join(f"{label} {i + 1}: {s}"
                                 for i, s in enumerate(subs))
            framed = (f"{question}\n\n（已分解为：\n{preamble}\n请逐一回答后综合。）"
                      if zh else
                      f"{question}\n\n(Decomposed into:\n{preamble}\n"
                      f"Answer each, then synthesize.)")
        else:
            framed = question
        ans = self.pipeline.answer_from_hits(framed, merged)
        return RagAnswer(question=question, answer=ans.answer, hits=merged)
