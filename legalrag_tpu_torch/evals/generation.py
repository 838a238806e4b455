"""Generation-quality evaluation: answers, not just retrieval (port of
``legalrag_tpu/evals/generation.py``, host code; the same answer and hits
give the same numbers, exactly).

Per item and in aggregate:

- **citation precision**: of the statute refs the answer cites, the
  fraction supported by the retrieved hits (``pipeline/citations.py``
  ``verify_citations``, the guardrail serving attaches to every answer).
- **citation recall**: whether the gold article for the query is cited
  *and* supported.
- **faithfulness proxy**: fraction of answer sentences lexically
  entailed by some retrieved provision (zh character-bigram / en word
  containment >= ``tau``); a real judge plugs in via ``judge=`` (any
  callable ``(question, answer, provisions) -> float in [0, 1]``).
- **schema validity**: for JSON-task answers, whether the text parses
  as JSON and carries the required keys (the constrained-decoding
  contract of ``models/constrain.py``).

``extractive_answer`` is the deterministic answerer (quote the top
provisions, conclusion first), a provider whose citations are verifiable.
"""

from __future__ import annotations

import json
import re
from typing import Callable, Dict, List, Optional, Sequence

from legalrag_tpu_torch.pipeline.citations import verify_citations
from legalrag_tpu_torch.schemas import RetrievalHit

Judge = Callable[[str, str, List[str]], float]

_ZH_SENT = re.compile(r"[^。；！？\n]+")
_EN_SENT = re.compile(r"[^.;!?\n]+")
_EN_WORD = re.compile(r"[A-Za-z0-9§-]+")


def split_sentences(text: str, lang: str) -> List[str]:
    """Answer text → scoring units (zh: 。；！？-delimited; en: .;!?)."""
    pat = _ZH_SENT if lang == "zh" else _EN_SENT
    return [s.strip() for s in pat.findall(text) if len(s.strip()) >= 4]


def _features(text: str, lang: str) -> set:
    if lang == "zh":
        # character bigrams over CJK + digits (word boundaries don't
        # exist in zh; bigrams are the standard cheap proxy)
        chars = [c for c in text if c.strip() and not c.isspace()]
        return {a + b for a, b in zip(chars, chars[1:])}
    return {w.lower() for w in _EN_WORD.findall(text) if len(w) > 2}


def sentence_supported(sentence: str, provisions: Sequence[str],
                       lang: str, tau: float = 0.5) -> bool:
    """Containment test: ≥ ``tau`` of the sentence's features appear in
    some single provision (containment, not symmetric Jaccard — the
    provision is much longer than the sentence)."""
    f = _features(sentence, lang)
    if not f:
        return True  # punctuation-only / numeric scraps don't count against
    for prov in provisions:
        p = _features(prov, lang)
        if len(f & p) / len(f) >= tau:
            return True
    return False


def faithfulness(answer: str, hits: Sequence[RetrievalHit], lang: str,
                 tau: float = 0.5) -> Dict[str, float]:
    """Sentence-level support rate of the answer against the hits."""
    provisions = [h.chunk.text for h in hits]
    sents = split_sentences(answer, lang)
    if not sents:
        return {"supported_sentences": 0, "total_sentences": 0,
                "support_rate": 0.0}
    n_sup = sum(sentence_supported(s, provisions, lang, tau)
                for s in sents)
    return {"supported_sentences": n_sup, "total_sentences": len(sents),
            "support_rate": n_sup / len(sents)}


def schema_validity(answer: str,
                    required_keys: Sequence[str] = ()) -> bool:
    """Does the answer parse as a JSON object with the required keys?
    (The ``models/constrain.py`` contract: constrained streams are valid
    by construction; unconstrained ones measurably are not.)"""
    try:
        doc = json.loads(answer)
    except Exception:
        return False
    if not isinstance(doc, dict):
        return False
    return all(k in doc for k in required_keys)


# ---------------------------------------------------------------------------
# first-party extractive answerer (deterministic, zero-model provider)

def extractive_answer(question: str, hits: Sequence[RetrievalHit],
                      lang: str, max_provisions: int = 3) -> str:
    """Conclusion-first answer quoting the top provisions with refs in
    the exact formats ``pipeline/citations.py`` extracts (zh ``第N条``,
    en ``§ A-S``), so its citations are verifiable end-to-end."""
    top = list(hits)[:max_provisions]
    if not top:
        return ("结论：未检索到相关条文。" if lang == "zh"
                else "Conclusion: no relevant provisions retrieved.")
    if lang == "zh":
        refs = "、".join(f"《{h.chunk.law_name}》第{h.chunk.article_id}条"
                         for h in top)
        body = "\n".join(
            f"第{h.chunk.article_id}条：{h.chunk.text}" for h in top)
        return f"结论：本问题适用{refs}。\n依据：\n{body}"
    refs = ", ".join(f"§ {h.chunk.article_id}" for h in top)
    body = "\n".join(f"§ {h.chunk.article_id}: {h.chunk.text}"
                     for h in top)
    return (f"Conclusion: the question is governed by {refs}.\n"
            f"Authority:\n{body}")


# ---------------------------------------------------------------------------
# per-item + aggregate

def evaluate_answer(question: str, answer: str,
                    hits: Sequence[RetrievalHit], gold_id: Optional[str],
                    lang: str, tau: float = 0.5,
                    judge: Optional[Judge] = None) -> Dict:
    """Score one (question, answer, hits) triple; ``gold_id`` is the
    article id that answers the question (None skips recall)."""
    cites = verify_citations(answer, hits)
    n_sup, n_unsup = len(cites["supported"]), len(cites["unsupported"])
    n_refs = n_sup + n_unsup
    out: Dict = {
        "n_refs": n_refs,
        "citation_precision": (n_sup / n_refs) if n_refs else None,
        "cites_anything": n_refs > 0,
    }
    if gold_id is not None:
        sup_ids = {c["article_id"] for c in cites["supported"]}
        sup_refs = {c["ref"] for c in cites["supported"]}
        out["citation_recall"] = float(str(gold_id) in sup_ids
                                       or str(gold_id) in sup_refs)
    out.update(faithfulness(answer, hits, lang, tau))
    if judge is not None:
        out["judge_score"] = float(judge(
            question, answer, [h.chunk.text for h in hits]))
    return out


def aggregate_generation(items: List[Dict]) -> Dict[str, float]:
    """Mean every numeric field over the items (None-aware)."""
    keys = {k for it in items for k, v in it.items()
            if isinstance(v, (int, float, bool)) or v is None}
    out: Dict[str, float] = {"n": len(items)}
    for k in sorted(keys):
        vals = [float(it[k]) for it in items
                if it.get(k) is not None
                and isinstance(it[k], (int, float, bool))]
        if vals:
            out[k] = sum(vals) / len(vals)
    return out
