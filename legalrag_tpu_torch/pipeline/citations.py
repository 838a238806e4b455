"""Citation verification: are the answer's article references supported?
(port of ``legalrag_tpu/pipeline/citations.py``)

After generation, every statute reference in the answer text (zh ``第X条``
with Chinese-numeral normalization, en ``§ N-NNN`` / ``Article N`` /
``Section N-NNN``) is checked against the retrieved hits' ``article_id``s.
The result is attached to ``RagAnswer.citations`` and sent as the SSE
``citations`` event before ``done``, so clients can flag unsupported
(hallucinated) citations without re-running retrieval.

Extraction uses the port's corpus parser's numeral normalization
(``corpus/preprocess.py:normalize_article_no``), so ``第一千零七十九条``
and ``第1079条`` agree with the index's ids.
"""

from __future__ import annotations

import re
from typing import Dict, List, Sequence

from legalrag_tpu_torch.corpus.preprocess import normalize_article_no
from legalrag_tpu_torch.schemas import RetrievalHit

_ZH_REF = re.compile(r"第[零一二两三四五六七八九十百千万\d]+条")
# en: "§ 2-201", "Section 2-201" (hyphen or typographic dash — the corpus
# normalizer accepts all three, corpus/preprocess.py), and bare
# "Article 9", which names a whole UCC article and is verified as a
# prefix of the hits' section ids
_EN_SEC = re.compile(r"(?:§|[Ss]ection)\s*(\d+[A-Za-z]?)[-–—](\d+[a-zA-Z]?)")
_EN_ART = re.compile(r"[Aa]rticle\s+(\d+[A-Za-z]?)\b")


def extract_article_refs(text: str) -> List[str]:
    """Normalized, order-preserving, deduplicated refs found in ``text``.

    en article-level refs are returned as ``Article N`` (section refs and
    zh article ids are bare)."""
    refs: List[str] = []
    for m in _ZH_REF.finditer(text):
        norm = normalize_article_no(m.group(0), "zh")
        if norm and norm not in refs:
            refs.append(norm)
    for m in _EN_SEC.finditer(text):
        ref = f"{m.group(1)}-{m.group(2)}"
        if ref not in refs:
            refs.append(ref)
    for m in _EN_ART.finditer(text):
        ref = f"Article {m.group(1)}"
        if ref not in refs:
            refs.append(ref)
    return refs


def verify_citations(text: str, hits: Sequence[RetrievalHit]) -> Dict:
    """Split the answer's references into supported / unsupported.

    A reference is *supported* when some retrieved hit's ``article_id``
    matches it exactly (zh numeric ids) or matches the en section key.
    Returns ``{"supported": [{"ref", "article_id", "rank"}...],
    "unsupported": [ref...]}`` — empty lists when the answer cites
    nothing, so callers can always read both keys.
    """
    by_id: Dict[str, RetrievalHit] = {}
    for h in hits:
        by_id.setdefault(str(h.chunk.article_id), h)
        # en canonical ids can carry article context ("2-201" vs "2A-201");
        # also index the bare article_no key if distinct
        key = normalize_article_no(h.chunk.article_no or "", h.chunk.lang)
        if key:
            by_id.setdefault(str(key), h)
    supported, unsupported = [], []
    for ref in extract_article_refs(text):
        hit = by_id.get(ref)
        if hit is None and ref.startswith("Article "):
            # article-level en ref: supported if any hit's section id
            # belongs to that article ("Article 2" ⊇ "2-201")
            art = ref.split(" ", 1)[1]
            hit = next((h for h in hits
                        if str(h.chunk.article_id).split("-")[0] == art),
                       None)
        if hit is not None:
            supported.append({"ref": ref,
                              "article_id": str(hit.chunk.article_id),
                              "rank": hit.rank})
        else:
            unsupported.append(ref)
    return {"supported": supported, "unsupported": unsupported}
