"""Law-graph construction (port of ``legalrag_tpu/graph/builder.py``, pure
Python: the same chunks give the same file, byte for byte).

Behavioral parity with the reference ``GraphBuilder``
(``graph_builder.py:201-478``), re-implemented for this framework:

- pass 1: ``prev``/``next`` edges over article-sorted order (conf 1.0);
  zh citation edges 第X条 (0.90) and ranges 第X条至/到第Y条 (0.95, range cap
  200), bidirectional ``cite``/``cited``; en Section/Article/§/range
  citations (0.85); definition extraction — zh 所称X是指 strong 0.95 /
  bare X是指 weak 0.60, en quoted "X" means 0.95 / bare 0.70, with
  stopword lists.
- pass 2: ``defined_by``/``defines_term`` edges wherever a strongly-defined
  term (conf ≥ 0.8) appears in another article, budget 10 per node; term
  length ≥ 4 chars ⇒ conf 0.90 else 0.85.
- budgets: cite 20 / defined_by 10 / total 60 edges per node; duplicate
  (dst, relation) edges keep max conf.
- output: one JSON node per line {article_id, article_no, law_name, title,
  chapter, section, neighbors, meta.defines_terms}; atomic tmp+replace.
"""

from __future__ import annotations

import json
import os
import re
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from legalrag_tpu_torch.corpus.preprocess import cn_numeral_to_int
from legalrag_tpu_torch.schemas import LawChunk
from legalrag_tpu_torch.utils import detect_lang, get_logger

log = get_logger("torch.graph.builder")

_ZH_ARTICLE = re.compile(r"第\s*([0-9一二三四五六七八九十百千万两〇零]+)\s*条")
_ZH_RANGE = re.compile(
    r"第\s*([0-9一二三四五六七八九十百千万两〇零]+)\s*条\s*(?:至|到)\s*"
    r"第\s*([0-9一二三四五六七八九十百千万两〇零]+)\s*条")
_ZH_DEFINE_STRONG = re.compile(
    r"(?:本法|本章|本节|本编|本条)?\s*所称\s*([^，。；:：\n]{1,30})\s*(?:[，,:：]\s*)?是指")
# the PRC Civil Code phrases definitions as 所称X，包括… (never 是指 — measured
# on the corpus); the reference's 是指-only patterns extract zero zh
# definitions there. Additional strong pattern, conf 0.90.
_ZH_DEFINE_INCLUDE = re.compile(r"所称\s*([^，。；:：\n“”]{1,20})\s*[，,]\s*包括")
_ZH_DEFINE_WEAK = re.compile(r"([^，。；:：\n]{2,30})\s*是指")
_ZH_STOP = {"本法", "本章", "本节", "本编", "本条", "当事人", "合同", "法律", "规定",
            "行为", "权利", "义务", "应当", "可以", "不得", "人民法院", "国家",
            "组织", "单位"}

# Ranges: "Sections 10 to 15", "§§ 20-25", "Article 5 through 9". A plain
# hyphen after a single §/Section is a UCC section id (§ 1-102), NOT a range
# — only word separators, the en-dash, or a doubled §§ mark a true range.
# (The reference's broader regex is harmless there only because its en
# reference keys never resolve, graph_builder.py:335.)
_EN_RANGE = re.compile(
    r"(Sections?|Sec\.?|§§|Articles?|Art\.?)\s+(\d+)\s*(–|to|through|-)\s*(\d+)",
    re.IGNORECASE)
_EN_SECTION_CITE = re.compile(
    r"(?:Section|Sec\.)\s+(\d+[A-Za-z]?-\d+[A-Za-z]?(?:\.\d+)?|\d+(?:\.\d+)*)",
    re.IGNORECASE)
_EN_PARA_CITE = re.compile(r"§\s*(\d+[A-Za-z]?(?:-\d+[A-Za-z]?)*)")
_EN_ARTICLE_CITE = re.compile(r"(?:Article)\s+(\d+[A-Za-z]?)", re.IGNORECASE)
_EN_DEF_QUOTED = re.compile(r"[“\"]\s*([^”\"]{1,60}?)\s*[”\"]\s*(?:means|shall mean)\b",
                            re.IGNORECASE)
_EN_DEF_BARE = re.compile(r"\b([A-Z][A-Za-z0-9\- ]{1,40})\s+(?:means|shall mean)\b")
_EN_STOP = {"Agreement", "Party", "Parties", "Law", "Regulation", "Court",
            "State", "Company"}

_ZH_CN_TO_INT = cn_numeral_to_int


def _zh_num(s: str) -> Optional[int]:
    s = (s or "").replace("〇", "零").strip()
    return _ZH_CN_TO_INT(s)


class _Adjacency:
    """Edge accumulator with per-node budgets and max-conf dedup (parity:
    reference ``_safe_add``, ``graph_builder.py:168-194``)."""

    def __init__(self) -> None:
        self.adj: Dict[str, List[dict]] = {}

    def add(self, src: str, dst: str, relation: str, conf: float,
            evidence: Optional[dict], max_per_node: int) -> bool:
        """Returns True iff a NEW edge was appended (dedup upgrades and
        budget rejections return False) — pass-2 budgets count distinct
        edges, not containment attempts, so a node mentioning many defined
        terms that dedup to one target doesn't starve its real edges."""
        if not src or not dst or src == dst:
            return False
        edges = self.adj.setdefault(src, [])
        if len(edges) >= max_per_node:
            return False
        for e in edges:
            if e["article_id"] == dst and e["relation"] == relation:
                if e.get("conf", 0.0) < conf:
                    e["conf"] = float(conf)
                    if evidence:
                        e["evidence"] = evidence
                return False
        edge = {"article_id": dst, "relation": relation, "conf": float(conf)}
        if evidence:
            edge["evidence"] = evidence
        edges.append(edge)
        return True


class GraphBuilder:
    def __init__(self, max_cite: int = 20, max_def: int = 10, max_total: int = 60,
                 range_cap: int = 200):
        self.max_cite = max_cite
        self.max_def = max_def
        self.max_total = max_total
        self.range_cap = range_cap

    # ------------------------------------------------------------------
    def build_nodes(self, chunks: Sequence[LawChunk]) -> List[dict]:
        chunks = sorted(chunks, key=self._sort_key)
        ref2id = self._reference_keys(chunks)
        adj = _Adjacency()
        term2def: Dict[str, str] = {}
        def2terms: Dict[str, List[str]] = {}

        for i, c in enumerate(chunks):
            aid = c.article_id
            if i > 0:
                adj.add(aid, chunks[i - 1].article_id, "prev", 1.0, None,
                        self.max_total)
            if i + 1 < len(chunks):
                adj.add(aid, chunks[i + 1].article_id, "next", 1.0, None,
                        self.max_total)
            text = c.text or ""
            if not text.strip():
                continue
            lang = detect_lang(text)
            if lang == "zh":
                self._zh_citations(aid, text, ref2id, adj)
            else:
                self._en_citations(aid, text, ref2id, adj)
            defs = self._definitions(text, lang)
            if defs:
                best: Dict[str, float] = {}
                for t, cf in defs:
                    best[t] = max(best.get(t, 0.0), cf)
                def2terms[aid] = sorted(best, key=len, reverse=True)
                for t, cf in best.items():
                    if cf >= 0.8 and t not in term2def:
                        term2def[t] = aid

        # pass 2: term usage edges (en containment is case-insensitive — the
        # reference's case-sensitive check misses lowercase uses of
        # capitalized defined terms; documented divergence)
        if term2def:
            terms = sorted(term2def, key=len, reverse=True)
            for c in chunks:
                aid = c.article_id
                text = c.text or ""
                text_cf = text.casefold()
                added = 0
                for term in terms:
                    def_id = term2def[term]
                    if def_id == aid or term.casefold() not in text_cf:
                        continue
                    conf = 0.90 if len(term) >= 4 else 0.85
                    if adj.add(aid, def_id, "defined_by", conf,
                               {"term": term}, self.max_def):
                        added += 1
                    adj.add(def_id, aid, "defines_term", conf, {"term": term},
                            self.max_def)
                    if added >= self.max_def:
                        break

        nodes = []
        for c in chunks:
            nodes.append({
                "article_id": c.article_id,
                "article_no": c.article_no,
                "law_name": c.law_name,
                "title": None,
                "chapter": c.chapter,
                "section": c.section,
                "neighbors": adj.adj.get(c.article_id, []),
                "meta": {"defines_terms": def2terms.get(c.article_id, []),
                         "lang": c.lang},
            })
        return nodes

    def build_to_file(self, chunks: Sequence[LawChunk], out_path: str | Path) -> Path:
        out_path = Path(out_path)
        out_path.parent.mkdir(parents=True, exist_ok=True)
        tmp = out_path.with_suffix(".tmp")
        with tmp.open("w", encoding="utf-8") as f:
            for node in self.build_nodes(chunks):
                f.write(json.dumps(node, ensure_ascii=False) + "\n")
        os.replace(tmp, out_path)
        log.info("built law graph: %d nodes -> %s", len(chunks), out_path)
        return out_path

    # ------------------------------------------------------------------
    @staticmethod
    def _sort_key(c: LawChunk):
        try:
            return (0, int(c.article_id), "")
        except (TypeError, ValueError):
            return (1, 0, str(c.article_id))

    @staticmethod
    def _reference_keys(chunks: Sequence[LawChunk]) -> Dict[str, str]:
        """article references → article_id: bare id, 第N条, en section keys."""
        ref2id: Dict[str, str] = {}
        for c in chunks:
            aid = c.article_id
            ref2id[aid] = aid
            try:
                ref2id[f"第{int(aid)}条"] = aid
            except ValueError:
                pass
            ano = re.sub(r"\s+", "", c.article_no or "")
            if ano.startswith("第") and ano.endswith("条"):
                ref2id[ano] = aid
                n = _zh_num(ano[1:-1])
                if n is not None:
                    ref2id[f"第{n}条"] = aid
            if c.lang == "en":
                # "2-201" and the bare section number within its article file
                ref2id.setdefault(aid, aid)
        return ref2id

    def _zh_citations(self, aid: str, text: str, ref2id: Dict[str, str],
                      adj: _Adjacency) -> None:
        for m in _ZH_RANGE.finditer(text):
            na, nb = _zh_num(m.group(1)), _zh_num(m.group(2))
            if na is None or nb is None:
                continue
            lo, hi = min(na, nb), max(na, nb)
            if hi - lo > self.range_cap:
                continue
            ev = {"span": [m.start(), m.end()], "text": m.group(0)}
            for num in range(lo, hi + 1):
                dst = ref2id.get(f"第{num}条")
                if dst:
                    adj.add(aid, dst, "cite", 0.95, ev, self.max_cite)
                    adj.add(dst, aid, "cited", 0.95, ev, self.max_cite)
        for m in _ZH_ARTICLE.finditer(text):
            n = _zh_num(m.group(1))
            if n is None:
                continue
            dst = ref2id.get(f"第{n}条")
            if dst:
                ev = {"span": [m.start(), m.end()], "text": m.group(0)}
                adj.add(aid, dst, "cite", 0.90, ev, self.max_cite)
                adj.add(dst, aid, "cited", 0.90, ev, self.max_cite)

    def _en_citations(self, aid: str, text: str, ref2id: Dict[str, str],
                      adj: _Adjacency) -> None:
        def cite(dst_key: str, m: re.Match, conf: float = 0.85) -> None:
            dst = ref2id.get(dst_key)
            if dst:
                ev = {"span": [m.start(), m.end()], "text": m.group(0)}
                adj.add(aid, dst, "cite", conf, ev, self.max_cite)
                adj.add(dst, aid, "cited", conf, ev, self.max_cite)

        article_prefix = aid.split("-")[0] if "-" in aid else ""
        for m in _EN_RANGE.finditer(text):
            marker, sep = m.group(1), m.group(3)
            if sep == "-" and marker.rstrip(".").lower() in ("sec", "section", "article", "art"):
                continue  # "§ 1-102"-style id reached via the singular marker
            lo, hi = sorted((int(m.group(2)), int(m.group(4))))
            if hi - lo > self.range_cap:
                continue
            for num in range(lo, hi + 1):
                cite(f"{article_prefix}-{num}" if article_prefix else str(num), m)
        for m in _EN_SECTION_CITE.finditer(text):
            key = m.group(1)
            cite(key, m)
            if "-" not in key and article_prefix:
                cite(f"{article_prefix}-{key}", m)
        for m in _EN_PARA_CITE.finditer(text):
            cite(m.group(1), m)
        for m in _EN_ARTICLE_CITE.finditer(text):
            cite(m.group(1), m)

    @staticmethod
    def _definitions(text: str, lang: str) -> List[Tuple[str, float]]:
        defs: List[Tuple[str, float]] = []
        if lang == "zh":
            for m in _ZH_DEFINE_STRONG.finditer(text):
                term = re.sub(r"\s+", "", m.group(1) or "")
                if 2 <= len(term) <= 20 and term not in _ZH_STOP:
                    defs.append((term, 0.95))
            for m in _ZH_DEFINE_INCLUDE.finditer(text):
                term = re.sub(r"\s+", "", m.group(1) or "")
                if 2 <= len(term) <= 20 and term not in _ZH_STOP:
                    defs.append((term, 0.90))
            for m in _ZH_DEFINE_WEAK.finditer(text):
                term = re.sub(r"\s+", "", m.group(1) or "")
                if 2 <= len(term) <= 12 and term not in _ZH_STOP:
                    defs.append((term, 0.60))
        else:
            for m in _EN_DEF_QUOTED.finditer(text):
                term = (m.group(1) or "").strip()
                if 2 <= len(term) <= 50 and term not in _EN_STOP:
                    defs.append((term, 0.95))
            for m in _EN_DEF_BARE.finditer(text):
                term = (m.group(1) or "").strip()
                if 2 <= len(term) <= 40 and term not in _EN_STOP:
                    defs.append((term, 0.70))
        return defs
