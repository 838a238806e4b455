"""Graph-mined semantic (broken-lexical-overlap) query/gold pairs (port of
``legalrag_tpu/evals/semantic_pairs.py``, host code; the same chunks,
graph and seed give the same rows, in the same order).

- ``cite`` edges: the sentence around 第N条 in a citing article describes
  the cited rule in other words; with the citation stripped, its only
  route to the gold article is semantic.
- ``defined_by`` edges: a sentence using a defined term, with gold = the
  defining article.
- term templates ("什么是X" / 'what does "X" mean') -> defining article.

Every pair carries its measured token overlap with its gold article and
the miner enforces ``max_overlap``. ``corrupt_pairs`` swaps statutory
terms for the query register (Python ``random`` with a seed);
``split_by_gold`` splits by gold article (numpy's generator).
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence

from legalrag_tpu_torch.schemas import LawChunk
from legalrag_tpu_torch.tokenize import tokenize
from legalrag_tpu_torch.utils import get_logger

log = get_logger("torch.semantic_pairs")

# citation surface forms to strip from query text (zh numerals or digits,
# en §/Section refs) — same families as generate_synthetic_data
_ZH_CITE = re.compile(
    r"(本法|依照|根据|适用|参照)?第[零一二三四五六七八九十百千万两〇\d]+条"
    r"(至第[零一二三四五六七八九十百千万两〇\d]+条)?(的规定)?")
_EN_CITE = re.compile(
    r"(§+\s*[\dA-Za-z.\-()]+|[Ss]ections?\s+[\dA-Za-z.\-()]+"
    r"|[Aa]rticles?\s+[\dA-Za-z.\-()]+)")
_SENT_SPLIT = re.compile(r"[。；！？\n]|(?<=[.;!?])\s")


def _sentences(text: str) -> List[str]:
    return [s.strip() for s in _SENT_SPLIT.split(text or "") if s.strip()]


def strip_refs(text: str) -> str:
    return _EN_CITE.sub(" ", _ZH_CITE.sub("", text)).strip(" ，,、；;:：")


def build_stops(chunks: Sequence[LawChunk], lang: str,
                df_frac: float = 0.15) -> frozenset:
    """Tokens occurring in more than ``df_frac`` of articles. These are the
    function/boilerplate words BM25's IDF already nulls out — overlap on
    them is not a lexical route to the GOLD article, so the overlap metric
    excludes them."""
    from collections import Counter

    df: Counter = Counter()
    for c in chunks:
        df.update(set(tokenize(c.text or "", lang)))
    cut = max(2, int(len(chunks) * df_frac))
    return frozenset(t for t, n in df.items() if n > cut)


def token_overlap(query: str, gold_text: str, lang: str,
                  stops: frozenset = frozenset()) -> float:
    """Fraction of the query's CONTENT tokens (tokens not in ``stops``)
    that also occur in the gold article — the IDF-weighted lexical route a
    BoW retriever could exploit."""
    q = [t for t in tokenize(query, lang) if t not in stops]
    if not q:
        return 1.0
    g = set(tokenize(gold_text, lang))
    return sum(1 for t in q if t in g) / len(q)


def _quality(q: str, lang: str) -> bool:
    lo, hi = (8, 160) if lang == "zh" else (20, 300)
    if not (lo <= len(q) <= hi):
        return False
    if _ZH_CITE.search(q) or _EN_CITE.search(q):
        return False
    return True


def mine_pairs(chunks: Sequence[LawChunk], adj: Dict[str, list],
               lang: str, max_overlap: float = 0.35,
               max_per_gold: int = 4,
               stops: Optional[frozenset] = None) -> List[Dict]:
    """``adj``: graph adjacency {src: [(dst, relation, conf, evidence)]}
    (``LawGraphStore.adj``). Returns eval rows
    ``{query, article_id, lang, rel, overlap}`` sorted by gold id."""
    if stops is None:
        stops = build_stops(chunks, lang)
    by_id = {c.article_id: c for c in chunks}
    rows: List[Dict] = []
    n_gold: Dict[str, int] = {}

    def add(query: str, gold: str, rel: str) -> None:
        query = re.sub(r"\s+", " ", query).strip()
        gold_c = by_id.get(gold)
        if gold_c is None or not _quality(query, lang):
            return
        if n_gold.get(gold, 0) >= max_per_gold:
            return
        ov = token_overlap(query, gold_c.text, lang, stops)
        if ov > max_overlap:
            return
        n_gold[gold] = n_gold.get(gold, 0) + 1
        rows.append({"query": query, "article_id": gold, "lang": lang,
                     "rel": rel, "overlap": round(ov, 3)})

    for src, edges in adj.items():
        src_c = by_id.get(src)
        if src_c is None:
            continue
        sents = _sentences(src_c.text)
        for dst, rel, conf, ev in edges:
            if rel == "cite":
                # the sentence carrying the citation, reference stripped
                ev_text = (ev or {}).get("text") or ""
                for s in sents:
                    if ev_text and ev_text in s:
                        add(strip_refs(s), dst, "cite")
                        break
            elif rel == "defined_by":
                # src USES the term; gold = the defining article (dst)
                term = (ev or {}).get("term") or ""
                if not term:
                    continue
                for s in sents:
                    if term in s:
                        add(strip_refs(s), dst, "defined_by")
                        break
            elif rel == "defines_term":
                term = (ev or {}).get("term") or ""
                if term and len(term) >= (2 if lang == "zh" else 4):
                    q = (f"什么是{term}？其范围如何界定" if lang == "zh"
                         else f'what does "{term}" mean and what does it '
                              f"cover")
                    # gold is the DEFINING article itself here (src)
                    add(q, src, "term_template")

    # dedup identical queries (a sentence may carry several citations —
    # keep the first gold; multi-gold queries would poison training)
    seen: Dict[str, int] = {}
    out: List[Dict] = []
    for r in rows:
        key = r["query"]
        if key in seen:
            continue
        seen[key] = 1
        out.append(r)
    out.sort(key=lambda r: (str(r["article_id"]), r["rel"], r["query"]))
    log.info("[%s] mined %d semantic pairs (%d golds, mean overlap %.3f)",
             lang, len(out), len({r['article_id'] for r in out}),
             sum(r["overlap"] for r in out) / max(len(out), 1))
    return out


# ---------------------------------------------------------------------------
# Corruption generator: synonym / colloquialism swaps over extractive spans.
# The graph yields high-quality but FEW pairs; training needs volume. Each
# swap replaces a statutory term with a query-side synonym or colloquialism
# (the register real users type — the LLM-paraphrase setting of the
# reference's notebook 03 eval), then residual overlapping tokens are
# dropped until the measured overlap clears ``max_overlap``.

ZH_SYNONYMS = {
    "人民法院": "法院", "未成年人": "未满十八周岁的人", "诉讼时效": "起诉期限",
    "建筑物": "楼房", "机动车": "汽车", "监护人": "照护责任人",
    "承租人": "租客", "出租人": "房东", "债权人": "债主", "债务人": "负债一方",
    "保证人": "担保人", "所有权": "产权", "当事人": "双方", "书面": "文字",
    "合同": "契约", "买卖": "购销", "应当": "必须", "不得": "禁止",
    "可以": "能够", "损害": "损失", "赔偿": "偿付", "支付": "给付",
    "房屋": "住房", "租赁": "出租", "抚养": "养育", "赡养": "奉养",
    "继承": "承继", "占有": "持有", "违约": "不履行约定", "利息": "利钱",
    "诉讼": "打官司", "撤销": "取消", "无效": "不发生效力", "侵害": "侵犯",
    "许可": "同意", "抵押": "按揭", "婚姻": "夫妻关系", "离婚": "解除婚姻",
    "定金": "订金", "自然人": "个人", "第三人": "他人", "不动产": "房产土地",
    "动产": "可移动财产", "物权": "财产权利", "转让": "让与", "设立": "创设",
    "登记": "备案", "期限": "时间限制", "补偿": "弥补", "消灭": "归于终结",
    "善意": "不知情", "恶意": "明知故犯", "共有": "共同拥有",
    "份额": "比例", "孳息": "收益", "约定": "商定", "履行": "兑现",
    "解除": "终结", "通知": "告知", "标的物": "交易物品", "价款": "货款",
    "质量": "品质", "交付": "移交", "毁损": "毁坏", "灭失": "丢失",
    "返还": "归还", "请求": "要求", "承担": "负担", "责任": "后果",
    "权利": "权益", "义务": "责任义项", "收益": "获利", "使用": "利用",
    "禁止": "严禁", "终止": "停止", "变更": "更改", "担保": "作保",
    "清偿": "还清", "受让人": "接手一方", "抵销": "冲抵", "委托": "托付",
    "代理": "代办", "追偿": "索回", "过错": "过失", "遗产": "身后财产",
    "配偶": "另一半", "子女": "孩子", "父母": "爸妈", "收养": "领养",
}
EN_PHRASES = {
    "security interest": "collateral right",
    "good faith": "honest dealing",
}
EN_SYNONYMS = {
    "buyer": "purchaser", "seller": "vendor", "goods": "merchandise",
    "contract": "agreement", "lease": "rental", "lessee": "tenant",
    "lessor": "owner", "payment": "remittance", "pay": "remit",
    "price": "cost", "delivery": "handover", "deliver": "hand over",
    "breach": "violation", "remedy": "relief", "damages": "compensation",
    "debtor": "borrower", "creditor": "lender", "obligation": "duty",
    "notice": "notification", "notify": "inform", "writing": "written form",
    "signed": "executed", "instrument": "document", "warranty": "guarantee",
    "merchant": "trader", "bank": "financial institution",
    "reasonable": "fair", "receive": "obtain", "received": "obtained",
}
_EN_SYN_RX = re.compile(
    r"\b(" + "|".join(sorted(EN_SYNONYMS, key=len, reverse=True)) + r")\b",
    re.IGNORECASE)
_ZH_SYN_KEYS = sorted(ZH_SYNONYMS, key=len, reverse=True)


def apply_synonyms(text: str, lang: str) -> tuple:
    """(swapped text, n_swaps). One pass, longest term first — replacements
    are never re-substituted."""
    n = 0
    if lang == "zh":
        out = text
        for key in _ZH_SYN_KEYS:
            if key in out:
                out = out.replace(key, ZH_SYNONYMS[key])
                n += 1
        return out, n
    for ph, rep in EN_PHRASES.items():
        if ph in text.lower():
            text = re.sub(re.escape(ph), rep, text, flags=re.IGNORECASE)
            n += 1

    def sub(m):
        nonlocal n
        n += 1
        return EN_SYNONYMS[m.group(1).lower()]

    return _EN_SYN_RX.sub(sub, text), n


def corrupt_pairs(chunks: Sequence[LawChunk], lang: str, n: int, seed: int,
                  max_overlap: float = 0.35, min_swaps: int = 2,
                  per_article: int = 2,
                  stops: Optional[frozenset] = None) -> List[Dict]:
    """Synonym-corrupted extractive pairs: spans whose statutory vocabulary
    is swapped for the query register. Rows whose measured content-token
    overlap still exceeds ``max_overlap`` after the swaps are discarded
    (queries stay grammatical — no token shredding). Returns
    ``{query, article_id, lang, rel: "synonym", overlap, n_swaps}``."""
    import random

    if stops is None:
        stops = build_stops(chunks, lang)
    rng = random.Random(seed)
    rows: List[Dict] = []
    order = list(range(len(chunks)))
    rng.shuffle(order)
    for idx in order:
        c = chunks[idx]
        added = 0
        sents = [s for s in _sentences(strip_refs(c.text))
                 if (10 if lang == "zh" else 30) <= len(s) <= 240]
        rng.shuffle(sents)
        for s in sents:
            q, n_swaps = apply_synonyms(s, lang)
            if n_swaps < min_swaps:
                continue
            ov = token_overlap(q, c.text, lang, stops)
            if ov > max_overlap or not _quality(q, lang):
                continue
            rows.append({"query": q, "article_id": c.article_id,
                         "lang": lang, "rel": "synonym",
                         "overlap": round(ov, 3), "n_swaps": n_swaps})
            added += 1
            if added >= per_article:
                break
        if len(rows) >= n:
            break
    log.info("[%s] corrupted %d synonym pairs (mean overlap %.3f, "
             "mean swaps %.1f)", lang, len(rows),
             sum(r["overlap"] for r in rows) / max(len(rows), 1),
             sum(r["n_swaps"] for r in rows) / max(len(rows), 1))
    return rows


def split_by_gold(rows: List[Dict], holdout: float, seed: int):
    """Leakage-free split: all pairs sharing a gold article land on the
    same side."""
    import numpy as np

    golds = sorted({str(r["article_id"]) for r in rows})
    rng = np.random.default_rng(seed)
    rng.shuffle(golds)
    n_hold = int(len(golds) * holdout)
    held_golds = set(golds[:n_hold])
    train = [r for r in rows if str(r["article_id"]) not in held_golds]
    held = [r for r in rows if str(r["article_id"]) in held_golds]
    return train, held
