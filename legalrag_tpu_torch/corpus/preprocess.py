"""Statute text → per-article LawChunk records.

Behavioral parity with the reference preprocessing stage
(``scripts/preprocess_law.py``): a zh state machine over 编/分编/章/节
headings and 第X条 articles with Chinese-numeral normalization
(``preprocess_law.py:17-50,317-389``), an en ``§ N-NNN`` UCC section parser
(``preprocess_law.py:280-315``), and a scan-mode fallback that slices running
text on article markers while rejecting citation-context matches such as
本法第X条 (``preprocess_law.py:427-476``). ``parse_auto`` picks line- vs
scan-mode by yield (``preprocess_law.py:513-523``).

All functions are pure and host-side; output records feed the index builders.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from legalrag_tpu_torch.schemas import LawChunk
from legalrag_tpu_torch.utils.lang import detect_lang

# ---------------------------------------------------------------------------
# Chinese numerals

_CN_DIGITS = {"零": 0, "一": 1, "二": 2, "两": 2, "三": 3, "四": 4,
              "五": 5, "六": 6, "七": 7, "八": 8, "九": 9}
_CN_UNITS = {"十": 10, "百": 100, "千": 1000, "万": 10000}


def cn_numeral_to_int(s: str) -> Optional[int]:
    """Convert a Chinese numeral (e.g. 一千二百六十) to an int.

    Handles the leading-十 idiom (十五 = 15) and bare digits; returns None on
    anything unparseable. Parity: reference ``normalize_article_no``
    (``preprocess_law.py:17-50``).
    """
    s = s.strip()
    if not s:
        return None
    if s.isdigit():
        return int(s)
    total = 0
    section = 0  # value below the current 万-block
    num = 0
    for ch in s:
        if ch in _CN_DIGITS:
            num = _CN_DIGITS[ch]
        elif ch in _CN_UNITS:
            unit = _CN_UNITS[ch]
            if unit == 10000:
                section = (section + (num if num else 0)) * 10000
                total += section
                section = 0
                num = 0
            else:
                if num == 0:
                    num = 1  # 十五 → 15
                section += num * unit
                num = 0
        else:
            return None
    return total + section + num


def normalize_article_no(article_no: str, lang: str = "zh") -> Optional[str]:
    """Normalize a raw article marker to its canonical id.

    zh: ``第一千二百六十条`` → ``"1260"``; en: ``§ 2-201`` → ``"2-201"``.
    """
    if lang == "zh":
        m = re.search(r"第([零一二两三四五六七八九十百千万\d]+)条", article_no)
        if not m:
            return None
        v = cn_numeral_to_int(m.group(1))
        return str(v) if v is not None else None
    m = re.search(r"(\d+[A-Za-z]?)[-–—](\d+[A-Za-z]?(?:\.\d+)?)", article_no)
    if m:
        return f"{m.group(1)}-{m.group(2)}"
    m = re.search(r"(\d+)", article_no)
    return m.group(1) if m else None


# ---------------------------------------------------------------------------
# Record type

@dataclass
class ArticleRecord:
    law_name: str
    article_no: str       # raw marker, e.g. 第一条 / § 1-101
    article_id: str       # normalized, e.g. "1" / "1-101"
    text: str
    lang: str
    chapter: Optional[str] = None
    section: Optional[str] = None
    source: Optional[str] = None
    start_char: Optional[int] = None
    end_char: Optional[int] = None
    title: Optional[str] = None
    extra: Dict[str, str] = field(default_factory=dict)

    def to_chunk(self) -> LawChunk:
        return LawChunk(
            id=f"{self.lang}:{_slug(self.law_name)}:{self.article_id}",
            law_name=self.law_name,
            chapter=self.chapter,
            section=self.section,
            article_no=self.article_no,
            article_id=self.article_id,
            text=self.text,
            lang=self.lang,
            source=self.source,
            start_char=self.start_char,
            end_char=self.end_char,
        )


def _slug(name: str) -> str:
    s = re.sub(r"[^\w一-鿿]+", "_", name.strip())
    return s.strip("_") or "law"


# ---------------------------------------------------------------------------
# zh line parser

_ZH_BOOK = re.compile(r"^第[零一二两三四五六七八九十百千\d]+编")        # 编 (book)
_ZH_SUBBOOK = re.compile(r"^第[零一二两三四五六七八九十百千\d]+分编")   # 分编 (sub-book)
_ZH_CHAPTER = re.compile(r"^第[零一二两三四五六七八九十百千\d]+章")     # 章 (chapter)
_ZH_SECTION = re.compile(r"^第[零一二两三四五六七八九十百千\d]+节")     # 节 (section)
_ZH_ARTICLE = re.compile(r"^(第[零一二两三四五六七八九十百千万\d]+条)")  # 条 (article)
# citation context that must NOT open a new article in scan mode
# (covers 本法第X条 / 依照第X条 / 第X条至第Y条 / 根据…第X条 etc.)
_ZH_CITE_PREFIX = re.compile(r"[本该前依照据用和、与及至法款项定]$")


def _clean_heading(line: str) -> str:
    return re.sub(r"[\s　]+", " ", line.strip())


def parse_zh_lines(text: str, law_name: str = "中华人民共和国民法典",
                   source: Optional[str] = None) -> List[ArticleRecord]:
    """Parse line-structured zh statute text into per-article records.

    State machine over 编/分编/章/节 headings; a 目录 (table of contents)
    prefix is skipped by only *entering* article mode after the first article
    marker that begins a line with body text following its marker. Heading
    lines inside the TOC repeat later in the body, so chapter/section state is
    simply overwritten as lines stream through.
    """
    lines = text.splitlines()
    records: List[ArticleRecord] = []
    book = subbook = chapter = section = None
    cur_no: Optional[str] = None
    cur_parts: List[str] = []
    cur_start = 0
    pos = 0
    # Detect end of TOC: the body restarts with the first 编/章 heading after
    # an initial heading-only run. Simplest robust rule (matches reference
    # yield-based selection): articles only exist in the body, so everything
    # keys off article markers; TOC lines contain no article markers.

    def flush(end_pos: int) -> None:
        nonlocal cur_no, cur_parts
        if cur_no is None:
            return
        body = "\n".join(cur_parts).strip()
        aid = normalize_article_no(cur_no, "zh")
        if body and aid is not None:
            chap = _compose(book, subbook, chapter)
            records.append(ArticleRecord(
                law_name=law_name, article_no=cur_no, article_id=aid,
                text=f"{cur_no}　{body}" if not body.startswith(cur_no) else body,
                lang="zh", chapter=chap, section=section, source=source,
                start_char=cur_start, end_char=end_pos))
        cur_no, cur_parts = None, []

    for raw_line in lines:
        line = raw_line.strip().replace("　", " ").strip()
        line_start = pos
        pos += len(raw_line) + 1
        if not line:
            continue
        if _ZH_SUBBOOK.match(line):
            flush(line_start)
            subbook = _clean_heading(line)
            chapter = section = None
            continue
        if _ZH_BOOK.match(line):
            flush(line_start)
            book = _clean_heading(line)
            subbook = chapter = section = None
            continue
        if _ZH_CHAPTER.match(line):
            flush(line_start)
            chapter = _clean_heading(line)
            section = None
            continue
        if _ZH_SECTION.match(line):
            flush(line_start)
            section = _clean_heading(line)
            continue
        m = _ZH_ARTICLE.match(line)
        if m:
            flush(line_start)
            cur_no = m.group(1)
            cur_start = line_start
            rest = line[m.end():].lstrip(" 　")
            cur_parts = [rest] if rest else []
            continue
        if cur_no is not None:
            cur_parts.append(line)
    flush(pos)
    return _dedup_keep_last(records)


def _compose(*parts: Optional[str]) -> Optional[str]:
    vals = [p for p in parts if p]
    return " / ".join(vals) if vals else None


def _dedup_keep_last(records: List[ArticleRecord]) -> List[ArticleRecord]:
    """TOC or repeated markers can produce duplicate article_ids; the last
    occurrence (the body one, with text) wins. Order follows last occurrence
    of each id in document order."""
    by_id: Dict[str, ArticleRecord] = {}
    for r in records:
        prev = by_id.get(r.article_id)
        if prev is None or len(r.text) >= len(prev.text):
            by_id[r.article_id] = r
    return sorted(by_id.values(), key=lambda r: (r.start_char or 0))


# ---------------------------------------------------------------------------
# en UCC parser

_EN_SECTION = re.compile(r"^§\s*(\d+[A-Za-z]?-\d+[A-Za-z]?(?:\.\d+)?)\.?\s*")
_EN_PART = re.compile(r"^PART\s+(\d+[A-Za-z]?)\.?\s*(.*)$", re.IGNORECASE)
_EN_ARTICLE_HEAD = re.compile(r"^ARTICLE\s+(\d+[A-Za-z]?)\.?\s*(.*)$", re.IGNORECASE)


def parse_en_sections(text: str, law_name: str = "Uniform Commercial Code",
                      source: Optional[str] = None) -> List[ArticleRecord]:
    """Parse UCC-style text: ``§ N-NNN. Title. body...`` blocks grouped under
    PART / ARTICLE headings. A section runs until the next § line or heading."""
    lines = text.splitlines()
    records: List[ArticleRecord] = []
    part = article_head = None
    cur_id: Optional[str] = None
    cur_parts: List[str] = []
    cur_start = 0
    pos = 0

    def flush(end_pos: int) -> None:
        nonlocal cur_id, cur_parts
        if cur_id is None:
            return
        body = "\n".join(p for p in cur_parts if p).strip()
        if body:
            title_m = re.match(r"([^.]{1,120})\.", body)
            records.append(ArticleRecord(
                law_name=law_name, article_no=f"§ {cur_id}", article_id=cur_id,
                text=f"§ {cur_id}. {body}", lang="en",
                chapter=article_head, section=part, source=source,
                start_char=cur_start, end_char=end_pos,
                title=title_m.group(1).strip() if title_m else None))
        cur_id, cur_parts = None, []

    for raw_line in lines:
        line = raw_line.strip()
        line_start = pos
        pos += len(raw_line) + 1
        if not line:
            continue
        mp = _EN_PART.match(line)
        if mp and len(line) < 120:
            flush(line_start)
            part = line
            continue
        ma = _EN_ARTICLE_HEAD.match(line)
        if ma and len(line) < 120:
            flush(line_start)
            article_head = line
            part = None
            continue
        ms = _EN_SECTION.match(line)
        if ms:
            flush(line_start)
            cur_id = ms.group(1)
            cur_start = line_start
            rest = line[ms.end():]
            cur_parts = [rest] if rest else []
            continue
        if cur_id is not None:
            cur_parts.append(line)
    flush(pos)
    return _dedup_keep_last(records)


# ---------------------------------------------------------------------------
# scan fallback (broken line structure, e.g. PDF paste)

def parse_zh_scan_fallback(text: str, law_name: str,
                           source: Optional[str] = None) -> List[ArticleRecord]:
    """Slice running zh text on article markers regardless of line structure,
    rejecting markers preceded by citation context (本法第X条, 依照第X条…).
    Parity: reference ``parse_by_scan_fallback`` (``preprocess_law.py:427-476``).
    """
    marker = re.compile(r"第[零一二两三四五六七八九十百千万\d]+条")
    starts: List[Tuple[int, str]] = []
    for m in marker.finditer(text):
        prefix = text[max(0, m.start() - 2):m.start()]
        if prefix and _ZH_CITE_PREFIX.search(prefix):
            continue
        starts.append((m.start(), m.group(0)))
    records: List[ArticleRecord] = []
    for i, (start, no) in enumerate(starts):
        end = starts[i + 1][0] if i + 1 < len(starts) else len(text)
        body = text[start:end].strip()
        aid = normalize_article_no(no, "zh")
        if aid is None or len(body) <= len(no):
            continue
        records.append(ArticleRecord(
            law_name=law_name, article_no=no, article_id=aid, text=body,
            lang="zh", source=source, start_char=start, end_char=end))
    return _dedup_keep_last(records)


# ---------------------------------------------------------------------------
# entry point

def parse_auto(text: str, law_name: Optional[str] = None,
               source: Optional[str] = None) -> List[ArticleRecord]:
    """Detect language and structure; pick line vs scan parse by yield
    (parity: reference ``main()`` selection, ``preprocess_law.py:513-523``)."""
    lang = detect_lang(text)
    if lang == "en":
        return parse_en_sections(text, law_name or "Uniform Commercial Code", source)
    name = law_name or _guess_zh_law_name(text) or "法律文本"
    by_lines = parse_zh_lines(text, name, source)
    by_scan = parse_zh_scan_fallback(text, name, source)
    return by_lines if len(by_lines) >= len(by_scan) * 0.8 else by_scan


def _guess_zh_law_name(text: str) -> Optional[str]:
    for line in text.splitlines()[:10]:
        line = line.strip()
        if line and ("法" in line or "条例" in line) and len(line) < 40:
            return line
    return None
