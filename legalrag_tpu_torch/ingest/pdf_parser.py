"""PDF / document text extraction (port of
``legalrag_tpu/ingest/pdf_parser.py``).

The extraction ladder: plain-text payloads (``.txt``/``.text``/``.md``) are
decoded as UTF-8; a PDF goes to docling (when enabled and installed), then
pdfplumber's per-page text with an OCR fallback for empty pages
(pytesseract + pdf2image, when enabled and installed), or a layout-aware
reconstruction from word boxes with repeated headers/footers dropped,
chosen when it keeps at least 60% of the raw length; without pdfplumber,
the first-party extractor (``ingest/minipdf.py``). ``trim_law_body``
NFKC-normalizes the text and cuts a table-of-contents prefix.

Every heavy extractor is an optional import, as in the JAX package; a PDF
from which no rung recovers text raises ``RuntimeError``.
"""

from __future__ import annotations

import re
import unicodedata
from collections import Counter
from pathlib import Path
from typing import List, Optional

from legalrag_tpu_torch.utils import get_logger

log = get_logger("torch.pdf.parser")


def extract_text(path: str | Path, *, enable_ocr: bool = False,
                 enable_docling: bool = False) -> str:
    """Extraction ladder; raises RuntimeError when no extractor can run."""
    path = Path(path)
    if path.suffix.lower() in (".txt", ".text", ".md"):
        return path.read_bytes().decode("utf-8", "replace")
    if enable_docling:
        text = _try_docling(path)
        if text:
            return text
    return _extract_pdf(path, enable_ocr=enable_ocr)


def _try_docling(path: Path) -> Optional[str]:
    try:
        from docling.document_converter import DocumentConverter  # type: ignore
    except ImportError:
        return None
    try:
        result = DocumentConverter().convert(str(path))
        return result.document.export_to_markdown()
    except Exception as e:
        log.warning("docling failed on %s: %s", path.name, e)
        return None


def _extract_pdf(path: Path, *, enable_ocr: bool) -> str:
    try:
        import pdfplumber  # type: ignore
    except ImportError:
        # last rung: the first-party pure-Python extractor (Flate/raw
        # text streams + ToUnicode CMaps)
        from legalrag_tpu_torch.ingest.minipdf import extract_pdf_text

        text = extract_pdf_text(path.read_bytes())
        if text.strip():
            log.info("extracted %s via minipdf (%d chars)", path.name,
                     len(text))
            return text
        raise RuntimeError(
            "PDF extraction failed: pdfplumber is not installed and the "
            "built-in extractor found no decodable text streams "
            "(image-only/encrypted PDF?); upload plain-text instead")
    pages: List[str] = []
    layout_pages: List[List[str]] = []
    with pdfplumber.open(str(path)) as pdf:
        for page in pdf.pages:
            text = page.extract_text() or ""
            if not text.strip() and enable_ocr:
                text = _ocr_page(path, page.page_number)
            pages.append(text)
            try:
                words = page.extract_words() or []
            except Exception:
                words = []
            lines = _lines_from_words(words)
            if not lines and text.strip():
                # no word boxes (OCR'd / image page): keep the raw lines so
                # the layout path never silently drops recovered content
                lines = [l for l in text.splitlines() if l.strip()]
            layout_pages.append(lines)
    raw = "\n".join(pages)
    layout = _layout_text(layout_pages)
    if layout and len(layout) >= 0.6 * len(raw):
        return layout
    return raw


def _ocr_page(path: Path, page_number: int) -> str:
    try:
        import pytesseract  # type: ignore
        from pdf2image import convert_from_path  # type: ignore
    except ImportError:
        return ""
    try:
        images = convert_from_path(str(path), first_page=page_number,
                                   last_page=page_number)
        return "\n".join(pytesseract.image_to_string(im, lang="chi_sim+eng")
                         for im in images)
    except Exception as e:
        log.warning("OCR failed on %s p%d: %s", path.name, page_number, e)
        return ""


def _lines_from_words(words: List[dict]) -> List[str]:
    """Reconstruct reading-order lines from word boxes (y-bucketed)."""
    rows: dict = {}
    for w in words:
        key = round(float(w.get("top", 0)) / 3)
        rows.setdefault(key, []).append(w)
    lines = []
    for key in sorted(rows):
        ws = sorted(rows[key], key=lambda w: float(w.get("x0", 0)))
        lines.append(" ".join(str(w.get("text", "")) for w in ws))
    return lines


def _layout_text(pages: List[List[str]]) -> str:
    """Join layout lines across pages, dropping repeated headers/footers
    (normalized lines recurring on ≥30% of pages) and bare page numbers."""
    if not any(pages):
        return ""
    n_pages = max(1, sum(1 for p in pages if p))
    freq: Counter = Counter()
    for lines in pages:
        for line in set(_norm_line(l) for l in lines[:2] + lines[-2:] if l.strip()):
            freq[line] += 1
    repeated = {l for l, c in freq.items() if c >= 0.3 * n_pages and c > 1}
    out: List[str] = []
    for lines in pages:
        for i, line in enumerate(lines):
            norm = _norm_line(line)
            if not norm:
                continue
            if (i < 2 or i >= len(lines) - 2) and norm in repeated:
                continue
            if re.fullmatch(r"[-—\s]*\d{1,4}[-—\s]*", line.strip()):
                continue
            out.append(line)
    return "\n".join(out)


def _norm_line(line: str) -> str:
    return re.sub(r"[\s\d]+", "", line).strip().lower()


# --------------------------------------------------------------------------
_TOC_MARK = re.compile(r"^目\s*录\s*$", re.MULTILINE)
_FIRST_ZH_ARTICLE = re.compile(r"^第[一二三四五六七八九十百千万零]+条", re.MULTILINE)


def trim_law_body(text: str) -> str:
    """NFKC-normalize; cut a 目录 (TOC) prefix when the body restarts after
    it; cut trailing non-article footer after the last article's paragraph
    (reference ``parser.py:45-192``)."""
    text = unicodedata.normalize("NFKC", text or "")
    toc = _TOC_MARK.search(text)
    if toc:
        articles = list(_FIRST_ZH_ARTICLE.finditer(text, toc.end()))
        if articles:
            # body begins at the last heading run before the first article
            text = text[articles[0].start():]
    return text.strip()
