"""Document -> LawChunk records for online ingestion (port of
``legalrag_tpu/ingest/ingestor.py``; host code, the same output bytes).

- a stable ``doc_id = sha1(f"{name}|{sha1(text)[:12]}")[:16]`` over the
  extracted, trimmed text;
- statute parsing (``corpus.parse_auto``) behind a quality gate: enough
  records, enough of the text covered, few gaps in the article numbers, no
  record too long for the text; its chunks keep their article and get the
  id ``"{doc_id}:{article_id}"`` and the source ``"ingest:{doc_id}"``;
- otherwise the generic chunker: paragraphs split at sentence ends into
  ~``chunk_chars`` pieces that carry the last ``chunk_overlap`` characters
  over, each labelled by its first line (made unique with a `` (n)``
  suffix);
- the chunks written to ``processed/ingested_<doc_id>.jsonl``.
"""

from __future__ import annotations

import hashlib
import re
from pathlib import Path
from typing import List, Optional, Tuple

from legalrag_tpu_torch.config import AppConfig
from legalrag_tpu_torch.corpus import ArticleRecord, parse_auto, write_chunks_jsonl
from legalrag_tpu_torch.ingest.pdf_parser import extract_text, trim_law_body
from legalrag_tpu_torch.schemas import LawChunk
from legalrag_tpu_torch.utils import detect_lang, get_logger

log = get_logger("torch.ingestor")

_SENT_BOUND = re.compile(r"(?<=[。！？；.!?;])")


def compute_doc_id(name: str, text: str) -> str:
    th = hashlib.sha1(text.encode("utf-8")).hexdigest()[:12]
    return hashlib.sha1(f"{name}|{th}".encode("utf-8")).hexdigest()[:16]


class PDFIngestor:
    def __init__(self, cfg: AppConfig):
        self.cfg = cfg

    def ingest_file_to_jsonl(self, path: str | Path,
                             display_name: Optional[str] = None
                             ) -> Tuple[str, Path, List[LawChunk]]:
        """Extract -> parse or chunk -> write the JSONL: (doc_id, path,
        chunks). Raises ``ValueError`` when no text is left."""
        path = Path(path)
        name = display_name or path.name
        p = self.cfg.pdf
        text = extract_text(path, enable_ocr=p.enable_ocr,
                            enable_docling=p.enable_docling)
        text = trim_law_body(text)
        if not text.strip():
            raise ValueError(f"no extractable text in {name}")
        doc_id = compute_doc_id(name, text)
        chunks = self._to_chunks(text, name, doc_id)
        out = Path(self.cfg.paths.processed_dir) / f"ingested_{doc_id}.jsonl"
        write_chunks_jsonl(chunks, out)
        log.info("ingested %s -> %d chunks (%s)", name, len(chunks), out.name)
        return doc_id, out, chunks

    def _to_chunks(self, text: str, name: str, doc_id: str) -> List[LawChunk]:
        records = parse_auto(text, source=name)
        if self._statute_quality_ok(records, text):
            log.info("%s parsed as statute: %d articles", name, len(records))
            return [self._record_chunk(r, doc_id) for r in records]
        return self._generic_chunks(text, name, doc_id)

    def _statute_quality_ok(self, records: List[ArticleRecord],
                            text: str) -> bool:
        p = self.cfg.pdf
        if len(records) < p.min_statute_records:
            return False
        covered = sum(len(r.text) for r in records)
        if covered < p.statute_coverage_min * max(len(text), 1):
            return False
        nums = sorted(int(r.article_id) for r in records
                      if r.article_id.isdigit())
        if len(nums) >= 2:
            span = nums[-1] - nums[0] + 1
            if 1.0 - len(nums) / span > p.statute_gap_ratio_max:
                return False
        mean_len = covered / len(records)
        return mean_len <= p.statute_avg_len_ratio_max * max(len(text), 1)

    @staticmethod
    def _record_chunk(r: ArticleRecord, doc_id: str) -> LawChunk:
        chunk = r.to_chunk()
        chunk.id = f"{doc_id}:{chunk.article_id}"
        chunk.source = f"ingest:{doc_id}"
        return chunk

    def _generic_chunks(self, text: str, name: str, doc_id: str
                        ) -> List[LawChunk]:
        p = self.cfg.pdf
        lang = detect_lang(text)
        paragraphs = [b.strip() for b in re.split(r"\n\s*\n", text) if b.strip()]
        pieces: List[str] = []
        buf = ""
        for para in paragraphs:
            for sent in _SENT_BOUND.split(para):
                if not sent:
                    continue
                if len(buf) + len(sent) > p.chunk_chars and buf:
                    pieces.append(buf)
                    buf = buf[-p.chunk_overlap:] if p.chunk_overlap else ""
                buf += sent
            buf += "\n"
        if buf.strip():
            pieces.append(buf)
        chunks: List[LawChunk] = []
        seen_labels: dict = {}
        pos = 0
        for i, piece in enumerate(pieces, start=1):
            piece = piece.strip()
            label = self._label_of(piece, i, seen_labels)
            chunks.append(LawChunk(
                id=f"{doc_id}:{i}", law_name=name, article_no=label,
                article_id=f"{doc_id}-{i}", text=piece, lang=lang,
                source=f"ingest:{doc_id}", start_char=pos,
                end_char=pos + len(piece)))
            pos += len(piece)
        return chunks

    @staticmethod
    def _label_of(piece: str, idx: int, seen: dict) -> str:
        head = piece.splitlines()[0][:30].strip() or f"chunk-{idx}"
        n = seen.get(head, 0) + 1
        seen[head] = n
        return head if n == 1 else f"{head} ({n})"
