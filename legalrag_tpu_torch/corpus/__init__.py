from legalrag_tpu_torch.corpus.loader import (
    iter_chunks_from_file,
    load_chunks_from_dir,
    write_chunks_jsonl,
)
from legalrag_tpu_torch.corpus.preprocess import (
    ArticleRecord,
    cn_numeral_to_int,
    normalize_article_no,
    parse_auto,
    parse_en_sections,
    parse_zh_lines,
    parse_zh_scan_fallback,
)

__all__ = [
    "ArticleRecord", "cn_numeral_to_int", "normalize_article_no", "parse_auto",
    "parse_en_sections", "parse_zh_lines", "parse_zh_scan_fallback",
    "iter_chunks_from_file", "load_chunks_from_dir", "write_chunks_jsonl",
]
