"""CLI: raw statute text -> per-language processed JSONL corpora (port of
``scripts/preprocess_law.py``).

Walks the raw ``.txt`` files in name order, parses each (``parse_auto``:
the line parser or the scan fallback, by what the text holds), splits the
records by language and writes ``processed/law_{lang}.jsonl``. Host code.

Usage: python -m legalrag_tpu_torch.cli.preprocess_law [--config F]
       [--raw-dir D] [--out-dir D]
"""

from __future__ import annotations

import argparse
from collections import defaultdict
from pathlib import Path
from typing import List, Optional

from legalrag_tpu_torch.config import AppConfig
from legalrag_tpu_torch.corpus import parse_auto, write_chunks_jsonl
from legalrag_tpu_torch.utils import get_logger

log = get_logger("torch.cli.preprocess_law")


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default=None)
    ap.add_argument("--raw-dir", default=None)
    ap.add_argument("--out-dir", default=None)
    args = ap.parse_args(argv)

    cfg = AppConfig.load(args.config)
    raw_dir = Path(args.raw_dir or cfg.paths.raw_dir)
    out_dir = Path(args.out_dir or cfg.paths.processed_dir)

    by_lang = defaultdict(list)
    txt_files = sorted(raw_dir.rglob("*.txt"))
    if not txt_files:
        log.warning("no raw .txt files under %s", raw_dir)
    for path in txt_files:
        text = path.read_text(encoding="utf-8", errors="replace")
        if not text.strip():
            continue
        records = parse_auto(text, source=path.name)
        log.info("%s: %d articles", path.name, len(records))
        for rec in records:
            by_lang[rec.lang].append(rec.to_chunk())

    for lang, chunks in sorted(by_lang.items()):
        out = out_dir / f"law_{lang}.jsonl"
        n = write_chunks_jsonl(chunks, out)
        log.info("wrote %d chunks -> %s", n, out)


if __name__ == "__main__":
    main()
