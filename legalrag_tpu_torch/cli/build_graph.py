"""CLI: the law graph of each language over the processed corpora (port of
``scripts/build_graph.py``). Host code.

Usage: python -m legalrag_tpu_torch.cli.build_graph [--config F] [--lang L]
"""

from __future__ import annotations

import argparse
from collections import defaultdict
from typing import List, Optional

from legalrag_tpu_torch.config import AppConfig
from legalrag_tpu_torch.corpus import load_chunks_from_dir
from legalrag_tpu_torch.graph import GraphBuilder
from legalrag_tpu_torch.utils import get_logger

log = get_logger("torch.cli.build_graph")


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default=None)
    ap.add_argument("--lang", default=None)
    args = ap.parse_args(argv)

    cfg = AppConfig.load(args.config)
    chunks = load_chunks_from_dir(cfg.paths.processed_dir)
    by_lang = defaultdict(list)
    for c in chunks:
        by_lang[c.lang or "zh"].append(c)
    for lang, lang_chunks in sorted(by_lang.items()):
        if args.lang and lang != args.lang:
            continue
        out = cfg.with_lang(lang).paths.graph_file
        GraphBuilder().build_to_file(lang_chunks, out)
        log.info("[%s] graph -> %s", lang, out)


if __name__ == "__main__":
    main()
