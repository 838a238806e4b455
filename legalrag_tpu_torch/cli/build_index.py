"""CLI: processed corpora -> per-language index bundles (port of
``scripts/build_index.py``).

Loads every processed chunk (``load_chunks_from_dir``), groups them by
language and builds each language's bundle (dense, BM25 and, unless
``--no-colbert``, the token store) on ``--device``: ``cuda`` by default
(without a card that raises), ``cpu`` when asked. The encoder is the
config's, as in JAX: ``retrieval.embedding_backend`` "hash", or "bert"
with ``retrieval.embedding_model_zh`` / ``_en`` and the query
instructions. The JAX script builds on
the CPU to avoid one XLA compile per shape; nothing compiles per shape
here. The bundle goes to ``index/<lang>/``, or with ``--index-version V``
to ``index/<lang>/versions/V/``, which ``--activate`` makes the active
version (``index/registry.py``).

Usage: python -m legalrag_tpu_torch.cli.build_index [--config F]
       [--lang L] [--no-colbert] [--index-version V] [--activate]
       [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import time
from collections import defaultdict
from pathlib import Path
from typing import List, Optional

from legalrag_tpu_torch.config import AppConfig
from legalrag_tpu_torch.corpus import load_chunks_from_dir
from legalrag_tpu_torch.index.bundle import IndexBundle
from legalrag_tpu_torch.index.registry import IndexRegistry
from legalrag_tpu_torch.utils import get_logger
from legalrag_tpu_torch.utils.device import resolve_device

log = get_logger("torch.cli.build_index")


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default=None)
    ap.add_argument("--lang", default=None, help="build only this language")
    ap.add_argument("--no-colbert", action="store_true")
    ap.add_argument("--index-version", default=None)
    ap.add_argument("--activate", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="torch device the bundles are built on")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = AppConfig.load(args.config)
    if args.no_colbert:
        cfg.retrieval.enable_colbert = False

    chunks = load_chunks_from_dir(cfg.paths.processed_dir)
    by_lang = defaultdict(list)
    for c in chunks:
        by_lang[c.lang or "zh"].append(c)
    if not by_lang:
        log.warning("no processed chunks under %s: run "
                    "legalrag_tpu_torch.cli.preprocess_law first",
                    cfg.paths.processed_dir)
        return

    for lang, lang_chunks in sorted(by_lang.items()):
        if args.lang and lang != args.lang:
            continue
        t0 = time.time()
        log.info("[%s] building index over %d chunks on %s", lang,
                 len(lang_chunks), device)
        bundle = IndexBundle.build_from_chunks(lang_chunks, cfg, lang,
                                               device=device)
        root = Path(cfg.paths.index_dir) / lang
        if args.index_version:
            out = IndexRegistry(root).versions_root() / args.index_version
        else:
            out = root
        bundle.save(out)
        if args.index_version and args.activate:
            IndexRegistry(root).activate(args.index_version)
            log.info("[%s] activated version %s", lang, args.index_version)
        log.info("[%s] done in %.1fs", lang, time.time() - t0)


if __name__ == "__main__":
    main()
