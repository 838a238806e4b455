"""CLI: the case-law index of one language (port of
``scripts/build_case_index.py``).

Reads a cases JSONL (``CaseEntry`` lines; by default
``raw_dir/cases_<lang>.jsonl``), builds a ``CaseRetriever`` on
``--device`` (``cuda`` by default, which raises without a card; ``cpu``
when asked) and saves it to ``index_dir/<lang>`` (``cases.jsonl``,
``case_dense.npz``, ``case_bm25.npz``, ``case_encoder.npz``, in the JAX
package's formats). With no corpus at the path it logs so and returns.

Usage: python -m legalrag_tpu_torch.cli.build_case_index [--config F]
       [--cases F] [--lang zh] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import List, Optional

from legalrag_tpu_torch.config import AppConfig
from legalrag_tpu_torch.retrieval.case_retriever import CaseRetriever
from legalrag_tpu_torch.utils import get_logger
from legalrag_tpu_torch.utils.device import resolve_device

log = get_logger("torch.cli.build_case_index")


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default=None)
    ap.add_argument("--cases", default=None,
                    help="cases JSONL (default: data/raw/cases_<lang>.jsonl)")
    ap.add_argument("--lang", default="zh")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="torch device the index is built on")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = AppConfig.load(args.config)
    path = Path(args.cases or Path(cfg.paths.raw_dir) / f"cases_{args.lang}.jsonl")
    if not path.exists():
        log.error("no case corpus at %s", path)
        return
    retriever = CaseRetriever.from_jsonl(path, cfg, args.lang, device)
    out = Path(cfg.paths.index_dir) / args.lang
    retriever.save(out)
    log.info("case index: %d cases -> %s", len(retriever.cases), out)


if __name__ == "__main__":
    main()
