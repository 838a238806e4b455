"""CLI: mine graph-bridged semantic eval / training pairs (port of
``scripts/mine_semantic_pairs.py:37-91``). Host code.

Reads each language's law graph and processed corpus and writes
broken-lexical-overlap (query, gold) pairs:

  data/eval/semantic_{lang}.jsonl        all pairs
  data/eval/semantic_{lang}_train.jsonl  training split (by gold article)
  data/eval/semantic_{lang}_held.jsonl   held-out split

The held split is a drop-in ``--eval-file`` for
``legalrag_tpu_torch.cli.evaluate_retrieval``. See
``legalrag_tpu_torch/evals/semantic_pairs.py`` for the mining rules.

Usage: python -m legalrag_tpu_torch.cli.mine_semantic_pairs [--config F]
       [--lang zh] [--max-overlap 0.35]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import List, Optional

from legalrag_tpu_torch.config import AppConfig
from legalrag_tpu_torch.corpus import load_chunks_from_dir
from legalrag_tpu_torch.evals.semantic_pairs import (
    build_stops,
    corrupt_pairs,
    mine_pairs,
    split_by_gold,
)
from legalrag_tpu_torch.graph.store import LawGraphStore
from legalrag_tpu_torch.utils import get_logger

log = get_logger("torch.cli.mine_semantic_pairs")


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default=None)
    ap.add_argument("--lang", default=None, help="one language (default both)")
    ap.add_argument("--max-overlap", type=float, default=0.35)
    ap.add_argument("--corrupt-overlap", type=float, default=0.45,
                    help="overlap cap for the synonym-corruption generator "
                    "(volume source; graph pairs keep --max-overlap)")
    ap.add_argument("--per-article", type=int, default=3,
                    help="synonym pairs per article")
    ap.add_argument("--max-per-gold", type=int, default=4)
    ap.add_argument("--holdout", type=float, default=0.4)
    ap.add_argument("--seed", type=int, default=3)
    args = ap.parse_args(argv)

    cfg = AppConfig.load(args.config)
    langs = [args.lang] if args.lang else ["zh", "en"]
    for lang in langs:
        lang_cfg = cfg.with_lang(lang)
        chunks = [c for c in load_chunks_from_dir(lang_cfg.paths.processed_dir)
                  if (c.lang or lang) == lang]
        store = LawGraphStore(lang_cfg.paths.graph_file)
        store.load()
        stops = build_stops(chunks, lang)
        rows = mine_pairs(chunks, store.adj, lang,
                          max_overlap=args.max_overlap,
                          max_per_gold=args.max_per_gold, stops=stops)
        syn = corrupt_pairs(chunks, lang, n=10 ** 9, seed=args.seed,
                            max_overlap=args.corrupt_overlap,
                            per_article=args.per_article, stops=stops)
        seen = {r["query"] for r in rows}
        rows += [r for r in syn if r["query"] not in seen]
        if not rows:
            log.warning("[%s] no pairs mined", lang)
            continue
        train, held = split_by_gold(rows, args.holdout, args.seed)
        out_dir = Path(lang_cfg.paths.eval_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        for name, subset in (("", rows), ("_train", train), ("_held", held)):
            p = out_dir / f"semantic_{lang}{name}.jsonl"
            with p.open("w", encoding="utf-8") as f:
                for r in subset:
                    f.write(json.dumps(r, ensure_ascii=False) + "\n")
            log.info("[%s] wrote %d rows -> %s", lang, len(subset), p)
        print(json.dumps({
            "lang": lang, "pairs": len(rows), "train": len(train),
            "held": len(held),
            "mean_overlap": round(sum(r["overlap"] for r in rows)
                                  / len(rows), 3),
            "by_rel": {rel: sum(1 for r in rows if r["rel"] == rel)
                       for rel in sorted({r['rel'] for r in rows})},
        }, ensure_ascii=False))


if __name__ == "__main__":
    main()
