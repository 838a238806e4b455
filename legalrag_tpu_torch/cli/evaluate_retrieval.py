"""CLI: retrieval-quality evaluation across systems (port of
``scripts/evaluate_retrieval.py:35-164``).

Loads ``data/eval/law_qa.jsonl`` records ``{query, article_id[, lang]}``,
runs each system over each language's bundle and law graph, and reports
Hit@{3,10} / R@{5,10} / MRR@10 / nDCG@10 means (and, with more than one
language, per language), with optional JSON and CSV export in the JAX
script's format. The bundles load on ``--device``: ``cuda`` by default
(which raises without a card), ``cpu`` when asked.

Systems: bm25 | dense | colbert (``HybridRetriever``'s channel APIs) |
fused (``FusedQueryEngine.search_hits``, the map-mode fused program) |
fused+graph (``HybridRetriever.search`` in ``GRAPH_AUGMENTED`` mode with
rerank off) | hybrid (the full search with rerank). Every system reaches
score+select and MaxSim on the card.

Usage: python -m legalrag_tpu_torch.cli.evaluate_retrieval [--config F]
       [--eval-file F] [--systems S,...] [--k 20] [--limit N]
       [--out-json F] [--out-csv F] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from legalrag_tpu_torch.config import AppConfig
from legalrag_tpu_torch.evals import aggregate, evaluate_one
from legalrag_tpu_torch.graph import LawGraphStore
from legalrag_tpu_torch.index.bundle import IndexBundle
from legalrag_tpu_torch.retrieval.engine import FusedQueryEngine
from legalrag_tpu_torch.retrieval.hybrid import HybridRetriever
from legalrag_tpu_torch.schemas import (
    IssueType,
    RetrievalHit,
    RoutingDecision,
    RoutingMode,
    TaskType,
)
from legalrag_tpu_torch.utils import detect_lang, get_logger
from legalrag_tpu_torch.utils.device import DeviceLike, resolve_device

log = get_logger("torch.cli.evaluate_retrieval")

SYSTEMS = ("bm25", "dense", "colbert", "fused", "fused+graph", "hybrid")
METRICS = ("recall@5", "recall@10", "mrr@10", "ndcg@10", "hit@3", "hit@10")
HEADERS = ("R@5", "R@10", "MRR@10", "nDCG@10", "Hit@3", "Hit@10")


def load_eval_set(path: Path) -> List[dict]:
    rows = []
    with path.open("r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append(json.loads(line))
    return rows


def by_language(rows: Sequence[dict]) -> Dict[str, List[dict]]:
    out: Dict[str, list] = defaultdict(list)
    for r in rows:
        out[r.get("lang") or detect_lang(r["query"])].append(r)
    return out


def graph_decision() -> RoutingDecision:
    return RoutingDecision(task_type=TaskType.JUDGE_STYLE,
                           issue_type=IssueType.OTHER,
                           mode=RoutingMode.GRAPH_AUGMENTED)


def system_hits(system: str, question: str, hybrid: HybridRetriever,
                engine: FusedQueryEngine, k: int) -> List[RetrievalHit]:
    """The hits that ``run_system`` ranks (its scores kept, for the
    near-tie checks of a twin)."""
    if system == "bm25":
        return hybrid.search_bm25(question, k)
    if system == "dense":
        return hybrid.search_dense(question, k)
    if system == "colbert":
        return hybrid.search_colbert(question, k)
    if system == "fused":
        return engine.search_hits([question], k)[0]
    if system == "fused+graph":
        rerank = hybrid.cfg.retrieval.enable_rerank
        hybrid.cfg.retrieval.enable_rerank = False
        try:
            return hybrid.search(question, top_k=k, decision=graph_decision())
        finally:
            hybrid.cfg.retrieval.enable_rerank = rerank
    # hybrid (full)
    return hybrid.search(question, top_k=k, decision=graph_decision())


def run_system(system: str, question: str, hybrid: HybridRetriever,
               engine: FusedQueryEngine, k: int) -> List[str]:
    return [h.chunk.article_id
            for h in system_hits(system, question, hybrid, engine, k)]


def open_language(cfg: AppConfig, lang: str, device: DeviceLike = None
                  ) -> Tuple[HybridRetriever, FusedQueryEngine]:
    """The saved bundle and law graph of ``lang`` as (hybrid retriever,
    fused engine)."""
    lang_cfg = cfg.with_lang(lang)
    bundle = IndexBundle.load(lang_cfg.paths.lang_index_dir, lang_cfg, lang,
                              device)
    graph = LawGraphStore(lang_cfg.paths.graph_file)
    return (HybridRetriever(bundle, lang_cfg, graph_store=graph),
            FusedQueryEngine(bundle, lang_cfg))


def evaluate(by_lang: Dict[str, List[dict]], systems: Sequence[str], k: int,
             retrievers) -> Tuple[Dict[str, List[dict]], Dict[tuple, List[dict]]]:
    """Per-query metrics of every system, overall and by (system, lang);
    ``retrievers(lang)`` gives that language's (hybrid, engine). A system
    that raises on a query is logged and skipped, as in the JAX script."""
    results: Dict[str, List[dict]] = defaultdict(list)
    results_lang: Dict[tuple, List[dict]] = defaultdict(list)
    for lang, lang_rows in sorted(by_lang.items()):
        hybrid, engine = retrievers(lang)
        log.info("[%s] evaluating %d queries over %d docs", lang,
                 len(lang_rows), hybrid.bundle.n_docs)
        for i, row in enumerate(lang_rows):
            gold = str(row["article_id"])
            for system in systems:
                try:
                    ranked = run_system(system, row["query"], hybrid, engine, k)
                    m = evaluate_one(ranked, gold)
                    results[system].append(m)
                    results_lang[(system, lang)].append(m)
                except Exception as e:
                    log.warning("[%s] %s failed on %r: %s", lang, system,
                                row["query"][:40], e)
            if (i + 1) % 25 == 0:
                log.info("[%s] %d/%d", lang, i + 1, len(lang_rows))
    return results, results_lang


def table(results, results_lang, systems: Sequence[str],
          langs: Sequence[str]) -> List[str]:
    """The JAX script's printed table: the header, each system's means
    and, with more than one language, each language's block."""
    summary = {s: aggregate(results[s]) for s in systems if results[s]}
    lines = [f"{'system':<13}" + "".join(f"{m:>10}" for m in HEADERS)]
    for s in systems:
        if s in summary:
            lines.append(f"{s:<13}" + "".join(
                f"{summary[s][m]['mean']:>10.3f}" for m in METRICS))
    if len(langs) > 1:
        for lang in sorted(langs):
            lines.append(f"-- {lang} --")
            for s in systems:
                agg = aggregate(results_lang.get((s, lang), []))
                if agg:
                    lines.append(f"{s:<13}" + "".join(
                        f"{agg[m]['mean']:>10.3f}" for m in METRICS))
    return lines


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--eval-file", default=None)
    ap.add_argument("--systems", default=",".join(SYSTEMS))
    ap.add_argument("--k", type=int, default=20)
    ap.add_argument("--limit", type=int, default=0)
    ap.add_argument("--out-json", default=None)
    ap.add_argument("--out-csv", default=None)
    ap.add_argument("--config", default=None,
                    help="config overlay JSON/YAML (e.g. a tuned-fusion "
                    "overlay)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="torch device the bundles load on")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = AppConfig.load(args.config)
    eval_path = Path(args.eval_file or Path(cfg.paths.eval_dir) / "law_qa.jsonl")
    if not eval_path.exists():
        log.error("eval set not found: %s", eval_path)
        sys.exit(1)
    rows = load_eval_set(eval_path)
    if args.limit:
        rows = rows[: args.limit]
    systems = [s for s in args.systems.split(",") if s]
    by_lang = by_language(rows)
    results, results_lang = evaluate(
        by_lang, systems, args.k, lambda lang: open_language(cfg, lang, device))
    for line in table(results, results_lang, systems, list(by_lang)):
        print(line)

    summary = {s: aggregate(results[s]) for s in systems if results[s]}
    if args.out_json:
        Path(args.out_json).write_text(json.dumps(summary, indent=2),
                                       encoding="utf-8")
    if args.out_csv:
        lines = ["system," + ",".join(METRICS)]
        for s in systems:
            if s in summary:
                lines.append(s + "," + ",".join(
                    f"{summary[s][m]['mean']:.4f}" for m in METRICS))
        Path(args.out_csv).write_text("\n".join(lines), encoding="utf-8")


if __name__ == "__main__":
    main()
