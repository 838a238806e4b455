"""CLI: contrastive encoder adaptation on the device mesh (port of
``scripts/train_encoder.py``).

Fine-tunes the hash encoder's projection head with in-batch-negative
InfoNCE over (query, gold article) pairs, split over the ``(data, model)``
mesh (``parallel/training.py``): extractive queries from the bundle's
articles by default (``evals/synthetic.py``), or ``--pairs`` /
``--eval-pairs`` files of ``cli/mine_semantic_pairs.py``. The held-out
dense Recall@10 is measured before training and after every epoch; the
best epoch's projection is kept. With ``--save`` a projection that does
not improve on the start is refused (exit 1); one that does is set on the
encoder, the dense rows are re-encoded, the generation moves on and the
bundle is saved in the format both packages load, so serving picks the
trained projection up.

With extractive pairs the held-out recall is not expected to improve (the
JAX script's measurement: the queries are lexical subsets of their
articles, which the untrained projection already serves), so ``--save``
exits 1 there; semantic pairs are where it gains.

The mesh is every card of ``--device cuda`` (the default): ``(1, n)``, or
``(2, n / 2)`` for an even n >= 4, as JAX lays out its devices; ``--device
cpu`` trains on ``(1, 1)``. The sketches are host work; the steps, the
projections and the recall run on the mesh's lead device.

Usage: python -m legalrag_tpu_torch.cli.train_encoder [--config F]
       [--lang zh] [--epochs 8] [--batch 64] [--hardness 0.5] [--save]
       [--pairs F --eval-pairs F] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from legalrag_tpu_torch.config import AppConfig
from legalrag_tpu_torch.evals.synthetic import extractive_queries
from legalrag_tpu_torch.index.bundle import IndexBundle
from legalrag_tpu_torch.index.dense_index import DenseIndex
from legalrag_tpu_torch.models.hash_encoder import HashEncoder
from legalrag_tpu_torch.parallel.mesh import (
    batch_sharded,
    local_devices,
    make_mesh,
    place,
)
from legalrag_tpu_torch.parallel.training import (
    full_projection,
    make_contrastive_train_step,
)
from legalrag_tpu_torch.utils import get_logger
from legalrag_tpu_torch.utils.device import resolve_device

log = get_logger("torch.cli.train_encoder")


def recall_at_k(q_emb: torch.Tensor, d_emb: torch.Tensor, gold: torch.Tensor,
                k: int = 10) -> float:
    """Share of queries whose gold row is among their top k docs."""
    top = torch.topk(q_emb @ d_emb.T, min(k, d_emb.shape[0]), dim=1).indices
    return float((top == gold[:, None]).any(dim=1).float().mean())


def _norm_rows(x: np.ndarray) -> np.ndarray:
    return x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-9)


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=1, keepdim=True),
                           min=1e-9)


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default=None)
    ap.add_argument("--lang", default="zh")
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--l2sp", type=float, default=0.1)
    ap.add_argument("--temperature", type=float, default=0.1)
    ap.add_argument("--hardness", type=float, default=0.5)
    ap.add_argument("--queries-per-article", type=int, default=2)
    ap.add_argument("--holdout", type=float, default=0.2)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--save", action="store_true",
                    help="persist the trained projection into the bundle")
    ap.add_argument("--pairs", default=None,
                    help="JSONL of {query, article_id} semantic training "
                    "pairs (cli/mine_semantic_pairs.py); replaces the "
                    "extractive generator")
    ap.add_argument("--eval-pairs", default=None,
                    help="held-out JSONL for the improvement gate (split by "
                    "gold article; defaults to an in-set random holdout)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="torch device type of the mesh")
    return ap.parse_args(argv)


def run(args: argparse.Namespace) -> Dict:
    """Train as the module docstring says; returns ``exit`` (0, or 1 when
    ``--save`` refused), ``before`` / ``after`` recall, every step's
    ``losses`` and ``step_s``, ``sketch_s``, the best ``projection`` (a
    float32 CPU tensor), ``saved`` and the mesh ``shape``."""
    device = resolve_device(args.device)
    devs = local_devices(device.type)
    n_dev = len(devs)
    data_ax = 2 if n_dev % 2 == 0 and n_dev >= 4 else 1
    mesh = make_mesh(devs, data=data_ax, model=n_dev // data_ax)
    log.info("mesh %s over %d %s devices", mesh.shape, n_dev, device.type)

    cfg = AppConfig.load(args.config)
    lang_cfg = cfg.with_lang(args.lang)
    index_dir = lang_cfg.paths.lang_index_dir
    bundle = IndexBundle.load(index_dir, lang_cfg, args.lang, device=mesh.lead)
    st = bundle.state
    enc = st.encoder
    if not isinstance(enc, HashEncoder):
        raise ValueError("train_encoder tunes the hash encoder's projection; "
                         "this bundle's encoder is "
                         f"{type(enc).__name__}")
    log.info("corpus: %d docs", bundle.n_docs)

    aid2row = {c.article_id: i for i, c in enumerate(st.chunks)}
    if args.pairs:
        def load_rows(path):
            with open(path, encoding="utf-8") as f:
                out = [json.loads(line) for line in f if line.strip()]
            return [r for r in out if str(r["article_id"]) in aid2row]

        train_rows = load_rows(args.pairs)
        held_rows = load_rows(args.eval_pairs) if args.eval_pairs else []
        rows = train_rows + held_rows
        log.info("semantic pairs: %d train + %d held (%s)",
                 len(train_rows), len(held_rows), args.pairs)
    else:
        rows = extractive_queries(st.chunks, n=10 ** 9, seed=args.seed,
                                  per_article=args.queries_per_article,
                                  hardness=args.hardness)
        train_rows, held_rows = rows, []
        log.info("pairs: %d (extractive, hardness %.2f)", len(rows),
                 args.hardness)
    queries = [r["query"] for r in rows]
    gold = np.asarray([aid2row[str(r["article_id"])] for r in rows])

    t0 = time.time()
    q_sk = _norm_rows(enc._sketch(queries))
    d_sk_all = _norm_rows(enc._sketch([c.text for c in st.chunks]))
    sketch_s = time.time() - t0
    log.info("sketches in %.1fs", sketch_s)

    rng = np.random.default_rng(args.seed)
    if held_rows:
        # split by gold article beforehand (cli/mine_semantic_pairs.py)
        train = np.arange(len(train_rows))
        hold = np.arange(len(train_rows), len(rows))
    else:
        perm = rng.permutation(len(queries))
        n_hold = int(len(queries) * args.holdout)
        hold, train = perm[:n_hold], perm[n_hold:]

    lead = mesh.lead
    d_sk_dev = torch.from_numpy(d_sk_all).to(lead)
    q_hold_dev = torch.from_numpy(q_sk[hold]).to(lead)
    gold_hold = torch.from_numpy(gold[hold]).to(lead)

    def eval_recall(w_full: torch.Tensor) -> float:
        return recall_at_k(_unit(q_hold_dev @ w_full), _unit(d_sk_dev @ w_full),
                           gold_hold, 10)

    w = enc.projection().to(lead, torch.float32)
    before = eval_recall(w)
    log.info("held-out dense Recall@10 before: %.4f", before)

    step = make_contrastive_train_step(mesh, lr=args.lr,
                                       temperature=args.temperature,
                                       l2sp=args.l2sp)
    w_dev = place(mesh, w, model_dim=1)
    w0_dev = place(mesh, w.clone(), model_dim=1)
    b = args.batch - args.batch % max(data_ax, 1)
    # the persisted projection is the best held-out epoch's (contrastive
    # fitting on a few hundred pairs overfits past a few epochs), as in JAX
    best_w, best_recall = w.clone(), before
    losses: List[float] = []
    step_s: List[float] = []
    for epoch in range(args.epochs):
        rng.shuffle(train)
        ep_losses = []
        for i in range(0, len(train) - b + 1, b):
            idx = train[i:i + b]
            t0 = time.perf_counter()
            qb = batch_sharded(mesh, torch.from_numpy(q_sk[idx]))
            db = batch_sharded(mesh, torch.from_numpy(d_sk_all[gold[idx]]))
            if args.l2sp > 0:
                w_dev, loss = step(w_dev, w0_dev, qb, db)
            else:
                w_dev, loss = step(w_dev, qb, db)
            ep_losses.append(float(loss))
            step_s.append(time.perf_counter() - t0)
        losses.extend(ep_losses)
        w_full = full_projection(mesh, w_dev)
        ep_recall = eval_recall(w_full)
        log.info("epoch %d: loss %.4f -> held-out Recall@10 %.4f",
                 epoch + 1, float(np.mean(ep_losses)) if ep_losses
                 else float("nan"), ep_recall)
        if ep_recall > best_recall:
            best_w, best_recall = w_full.clone(), ep_recall

    after = best_recall
    log.info("held-out dense Recall@10: %.4f -> %.4f (%+.4f, "
             "best-epoch checkpoint)", before, after, after - before)
    result = {"exit": 0, "before": before, "after": after, "losses": losses,
              "step_s": step_s, "sketch_s": sketch_s, "saved": False,
              "projection": best_w.cpu(), "shape": mesh.shape,
              "n_train": len(train), "n_held": len(hold)}
    if args.save:
        if after <= before:
            log.warning("no improvement; NOT saving")
            result["exit"] = 1
            return result
        enc.set_projection(best_w.cpu().numpy())
        # the dense rows are re-encoded under the new projection
        e = lang_cfg.engine
        dense = DenseIndex(st.dense.dim, e.dtype, e.capacity_round,
                           bundle.device)
        dense.add(enc.encode_passages([c.text for c in st.chunks]))
        bundle.state = dataclasses.replace(st, dense=dense,
                                           generation=st.generation + 1)
        bundle.save(index_dir)
        result["saved"] = True
        log.info("saved trained projection + re-encoded dense index -> %s",
                 index_dir)
    return result


def main(argv: Optional[List[str]] = None) -> int:
    return run(parse_args(argv))["exit"]


if __name__ == "__main__":
    sys.exit(main())
