"""The large-corpus hybrid query on a synthetic corpus (port of
``scripts/bench_scale.py:65-154``).

    python -m legalrag_tpu_torch.scale [--n-docs 65536] [--batch 64]

Synthesizes an N-doc index directly on the device from a seed (an explicit
``torch.Generator``), in chunks so no large host or float32 temporary is
made:

- unit-norm dense rows, stored in bf16;
- cluster-structured unit token vectors (1024 centres, noise 0.35, as real
  embeddings cluster), quantized to an int8 store;
- Zipf-like CSR postings: term t is in ``min(N // (t + 10), 2048)`` docs
  drawn at random, with random positive weights. Unlike the JAX script,
  which draws doc ids with replacement and unsorted, each term's doc ids are
  made unique and ascending (``torch.unique`` over ``term * N + doc``
  keys), the layout ``build_postings`` guarantees;
- queries: unit dense vectors, 32 BM25 term slots of count 1 and 16 unit
  query tokens.

It then runs ``fused_hybrid_topk`` in the large-corpus mode (the JAX
script's ``FusedParams``: eff_k 64, final_k 10, 128 late candidates, 32 x
2048 postings) back to back and prints one ``scale_hybrid_qps`` JSON line,
which names the device it ran on.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import torch

from legalrag_tpu_torch.index.dense_index import round_up
from legalrag_tpu_torch.ops.fused_query import FusedParams, fused_hybrid_topk
from legalrag_tpu_torch.ops.maxsim import INT8_SCALE
from legalrag_tpu_torch.utils.device import DeviceLike, resolve_device

N_CENTRES = 1024
TOKEN_NOISE = 0.35
POSTINGS_CAP = 2048
QUERY_TERMS = 32
QUERY_TOKENS = 16
POSTINGS_CHUNK = 512  # build_postings' padding chunk


@dataclass
class ScaleIndex:
    emb: torch.Tensor        # [N, d] bf16 unit rows
    postings: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # CSR triple
    doc_tok: torch.Tensor    # [N, L, dt] int8
    doc_mask: torch.Tensor   # [N, L] bool
    n: int

    @property
    def nbytes(self) -> Dict[str, int]:
        def size(t: torch.Tensor) -> int:
            return t.numel() * t.element_size()

        return {"dense": size(self.emb), "tokens": size(self.doc_tok),
                "token_mask": size(self.doc_mask),
                "postings": sum(size(t) for t in self.postings)}


@dataclass
class ScaleQueries:
    qvec: torch.Tensor         # [B, d] float32 unit
    term_ids: torch.Tensor     # [B, 32] int32
    term_counts: torch.Tensor  # [B, 32] int32, all 1
    q_tok: torch.Tensor        # [B, 16, dt] float32 unit
    q_mask: torch.Tensor       # [B, 16] bool


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / x.norm(dim=-1, keepdim=True)


def synthesize_index(n_docs: int = 65536, vocab: int = 65536, dim: int = 768,
                     doc_len: int = 64, token_dim: int = 128, seed: int = 0,
                     device: DeviceLike = None, chunk_docs: int = 4096
                     ) -> ScaleIndex:
    """The synthetic index of the scale point, made on ``device``."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    n = n_docs

    emb = torch.empty((n, dim), dtype=torch.bfloat16, device=dev)
    for s in range(0, n, 16 * chunk_docs):
        e = min(n, s + 16 * chunk_docs)
        emb[s:e] = _unit(torch.randn((e - s, dim), generator=g,
                                     device=dev)).to(torch.bfloat16)

    doc_tok = torch.empty((n, doc_len, token_dim), dtype=torch.int8,
                          device=dev)
    centres = torch.randn((N_CENTRES, token_dim), generator=g, device=dev)
    for s in range(0, n, chunk_docs):
        m = (min(n, s + chunk_docs) - s) * doc_len
        assign = torch.randint(0, N_CENTRES, (m,), generator=g, device=dev)
        tok = torch.randn((m, token_dim), generator=g, device=dev)
        tok = _unit(tok * TOKEN_NOISE + centres[assign])
        tok = torch.clamp(torch.round(tok * INT8_SCALE), -127, 127)
        doc_tok[s:s + m // doc_len] = tok.to(torch.int8).view(
            -1, doc_len, token_dim)
    doc_mask = torch.ones((n, doc_len), dtype=torch.bool, device=dev)

    sizes = torch.clamp(n // (torch.arange(vocab, device=dev) + 10),
                        max=POSTINGS_CAP)
    term = torch.repeat_interleave(torch.arange(vocab, device=dev), sizes)
    docs = torch.randint(0, n, term.shape, generator=g, device=dev)
    # unique (term, doc) keys in ascending order: term-major, doc ids
    # distinct and ascending within a term
    keys = torch.unique(term * n + docs)
    term, docs = keys // n, keys % n
    offsets = torch.zeros(vocab + 1, dtype=torch.int64, device=dev)
    offsets[1:] = torch.cumsum(torch.bincount(term, minlength=vocab), 0)
    nnz = keys.numel()
    nnz_pad = round_up(nnz + POSTINGS_CHUNK, POSTINGS_CHUNK)
    post_docs = torch.zeros(nnz_pad, dtype=torch.int32, device=dev)
    post_w = torch.zeros(nnz_pad, dtype=torch.float32, device=dev)
    post_docs[:nnz] = docs.to(torch.int32)
    post_w[:nnz] = torch.randn(nnz, generator=g, device=dev).abs()
    return ScaleIndex(emb, (offsets.to(torch.int32), post_docs, post_w),
                      doc_tok, doc_mask, n)


def synthesize_queries(index: ScaleIndex, vocab: int, batch: int = 64,
                       seed: int = 1) -> ScaleQueries:
    """One batch of the scale point's queries, on the index's device."""
    dev = index.emb.device
    g = torch.Generator(device=dev).manual_seed(seed)
    dim, token_dim = index.emb.shape[1], index.doc_tok.shape[2]
    return ScaleQueries(
        qvec=_unit(torch.randn((batch, dim), generator=g, device=dev)),
        term_ids=torch.randint(0, vocab, (batch, QUERY_TERMS), generator=g,
                               device=dev, dtype=torch.int32),
        term_counts=torch.ones((batch, QUERY_TERMS), dtype=torch.int32,
                               device=dev),
        q_tok=_unit(torch.randn((batch, QUERY_TOKENS, token_dim),
                                generator=g, device=dev)),
        q_mask=torch.ones((batch, QUERY_TOKENS), dtype=torch.bool,
                          device=dev))


def scale_params(candidates: int = 128, dense_map_bf16: bool = False
                 ) -> FusedParams:
    """The scale point's ``FusedParams`` (``bench_scale.py:147-151``)."""
    return FusedParams(eff_k=64, final_k=10, rrf_k=60.0, alpha=0.5,
                       w_dense=0.6, w_bm25=0.4, w_late=0.35,
                       late_candidates=candidates,
                       max_postings=QUERY_TERMS * POSTINGS_CAP,
                       dense_map_bf16=dense_map_bf16)


def run_hybrid(index: ScaleIndex, queries: ScaleQueries, params: FusedParams
               ) -> Dict[str, torch.Tensor]:
    """One batch through the large-corpus ``fused_hybrid_topk``."""
    return fused_hybrid_topk(index.emb, index.postings, index.doc_tok,
                             index.doc_mask, queries.qvec,
                             (queries.term_ids, queries.term_counts),
                             queries.q_tok, queries.q_mask, index.n, params)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-docs", type=int, default=65536)
    ap.add_argument("--vocab", type=int, default=65536)
    ap.add_argument("--dim", type=int, default=768)
    ap.add_argument("--doc-len", type=int, default=64)
    ap.add_argument("--token-dim", type=int, default=128)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--candidates", type=int, default=128)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--dense-map", choices=("float32", "bfloat16"),
                    default="float32")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu only on request)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    t0 = time.perf_counter()
    index = synthesize_index(args.n_docs, args.vocab, args.dim, args.doc_len,
                             args.token_dim, args.seed, dev)
    _sync(dev)
    synth_s = time.perf_counter() - t0
    queries = [synthesize_queries(index, args.vocab, args.batch,
                                  args.seed + 1 + i) for i in range(4)]
    params = scale_params(args.candidates, args.dense_map == "bfloat16")
    t0 = time.perf_counter()
    run_hybrid(index, queries[0], params)
    _sync(dev)
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for i in range(args.iters):
        out = run_hybrid(index, queries[i % len(queries)], params)
    _sync(dev)
    dt = (time.perf_counter() - t0) / max(args.iters, 1)
    print(f"{args.n_docs} docs: {dt * 1e3:.3f} ms/batch{args.batch} "
          f"(synthesis {synth_s:.1f} s, first batch {first_s:.2f} s)",
          file=sys.stderr, flush=True)
    kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu")
    print(json.dumps({
        "metric": "scale_hybrid_qps", "n_docs": args.n_docs,
        "value": args.batch / dt, "unit": "queries/s",
        "ms_per_batch": dt * 1e3, "batch": args.batch,
        "dense_dtype": "bfloat16", "dense_map": args.dense_map,
        "token_dtype": "int8",
        "token_store_gb": index.nbytes["tokens"] / 1e9,
        "rows_shape": list(out["rows"].shape), "device": kind}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
