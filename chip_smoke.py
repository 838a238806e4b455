"""Drive the PyTorch/CUDA port (``legalrag_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. ``device``: the card's name, count, and ``nvidia-smi``'s name and power limit;
2. ``build``: compiles the hand-written kernels (``legalrag_tpu_torch/csrc``)
   with nvcc for sm_90a, timed; then ``kernel_edge_cases`` holds each kernel
   against its plain version on small synthetic inputs that the main path
   does not give it (float32, ragged tiles, empty docs, ...);
3. ``index``: builds the zh (Civil Code) and en (UCC) bundles from
   ``data/raw`` on the card, at full width (d=768, sketch 16384, token_dim
   128, doc_maxlen 220);
4. ``kernels``: each kernel against its plain PyTorch version at the shapes
   the main path gives it (the zh bundle and a batch of 64 sampled queries),
   with the tolerance stated, plus timings (CUDA events, median of 25 after
   warm-up) of the kernel, the plain version and one PyTorch library call
   chain computing the same function, and the least time the card could
   take (``bound_ms``);
5. ``e2e`` (zh, then en): 1024 self-retrieval queries (sampled as bench.py
   samples them), batch 64, top 10, through ``FusedQueryEngine`` (map
   mode): queries/s, Recall@10, the kernels' launch counts on that run
   (reset just before it), a reference check of 8 queries against the
   port's plain CPU path on the same index, and one ``search_hits`` call;
6. ``large``: the large-corpus mode at the JAX repo's 1M-doc scale point
   (``legalrag_tpu_torch.scale``: N 1,048,576, V 65,536, d 768 bf16,
   64 x 128 int8 doc tokens, B 64, 32 term slots, 16 query tokens): the
   index synthesized on the card (timed); the CSR BM25 kernel against its
   plain version on the same card tensors, with timings as in 4; back-to-back
   batches through ``fused_hybrid_topk`` with the CSR triple (ms per batch,
   queries/s, profiler breakdown, launch counts); one batch with the bf16
   dense map against the float32 map; the 1M-doc index copied to the CPU,
   whose plain path must give the first batch's top-10 for 8 queries (the
   two-pass dense selection); and the same check on a 65,536-doc index
   synthesized on the card (the one-pass selection).

Each path checks its own kernels: every kernel of the path launched once
per batch, every other kernel not at all. Then the ``{"kernels": [...]}``
summary line, the nvidia-smi line, and last ``{"ok": true, "device":
{...}}``. Any failed check raises: the script then exits non-zero and prints
no result. Without a CUDA device it exits 2 at once. It imports nothing of
jax and nothing of the JAX package.
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from legalrag_tpu_torch import kernels, scale
from legalrag_tpu_torch.config import AppConfig
from legalrag_tpu_torch.convert import bundle_from_arrays
from legalrag_tpu_torch.corpus import parse_auto
from legalrag_tpu_torch.index.bundle import IndexBundle
from legalrag_tpu_torch.models.hash_encoder import project_norm
from legalrag_tpu_torch.ops.bm25_sparse import (
    bm25_sparse_map,
    bm25_sparse_scores,
    bm25_sparse_scores_plain,
)
from legalrag_tpu_torch.ops.maxsim import maxsim_full, maxsim_full_plain
from legalrag_tpu_torch.ops.topk import (
    NEG_INF,
    TWO_PASS_MIN_N,
    dense_topk,
    dense_topk_fused_plain,
    stable_topk,
)
from legalrag_tpu_torch.retrieval.engine import FusedQueryEngine
from legalrag_tpu_torch.tokenize import tokenizers

REPO = Path(__file__).resolve().parent
BATCH, N_QUERIES, TOP_K = 64, 1024, 10
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
BF16_FLOP_PER_S = 989e12    # dense bf16 tensor-core peak, same source
F32_FLOP_PER_S = 67e12      # float32 outside the tensor cores
TIE = 1e-6                  # scores closer than this may swap order
# the JAX repo's 1M-doc scale point (scripts/bench_scale.py --n-docs 1048576)
LARGE = dict(n_docs=1 << 20, vocab=65536, dim=768, doc_len=64, token_dim=128)
LARGE_BATCHES = 8           # back-to-back query batches of 64
REF_DOCS = 65536            # the CPU reference's index
# the kernels each path must launch once per batch (and no other)
PATH_KERNELS = {"map": ("score_select", "maxsim"), "large": ("bm25_sparse",)}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median milliseconds of one call, by CUDA events around each call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def bound(n_bytes: float, n_flop: float, flop_rate: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flop / flop_rate * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def load_chunks(lang: str):
    chunks = []
    for p in sorted((REPO / "data" / "raw").rglob("*.txt")):
        text = p.read_text(encoding="utf-8", errors="replace")
        if text.strip():
            chunks += [r.to_chunk() for r in parse_auto(text, source=p.name)
                       if r.lang == lang]
    return chunks


def make_queries(bundle, n: int, seed: int = 0):
    """Sentence-sampled queries with gold rows (bench.py's make_queries)."""
    rng = np.random.default_rng(seed)
    queries, gold = [], []
    for row in rng.permutation(bundle.n_docs):
        text = bundle.chunks[int(row)].text
        sents = [s for s in re.split(r"[。；！? .;!?\n]", text)
                 if 8 <= len(s) <= 80]
        if not sents:
            continue
        queries.append(sents[rng.integers(len(sents))])
        gold.append(int(row))
        if len(queries) >= n:
            break
    keep = len(queries) // BATCH * BATCH
    return queries[:keep], np.asarray(gold[:keep])


def ties_only(want_s, want_i, got_s, got_i, tol: float) -> int:
    """Rows equal except within groups of scores closer than ``tol``;
    returns the number of positions that differ (all near-ties)."""
    diff = np.argwhere(want_i != got_i)
    for q, p in diff:
        # the row at p sits elsewhere in the wanted list within a tie of p,
        # or past its end with a score tied to position p
        where = np.nonzero(want_i[q] == got_i[q, p])[0]
        ref = want_s[q, where[0]] if len(where) else got_s[q, p]
        check(abs(ref - want_s[q, p]) < tol,
              f"row order differs beyond a tie at query {q} position {p}")
    return len(diff)


def check_edge_cases(dev) -> dict:
    """Both kernels against their plain versions off the main path's
    shapes: float32 stores, N not a multiple of the tile, k above the tile,
    valid_n < N, token_dim 64, token masks that are not a prefix, an empty
    doc and negative similarities."""
    g = torch.Generator().manual_seed(1)
    emb = torch.randn(1000, 64, generator=g)
    emb = (emb / emb.norm(dim=1, keepdim=True)).to(dev)
    q = torch.randn(5, 64, generator=g).to(dev)
    s, i = dense_topk(emb, q, 900, 200)
    ps, pi = dense_topk_fused_plain(emb, q, 900, 200)
    err1 = (s - ps).abs().max().item()
    check(err1 <= 1e-4, f"score_select f32 edge case differs by {err1}")
    swaps = ties_only(ps.cpu().numpy(), pi.cpu().numpy(), s.cpu().numpy(),
                      i.cpu().numpy(), TIE)

    tok = torch.randn(300, 40, 64, generator=g).to(dev)
    dmask = (torch.rand(300, 40, generator=g) > 0.6).to(dev)
    dmask[7] = False                                   # empty doc
    dmask[8] = torch.arange(40, device=dev) % 5 == 3   # not a prefix
    q_tok = torch.randn(3, 9, 64, generator=g).to(dev)
    q_mask = (torch.rand(3, 9, generator=g) > 0.3).to(dev)
    q_mask[:, 0] = True
    got = maxsim_full(tok, dmask, q_tok, q_mask)
    want = maxsim_full_plain(tok, dmask, q_tok, q_mask)
    err2 = (got - want).abs().max().item()
    check(torch.allclose(got, want, rtol=1e-4, atol=1e-4),
          f"maxsim f32 edge case differs by {err2}")
    check(bool((got[:, 7] == 0).all()), "maxsim: an empty doc must score 0")
    neg = -tok[:, :1].abs()                            # every product <= 0
    got_neg = maxsim_full(neg.contiguous(), dmask[:, :1].contiguous(),
                          q_tok.abs(), q_mask)
    check(bool((got_neg[:, dmask[:, 0]] < 0).all()),
          "maxsim: negative best matches must stay negative")
    return {"score_select_max_abs_err": err1, "score_select_tie_swaps": swaps,
            "maxsim_max_abs_err": err2}


# ------------------------------------------------------------------ phases

def phase_kernels(zh, queries):
    """Each kernel vs its plain version at the main path's zh shapes."""
    enc = zh.encoder
    dev = zh.device
    q = project_norm(enc.sketch_tensor(queries, query=True), enc.projection())
    emb, valid_n = zh.dense.emb, zh.dense.n
    eff_k = FusedQueryEngine(zh)._params(TOP_K).eff_k
    out = {}

    # kernel 1: dense score + select (main path, then ties + valid_n < N)
    s, i = dense_topk(emb, q, valid_n, eff_k)
    ps, pi = dense_topk_fused_plain(emb, q, valid_n, eff_k)
    err1 = (s - ps).abs().max().item()
    check(err1 <= 1e-4, f"score_select scores differ by {err1}")
    swaps = ties_only(ps.cpu().numpy(), pi.cpu().numpy(), s.cpu().numpy(),
                      i.cpu().numpy(), TIE)
    dup = emb.clone()
    dup[1300:1310] = dup[7]          # rows 1300-1304 valid, 1305-1309 masked
    q_dup = q.clone()
    q_dup[0] = dup[7].float()
    s2, i2 = dense_topk(dup, q_dup, 1305, eff_k)
    ps2, pi2 = dense_topk_fused_plain(dup, q_dup, 1305, eff_k)
    check(torch.equal(i2, pi2), "score_select tie order differs (dup rows)")
    check((s2 - ps2).abs().max().item() <= 1e-4, "score_select dup scores")
    check(i2[0, :6].tolist() == [7, 1300, 1301, 1302, 1303, 1304],
          f"duplicate rows not in row order: {i2[0, :6].tolist()}")
    b, d = q.shape
    mask_col = torch.arange(emb.shape[0], device=dev)[None, :] < valid_n

    def library1():
        sc = torch.matmul(q.to(emb.dtype), emb.T).float()
        return torch.topk(sc.masked_fill(~mask_col, -1e30), eff_k)

    tile = kernels.lib().score_select_tile()
    kp = min(eff_k, tile)
    tiles = -(-emb.shape[0] // tile)
    qc = q.to(emb.dtype).contiguous()
    o_s = torch.empty((tiles, b, kp), dtype=torch.float32, device=dev)
    o_i = torch.empty((tiles, b, kp), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    raw = kernels.lib().score_select
    dtype_id = {torch.float32: 0, torch.bfloat16: 1}[emb.dtype]

    def kernel_only():
        check(raw(qc.data_ptr(), emb.data_ptr(), dtype_id, b, emb.shape[0], d,
                  valid_n, kp, o_s.data_ptr(), o_i.data_ptr(), stream) == 0,
              "score_select launch")

    bms, by = bound(valid_n * d * emb.element_size() + b * d * 4
                    + b * eff_k * 12,
                    2 * b * valid_n * d, BF16_FLOP_PER_S)
    out["score_select"] = {
        "name": "score_select", "route": "cuda",
        "source": "legalrag_tpu_torch/csrc/score_select.cu",
        "replaces": "legalrag_tpu/ops/topk.py:328",
        "shapes": {"B": b, "N": emb.shape[0], "valid_n": valid_n, "d": d,
                   "k": eff_k, "dtype": str(emb.dtype)},
        "max_abs_err": err1, "ids_equal": bool(torch.equal(i, pi)),
        "tie_swaps": swaps, "tolerance": 1e-4,
        "ms": cuda_ms(lambda: dense_topk(emb, q, valid_n, eff_k)),
        "kernel_only_ms": cuda_ms(kernel_only),
        "plain_ms": cuda_ms(lambda: dense_topk_fused_plain(emb, q, valid_n,
                                                           eff_k)),
        "library_ms": cuda_ms(library1),
        "bound_ms": bms, "bound_by": by}

    # kernel 2: full-corpus MaxSim
    qt, qm = enc.encode_tokens(queries, zh.cfg.engine.max_query_tokens,
                               query=True)
    q_tok = torch.from_numpy(qt).to(dev).to(zh.tokens.query_dtype)
    q_mask = torch.from_numpy(qm).to(dev)
    tok, dmask = zh.tokens.tok, zh.tokens.mask
    got = maxsim_full(tok, dmask, q_tok, q_mask)
    want = maxsim_full_plain(tok, dmask, q_tok, q_mask)
    err2 = (got - want).abs().max().item()
    check(torch.allclose(got, want, rtol=1e-4, atol=1e-4),
          f"maxsim differs by {err2}")
    check(torch.isfinite(got).all().item(), "maxsim not finite")
    n, l_doc, dt = tok.shape

    def library2():
        res = torch.empty((b, n), dtype=torch.float32, device=dev)
        for c0 in range(0, n, 256):
            sim = torch.einsum("bqd,cld->bcql", q_tok, tok[c0:c0 + 256])
            sim = sim.masked_fill(~dmask[c0:c0 + 256][None, :, None, :],
                                  float("-inf")).amax(-1).float()
            sim = torch.where(torch.isfinite(sim), sim, 0.0)
            res[:, c0:c0 + 256] = torch.where(q_mask[:, None, :], sim,
                                              0.0).sum(-1)
        return res

    nvq, nvd = int(q_mask.sum()), int(dmask.sum())
    bms, by = bound((nvd + nvq) * dt * tok.element_size() + n * l_doc
                    + q_mask.numel() + b * n * 4,
                    2 * dt * nvq * nvd, BF16_FLOP_PER_S)
    padded_flop = 2 * b * q_tok.shape[1] * n * l_doc * dt
    out["maxsim"] = {
        "name": "maxsim", "route": "cuda",
        "source": "legalrag_tpu_torch/csrc/maxsim.cu",
        "replaces": "legalrag_tpu/ops/maxsim_pallas2.py:90",
        "also_replaces": "legalrag_tpu/ops/maxsim_pallas.py:80",
        "shapes": {"B": b, "Lq": q_tok.shape[1], "N": n, "L": l_doc,
                   "dt": dt, "dtype": str(tok.dtype),
                   "valid_query_tokens": nvq, "valid_doc_tokens": nvd,
                   "doc_fill": nvd / (zh.tokens.n * l_doc)},
        "max_abs_err": err2, "tolerance": 1e-4,
        "ms": cuda_ms(lambda: maxsim_full(tok, dmask, q_tok, q_mask)),
        "plain_ms": cuda_ms(lambda: maxsim_full_plain(tok, dmask, q_tok,
                                                      q_mask)),
        "library_ms": cuda_ms(library2),
        "bound_ms": bms, "bound_by": by,
        "valid_tflop": 2 * dt * nvq * nvd / 1e12,
        "padded_tflop": padded_flop / 1e12,
        "padded_bound_ms": padded_flop / BF16_FLOP_PER_S * 1e3,
        "f32_cuda_core_bound_ms": 2 * dt * nvq * nvd / F32_FLOP_PER_S * 1e3}
    for v in out.values():
        emit({"phase": "kernels", **v})
    return out


def cpu_reference(bundle, queries, got_s, got_r):
    """The same index on the CPU (the kernels' plain versions) must give the
    same top-10 for the first queries."""
    enc = bundle.encoder
    arrays = {
        "encoder": enc.state(), "proj": enc.projection().cpu().numpy(),
        "emb": bundle.dense.emb.float().cpu().numpy(), "n": bundle.dense.n,
        "impact": bundle.bm25.impact.cpu().numpy(),
        "tok": bundle.tokens.tok.float().cpu().numpy(),
        "mask": bundle.tokens.mask.cpu().numpy(),
        "flat_ids": np.concatenate(bundle.bm25.doc_term_ids),
        "flat_tfs": np.concatenate(bundle.bm25.doc_term_freqs),
        "offsets": np.cumsum([0] + [len(a) for a in bundle.bm25.doc_term_ids]),
        "bm25_params": [bundle.bm25.k1, bundle.bm25.b, bundle.bm25.epsilon]}
    cpu = bundle_from_arrays(arrays, bundle.chunks, bundle.bm25.vocab,
                             bundle.cfg, "cpu")
    ws, wr, _ = FusedQueryEngine(cpu).search_batch(queries, TOP_K)
    check(np.allclose(got_s, ws, atol=1e-4), "fused scores vs CPU reference")
    return ties_only(ws, wr, got_s, got_r, 1e-5)


def check_launches(path: str, launches, batches: int) -> None:
    """The path's kernels launched once per batch, the others not at all."""
    for name in kernels.KERNELS:
        want = batches if name in PATH_KERNELS[path] else 0
        check(launches[name] == want,
              f"{path}: {name} launched {launches[name]} times for "
              f"{batches} batches (want {want})")


def profile_device(run, batches: int):
    """torch.profiler over ``run()`` (the execute of every batch): device
    time by kernel, the card's busy time and its idle share of the window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3

    # device-side events only (kernels, copies, sets): the host operators
    # that launched them report the same time again
    by_kernel = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                        for e in prof.key_averages()
                        if e.device_type == DeviceType.CUDA
                        and e.self_device_time_total > 0),
                       key=lambda t: -t[1])
    busy_ms = sum(t[1] for t in by_kernel)
    return {"batches": batches, "window_ms": window_ms,
            "device_busy_ms": busy_ms,
            "idle_share": 1 - busy_ms / window_ms if busy_ms else None,
            "top": [[k[:70], ms, n] for k, ms, n in by_kernel[:8]]}


def phase_e2e(lang, bundle):
    engine = FusedQueryEngine(bundle)
    queries, gold = make_queries(bundle, N_QUERIES)
    batches = [queries[i:i + BATCH] for i in range(0, len(queries), BATCH)]
    engine.search_batch(batches[0], TOP_K)           # warm-up (kernel load)
    torch.cuda.synchronize()

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    prepared = [engine.prepare(b, TOP_K) for b in batches]
    t1 = time.perf_counter()
    results = [engine.collect(engine.execute(p)) for p in prepared]
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = kernels.launch_counts()
    check_launches("map", launches, len(batches))

    scores = np.concatenate([r[0] for r in results])
    rows = np.concatenate([r[1] for r in results])
    check(rows.shape == (len(queries), TOP_K), "rows shape")
    check(np.isfinite(scores).all(), "non-finite fused scores")
    check(((rows >= 0) & (rows < bundle.n_docs)).all(), "row out of range")
    recall = float(np.mean([g in set(r.tolist()) for r, g in zip(rows, gold)]))
    check(recall > 0.5, f"{lang}: Recall@10 {recall}")

    # one batch's execute between two CUDA events (median over the batches):
    # includes any wait of the card for the host's launches
    ms = []
    for p in prepared:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        engine.execute(p)
        b.record()
        ms.append((a, b))
    torch.cuda.synchronize()
    execute_ms = statistics.median(a.elapsed_time(b) for a, b in ms)
    profile = profile_device(lambda: [engine.execute(p) for p in prepared],
                             len(prepared))

    swaps = cpu_reference(bundle, batches[0][:8], scores[:8], rows[:8])
    hits = engine.search_hits(batches[0][:2], TOP_K)
    check(len(hits) == 2 and all(h.chunk.text for hs in hits for h in hs),
          "search_hits")
    check(all(h.score_breakdown["per_channel"].keys()
              == {"dense", "bm25", "colbert"} for hs in hits for h in hs),
          "search_hits breakdown")
    res = {"phase": "e2e", "lang": lang, "n_docs": bundle.n_docs,
           "queries": len(queries), "batch": BATCH, "batches": len(batches),
           "top_k": TOP_K, "qps": len(queries) / (t2 - t0),
           "seconds": t2 - t0, "host_prepare_s": t1 - t0,
           "execute_collect_s": t2 - t1, "execute_ms_per_batch": execute_ms,
           "profile": profile,
           "recall_at_10": recall, "launches": launches,
           "cpu_reference_tie_swaps": swaps,
           "search_hits_top1": hits[0][0].chunk.id if hits[0] else None}
    if lang == "zh":
        res["zh_tokenizer"] = ("jieba" if tokenizers._jieba() is not None
                               else "char+bigram fallback")
    emit(res)
    return res


# ------------------------------------------------------- large-corpus mode

def check_bm25_kernel(index, q, params):
    """Kernel 4 (CSR BM25) against its plain version on the same card
    tensors, at the scale point's shapes, with timings and the bound."""
    ids, counts = q.term_ids, q.term_counts
    offsets, post_docs, post_w = index.postings
    n, (b, n_slots) = index.n, ids.shape
    per_term = params.max_postings // n_slots
    args = (ids, counts, offsets, post_docs, post_w, n, per_term)
    k_s, k_t = bm25_sparse_map(*args)
    p_s, p_t = bm25_sparse_scores_plain(*args)
    check(torch.equal(k_t, p_t), "bm25_sparse: touched masks differ")
    err = (k_s - p_s).abs().max().item()
    # float32 sums in atomic order against the slot-by-slot order
    check(torch.allclose(k_s, p_s, rtol=1e-5, atol=1e-5),
          f"bm25_sparse scores differ by {err}")
    eff_k = params.eff_k
    ws, wi = stable_topk(torch.where(p_t.bool(), p_s, NEG_INF), eff_k)
    gs, gi = stable_topk(torch.where(k_t.bool(), k_s, NEG_INF), eff_k)
    swaps = ties_only(ws.cpu().numpy(), wi.cpu().numpy(), gs.cpu().numpy(),
                      gi.cpu().numpy(), 1e-5)
    # no cap: the Pallas kernel's function (bm25_sparse_scores)
    full = bm25_sparse_scores(ids, counts, offsets, post_docs, post_w, n)
    full_plain = bm25_sparse_scores_plain(ids, counts, offsets, post_docs,
                                          post_w, n)[0]
    check(torch.allclose(full, full_plain, rtol=1e-5, atol=1e-5),
          "bm25_sparse uncapped scores differ")

    # library: one sparse product, the transposed [N, V] CSR impact built
    # once (outside the timing) times the dense [V, B] query counts
    v = offsets.shape[0] - 1
    nnz = int(offsets[-1])
    sizes = (offsets[1:] - offsets[:-1]).long()
    term = torch.repeat_interleave(torch.arange(v, device=post_w.device),
                                   sizes)
    impact_t = torch.sparse_coo_tensor(
        torch.stack([post_docs[:nnz].long(), term]), post_w[:nnz],
        (n, v)).coalesce().to_sparse_csr()
    qtf_t = torch.zeros((v, b), dtype=torch.float32, device=post_w.device)
    qtf_t.index_put_((ids.long().T.reshape(-1),
                      torch.arange(b, device=ids.device).repeat(n_slots)),
                     counts.float().T.reshape(-1), accumulate=True)
    lib = torch.sparse.mm(impact_t, qtf_t)
    lib_err = (lib.T - full).abs().max().item()
    check(torch.allclose(lib.T, full, rtol=1e-4, atol=1e-4),
          f"torch.sparse.mm disagrees with the kernel by {lib_err}")

    # bound: both outputs written once, each counted slot's ids, count and
    # two offsets read once, its capped postings (doc id + weight) once
    live = counts > 0
    span = (offsets[ids.long() + 1] - offsets[ids.long()]).long()
    gathered = int(torch.where(live, span.clamp(max=per_term), 0).sum())
    n_bytes = b * n * 5 + ids.numel() * 8 + int(live.sum()) * 8 + gathered * 8
    bms, by = bound(n_bytes, 2 * gathered, F32_FLOP_PER_S)
    return {
        "name": "bm25_sparse", "route": "cuda",
        "source": "legalrag_tpu_torch/csrc/bm25_sparse.cu",
        "replaces": "legalrag_tpu/ops/bm25_sparse.py:120",
        "shapes": {"B": b, "L": n_slots, "n_docs_pad": n, "V": v,
                   "nnz": nnz, "per_term": per_term,
                   "gathered_postings": gathered},
        "max_abs_err": err, "tolerance": 1e-5, "touched_equal": True,
        "top_list_tie_swaps": swaps, "library_max_abs_err": lib_err,
        "ms": cuda_ms(lambda: bm25_sparse_map(*args)),
        "plain_ms": cuda_ms(lambda: bm25_sparse_scores_plain(*args)),
        "library_ms": cuda_ms(lambda: torch.sparse.mm(impact_t, qtf_t)),
        "library": "torch.sparse.mm (CSR [N, V] x dense [V, B])",
        "bound_ms": bms, "bound_by": by}


def check_large_out(out, n: int, b: int) -> None:
    rows, packed = out["rows"], out["packed"]
    check(tuple(rows.shape) == (b, TOP_K), f"large rows {tuple(rows.shape)}")
    check(tuple(packed.shape) == (b, TOP_K, 6), "large packed shape")
    check(bool(torch.isfinite(packed).all()), "large: non-finite packed")
    check(bool(((rows >= 0) & (rows < n)).all()), "large: row out of range")
    check(bool((packed[..., 0].diff(dim=1) <= 1e-6).all()),
          "large: fused scores not descending")


def cpu_reference_large(idx, q, got, params, queries: int = 8):
    """The card's index copied to the CPU, where the plain versions must
    give the card's top-10 (``got``) for the first queries of ``q``, except
    near-ties. From ``TWO_PASS_MIN_N`` docs on, both sides select the dense
    list by the block-max two-pass route."""
    cpu_idx = scale.ScaleIndex(idx.emb.cpu(),
                               tuple(t.cpu() for t in idx.postings),
                               idx.doc_tok.cpu(), idx.doc_mask.cpu(), idx.n)
    cpu_q = scale.ScaleQueries(*(getattr(q, f)[:queries].cpu() for f in (
        "qvec", "term_ids", "term_counts", "q_tok", "q_mask")))
    want = scale.run_hybrid(cpu_idx, cpu_q, params)
    got_s = got["packed"][:queries, :, 0].cpu().numpy()
    want_s = want["packed"][:, :, 0].numpy()
    check(np.allclose(got_s, want_s, atol=1e-4),
          f"large fused scores vs CPU reference at {idx.n} docs")
    swaps = ties_only(want_s, want["rows"].numpy(), got_s,
                      got["rows"][:queries].cpu().numpy(), 1e-5)
    return {"n_docs": idx.n, "queries": queries,
            "two_pass": idx.n >= TWO_PASS_MIN_N, "tie_swaps": swaps,
            "max_abs_err": float(np.abs(got_s - want_s).max())}


def small_cpu_reference(params):
    """The same check on a REF_DOCS-doc index synthesized on the card,
    below ``TWO_PASS_MIN_N``: the one-pass dense selection."""
    idx = scale.synthesize_index(**dict(LARGE, n_docs=REF_DOCS),
                                 device="cuda")
    q = scale.synthesize_queries(idx, LARGE["vocab"], BATCH, seed=99)
    got = scale.run_hybrid(idx, q, params)
    check_large_out(got, idx.n, BATCH)
    return cpu_reference_large(idx, q, got, params)


def phase_large():
    """The large-corpus mode at the 1M-doc scale point (module docstring)."""
    t0 = time.perf_counter()
    index = scale.synthesize_index(**LARGE, device="cuda")
    torch.cuda.synchronize()
    synth_s = time.perf_counter() - t0
    emit({"phase": "large_index", "seconds": synth_s, **LARGE,
          "bytes": index.nbytes, "nnz": int(index.postings[0][-1]),
          "device_allocated_gb": torch.cuda.memory_allocated() / 1e9})
    batches = [scale.synthesize_queries(index, LARGE["vocab"], BATCH,
                                        seed=1 + i)
               for i in range(LARGE_BATCHES)]
    params = scale.scale_params()
    kres = check_bm25_kernel(index, batches[0], params)
    emit({"phase": "kernels", **kres})

    def run_all():
        return [scale.run_hybrid(index, q, params) for q in batches]

    scale.run_hybrid(index, batches[0], params)          # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    outs = run_all()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = kernels.launch_counts()
    check_launches("large", launches, len(batches))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for out in outs:
        check_large_out(out, index.n, BATCH)

    ms = []
    for q in batches:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        scale.run_hybrid(index, q, params)
        b.record()
        ms.append((a, b))
    torch.cuda.synchronize()
    batch_ms = statistics.median(a.elapsed_time(b) for a, b in ms)
    profile = profile_device(run_all, len(batches))

    # the bf16 dense map against the float32 map, one batch
    b16 = scale.run_hybrid(index, batches[0],
                           scale.scale_params(dense_map_bf16=True))
    check_large_out(b16, index.n, BATCH)
    rf, rb = outs[0]["rows"].cpu().numpy(), b16["rows"].cpu().numpy()
    pf, pb = outs[0]["packed"].cpu().numpy(), b16["packed"].cpu().numpy()
    overlap = [len(set(rf[r].tolist()) & set(rb[r].tolist())) / TOP_K
               for r in range(BATCH)]
    dense_diff = 0.0
    for r in range(BATCH):
        for doc in set(rf[r].tolist()) & set(rb[r].tolist()):
            i, j = list(rf[r]).index(doc), list(rb[r]).index(doc)
            dense_diff = max(dense_diff, abs(pf[r, i, 1] - pb[r, j, 1]))
    check(dense_diff <= 1e-5, f"bf16 map: rescored dense differs by "
                              f"{dense_diff}")
    # the JAX test's bar (>= 9/10 shared, same top-1), per query: every
    # query keeps its top-1, at most 4 of 64 fall below 9/10
    near = sum(o >= 0.9 for o in overlap)
    same_top1 = int((rf[:, 0] == rb[:, 0]).sum())
    check(near >= BATCH - 4 and same_top1 == BATCH,
          f"bf16 map: {near} of {BATCH} queries share >= 9/10, "
          f"{same_top1} the top-1")
    # the main path's first batch, on the CPU: the two-pass route
    ref_1m = cpu_reference_large(index, batches[0], outs[0], params)
    del outs, b16
    ref = small_cpu_reference(params)
    res = {"phase": "large", "n_docs": index.n, "batch": BATCH,
           "batches": len(batches), "top_k": TOP_K,
           "ms_per_batch": batch_ms, "qps": BATCH * len(batches) / seconds,
           "seconds": seconds, "peak_device_gb": peak_gb,
           "launches": launches, "profile": profile,
           "bf16_map": {"mean_top10_overlap": statistics.mean(overlap),
                        "min_top10_overlap": min(overlap),
                        "queries_9_of_10": near, "same_top1": same_top1,
                        "queries": BATCH,
                        "dense_component_max_diff": float(dense_diff)},
           "cpu_reference": ref, "cpu_reference_1m": ref_1m}
    emit(res)
    del index
    torch.cuda.empty_cache()
    return kres, res


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "kind": kind,
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    built = kernels.build(force=True)
    regs = re.findall(r"Compiling entry function '(\w+)'.*?Used (\d+) registers",
                      built["ptxas"], re.S)
    emit({"phase": "build", "seconds": built["seconds"],
          "registers": {name[-60:]: int(n) for name, n in regs}})
    kernels.lib()
    emit({"phase": "kernel_edge_cases",
          **check_edge_cases(torch.device("cuda"))})

    cfg = AppConfig()
    bundles = {}
    for lang in ("zh", "en"):
        t0 = time.perf_counter()
        chunks = load_chunks(lang)
        bundles[lang] = IndexBundle.build_from_chunks(
            chunks, cfg.with_lang(lang), lang, device="cuda")
        torch.cuda.synchronize()
        b = bundles[lang]
        emit({"phase": "index", "lang": lang, "n_docs": b.n_docs,
              "seconds": time.perf_counter() - t0,
              "emb": list(b.dense.emb.shape), "impact": list(b.bm25.impact.shape),
              "tok": list(b.tokens.tok.shape)})
    zh_queries, _ = make_queries(bundles["zh"], BATCH)
    kres = phase_kernels(bundles["zh"], zh_queries)

    e2e = {lang: phase_e2e(lang, bundles[lang]) for lang in ("zh", "en")}
    del bundles
    kres["bm25_sparse"], large = phase_large()
    runs = {"map": list(e2e.values()), "large": [large]}
    summary = []
    for name, k in kres.items():
        path = next(p for p, names in PATH_KERNELS.items() if name in names)
        summary.append({
            key: k[key] for key in ("name", "route", "source", "replaces",
                                    "max_abs_err", "ms", "plain_ms",
                                    "bound_ms", "bound_by", "library_ms")}
            | {"launches": sum(e["launches"][name] for e in runs[path])})
    emit({"kernels": summary})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
