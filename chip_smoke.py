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
   samples them), batch 64, top 10, through ``FusedQueryEngine``:
   queries/s, Recall@10, both kernels' launch counts on that run (reset
   just before it), a reference check of 8 queries against the port's plain
   CPU path on the same index, and one ``search_hits`` call.

Then the ``{"kernels": [...]}`` summary line, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``. Any failed check raises: the script then
exits non-zero and prints no result. Without a CUDA device it exits 2 at
once. It imports nothing of jax and nothing of the JAX package.
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

from legalrag_tpu_torch import kernels
from legalrag_tpu_torch.config import AppConfig
from legalrag_tpu_torch.convert import bundle_from_arrays
from legalrag_tpu_torch.corpus import parse_auto
from legalrag_tpu_torch.index.bundle import IndexBundle
from legalrag_tpu_torch.models.hash_encoder import project_norm
from legalrag_tpu_torch.ops.maxsim import maxsim_full, maxsim_full_plain
from legalrag_tpu_torch.ops.topk import dense_topk, dense_topk_fused_plain
from legalrag_tpu_torch.retrieval.engine import FusedQueryEngine
from legalrag_tpu_torch.tokenize import tokenizers

REPO = Path(__file__).resolve().parent
BATCH, N_QUERIES, TOP_K = 64, 1024, 10
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
BF16_FLOP_PER_S = 989e12    # dense bf16 tensor-core peak, same source
F32_FLOP_PER_S = 67e12      # float32 outside the tensor cores
TIE = 1e-6                  # scores closer than this may swap order


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


def profile_execute(engine, prepared):
    """torch.profiler over the execute of every prepared batch: device time
    by kernel, the card's busy time and its idle share of the window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for p in prepared:
            engine.execute(p)
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
    return {"batches": len(prepared), "window_ms": window_ms,
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
    for name in kernels.KERNELS:
        check(launches[name] == len(batches),
              f"{lang}: {name} launched {launches[name]} times for "
              f"{len(batches)} batches")

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
    profile = profile_execute(engine, prepared)

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
    summary = []
    for name, k in kres.items():
        summary.append({
            key: k[key] for key in ("name", "route", "source", "replaces",
                                    "max_abs_err", "ms", "plain_ms",
                                    "bound_ms", "bound_by", "library_ms")}
            | {"launches": sum(e["launches"][name] for e in e2e.values())})
    emit({"kernels": summary})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
