"""BM25 from CSR postings (port of ``legalrag_tpu/ops/bm25_sparse.py``).

The large-corpus mode keeps BM25 as term-major CSR postings on the device
instead of the dense [V, N] impact matrix:

- ``offsets`` int32 [V+1]: term t's postings are ``[offsets[t], offsets[t+1])``;
- ``post_docs`` int32 [NNZ_pad]: doc ids, ascending within a term;
- ``post_w`` float32 [NNZ_pad]: the per-(term, doc) BM25 contribution.

``build_postings`` makes them on the host, byte for byte as the JAX package
does. ``bm25_sparse_scores`` is the [B, n_docs_pad] score map of the Pallas
``_bm25_sparse_kernel``; ``bm25_sparse_topk`` is the top list that the JAX
``bm25_sparse_topk_auto`` computes (its sorted / merge-network variants are
TPU workarounds for a missing scatter-add; the port computes what they
compute from the score map).

Both go through one kernel. On a CUDA tensor it is the hand-written
``csrc/bm25_sparse.cu``; on a CPU tensor its plain version
``bm25_sparse_scores_plain``. It walks each counted (term, count) slot's
postings, at most ``per_term`` of them, adds ``post_w * count`` to the doc's
score and marks the doc as touched when the count is positive. The touched
mask is what tells a candidate whose BM25 total is exactly 0 (idf is 0 at
df = N/2) from a doc no posting reached.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from legalrag_tpu_torch import kernels
from legalrag_tpu_torch.index.dense_index import round_up
from legalrag_tpu_torch.ops.bm25 import compute_idf
from legalrag_tpu_torch.ops.topk import NEG_INF, stable_topk

# per-term postings cap that caps nothing (the Pallas kernel walks every
# posting of a term)
NO_CAP = 2**31 - 1


def build_postings(doc_term_ids: Sequence[np.ndarray],
                   doc_term_freqs: Sequence[np.ndarray], vocab_size: int,
                   k1: float = 1.5, b: float = 0.75, epsilon: float = 0.25,
                   chunk: int = 512
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(offsets [V+1] int32, post_docs [NNZ_pad] int32, post_w [NNZ_pad]
    float32): term-major CSR, doc ids ascending within a term, each weight
    the float64 BM25 contribution rounded once to float32. The postings pad
    to a chunk multiple (at least one chunk of headroom) with doc 0 and
    weight 0."""
    n_docs = len(doc_term_ids)
    df = np.zeros(vocab_size, np.int64)
    doc_len = np.zeros(n_docs, np.float64)
    for d, (ids, tfs) in enumerate(zip(doc_term_ids, doc_term_freqs)):
        df[ids] += 1
        doc_len[d] = tfs.sum()
    avgdl = doc_len.mean() if n_docs else 1.0
    idf = compute_idf(df, n_docs, epsilon)
    norm = k1 * (1.0 - b + b * doc_len / max(avgdl, 1e-9))

    contrib, terms, docs = [], [], []
    for d, (ids, tfs) in enumerate(zip(doc_term_ids, doc_term_freqs)):
        contrib.append(idf[ids] * tfs * (k1 + 1.0) / (tfs + norm[d]))
        terms.append(np.asarray(ids, np.int64))
        docs.append(np.full(len(ids), d, np.int64))
    terms = np.concatenate(terms) if terms else np.zeros(0, np.int64)
    # a stable sort by term keeps each term's docs in doc order
    order = np.argsort(terms, kind="stable")
    offsets = np.zeros(vocab_size + 1, np.int32)
    offsets[1:] = np.cumsum(np.bincount(terms, minlength=vocab_size))
    nnz = len(terms)
    nnz_pad = round_up(nnz + chunk, chunk)
    post_docs = np.zeros(nnz_pad, np.int32)
    post_w = np.zeros(nnz_pad, np.float32)
    if nnz:
        post_docs[:nnz] = np.concatenate(docs)[order]
        post_w[:nnz] = np.concatenate(contrib)[order]
    return offsets, post_docs, post_w


def bm25_sparse_scores_plain(term_ids: torch.Tensor, term_counts: torch.Tensor,
                             offsets: torch.Tensor, post_docs: torch.Tensor,
                             post_w: torch.Tensor, n_docs_pad: int,
                             per_term: int = NO_CAP
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: (scores float32, touched uint8),
    both [B, n_docs_pad]. Sums slot by slot and, within a slot, posting by
    posting (a term's doc ids are distinct), the Pallas kernel's order.
    Slots with count 0 or a term id outside [0, V) add nothing; doc ids
    outside [0, n_docs_pad) are dropped."""
    b, n_slots = term_ids.shape
    dev = post_w.device
    v = offsets.shape[0] - 1
    off = offsets.long()
    scores = torch.zeros(b * n_docs_pad, dtype=torch.float32, device=dev)
    touched = torch.zeros(b * n_docs_pad, dtype=torch.uint8, device=dev)
    rows = torch.arange(b, device=dev)
    for t in range(n_slots):
        tid = term_ids[:, t].long()
        count = term_counts[:, t].long()
        live = (count != 0) & (tid >= 0) & (tid < v)
        tid = torch.where(live, tid, 0)
        start = off[tid]
        size = torch.clamp(off[tid + 1] - start, min=0, max=per_term)
        size = torch.where(live, size, 0)
        q = torch.repeat_interleave(rows, size)
        first = torch.cumsum(size, 0) - size
        pos = torch.arange(q.shape[0], device=dev) - first[q]
        docs = post_docs[start[q] + pos].long()
        w = post_w[start[q] + pos] * count[q].float()
        keep = (docs >= 0) & (docs < n_docs_pad)
        flat = (q * n_docs_pad + docs)[keep]
        scores.index_add_(0, flat, w[keep])
        touched[flat[(count[q] > 0)[keep]]] = 1
    return scores.view(b, n_docs_pad), touched.view(b, n_docs_pad)


def _kernel_map(term_ids: torch.Tensor, term_counts: torch.Tensor,
                offsets: torch.Tensor, post_docs: torch.Tensor,
                post_w: torch.Tensor, n_docs_pad: int, per_term: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/bm25_sparse.cu``: the same (scores, touched) as
    ``bm25_sparse_scores_plain``, float32 sums in atomic (run-dependent)
    order."""
    dev = post_w.device
    if dev.type != "cuda" or any(t.device != dev for t in
                                 (term_ids, term_counts, offsets, post_docs)):
        raise ValueError("bm25_sparse needs all five tensors on one CUDA "
                         "device")
    if (offsets.dtype != torch.int32 or post_docs.dtype != torch.int32
            or post_w.dtype != torch.float32):
        raise TypeError(f"bm25_sparse takes int32 offsets and doc ids and "
                        f"float32 weights, got {offsets.dtype}, "
                        f"{post_docs.dtype}, {post_w.dtype}")
    if (term_ids.ndim != 2 or term_counts.shape != term_ids.shape
            or offsets.ndim != 1 or post_docs.shape != post_w.shape):
        raise ValueError(f"shapes term_ids {tuple(term_ids.shape)} counts "
                         f"{tuple(term_counts.shape)} offsets "
                         f"{tuple(offsets.shape)} docs "
                         f"{tuple(post_docs.shape)} w {tuple(post_w.shape)}")
    if not all(t.is_contiguous() for t in (offsets, post_docs, post_w)):
        raise ValueError("bm25_sparse needs contiguous postings")
    b, n_slots = term_ids.shape
    if b * n_docs_pad >= 2**31 or per_term < 0:
        raise ValueError(f"bm25_sparse: B * n_docs_pad = {b * n_docs_pad} "
                         f"must be < 2**31, per_term {per_term} >= 0")
    ids = term_ids.to(torch.int32).contiguous()
    counts = term_counts.to(torch.int32).contiguous()
    scores = torch.empty((b, n_docs_pad), dtype=torch.float32, device=dev)
    touched = torch.empty((b, n_docs_pad), dtype=torch.uint8, device=dev)
    kernels.launch("bm25_sparse", ids.data_ptr(), counts.data_ptr(), b,
                   n_slots, offsets.data_ptr(), offsets.shape[0] - 1,
                   post_docs.data_ptr(), post_w.data_ptr(), int(n_docs_pad),
                   int(per_term), scores.data_ptr(), touched.data_ptr(),
                   torch.cuda.current_stream(dev).cuda_stream)
    return scores, touched


def bm25_sparse_map(term_ids: torch.Tensor, term_counts: torch.Tensor,
                    offsets: torch.Tensor, post_docs: torch.Tensor,
                    post_w: torch.Tensor, n_docs_pad: int,
                    per_term: int = NO_CAP
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scores, touched) [B, n_docs_pad]: the kernel on a CUDA tensor, its
    plain version on a CPU tensor."""
    if post_w.device.type == "cpu":
        return bm25_sparse_scores_plain(term_ids, term_counts, offsets,
                                        post_docs, post_w, n_docs_pad,
                                        per_term)
    return _kernel_map(term_ids, term_counts, offsets, post_docs, post_w,
                       n_docs_pad, per_term)


def bm25_sparse_scores(term_ids: torch.Tensor, term_counts: torch.Tensor,
                       offsets: torch.Tensor, post_docs: torch.Tensor,
                       post_w: torch.Tensor, n_docs_pad: int, chunk: int = 512
                       ) -> torch.Tensor:
    """[B, L] padded query term ids / counts -> [B, n_docs_pad] BM25 scores,
    every posting of every slot counted. ``chunk`` is the build chunk; the
    postings length must be a multiple of it, as the JAX function demands."""
    if post_docs.shape[0] % chunk != 0:
        raise ValueError(
            f"postings length {post_docs.shape[0]} is not a multiple of "
            f"chunk={chunk}; use the chunk build_postings was built with")
    return bm25_sparse_map(term_ids, term_counts, offsets, post_docs, post_w,
                           n_docs_pad)[0]


def bm25_sparse_topk(term_ids: torch.Tensor, term_counts: torch.Tensor,
                     offsets: torch.Tensor, post_docs: torch.Tensor,
                     post_w: torch.Tensor, k: int, max_postings: int = 16384,
                     *, n_docs: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The BM25 top list of ``bm25_sparse_topk_auto``: (scores [B, k]
    float32, doc ids [B, k] int64).

    Each slot with count > 0 contributes at most ``max_postings // L``
    postings (the rest of a longer term is dropped); the candidates are the
    docs those postings touch, in (score desc, doc asc) order; slots past
    the candidates score NEG_INF. Doc ids are below ``n_docs``."""
    per_term = max_postings // max(term_ids.shape[1], 1)
    scores, touched = bm25_sparse_map(term_ids, term_counts, offsets,
                                      post_docs, post_w, n_docs, per_term)
    masked = torch.where(touched.bool(), scores, NEG_INF)
    s, i = stable_topk(masked, k)
    if k > n_docs:
        s = torch.nn.functional.pad(s, (0, k - n_docs), value=NEG_INF)
        i = torch.nn.functional.pad(i, (0, k - n_docs))
    return s, i
