"""Late-interaction MaxSim (port of ``legalrag_tpu/ops/maxsim.py:25-132``).

    score(q, d) = sum over valid query tokens i of max over valid doc tokens j of q_i . d_j

An empty doc (no valid token) contributes 0 and negative best-matches stay
negative, as in the JAX ``maxsim_full`` and its Pallas kernels.

``maxsim_full`` is the full-corpus [B, N] map of the late channel. On a CUDA
tensor it launches the hand-written kernel ``csrc/maxsim.cu`` (which
replaces the Pallas ``maxsim_scores_pallas`` / ``maxsim_scores_pallas2``):
for bf16 tokens one launch with the products on the tensor cores, for
float32 tokens two launches on the CUDA cores through a [N, B * Lq]
scratch. On a CPU tensor it runs the plain version ``maxsim_full_plain``.
Neither takes an int8 store yet (the kernel has no in-kernel dequant).

``maxsim_topk`` is the late channel's masked top-k over that map
(``legalrag_tpu/ops/maxsim.py:135-142``): columns >= ``valid_n`` NEG_INF,
then ``topk_large``.

``maxsim_candidates`` scores per-query candidate lists [B, C] (the
large-corpus mode's late channel): a batched gather and einsum, as XLA
computes it in JAX. It takes bf16, f32 and int8 stores (int8 holds
``round(v * 127)`` of unit vectors and is widened as ``x * (1 / 127)``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from legalrag_tpu_torch import kernels
from legalrag_tpu_torch.ops.topk import mask_cols, topk_large

INT8_SCALE = 127.0

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_DT = (32, 64, 128)


def _dequant(x: torch.Tensor) -> torch.Tensor:
    """Token tile -> float32 for the product: bf16 and f32 widen exactly,
    int8 rescales by 1/127. The nbit4 store is not ported yet."""
    if x.dtype == torch.int8:
        return x.float() * (1.0 / INT8_SCALE)
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise NotImplementedError(f"token store dtype {x.dtype} is not "
                                  "ported (bf16/f32/int8 only)")
    return x.float()


def maxsim_candidates(doc_tok: torch.Tensor, doc_mask: torch.Tensor,
                      q_tok: torch.Tensor, q_mask: torch.Tensor,
                      cand: torch.Tensor) -> torch.Tensor:
    """MaxSim of per-query candidate lists: doc_tok [N, L, dt], doc_mask
    [N, L] bool, q_tok [B, Lq, dt], q_mask [B, Lq] bool, cand [B, C] row
    ids -> [B, C] float32."""
    docs = _dequant(doc_tok[cand])                     # [B, C, L, dt]
    sim = torch.einsum("bqd,bcld->bcql", _dequant(q_tok), docs)
    sim = sim.masked_fill(~doc_mask[cand][:, :, None, :], float("-inf"))
    best = sim.amax(dim=-1)                            # [B, C, Lq]
    best = torch.where(q_mask[:, None, :], best, 0.0)
    best = torch.where(torch.isfinite(best), best, 0.0)  # empty docs
    return best.sum(dim=-1)


def maxsim_full_plain(doc_tok: torch.Tensor, doc_mask: torch.Tensor,
                      q_tok: torch.Tensor, q_mask: torch.Tensor,
                      budget_bytes: int = 256 << 20) -> torch.Tensor:
    """Plain PyTorch MaxSim map: doc-chunked float32 einsum of the widened
    operands. doc_tok [N, L, dt], doc_mask [N, L] bool, q_tok [B, Lq, dt],
    q_mask [B, Lq] bool -> [B, N] float32."""
    n, l_doc, _ = doc_tok.shape
    b, lq, _ = q_tok.shape
    qf = _dequant(q_tok)
    chunk = max(1, min(n, budget_bytes // max(4 * b * lq * l_doc, 1)))
    out = torch.empty((b, n), dtype=torch.float32, device=doc_tok.device)
    for s in range(0, n, chunk):
        d = _dequant(doc_tok[s:s + chunk])
        sim = torch.einsum("bqd,cld->bcql", qf, d)
        sim = sim.masked_fill(~doc_mask[s:s + chunk][None, :, None, :],
                              float("-inf"))
        best = sim.amax(dim=-1)                              # [B, C, Lq]
        best = torch.where(torch.isfinite(best), best, 0.0)  # empty docs
        best = torch.where(q_mask[:, None, :], best, 0.0)
        out[:, s:s + chunk] = best.sum(dim=-1)
    return out


def maxsim_full(doc_tok: torch.Tensor, doc_mask: torch.Tensor,
                q_tok: torch.Tensor, q_mask: torch.Tensor) -> torch.Tensor:
    """Exact full-corpus MaxSim -> [B, N] float32 (bf16/f32 stores)."""
    if doc_tok.dtype == torch.int8:
        raise NotImplementedError("full-corpus MaxSim over an int8 token "
                                  "store is not ported (no in-kernel "
                                  "dequant); use late_candidates > 0")
    if doc_tok.device.type == "cpu":
        return maxsim_full_plain(doc_tok, doc_mask, q_tok, q_mask)
    return _maxsim_kernel(doc_tok, doc_mask, q_tok, q_mask)


def maxsim_topk(doc_tok: torch.Tensor, doc_mask: torch.Tensor,
                q_tok: torch.Tensor, q_mask: torch.Tensor, valid_n: int,
                k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k rows of the full MaxSim map, rows >= ``valid_n`` scored
    NEG_INF: ([B, k] float32, [B, k] int64)."""
    scores = mask_cols(maxsim_full(doc_tok, doc_mask, q_tok, q_mask), valid_n)
    return topk_large(scores, min(k, scores.shape[1]))


def _maxsim_kernel(doc_tok: torch.Tensor, doc_mask: torch.Tensor,
                   q_tok: torch.Tensor, q_mask: torch.Tensor) -> torch.Tensor:
    dev = doc_tok.device
    if dev.type != "cuda" or any(t.device != dev
                                 for t in (doc_mask, q_tok, q_mask)):
        raise ValueError("maxsim needs all four tensors on one CUDA device")
    if doc_tok.dtype not in _KERNEL_DTYPES or q_tok.dtype != doc_tok.dtype:
        raise TypeError(f"maxsim takes bf16/f32 tokens of one dtype, got "
                        f"{doc_tok.dtype} and {q_tok.dtype}")
    if doc_mask.dtype != torch.bool or q_mask.dtype != torch.bool:
        raise TypeError("maxsim masks must be bool")
    n, l_doc, dt = doc_tok.shape
    b, lq, qdt = q_tok.shape
    if (qdt != dt or doc_mask.shape != (n, l_doc)
            or q_mask.shape != (b, lq)):
        raise ValueError(f"shapes doc {tuple(doc_tok.shape)} mask "
                         f"{tuple(doc_mask.shape)} q {tuple(q_tok.shape)} "
                         f"qmask {tuple(q_mask.shape)}")
    if dt not in _KERNEL_DT:
        raise ValueError(f"maxsim kernel takes token_dim in {_KERNEL_DT}, got {dt}")
    if not all(t.is_contiguous() for t in (doc_tok, doc_mask, q_tok, q_mask)):
        raise ValueError("maxsim needs contiguous tensors")
    if doc_tok.data_ptr() % 16 or q_tok.data_ptr() % 16:
        raise ValueError("maxsim needs 16-byte aligned token tensors")
    out = torch.empty((b, n), dtype=torch.float32, device=dev)
    if b == 0 or n == 0:
        return out
    lib = kernels.lib()
    dtype_id = _KERNEL_DTYPES[doc_tok.dtype]
    if lib.maxsim_smem_bytes(dtype_id, l_doc, dt) < 0:
        raise ValueError(f"doc_maxlen {l_doc} x token_dim {dt} does not fit "
                         f"the {doc_tok.dtype} kernel's shared-memory staging")
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    if doc_tok.dtype == torch.bfloat16:
        # one launch, about one block per SM; the kernel splits the blocks
        # among its query groups and doc slices
        grid = max(n_sm, -(-b // lib.maxsim_queries_per_block()))
        scratch = None
    else:
        grid = max(1, min(n, 2 * n_sm))
        scratch = torch.empty((n, b * lq), dtype=torch.float32, device=dev)
    kernels.launch("maxsim", doc_tok.data_ptr(), doc_mask.data_ptr(),
                   q_tok.data_ptr(), q_mask.data_ptr(), dtype_id, b, lq, n,
                   l_doc, dt, grid,
                   None if scratch is None else scratch.data_ptr(),
                   out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    return out
