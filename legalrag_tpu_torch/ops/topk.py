"""Dense scoring and top-k (port of ``legalrag_tpu/ops/topk.py:33-347``).

- ``dense_scores``: [B, d] queries x [N, d] store -> [B, N] float32. Over
  a bf16 or f32 store the query is cast to the store dtype first and both
  are widened to float32 for the product (JAX's
  ``preferred_element_type=f32``). Over the unit-int8 store each query row
  is quantized (``quantize_queries``) and the s8 x s8 product is summed
  exactly in int32 (``int8_dot``), then rescaled, as JAX computes it.
- ``stable_topk``: top-k ordered by (score desc, index asc). It stands in
  for every ``lax.top_k`` of the JAX package, whose ties fall to the lowest
  index; ``torch.topk`` leaves tie order undefined, so it runs over keys
  that never tie.
- ``score_select_topk``: the masked top-k of the full dense map in one
  selection (``lax.top_k``'s order). On a CUDA tensor it launches the
  hand-written score+select kernel (``csrc/score_select.cu``, which
  replaces the Pallas ``_score_select_kernel`` and the merge of its tile
  lists, in one launch); on a CPU tensor it runs the plain version
  ``dense_topk_fused_plain``, which computes the same function.
- ``dense_topk``: the dense channel's masked top-k, routed by size as JAX's
  ``default_backend`` routes it: ``score_select_topk`` below
  ``TWO_PASS_MIN_N`` rows, ``dense_topk_2pass`` from there. An int8 store
  never reaches the score+select kernel (JAX sends it to XLA): below
  ``TWO_PASS_MIN_N`` it is ``stable_topk`` of the masked quantized map.
- ``mask_cols``: a score map aligned to a width, columns past ``valid_n``
  NEG_INF (the mask every channel applies before its selection).
- ``topk_2pass``, ``topk_large``, ``topk_2pass_masked``,
  ``dense_topk_2pass``: the block-max two-pass selection of the
  large-corpus mode, step by step as in JAX (where XLA computes them), with
  ``stable_topk`` wherever JAX calls ``lax.top_k``, so the tie order is
  JAX's. The bf16 map (``dense_scores_bf16``, ``rescore_exact``) is never
  used over an int8 store: its quantized map is already the cheap one, and
  ``q.to(torch.int8)`` would truncate a unit query to zeros.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from legalrag_tpu_torch import kernels
from legalrag_tpu_torch.index.dense_index import round_up

NEG_INF = -1e30

# Below this many columns one full selection is cheap; above it the
# large-corpus mode selects by block maxima first (JAX's threshold).
TWO_PASS_MIN_N = 131_072
TWO_PASS_BLOCK = 512

# corpus rows per tile of the score+select kernel (csrc/score_select.cu TILE)
SCORE_SELECT_TILE = 128

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

INT8_SCALE = 127.0
# torch._int_mm (cuBLASLt's s8 x s8 -> s32 GEMM) takes more than 16 rows and
# widths that are multiples of 8; the queries are zero-padded to this many
# rows at least, on every device, so one route serves every batch size
INT_MM_MIN_ROWS = 24


def bucket_k(k: int, n: int) -> int:
    """Round k up to a small fixed set (the JAX package's compile buckets;
    kept so eff_k, and with it the candidate sets, match)."""
    for b in (8, 16, 32, 64, 128, 256, 512):
        if k <= b:
            return min(b, n) if n else b
    return min(k, n) if n else k


def true_div(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` rounded once, as numpy and XLA divide. A Python divisor
    would let CUDA multiply by its reciprocal instead (one rounding more);
    a tensor divisor is divided by on every device."""
    return x / torch.full_like(x, c)


def quantize_queries(q: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 query quantization of the int8 scorer
    (``legalrag_tpu/ops/topk.py:84-88``): ``qs = max(amax, 1e-8) / 127``,
    ``qq = round(q / qs)`` (half to even). Returns (qq [B, d] int8, qs
    [B, 1] float32)."""
    qf = q.float()
    amax = qf.abs().amax(dim=-1, keepdim=True)
    qs = true_div(torch.clamp(amax, min=1e-8), INT8_SCALE)
    return torch.round(qf / qs).to(torch.int8), qs


def int8_dot(qq: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
    """[B, d] int8 x [N, d] int8 -> [B, N] int32, the exact integer sums
    (JAX's ``dot_general(..., preferred_element_type=int32)``), by
    ``torch._int_mm`` with the rows zero-padded to ``INT_MM_MIN_ROWS`` or
    the next multiple of 8: one route for every batch size and device."""
    b, d = qq.shape
    n = emb.shape[0]
    if d % 8 or n % 8:
        raise ValueError(f"the int8 scorer needs d and the store's rows to "
                         f"be multiples of 8, got d {d}, N {n}")
    rows = max(INT_MM_MIN_ROWS, round_up(b, 8))
    qp = torch.zeros((rows, d), dtype=torch.int8, device=qq.device)
    qp[:b] = qq
    return torch._int_mm(qp, emb.T)[:b]


def dense_scores(emb: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """[B, d] queries x [N, d] store rows -> [B, N] float32. An int8 store
    holds ``round(127 * e)`` of unit rows: the query is quantized per row,
    the s8 x s8 sums are exact, and ``acc * (qs / 127)`` restores the inner
    products (``legalrag_tpu/ops/topk.py:69-94``)."""
    if emb.dtype == torch.int8:
        qq, qs = quantize_queries(q)
        return int8_dot(qq, emb).float() * true_div(qs, INT8_SCALE)
    return torch.matmul(q.to(emb.dtype).float(), emb.float().T)


def stable_topk(scores: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-min(k, n) along the last axis of a float32 or bf16 tensor,
    ordered by (score desc, index asc) with -0.0 below +0.0: the order of
    ``lax.top_k``, which sorts by XLA's float total order.

    One ``torch.topk`` over distinct int64 keys: the score's float32 bits
    made two's-complement (the total order) above the reversed column
    index, so no two keys tie and the largest come in that order."""
    n = scores.shape[-1]
    bits = scores.float().view(torch.int32)
    ordered = bits ^ ((bits >> 31) & 0x7FFFFFFF)
    rev = torch.arange(n - 1, -1, -1, device=scores.device)
    _, idx = torch.topk((ordered.long() << 32) | rev, min(k, n), dim=-1)
    return torch.gather(scores, -1, idx), idx


def dense_topk_fused_plain(emb: torch.Tensor, q: torch.Tensor, valid_n: int,
                           k: int, tile: int = SCORE_SELECT_TILE
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the score+select kernel: float32 matmul of
    the widened operands, rows >= valid_n set to NEG_INF, the top-kp of each
    ``tile`` rows, then the merge of the tile lists. Equals ``stable_topk``
    of the masked map: the lists are in row order and each in (score desc,
    row asc) order, so ``stable_topk`` over their concatenation breaks ties
    by the lower row."""
    n = emb.shape[0]
    k = min(k, n)
    kp = min(k, tile)
    scores = mask_cols(dense_scores(emb, q), valid_n)
    b = scores.shape[0]
    tiles = -(-n // tile)
    pad = tiles * tile - n
    if pad:  # rows that do not exist: -inf, never among the top k
        scores = torch.nn.functional.pad(scores, (0, pad), value=float("-inf"))
    s, i = stable_topk(scores.reshape(b, tiles, tile), kp)
    rows = i + (torch.arange(tiles, device=emb.device) * tile)[None, :, None]
    top_s, pos = stable_topk(s.reshape(b, tiles * kp), k)
    return top_s, torch.gather(rows.reshape(b, tiles * kp), 1, pos)


def score_select_topk(emb: torch.Tensor, q: torch.Tensor, valid_n: int,
                      k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked top-k inner products in one selection: ([B, k] float32
    scores, [B, k] int64 rows), rows >= ``valid_n`` scored NEG_INF. ``k``
    is clamped to N. An int8 store takes ``stable_topk`` of its masked
    quantized map on every device (JAX routes int8 to XLA, never to the
    score+select kernel, ``legalrag_tpu/ops/topk.py:364-368``)."""
    if emb.dtype == torch.int8:
        return stable_topk(mask_cols(dense_scores(emb, q), valid_n),
                           min(k, emb.shape[0]))
    if emb.device.type == "cpu":
        return dense_topk_fused_plain(emb, q, valid_n, k)
    return _score_select(emb, q, valid_n, k)


def dense_topk(emb: torch.Tensor, q: torch.Tensor, valid_n: int, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``score_select_topk`` below ``TWO_PASS_MIN_N`` store rows, the
    block-max ``dense_topk_2pass`` from there (``topk_large``'s route over
    the masked map, without the masked copy)."""
    if emb.shape[0] >= TWO_PASS_MIN_N:
        return dense_topk_2pass(emb, q, valid_n, k)
    return score_select_topk(emb, q, valid_n, k)


def mask_cols(s: torch.Tensor, valid_n: int, n: Optional[int] = None
              ) -> torch.Tensor:
    """A [B, *] score map with columns >= ``valid_n`` set to NEG_INF, first
    aligned to ``n`` columns when given (the channels pad the doc axis
    differently: impact N to 128, dense to ``capacity_round``)."""
    if n is not None and s.shape[1] < n:
        s = torch.nn.functional.pad(s, (0, n - s.shape[1]), value=NEG_INF)
    elif n is not None and s.shape[1] > n:
        s = s[:, :n]
    col = torch.arange(s.shape[1], device=s.device)[None, :]
    return torch.where(col < valid_n, s, torch.full_like(s, NEG_INF))


def _score_select(emb: torch.Tensor, q: torch.Tensor, valid_n: int, k: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of the kernel (after a memset of its tickets): the query
    is rounded to the store dtype inside it, and it writes the merged
    [B, k] scores and int64 rows."""
    if emb.device.type != "cuda" or q.device != emb.device:
        raise ValueError(f"score_select needs emb and q on one CUDA device, "
                         f"got {emb.device} and {q.device}")
    if emb.dtype not in _KERNEL_DTYPES or q.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"score_select takes bf16/f32 stores and queries, "
                        f"got {emb.dtype} and {q.dtype}")
    if emb.ndim != 2 or q.ndim != 2 or q.shape[1] != emb.shape[1]:
        raise ValueError(f"shapes emb {tuple(emb.shape)} q {tuple(q.shape)}")
    n, d = emb.shape
    b = q.shape[0]
    if d % 8 or d > 2048 or not (n and b and k):
        raise ValueError(f"score_select needs d % 8 == 0, d <= 2048 and "
                         f"non-empty inputs, got N {n}, d {d}, B {b}, k {k}")
    if not emb.is_contiguous():
        raise ValueError("score_select needs a contiguous store")
    k = min(k, n)
    qf = q.float().contiguous()     # no copy for the float32 queries
    if emb.data_ptr() % 16 or qf.data_ptr() % 16:
        raise ValueError("score_select needs 16-byte aligned emb and q")
    lib = kernels.lib()
    scratch = torch.empty(lib.score_select_scratch_bytes(b, n, k),
                          dtype=torch.uint8, device=emb.device)
    out_s = torch.empty((b, k), dtype=torch.float32, device=emb.device)
    out_i = torch.empty((b, k), dtype=torch.int64, device=emb.device)
    kernels.launch("score_select", qf.data_ptr(), emb.data_ptr(),
                   _KERNEL_DTYPES[emb.dtype], b, n, d, int(valid_n), k,
                   scratch.data_ptr(), out_s.data_ptr(), out_i.data_ptr(),
                   torch.cuda.current_stream(emb.device).cuda_stream)
    return out_s, out_i


# ---------------------------------------------------------------------------
# Two-pass (block-max) top-k for large N (ops/topk.py:108-268 of the JAX
# package)

def _pad_cols(scores: torch.Tensor, n_pad: int) -> torch.Tensor:
    n = scores.shape[1]
    if n_pad == n:
        return scores
    return torch.nn.functional.pad(scores, (0, n_pad - n), value=NEG_INF)


def _gather_blocks(blk: torch.Tensor, top_blocks: torch.Tensor
                   ) -> torch.Tensor:
    """[B, g, block] blocks, [B, kb] block ids -> [B, kb * block]."""
    b, _, block = blk.shape
    kb = top_blocks.shape[1]
    idx = top_blocks[:, :, None].expand(b, kb, block)
    return torch.gather(blk, 1, idx).reshape(b, kb * block)


def topk_2pass(scores: torch.Tensor, k: int, block: int = TWO_PASS_BLOCK,
               block2: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k of a [B, N] map without a full-width sort: the top-k
    blocks by block maximum, then the top-k of their columns (recursing once
    with ``block2`` when those are wide). Tie order is JAX's, which is not
    always (score desc, index asc) across blocks."""
    b, n = scores.shape
    if k >= n:
        vals, idx = stable_topk(scores, n)
        if k > n:
            vals = torch.nn.functional.pad(vals, (0, k - n), value=NEG_INF)
            idx = torch.cat([idx, idx[:, -1:].expand(b, k - n)], dim=1)
        return vals, idx
    scores = _pad_cols(scores, round_up(n, block))
    g = scores.shape[1] // block
    blk = scores.reshape(b, g, block)
    kb = min(k, g)
    _, top_blocks = stable_topk(blk.amax(dim=2), kb)
    cand = _gather_blocks(blk, top_blocks)
    if block2 and kb * block > 8192:
        top_s, pos = topk_2pass(cand, k, block=block2, block2=0)
    else:
        top_s, pos = stable_topk(cand, k)
    blk_of = torch.gather(top_blocks, 1, pos // block)
    # NEG_INF slots may sit in the rounding pad beyond n: clamp the row id
    return top_s, torch.clamp(blk_of * block + pos % block, max=n - 1)


def topk_large(scores: torch.Tensor, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two-pass past ``TWO_PASS_MIN_N`` columns, one ``stable_topk`` below."""
    if scores.shape[1] >= TWO_PASS_MIN_N and k < scores.shape[1]:
        return topk_2pass(scores, k)
    return stable_topk(scores, k)


def topk_2pass_masked(scores: torch.Tensor, valid_n: int, k: int,
                      block: int = TWO_PASS_BLOCK, block2: int = 128
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k of ``scores[:, :valid_n]`` (columns past it NEG_INF) with the
    mask applied at block granularity: invalid blocks leave the block-max
    array, the block that straddles ``valid_n`` is re-maxed under its column
    mask, and the gathered candidates are masked by column. No masked copy
    of the [B, N] map is made."""
    b, n = scores.shape
    valid_n = int(valid_n)
    if k >= n or n < 2 * block:
        return topk_2pass(mask_cols(scores, valid_n), k, block=block,
                          block2=block2)
    scores = _pad_cols(scores, round_up(n, block))
    g = scores.shape[1] // block
    blk = scores.reshape(b, g, block)
    bidx = torch.arange(g, device=scores.device)
    bmax = torch.where(bidx[None, :] * block < valid_n, blk.amax(dim=2),
                       NEG_INF)
    vb = valid_n // block
    if vb < g:  # the straddling block: re-max under the column mask
        bcol = vb * block + torch.arange(block, device=scores.device)
        mb = torch.where(bcol[None, :] < valid_n, blk[:, vb], NEG_INF)
        bmax[:, vb] = mb.amax(dim=1)
    kb = min(k, g)
    _, top_blocks = stable_topk(bmax, kb)
    cand = _gather_blocks(blk, top_blocks)
    cand_col = (top_blocks[:, :, None] * block
                + torch.arange(block, device=scores.device)[None, None, :]
                ).reshape(b, kb * block)
    cand = torch.where(cand_col < valid_n, cand, NEG_INF)
    if block2 and kb * block > 8192:
        top_s, pos = topk_2pass(cand, k, block=block2, block2=0)
    else:
        top_s, pos = stable_topk(cand, k)
    return top_s, torch.clamp(torch.gather(cand_col, 1, pos), max=n - 1)


def rescore_exact(emb: torch.Tensor, q: torch.Tensor, s_lp: torch.Tensor,
                  idx: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Winners of a bf16 map rescored in float32 from their rows (the query
    rounded to the store dtype, as in ``dense_scores``), NEG_INF slots kept,
    then re-ordered by a stable descending sort (``jnp.argsort(-s)``). Not
    for an int8 store, whose map is never written in bf16."""
    _no_int8(emb, "rescore_exact")
    rows = emb[idx].float()                                    # [B, k, d]
    exact = torch.einsum("bd,bkd->bk", q.to(emb.dtype).float(), rows)
    exact = torch.where(s_lp.float() > NEG_INF / 2, exact, NEG_INF)
    order = torch.argsort(-exact, dim=1, stable=True)
    return torch.gather(exact, 1, order), torch.gather(idx, 1, order)


def dense_scores_bf16(emb: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """[B, N] dense map written in bf16 (products summed in float32 by the
    matmul, rounded once). Not for an int8 store."""
    _no_int8(emb, "dense_scores_bf16")
    return torch.matmul(q.to(torch.bfloat16), emb.to(torch.bfloat16).T)


def _no_int8(emb: torch.Tensor, what: str) -> None:
    if emb.dtype == torch.int8:
        raise TypeError(f"{what} takes bf16/f32 stores: over an int8 store "
                        f"the quantized map is the exact route")


def dense_topk_2pass(emb: torch.Tensor, q: torch.Tensor, valid_n: int, k: int,
                     block: int = TWO_PASS_BLOCK, map_bf16: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k inner products by ``topk_2pass_masked``. ``map_bf16`` selects
    on a bf16 map and rescores the k winners exactly (``rescore_exact``);
    an int8 store ignores it, as in JAX (``topk.py:255``)."""
    if map_bf16 and emb.dtype != torch.int8:
        s_lp, idx = topk_2pass_masked(dense_scores_bf16(emb, q), valid_n, k,
                                      block=block)
        return rescore_exact(emb, q, s_lp, idx)
    return topk_2pass_masked(dense_scores(emb, q), valid_n, k, block=block)
