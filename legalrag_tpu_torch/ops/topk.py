"""Dense scoring and top-k (port of ``legalrag_tpu/ops/topk.py:33-347``).

- ``dense_scores``: [B, d] queries x [N, d] store -> [B, N] float32, the
  query cast to the store dtype first and both widened to float32 for the
  product (JAX's ``preferred_element_type=f32``).
- ``stable_topk``: top-k ordered by (score desc, index asc). It stands in
  for every ``lax.top_k`` of the JAX package, whose ties fall to the lowest
  index; ``torch.topk`` leaves tie order undefined, so it runs over keys
  that never tie.
- ``dense_topk``: the dense channel's masked top-k. On a CUDA tensor it
  launches the hand-written score+select kernel (``csrc/score_select.cu``,
  which replaces the Pallas ``_score_select_kernel``) and merges its
  tile-local lists with ``stable_topk``; on a CPU tensor it runs the plain
  version ``dense_topk_fused_plain``, which computes the same function.
- ``topk_2pass``, ``topk_large``, ``topk_2pass_masked``,
  ``dense_topk_2pass``: the block-max two-pass selection of the
  large-corpus mode, step by step as in JAX (where XLA computes them), with
  ``stable_topk`` wherever JAX calls ``lax.top_k``, so the tie order is
  JAX's.
"""

from __future__ import annotations

from typing import Tuple

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


def bucket_k(k: int, n: int) -> int:
    """Round k up to a small fixed set (the JAX package's compile buckets;
    kept so eff_k, and with it the candidate sets, match)."""
    for b in (8, 16, 32, 64, 128, 256, 512):
        if k <= b:
            return min(b, n) if n else b
    return min(k, n) if n else k


def dense_scores(emb: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """[B, d] queries x [N, d] bf16/f32 embedding rows -> [B, N] float32."""
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


def _merge_tiles(cand_s: torch.Tensor, cand_i: torch.Tensor, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[tiles, B, kp] tile-local lists -> [B, k]. Tiles are in row order and
    each list in (score desc, row asc) order, so ``stable_topk`` over the
    concatenation breaks ties by the lower row."""
    tiles, b, kp = cand_s.shape
    cs = cand_s.permute(1, 0, 2).reshape(b, tiles * kp)
    ci = cand_i.permute(1, 0, 2).reshape(b, tiles * kp)
    top_s, pos = stable_topk(cs, k)
    return top_s, torch.gather(ci, 1, pos).long()


def dense_topk_fused_plain(emb: torch.Tensor, q: torch.Tensor, valid_n: int,
                           k: int, tile: int = SCORE_SELECT_TILE
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the score+select kernel: float32 matmul of
    the widened operands, rows >= valid_n set to NEG_INF, the top-kp of each
    ``tile`` rows, then the merge. Equals ``stable_topk`` of the masked map."""
    n = emb.shape[0]
    k = min(k, n)
    kp = min(k, tile)
    scores = dense_scores(emb, q)
    b = scores.shape[0]
    col = torch.arange(n, device=emb.device)
    scores = torch.where(col[None, :] < valid_n, scores,
                         torch.full_like(scores, NEG_INF))
    tiles = -(-n // tile)
    pad = tiles * tile - n
    if pad:  # rows that do not exist: -inf, never among the top k
        scores = torch.nn.functional.pad(scores, (0, pad), value=float("-inf"))
    s, i = stable_topk(scores.reshape(b, tiles, tile), kp)
    rows = i + (torch.arange(tiles, device=emb.device) * tile)[None, :, None]
    return _merge_tiles(s.permute(1, 0, 2), rows.permute(1, 0, 2), k)


def dense_topk(emb: torch.Tensor, q: torch.Tensor, valid_n: int, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked top-k inner products: ([B, k] float32 scores, [B, k] int64
    rows), rows >= ``valid_n`` scored NEG_INF. ``k`` is clamped to N."""
    if emb.device.type == "cpu":
        return dense_topk_fused_plain(emb, q, valid_n, k)
    return _score_select(emb, q, valid_n, k)


def _score_select(emb: torch.Tensor, q: torch.Tensor, valid_n: int, k: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    if emb.device.type != "cuda" or q.device != emb.device:
        raise ValueError(f"score_select needs emb and q on one CUDA device, "
                         f"got {emb.device} and {q.device}")
    if emb.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"score_select takes bf16/f32 stores, got {emb.dtype}")
    if emb.ndim != 2 or q.ndim != 2 or q.shape[1] != emb.shape[1]:
        raise ValueError(f"shapes emb {tuple(emb.shape)} q {tuple(q.shape)}")
    n, d = emb.shape
    b = q.shape[0]
    if d % 8 or d > 4096:
        raise ValueError(f"score_select needs d % 8 == 0 and d <= 4096, got {d}")
    if not emb.is_contiguous():
        raise ValueError("score_select needs a contiguous store")
    tile = kernels.lib().score_select_tile()
    k = min(k, n)
    kp = min(k, tile)
    tiles = -(-n // tile)
    qc = q.to(emb.dtype).contiguous()
    out_s = torch.empty((tiles, b, kp), dtype=torch.float32, device=emb.device)
    out_i = torch.empty((tiles, b, kp), dtype=torch.int32, device=emb.device)
    kernels.launch("score_select", qc.data_ptr(), emb.data_ptr(),
                   _KERNEL_DTYPES[emb.dtype], b, n, d, int(valid_n), kp,
                   out_s.data_ptr(), out_i.data_ptr(),
                   torch.cuda.current_stream(emb.device).cuda_stream)
    return _merge_tiles(out_s, out_i, k)


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
        col = torch.arange(n, device=scores.device)[None, :]
        return topk_2pass(torch.where(col < valid_n, scores, NEG_INF), k,
                          block=block, block2=block2)
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
    then re-ordered by a stable descending sort (``jnp.argsort(-s)``)."""
    rows = emb[idx].float()                                    # [B, k, d]
    exact = torch.einsum("bd,bkd->bk", q.to(emb.dtype).float(), rows)
    exact = torch.where(s_lp.float() > NEG_INF / 2, exact, NEG_INF)
    order = torch.argsort(-exact, dim=1, stable=True)
    return torch.gather(exact, 1, order), torch.gather(idx, 1, order)


def dense_scores_bf16(emb: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """[B, N] dense map written in bf16 (products summed in float32 by the
    matmul, rounded once)."""
    return torch.matmul(q.to(torch.bfloat16), emb.to(torch.bfloat16).T)


def dense_topk_2pass(emb: torch.Tensor, q: torch.Tensor, valid_n: int, k: int,
                     block: int = TWO_PASS_BLOCK, map_bf16: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k inner products by ``topk_2pass_masked``. ``map_bf16`` selects
    on a bf16 map and rescores the k winners exactly (``rescore_exact``)."""
    if map_bf16:
        s_lp, idx = topk_2pass_masked(dense_scores_bf16(emb, q), valid_n, k,
                                      block=block)
        return rescore_exact(emb, q, s_lp, idx)
    return topk_2pass_masked(dense_scores(emb, q), valid_n, k, block=block)
