"""Dense scoring and top-k (port of ``legalrag_tpu/ops/topk.py:33-94, 274-347``).

- ``dense_scores``: [B, d] queries x [N, d] store -> [B, N] float32, the
  query cast to the store dtype first and both widened to float32 for the
  product (JAX's ``preferred_element_type=f32``).
- ``stable_topk``: top-k ordered by (score desc, index asc). It stands in
  for every ``lax.top_k`` of the JAX package, whose ties fall to the lowest
  index; ``torch.topk`` leaves tie order undefined.
- ``dense_topk``: the dense channel's masked top-k. On a CUDA tensor it
  launches the hand-written score+select kernel (``csrc/score_select.cu``,
  which replaces the Pallas ``_score_select_kernel``) and merges its
  tile-local lists with ``stable_topk``; on a CPU tensor it runs the plain
  version ``dense_topk_fused_plain``, which computes the same function.
"""

from __future__ import annotations

from typing import Tuple

import torch

from legalrag_tpu_torch import kernels

NEG_INF = -1e30

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
    """Top-k along the last axis, ordered by (score desc, index asc)."""
    s, i = torch.sort(scores, dim=-1, descending=True, stable=True)
    return s[..., :k], i[..., :k]


def _merge_tiles(cand_s: torch.Tensor, cand_i: torch.Tensor, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[tiles, B, kp] tile-local lists -> [B, k]. Tiles are in row order and
    each list in (score desc, row asc) order, so a stable sort over the
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
