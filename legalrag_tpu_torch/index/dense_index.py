"""Device-resident dense index (port of ``legalrag_tpu/index/dense_index.py``).

A [capacity, dim] bf16, f32 or int8 store, capacity rounded up to a
multiple of ``capacity_round`` (the same padding as the JAX package, so the
dense capacity, and with it eff_k, match). float32 -> bf16 rounds to
nearest even in both packages. The unit-int8 store holds
``rint(clip(v, -1, 1) * 127)`` of the encoder's unit rows (implicit scale
1/127, half the bf16 store's bytes) and is scored by ``ops.topk``'s int8
route: the query quantized per row, exact s8 x s8 sums. The npz format is
the JAX package's: ``emb`` float16 [n, dim] (an int8 store saves
``codes / 127`` and re-quantizes on load), ``dim``, ``n``.

``topk`` (the dense channel of the serving path) selects through
``ops.topk.dense_topk``, which routes by size as JAX's does: the
score+select kernel below ``TWO_PASS_MIN_N`` rows, the block-max two-pass
selection from there.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from legalrag_tpu_torch.utils.device import DeviceLike, resolve_device

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "int8": torch.int8}


def store_dtype(name: str) -> torch.dtype:
    if name not in _DTYPES:
        raise NotImplementedError(f"store dtype {name!r} is not ported "
                                  f"(bfloat16/float32/int8)")
    return _DTYPES[name]


def quantize_unit_rows(vectors: np.ndarray) -> np.ndarray:
    """The unit-int8 form of [m, dim] vectors, ``rint(clip(v, -1, 1) *
    127)`` (``legalrag_tpu/index/dense_index.py:66-68``)."""
    v = np.clip(np.asarray(vectors, np.float32), -1.0, 1.0)
    return np.rint(v * 127.0).astype(np.int8)


def round_up(x: int, m: int) -> int:
    """x rounded up to a multiple of m, at least m."""
    return max(m, -(-x // m) * m)


class DenseIndex:
    def __init__(self, dim: int, dtype: str = "bfloat16",
                 capacity_round: int = 1024, device: DeviceLike = None):
        self.dim = dim
        self.dtype = store_dtype(dtype)
        if self.dtype == torch.int8 and (capacity_round % 8 or dim % 8):
            raise ValueError(f"an int8 dense store needs capacity_round and "
                             f"dim multiples of 8 (ops.topk.int8_dot), got "
                             f"{capacity_round} and {dim}")
        self.capacity_round = capacity_round
        self.device = resolve_device(device)
        self.n = 0
        self.emb: Optional[torch.Tensor] = None  # [cap, dim]

    @property
    def capacity(self) -> int:
        return 0 if self.emb is None else self.emb.shape[0]

    def _ensure_capacity(self, need: int) -> None:
        if need <= self.capacity:
            return
        cap = round_up(need, self.capacity_round)
        new = torch.zeros((cap, self.dim), dtype=self.dtype, device=self.device)
        if self.emb is not None and self.n:
            new[: self.n] = self.emb[: self.n]
        self.emb = new

    def add(self, vectors: np.ndarray) -> None:
        """Append [m, dim] float vectors (L2-normalized by the encoder); an
        int8 store quantizes them (``quantize_unit_rows``)."""
        if vectors.shape[0] == 0:
            return
        if vectors.shape[1:] != (self.dim,):
            raise ValueError(f"vectors of shape {vectors.shape} for dim "
                             f"{self.dim}")
        if self.dtype == torch.int8:
            self.add_quantized(quantize_unit_rows(vectors))
            return
        self._put(torch.tensor(np.asarray(vectors, np.float32),
                               device=self.device).to(self.dtype))

    def add_quantized(self, codes: np.ndarray) -> None:
        """Append [m, dim] int8 codes to an int8 store as they are (a JAX
        int8 store's rows carried over, ``convert.bundle_from_arrays``)."""
        if self.dtype != torch.int8:
            raise TypeError(f"add_quantized needs an int8 store, not "
                            f"{self.dtype}")
        if codes.dtype != np.int8 or codes.shape[1:] != (self.dim,):
            raise ValueError(f"int8 rows {codes.dtype} {codes.shape} for dim "
                             f"{self.dim}")
        self._put(torch.tensor(codes, device=self.device))

    def _put(self, rows: torch.Tensor) -> None:
        m = rows.shape[0]
        if m == 0:
            return
        self._ensure_capacity(self.n + m)
        self.emb[self.n: self.n + m] = rows
        self.n += m

    def topk(self, q: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """[B, dim] float queries -> (scores [B, k], row ids [B, k]) on the
        host; the query is rounded to the store dtype (or quantized per row
        over an int8 store) inside the scorer."""
        # here, not at the top: ops.topk imports this module
        from legalrag_tpu_torch.ops import topk as topk_ops

        if self.n == 0:
            b = q.shape[0]
            return np.zeros((b, 0), np.float32), np.zeros((b, 0), np.int64)
        k = min(k, self.n)
        kb = topk_ops.bucket_k(k, self.capacity)
        qt = torch.from_numpy(np.array(q, np.float32)).to(self.device)
        s, i = topk_ops.dense_topk(self.emb, qt, self.n, kb)
        return s[:, :k].cpu().numpy(), i[:, :k].cpu().numpy()

    def score_rows(self, q: np.ndarray, rows: np.ndarray) -> np.ndarray:
        """Inner products of one query [dim] with the given rows [m] (the
        graph channel's scorer), summed in float32: the query rounded to the
        store dtype, or, over an int8 store, the float32 query against the
        rows divided by 127 (a division, as JAX's ``score_rows`` does; the
        MaxSim dequant multiplies by 1/127 instead)."""
        from legalrag_tpu_torch.ops.topk import INT8_SCALE, true_div

        if len(rows) == 0:
            return np.zeros(0, np.float32)
        idx = torch.from_numpy(np.array(rows, np.int64)).to(self.device)
        qt = torch.from_numpy(np.array(q, np.float32)).to(self.device)
        if self.dtype == torch.int8:
            s = torch.matmul(true_div(self.emb[idx].float(), INT8_SCALE), qt)
        else:
            s = torch.matmul(self.emb[idx].float(), qt.to(self.dtype).float())
        return s.cpu().numpy()

    # ------------------------------------------------------------- persist
    def save(self, path: str | Path) -> None:
        emb = (self.emb[: self.n].float().cpu().numpy() if self.n
               else np.zeros((0, self.dim), np.float32))
        if self.dtype == torch.int8:
            emb = emb / 127.0  # the file stays dtype-agnostic float16
        np.savez_compressed(path, emb=emb.astype(np.float16),
                            dim=self.dim, n=self.n)

    @classmethod
    def load(cls, path: str | Path, dtype: str = "bfloat16",
             capacity_round: int = 1024, device: DeviceLike = None
             ) -> "DenseIndex":
        z = np.load(path)
        idx = cls(int(z["dim"]), dtype=dtype, capacity_round=capacity_round,
                  device=device)
        idx.add(z["emb"].astype(np.float32))
        return idx
