"""Device-resident dense index (port of ``legalrag_tpu/index/dense_index.py``).

A [capacity, dim] bf16 or f32 store, capacity rounded up to a multiple of
``capacity_round`` (the same padding as the JAX package, so the dense
capacity, and with it eff_k, match). float32 -> bf16 rounds to nearest even
in both packages. The npz format is the JAX package's: ``emb`` float16
[n, dim], ``dim``, ``n``. The int8 store is not ported yet and raises.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np
import torch

from legalrag_tpu_torch.utils.device import DeviceLike, resolve_device

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def store_dtype(name: str) -> torch.dtype:
    if name not in _DTYPES:
        raise NotImplementedError(f"store dtype {name!r} is not ported yet "
                                  f"(bfloat16/float32 only)")
    return _DTYPES[name]


def round_up(x: int, m: int) -> int:
    """x rounded up to a multiple of m, at least m."""
    return max(m, -(-x // m) * m)


class DenseIndex:
    def __init__(self, dim: int, dtype: str = "bfloat16",
                 capacity_round: int = 1024, device: DeviceLike = None):
        self.dim = dim
        self.dtype = store_dtype(dtype)
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
        """Append [m, dim] float vectors (L2-normalized by the encoder)."""
        m = vectors.shape[0]
        if m == 0:
            return
        if vectors.shape[1] != self.dim:
            raise ValueError(f"vectors of dim {vectors.shape[1]} != {self.dim}")
        self._ensure_capacity(self.n + m)
        self.emb[self.n: self.n + m] = torch.tensor(
            np.asarray(vectors, np.float32), device=self.device).to(self.dtype)
        self.n += m

    # ------------------------------------------------------------- persist
    def save(self, path: str | Path) -> None:
        emb = (self.emb[: self.n].float().cpu().numpy() if self.n
               else np.zeros((0, self.dim), np.float32))
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
