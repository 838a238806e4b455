"""Device-resident token-embedding index for late interaction (port of
``TokenIndex`` in ``legalrag_tpu/index/token_index.py``).

A padded, masked [capacity, L, dt] bf16 or f32 store scored by
``ops.maxsim``; capacity rounded like the dense store. Same npz format
(``tok`` float16, ``mask``, ``token_dim``, ``doc_maxlen``, ``quantized``).
The int8 and nbit4 stores are not ported yet and raise.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np
import torch

from legalrag_tpu_torch.index.dense_index import round_up, store_dtype
from legalrag_tpu_torch.utils.device import DeviceLike, resolve_device


class TokenIndex:
    def __init__(self, token_dim: int, doc_maxlen: int = 220,
                 dtype: str = "bfloat16", capacity_round: int = 1024,
                 device: DeviceLike = None):
        self.token_dim = token_dim
        self.doc_maxlen = doc_maxlen
        self.dtype = store_dtype(dtype)
        self.capacity_round = capacity_round
        self.device = resolve_device(device)
        self.n = 0
        self.tok: Optional[torch.Tensor] = None   # [cap, L, dt]
        self.mask: Optional[torch.Tensor] = None  # [cap, L] bool

    @property
    def capacity(self) -> int:
        return 0 if self.tok is None else self.tok.shape[0]

    @property
    def query_dtype(self) -> torch.dtype:
        """Query tokens are cast to the store dtype (bf16/f32 stores)."""
        return self.dtype

    def _ensure_capacity(self, need: int) -> None:
        if need <= self.capacity:
            return
        cap = round_up(need, self.capacity_round)
        tok = torch.zeros((cap, self.doc_maxlen, self.token_dim),
                          dtype=self.dtype, device=self.device)
        mask = torch.zeros((cap, self.doc_maxlen), dtype=torch.bool,
                           device=self.device)
        if self.tok is not None and self.n:
            tok[: self.n] = self.tok[: self.n]
            mask[: self.n] = self.mask[: self.n]
        self.tok, self.mask = tok, mask

    def add(self, token_emb: np.ndarray, token_mask: np.ndarray) -> None:
        """Append [m, L, dt] per-token embeddings with their [m, L] mask."""
        m = token_emb.shape[0]
        if m == 0:
            return
        if token_emb.shape[1:] != (self.doc_maxlen, self.token_dim):
            raise ValueError(f"token block {token_emb.shape[1:]} != "
                             f"{(self.doc_maxlen, self.token_dim)}")
        self._ensure_capacity(self.n + m)
        self.tok[self.n: self.n + m] = torch.tensor(
            np.asarray(token_emb, np.float32), device=self.device).to(self.dtype)
        self.mask[self.n: self.n + m] = torch.tensor(
            np.asarray(token_mask, bool), device=self.device)
        self.n += m

    # -------------------------------------------------------------- persist
    def save(self, path: str | Path) -> None:
        if self.n:
            tok = self.tok[: self.n].float().cpu().numpy().astype(np.float16)
            mask = self.mask[: self.n].cpu().numpy()
        else:
            tok = np.zeros((0, self.doc_maxlen, self.token_dim), np.float16)
            mask = np.zeros((0, self.doc_maxlen), bool)
        np.savez_compressed(path, tok=tok, mask=mask,
                            token_dim=self.token_dim,
                            doc_maxlen=self.doc_maxlen,
                            quantized=np.bool_(False))

    @classmethod
    def load(cls, path: str | Path, dtype: str = "bfloat16",
             capacity_round: int = 1024, device: DeviceLike = None
             ) -> "TokenIndex":
        z = np.load(path)
        if "packed" in z.files or ("quantized" in z.files
                                   and bool(z["quantized"])):
            raise NotImplementedError("int8 / nbit4 token stores are not "
                                      "ported yet")
        idx = cls(int(z["token_dim"]), int(z["doc_maxlen"]), dtype=dtype,
                  capacity_round=capacity_round, device=device)
        idx.add(z["tok"].astype(np.float32), z["mask"])
        return idx
