"""Device-resident token-embedding index for late interaction (port of
``TokenIndex`` in ``legalrag_tpu/index/token_index.py``).

A padded, masked [capacity, L, dt] bf16, f32 or int8 store scored by
``ops.maxsim``; capacity rounded like the dense store. An int8 store holds
``clip(round(v * 127), -127, 127)`` of unit vectors (the JAX package's
symmetric quantization, computed by the same numpy code) and its queries
stay float32. Same npz format (``tok`` float16, or int8 with
``quantized=True``; ``mask``, ``token_dim``, ``doc_maxlen``): an int8
payload loads as int8 without requantization. The nbit4 store is not
ported yet and raises.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np
import torch

from legalrag_tpu_torch.index.dense_index import round_up, store_dtype
from legalrag_tpu_torch.ops.maxsim import INT8_SCALE
from legalrag_tpu_torch.utils.device import DeviceLike, resolve_device


def quantize_int8(token_emb: np.ndarray) -> np.ndarray:
    """Symmetric int8 quantization of unit-norm token vectors."""
    return np.clip(np.round(token_emb * INT8_SCALE), -127, 127).astype(np.int8)


class TokenIndex:
    def __init__(self, token_dim: int, doc_maxlen: int = 220,
                 dtype: str = "bfloat16", capacity_round: int = 1024,
                 device: DeviceLike = None):
        self.token_dim = token_dim
        self.doc_maxlen = doc_maxlen
        self.dtype = torch.int8 if dtype == "int8" else store_dtype(dtype)
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
        """Query tokens are cast to the store dtype, and stay float32 over
        an int8 store (a quantized query would lose the similarity scale)."""
        return torch.float32 if self.dtype == torch.int8 else self.dtype

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
        if self.dtype == torch.int8:
            self.add_quantized(quantize_int8(np.asarray(token_emb)), token_mask)
            return
        self._ensure_capacity(self.n + m)
        self.tok[self.n: self.n + m] = torch.tensor(
            np.asarray(token_emb, np.float32), device=self.device).to(self.dtype)
        self.mask[self.n: self.n + m] = torch.tensor(
            np.asarray(token_mask, bool), device=self.device)
        self.n += m

    def add_quantized(self, tok: np.ndarray, token_mask: np.ndarray) -> None:
        """Append an already-quantized [m, L, dt] int8 block and its mask to
        an int8 store, as they are."""
        if self.dtype != torch.int8:
            raise TypeError(f"add_quantized needs an int8 store, not "
                            f"{self.dtype}")
        if tok.dtype != np.int8 or tok.shape[1:] != (self.doc_maxlen,
                                                     self.token_dim):
            raise ValueError(f"int8 block {tok.dtype} {tok.shape} for a store "
                             f"of {(self.doc_maxlen, self.token_dim)}")
        m = tok.shape[0]
        if m == 0:
            return
        self._ensure_capacity(self.n + m)
        self.tok[self.n: self.n + m] = torch.from_numpy(tok).to(self.device)
        self.mask[self.n: self.n + m] = torch.from_numpy(
            np.asarray(token_mask, bool)).to(self.device)
        self.n += m

    # -------------------------------------------------------------- persist
    def save(self, path: str | Path) -> None:
        is_int8 = self.dtype == torch.int8
        if self.n:
            tok = self.tok[: self.n].cpu()
            tok = tok.numpy() if is_int8 else tok.float().numpy().astype(
                np.float16)
            mask = self.mask[: self.n].cpu().numpy()
        else:
            tok = np.zeros((0, self.doc_maxlen, self.token_dim),
                           np.int8 if is_int8 else np.float16)
            mask = np.zeros((0, self.doc_maxlen), bool)
        np.savez_compressed(path, tok=tok, mask=mask,
                            token_dim=self.token_dim,
                            doc_maxlen=self.doc_maxlen,
                            quantized=np.bool_(is_int8))

    @classmethod
    def load(cls, path: str | Path, dtype: str = "bfloat16",
             capacity_round: int = 1024, device: DeviceLike = None
             ) -> "TokenIndex":
        z = np.load(path)
        if "packed" in z.files:
            raise NotImplementedError("the nbit4 token store is not ported "
                                      "yet")
        stored_int8 = "quantized" in z.files and bool(z["quantized"])
        idx = cls(int(z["token_dim"]), int(z["doc_maxlen"]),
                  dtype="int8" if stored_int8 else dtype,
                  capacity_round=capacity_round, device=device)
        if stored_int8:
            idx.add_quantized(z["tok"], z["mask"])
        else:
            idx.add(z["tok"].astype(np.float32), z["mask"])
        return idx
