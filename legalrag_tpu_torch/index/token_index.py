"""Device-resident token-embedding indexes for late interaction (port of
``legalrag_tpu/index/token_index.py``).

``TokenIndex``: a padded, masked [capacity, L, dt] bf16, f32 or int8 store
scored by ``ops.maxsim``; capacity rounded like the dense store. An int8
store holds ``clip(round(v * 127), -127, 127)`` of unit vectors (the JAX
package's symmetric quantization, computed by the same numpy code) and its
queries stay float32. Same npz format (``tok`` float16, or int8 with
``quantized=True``; ``mask``, ``token_dim``, ``doc_maxlen``): an int8
payload loads as int8 without requantization.

``Residual4TokenIndex``: the PLAID-class nbit4 store
(``engine.token_dtype="nbit4"``): each token is the nearest of 256
centroids plus a 4-bit residual code a dimension, scaled per dimension; 1 +
dt / 2 bytes a token against 2 * dt for bf16. The k-means (seeded
``default_rng(0)``), the residual scales and the encoding are the JAX
package's numpy code, so both packages give the same bytes from the same
tokens. The first ``add`` trains the codebook; later adds (an ingest
append) encode with it. Its npz (``codes_c``, ``packed``, ``mask``,
``centroids``, ``scales``, ``token_dim``, ``doc_maxlen``) is the JAX
package's, and ``TokenIndex.load`` dispatches such a payload to it.

``topk`` (the late channel's full scan) goes through ``ops.maxsim``'s
``maxsim_topk``, so on the card it launches the MaxSim kernel;
``score_candidates`` (the two-phase route and the MaxSim reranker) scores
[B, C] gathered rows with ``maxsim_candidates``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from legalrag_tpu_torch.index.dense_index import round_up, store_dtype
from legalrag_tpu_torch.ops.maxsim import (
    INT8_SCALE,
    Residual4Store,
    maxsim_candidates,
    maxsim_topk,
)
from legalrag_tpu_torch.ops.topk import bucket_k
from legalrag_tpu_torch.utils.device import DeviceLike, resolve_device


def quantize_int8(token_emb: np.ndarray) -> np.ndarray:
    """Symmetric int8 quantization of unit-norm token vectors."""
    return np.clip(np.round(token_emb * INT8_SCALE), -127, 127).astype(np.int8)


def make_token_index(token_dim: int, doc_maxlen: int, dtype: str,
                     capacity_round: int = 1024, device: DeviceLike = None):
    """The empty token store for ``dtype`` (``engine.token_dtype or
    engine.dtype``, ``legalrag_tpu/index/bundle.py:55-66``): the nbit4
    residual store, or a bf16 / f32 / int8 ``TokenIndex``."""
    if dtype == "nbit4":
        return Residual4TokenIndex(token_dim, doc_maxlen,
                                   capacity_round=capacity_round,
                                   device=device)
    return TokenIndex(token_dim, doc_maxlen, dtype, capacity_round, device)


class _Scored:
    """Scoring shared by both stores: ``tok`` (the store as
    ``ops.maxsim`` takes it), ``mask``, ``n``, ``capacity``, ``device`` and
    ``query_dtype`` come from the store."""

    def _queries(self, q_tok: np.ndarray, q_mask: np.ndarray):
        return (torch.from_numpy(np.asarray(q_tok, np.float32)).to(
                    self.device).to(self.query_dtype),
                torch.from_numpy(np.asarray(q_mask, bool)).to(self.device))

    def score_candidates(self, q_tok: np.ndarray, q_mask: np.ndarray,
                         cand: np.ndarray) -> np.ndarray:
        """[B, Lq, dt] query tokens x [B, C] candidate rows -> [B, C]
        float32 scores on the host."""
        qt, qm = self._queries(q_tok, q_mask)
        rows = torch.from_numpy(np.asarray(cand, np.int64)).to(self.device)
        return maxsim_candidates(self.tok, self.mask, qt, qm, rows).cpu().numpy()

    def topk(self, q_tok: np.ndarray, q_mask: np.ndarray, k: int
             ) -> Tuple[np.ndarray, np.ndarray]:
        """Full-scan MaxSim top-k: (scores [B, k], row ids [B, k]) on the
        host."""
        if self.n == 0:
            b = q_tok.shape[0]
            return np.zeros((b, 0), np.float32), np.zeros((b, 0), np.int64)
        k = min(k, self.n)
        kb = bucket_k(k, self.capacity)
        qt, qm = self._queries(q_tok, q_mask)
        s, i = maxsim_topk(self.tok, self.mask, qt, qm, self.n, kb)
        return s[:, :k].cpu().numpy(), i[:, :k].cpu().numpy()

    def dequantized(self) -> Tuple[np.ndarray, np.ndarray]:
        return self.dequantized_rows(0, self.capacity)


class TokenIndex(_Scored):
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

    def dequantized_rows(self, start: int, stop: int
                         ) -> Tuple[np.ndarray, np.ndarray]:
        """Host float32 values and mask of rows [start, stop) (an int8
        store rescaled by 1/127, as ``ops.maxsim.dequant`` widens it)."""
        stop = min(stop, self.capacity)
        tok = self.tok[start:stop].float().cpu().numpy()
        if self.dtype == torch.int8:
            tok *= 1.0 / 127.0
        return tok, self.mask[start:stop].cpu().numpy()

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
        if "packed" in z.files:  # an nbit4 payload stays nbit4, like int8
            return Residual4TokenIndex.load(path,
                                            capacity_round=capacity_round,
                                            device=device)
        stored_int8 = "quantized" in z.files and bool(z["quantized"])
        idx = cls(int(z["token_dim"]), int(z["doc_maxlen"]),
                  dtype="int8" if stored_int8 else dtype,
                  capacity_round=capacity_round, device=device)
        if stored_int8:
            idx.add_quantized(z["tok"], z["mask"])
        else:
            idx.add(z["tok"].astype(np.float32), z["mask"])
        return idx


# ---------------------------------------------------------------------------
# PLAID-class nbits=4 residual compression (legalrag_tpu/index/token_index.py:
# 177-433)

class Residual4TokenIndex(_Scored):
    """The nbit4 store: codes_c [cap, L] uint8, packed [cap, L, dt // 2]
    uint8 (dim 2k in the high nibble, +8 bias), mask [cap, L] bool on the
    device; the codebook (centroids [256, dt], scales [dt]) on the host and
    the device. ``tok`` is the ``ops.maxsim.Residual4Store`` the MaxSim
    kernel and the plain versions take."""

    K = 256
    TRAIN_SAMPLE = 65536
    KMEANS_ITERS = 8

    def __init__(self, token_dim: int, doc_maxlen: int = 220,
                 capacity_round: int = 1024, device: DeviceLike = None):
        if token_dim % 2:
            raise ValueError("nbit4 packs two dims a byte: token_dim must "
                             "be even")
        self.token_dim = token_dim
        self.doc_maxlen = doc_maxlen
        self.dtype = "nbit4"
        self.capacity_round = capacity_round
        self.device = resolve_device(device)
        self.n = 0
        self.codes_c: Optional[torch.Tensor] = None  # [cap, L] uint8
        self.packed: Optional[torch.Tensor] = None   # [cap, L, dt // 2] uint8
        self.mask: Optional[torch.Tensor] = None     # [cap, L] bool
        self.centroids: Optional[np.ndarray] = None  # [K, dt] float32
        self.scales: Optional[np.ndarray] = None     # [dt] float32
        self._codebook: Optional[Tuple[torch.Tensor, ...]] = None

    @property
    def capacity(self) -> int:
        return 0 if self.codes_c is None else self.codes_c.shape[0]

    @property
    def query_dtype(self) -> torch.dtype:
        return torch.float32

    @property
    def tok(self) -> Optional[Residual4Store]:
        """The device store in the form ``ops.maxsim`` takes."""
        if self.codes_c is None:
            return None
        return Residual4Store(self.codes_c, self.packed, *self._codebook)

    def set_codebook(self, centroids: np.ndarray, scales: np.ndarray) -> None:
        """Install [K, dt] centroids and [dt] scales (trained, loaded or
        carried over) on the host and the device; ``step = scales / 7`` is
        divided once here, in float32."""
        self.centroids = np.asarray(centroids, np.float32)
        self.scales = np.asarray(scales, np.float32)
        step = (self.scales / np.float32(7.0)).astype(np.float32)
        self._codebook = tuple(torch.from_numpy(np.array(a)).to(self.device)
                               for a in (self.centroids, self.scales, step))

    # -------------------------------------------------------------- training
    def _train(self, token_emb: np.ndarray, token_mask: np.ndarray) -> None:
        """k-means over a token sample + robust per-dim residual scales
        (99.5th percentile of |residual|), the JAX package's numpy code."""
        flat = token_emb.reshape(-1, self.token_dim)[
            token_mask.reshape(-1).astype(bool)]
        if flat.shape[0] == 0:
            flat = np.zeros((1, self.token_dim), np.float32)
        rng = np.random.default_rng(0)
        if flat.shape[0] > self.TRAIN_SAMPLE:
            flat = flat[rng.choice(flat.shape[0], self.TRAIN_SAMPLE,
                                   replace=False)]
        k = min(self.K, flat.shape[0])
        cent = flat[rng.choice(flat.shape[0], k, replace=False)].astype(
            np.float32).copy()
        for _ in range(self.KMEANS_ITERS):
            assign = np.argmax(flat @ cent.T - 0.5 * (cent ** 2).sum(1), 1)
            for c in range(k):
                sel = assign == c
                if sel.any():
                    cent[c] = flat[sel].mean(0)
        if k < self.K:  # pad to K so shapes stay static
            cent = np.concatenate([cent, np.tile(cent[-1:],
                                                 (self.K - k, 1))], 0)
        res = flat - cent[np.argmax(flat @ cent.T
                                    - 0.5 * (cent ** 2).sum(1), 1)]
        scales = np.quantile(np.abs(res), 0.995, axis=0).astype(np.float32)
        self.set_codebook(cent.astype(np.float32), np.maximum(scales, 1e-6))

    def _encode(self, token_emb: np.ndarray
                ) -> Tuple[np.ndarray, np.ndarray]:
        """[m, L, dt] -> (codes_c uint8 [m, L], packed uint8 [m, L, dt //
        2]), in chunks of 2^19 tokens with scratch reused across them."""
        m = token_emb.shape[0]
        flat = np.asarray(token_emb, np.float32).reshape(-1, self.token_dim)
        half_norms = 0.5 * (self.centroids ** 2).sum(1)
        codes_c = np.empty(flat.shape[0], np.uint8)
        packed = np.empty((flat.shape[0], self.token_dim // 2), np.uint8)
        step = 1 << 19
        cT = np.ascontiguousarray(self.centroids.T)
        rows = min(step, flat.shape[0])
        sims = np.empty((rows, cT.shape[1]), np.float32)
        res = np.empty((rows, self.token_dim), np.float32)
        cen = np.empty((rows, self.token_dim), np.float32)
        inv_scale = 7.0 / self.scales
        for s in range(0, flat.shape[0], step):
            chunk = flat[s:s + step]
            b = chunk.shape[0]
            np.matmul(chunk, cT, out=sims[:b])
            sims[:b] -= half_norms
            cc = np.argmax(sims[:b], 1)
            np.take(self.centroids, cc, axis=0, out=cen[:b])
            np.subtract(chunk, cen[:b], out=res[:b])
            res[:b] *= inv_scale
            np.round(res[:b], out=res[:b])
            np.clip(res[:b], -8, 7, out=res[:b])
            res[:b] += 8
            q = res[:b].astype(np.uint8)
            codes_c[s:s + step] = cc.astype(np.uint8)
            packed[s:s + step] = (q[:, 0::2] << 4) | q[:, 1::2]
        return (codes_c.reshape(m, self.doc_maxlen),
                packed.reshape(m, self.doc_maxlen, self.token_dim // 2))

    # ------------------------------------------------------------------- add
    def _ensure_capacity(self, need: int) -> None:
        if need <= self.capacity:
            return
        cap = round_up(need, self.capacity_round)
        l_doc, half = self.doc_maxlen, self.token_dim // 2
        cc = torch.zeros((cap, l_doc), dtype=torch.uint8, device=self.device)
        pk = torch.zeros((cap, l_doc, half), dtype=torch.uint8,
                         device=self.device)
        mk = torch.zeros((cap, l_doc), dtype=torch.bool, device=self.device)
        if self.codes_c is not None and self.n:
            cc[: self.n] = self.codes_c[: self.n]
            pk[: self.n] = self.packed[: self.n]
            mk[: self.n] = self.mask[: self.n]
        self.codes_c, self.packed, self.mask = cc, pk, mk

    def add(self, token_emb: np.ndarray, token_mask: np.ndarray) -> None:
        """Append [m, L, dt] float tokens and their [m, L] mask, encoded
        with the codebook (trained on the first add)."""
        if token_emb.shape[0] == 0:
            return
        if token_emb.shape[1:] != (self.doc_maxlen, self.token_dim):
            raise ValueError(f"token block {token_emb.shape[1:]} != "
                             f"{(self.doc_maxlen, self.token_dim)}")
        token_emb = np.asarray(token_emb, np.float32)
        if self.centroids is None:
            self._train(token_emb, np.asarray(token_mask))
        self.add_encoded(*self._encode(token_emb), token_mask)

    def add_encoded(self, codes_c: np.ndarray, packed: np.ndarray,
                    token_mask: np.ndarray) -> None:
        """Append an encoded block (codes_c [m, L] uint8, packed [m, L, dt
        // 2] uint8) and its mask as they are; the codebook must be set."""
        if self.centroids is None:
            raise ValueError("add_encoded needs the codebook (set_codebook)")
        l_doc, half = self.doc_maxlen, self.token_dim // 2
        if (codes_c.dtype != np.uint8 or packed.dtype != np.uint8
                or codes_c.shape[1:] != (l_doc,)
                or packed.shape != codes_c.shape + (half,)):
            raise ValueError(f"nbit4 block codes {codes_c.dtype} "
                             f"{codes_c.shape}, packed {packed.dtype} "
                             f"{packed.shape} for {(l_doc, half)}")
        m = codes_c.shape[0]
        if m == 0:
            return
        self._ensure_capacity(self.n + m)
        end = self.n + m

        def put(a):
            return torch.tensor(np.asarray(a), device=self.device)

        self.codes_c[self.n:end] = put(codes_c)
        self.packed[self.n:end] = put(packed)
        self.mask[self.n:end] = put(np.asarray(token_mask, bool))
        self.n = end

    # ----------------------------------------------------------------- host
    def dequantized_rows(self, start: int, stop: int
                         ) -> Tuple[np.ndarray, np.ndarray]:
        """Host float32 reconstruction of rows [start, stop) in numpy (the
        JAX package's code: ``centroids[cc] + q * (scales / 7.0)``) and
        their mask."""
        stop = min(stop, self.capacity)
        cc = self.codes_c[start:stop].cpu().numpy()
        pk = self.packed[start:stop].cpu().numpy().astype(np.int32)
        q = np.empty(cc.shape + (self.token_dim,), np.float32)
        q[..., 0::2] = (pk >> 4) - 8
        q[..., 1::2] = (pk & 0xF) - 8
        tok = self.centroids[cc] + q * (self.scales / 7.0)
        return tok.astype(np.float32), self.mask[start:stop].cpu().numpy()

    @property
    def nbytes(self) -> int:
        """Bytes of the store at capacity plus the codebook, as the JAX
        package counts them (the mask aside)."""
        if self.codes_c is None:
            return 0
        return (self.codes_c.numel() + self.packed.numel()
                + self.centroids.nbytes + self.scales.nbytes)

    # -------------------------------------------------------------- persist
    def save(self, path: str | Path) -> None:
        l_doc, half = self.doc_maxlen, self.token_dim // 2
        if self.n:
            cc = self.codes_c[: self.n].cpu().numpy()
            pk = self.packed[: self.n].cpu().numpy()
            mk = self.mask[: self.n].cpu().numpy()
        else:
            cc = np.zeros((0, l_doc), np.uint8)
            pk = np.zeros((0, l_doc, half), np.uint8)
            mk = np.zeros((0, l_doc), bool)
        np.savez_compressed(
            path, codes_c=cc, packed=pk, mask=mk,
            centroids=self.centroids if self.centroids is not None
            else np.zeros((self.K, self.token_dim), np.float32),
            scales=self.scales if self.scales is not None
            else np.ones(self.token_dim, np.float32),
            token_dim=self.token_dim, doc_maxlen=self.doc_maxlen)

    @classmethod
    def load(cls, path: str | Path, capacity_round: int = 1024,
             device: DeviceLike = None) -> "Residual4TokenIndex":
        z = np.load(path)
        idx = cls(int(z["token_dim"]), int(z["doc_maxlen"]),
                  capacity_round=capacity_round, device=device)
        idx.set_codebook(z["centroids"], z["scales"])
        idx.add_encoded(z["codes_c"], z["packed"], z["mask"])
        return idx
