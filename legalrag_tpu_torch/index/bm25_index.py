"""Device-resident BM25 index (port of ``legalrag_tpu/index/bm25_index.py``).

The host keeps the per-doc (term id, tf) lists and the vocabulary; the
device holds the dense [V_pad, N_pad] float32 impact matrix, V rounded up to
8 and N to 128 as in the JAX package. Same npz format (``flat_ids``,
``flat_tfs``, ``offsets``, ``vocab`` JSON, ``params``, ``lang``).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from legalrag_tpu_torch.index.dense_index import round_up
from legalrag_tpu_torch.ops.bm25 import build_impact_matrix
from legalrag_tpu_torch.tokenize import tokenize
from legalrag_tpu_torch.utils.device import DeviceLike, resolve_device


class BM25Index:
    def __init__(self, lang: str, k1: float = 1.5, b: float = 0.75,
                 epsilon: float = 0.25, device: DeviceLike = None):
        self.lang = lang
        self.k1, self.b, self.epsilon = k1, b, epsilon
        self.device = resolve_device(device)
        self.vocab: Dict[str, int] = {}
        self.doc_term_ids: List[np.ndarray] = []
        self.doc_term_freqs: List[np.ndarray] = []
        self.impact: Optional[torch.Tensor] = None  # [V_pad, N_pad]
        self.n = 0

    # ---------------------------------------------------------------- build
    def build(self, doc_token_lists: Sequence[List[str]]) -> None:
        self.vocab = {}
        self.doc_term_ids, self.doc_term_freqs = [], []
        for toks in doc_token_lists:
            counts: Dict[int, int] = {}
            for t in toks:
                tid = self.vocab.setdefault(t, len(self.vocab))
                counts[tid] = counts.get(tid, 0) + 1
            self.doc_term_ids.append(np.fromiter(counts.keys(), np.int32,
                                                 len(counts)))
            self.doc_term_freqs.append(np.fromiter(counts.values(), np.int32,
                                                   len(counts)))
        self.n = len(self.doc_term_ids)
        self._materialize()

    def build_from_texts(self, texts: Sequence[str]) -> None:
        self.build([tokenize(t, self.lang) for t in texts])

    def _materialize(self) -> None:
        v = len(self.vocab)
        impact = build_impact_matrix(self.doc_term_ids, self.doc_term_freqs, v,
                                     self.k1, self.b, self.epsilon)
        v_pad, n_pad = round_up(v, 8), round_up(self.n, 128)
        padded = np.zeros((v_pad, n_pad), np.float32)
        padded[:v, : self.n] = impact
        self.impact = torch.from_numpy(padded).to(self.device)

    # ---------------------------------------------------------------- query
    def query_term_ids(self, queries: Sequence[str], maxlen: int = 64
                       ) -> Tuple[np.ndarray, np.ndarray]:
        """Padded (term_ids [B, L] int32, mask [B, L] bool): the KB-sized
        wire format the fused query scatters into counts on the device."""
        ids = np.zeros((len(queries), maxlen), np.int32)
        mask = np.zeros((len(queries), maxlen), bool)
        for i, q in enumerate(queries):
            toks = [self.vocab[t] for t in tokenize(q, self.lang, query=True)
                    if t in self.vocab][:maxlen]
            ids[i, : len(toks)] = toks
            mask[i, : len(toks)] = True
        return ids, mask

    # -------------------------------------------------------------- persist
    def save(self, path: str | Path) -> None:
        flat_ids = (np.concatenate(self.doc_term_ids) if self.doc_term_ids
                    else np.zeros(0, np.int32))
        flat_tfs = (np.concatenate(self.doc_term_freqs) if self.doc_term_freqs
                    else np.zeros(0, np.int32))
        offsets = np.cumsum([0] + [len(a) for a in self.doc_term_ids]).astype(np.int64)
        np.savez_compressed(
            path, flat_ids=flat_ids, flat_tfs=flat_tfs, offsets=offsets,
            vocab=json.dumps(self.vocab, ensure_ascii=False),
            params=np.array([self.k1, self.b, self.epsilon], np.float64),
            lang=self.lang)

    @classmethod
    def from_csr(cls, lang: str, vocab: Dict[str, int], flat_ids: np.ndarray,
                 flat_tfs: np.ndarray, offsets: np.ndarray,
                 params: Sequence[float], device: DeviceLike = None,
                 impact: Optional[np.ndarray] = None) -> "BM25Index":
        """Index from the host CSR (per-doc term ids and tfs) + vocabulary;
        ``impact`` [V_pad, N_pad], when given, is used as is instead of
        being rebuilt from the CSR."""
        k1, b, eps = (float(x) for x in params)
        idx = cls(lang, k1=k1, b=b, epsilon=eps, device=device)
        idx.vocab = dict(vocab)
        for a, bnd in zip(offsets[:-1], offsets[1:]):
            idx.doc_term_ids.append(np.asarray(flat_ids[a:bnd], np.int32))
            idx.doc_term_freqs.append(np.asarray(flat_tfs[a:bnd], np.int32))
        idx.n = len(idx.doc_term_ids)
        if impact is None:
            idx._materialize()
        else:
            idx.impact = torch.tensor(np.asarray(impact, np.float32),
                                      device=idx.device)
        return idx

    @classmethod
    def load(cls, path: str | Path, device: DeviceLike = None) -> "BM25Index":
        z = np.load(path, allow_pickle=False)
        return cls.from_csr(str(z["lang"]), json.loads(str(z["vocab"])),
                            z["flat_ids"], z["flat_tfs"], z["offsets"],
                            z["params"], device)
