"""Corpus-level n-gram draft tables for speculative decoding (port of
``legalrag_tpu/models/ngram_draft.py``).

Prompt lookup (``models/spec_decode.py``) drafts only from the sequence so
far: the first quote of a provision that is not in the prompt (statute
phrasing, citation scaffolding) misses it. The corpus table extends the
draft source to the indexed corpus: offline, count bigram -> next-token
continuations over the corpus token streams, chain the most frequent
successors into ``k``-token drafts and pack them into a direct-mapped hash
table that the verify pass probes with one hash, two gathers and a compare,
on the device and with no host read.

The table is three arrays: ``keys_a`` / ``keys_b`` [H] int32 (the bigram, -1
an empty slot) and ``vals`` [H, k] int32 (the chained continuation), saved
in JAX's ``.npz`` layout, so either package loads the other's file. The
slot is JAX's uint32-wrapping Knuth hash (``_slot``); the device probe
computes it in int64 masked to 32 bits. Collisions and stale entries only
lower acceptance: the verify pass rejects any draft the model would not
have produced.
"""

from __future__ import annotations

from collections import Counter, defaultdict
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from legalrag_tpu_torch.utils import get_logger
from legalrag_tpu_torch.utils.device import DeviceLike, resolve_device

log = get_logger("torch.models.ngram_draft")

# Knuth multiplicative hash constant; the device probe must compute the
# SAME uint32-wraparound hash (spec_decode.py).
_HASH_MULT = 2654435761


def _slot(a: int, b: int, size: int) -> int:
    """Direct-mapped slot for bigram (a, b): uint32-wrapping Knuth hash
    masked to the table size (a power of two)."""
    return ((a * _HASH_MULT + b) & 0xFFFFFFFF) & (size - 1)


class NgramDraftTable:
    """Direct-mapped bigram → k-token continuation table.

    ``size`` must be a power of two (the device probe uses a mask, not a
    modulo). Empty slots hold key −1 (token ids are non-negative, so an
    empty slot can never match). ``vals`` rows are chains of the
    most-frequent next token: val[0] = argmax c P(c | a, b), val[1] =
    argmax P(· | b, val[0]), … — drafts follow the corpus's dominant
    phrasing, which is exactly what a legal-RAG answer quotes. Chains
    shorter than ``k`` (the corpus runs dry) are padded with token 0;
    a pad that disagrees with the model is simply rejected at verify.
    """

    def __init__(self, keys_a: np.ndarray, keys_b: np.ndarray,
                 vals: np.ndarray):
        size = int(keys_a.shape[0])
        if size & (size - 1):
            raise ValueError(f"table size {size} is not a power of two")
        if keys_b.shape != (size,) or vals.shape[0] != size:
            raise ValueError("keys_a/keys_b/vals shape mismatch")
        self.size = size
        self.k = int(vals.shape[1])
        self._keys_a = np.ascontiguousarray(keys_a, np.int32)
        self._keys_b = np.ascontiguousarray(keys_b, np.int32)
        self._vals = np.ascontiguousarray(vals, np.int32)
        self._device = {}    # device -> (keys_a, keys_b, vals), placed lazily

    # ------------------------------------------------------------- build
    @classmethod
    def from_streams(cls, streams: Iterable[Sequence[int]], k: int = 8,
                     log2_size: int = 16) -> "NgramDraftTable":
        """Build from corpus token streams (one list of ids per document).

        Two passes over nothing but host dicts: (1) count next-token
        frequencies per bigram, (2) chain argmax successors into k-token
        drafts and pack them direct-mapped; on a slot collision the
        more frequent bigram wins (it is drafted more often).
        """
        nxt_counts: Dict[Tuple[int, int], Counter] = defaultdict(Counter)
        bigram_counts: Counter = Counter()
        n_tokens = 0
        for stream in streams:
            s = list(stream)
            n_tokens += len(s)
            for i in range(len(s) - 2):
                ab = (s[i], s[i + 1])
                nxt_counts[ab][s[i + 2]] += 1
                bigram_counts[ab] += 1
        nxt = {ab: c.most_common(1)[0][0] for ab, c in nxt_counts.items()}
        size = 1 << log2_size
        keys_a = np.full(size, -1, np.int32)
        keys_b = np.full(size, -1, np.int32)
        vals = np.zeros((size, k), np.int32)
        occupant = np.zeros(size, np.int64)
        filled = collided = 0
        for (a, b), cnt in bigram_counts.items():
            h = _slot(a, b, size)
            if occupant[h]:
                collided += 1
                if cnt <= occupant[h]:
                    continue
            chain: List[int] = []
            x, y = a, b
            for _ in range(k):
                c = nxt.get((x, y))
                if c is None:
                    break
                chain.append(c)
                x, y = y, c
            if not chain:
                continue
            chain += [0] * (k - len(chain))
            keys_a[h], keys_b[h] = a, b
            vals[h] = chain
            occupant[h] = cnt
            filled += 1
        log.info("ngram draft table: %d tokens -> %d bigrams, %d/%d slots "
                 "filled (%d collisions), k=%d",
                 n_tokens, len(bigram_counts), filled, size, collided, k)
        return cls(keys_a, keys_b, vals)

    # ------------------------------------------------------------ persist
    def save(self, path) -> None:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(path, keys_a=self._keys_a, keys_b=self._keys_b,
                            vals=self._vals)

    @classmethod
    def load(cls, path) -> "NgramDraftTable":
        with np.load(Path(path)) as z:
            return cls(z["keys_a"], z["keys_b"], z["vals"])

    # ------------------------------------------------------------- access
    def device_arrays(self, k: int, device: DeviceLike = None):
        """(keys_a, keys_b, vals[:, :k]) as int64 tensors on ``device`` for
        the verify pass; ``k`` <= the table's k (the engine's spec_k)."""
        if k > self.k:
            raise ValueError(
                f"engine spec_k={k} exceeds table draft length {self.k}; "
                "rebuild the table with a larger k")
        dev = resolve_device(device)
        if dev not in self._device:
            self._device[dev] = tuple(
                torch.from_numpy(a).long().to(dev)
                for a in (self._keys_a, self._keys_b, self._vals))
        ka, kb, vs = self._device[dev]
        return ka, kb, vs[:, :k]

    def lookup(self, a: int, b: int) -> Optional[List[int]]:
        """Host-side probe (tests / diagnostics): the stored continuation
        for bigram (a, b), or None on empty slot / key mismatch."""
        h = _slot(a, b, self.size)
        if self._keys_a[h] != a or self._keys_b[h] != b:
            return None
        return self._vals[h].tolist()

    def stats(self) -> Dict[str, int]:
        return {"size": self.size, "k": self.k,
                "filled": int((self._keys_a >= 0).sum())}


def resolve_ngram_draft(spec) -> Optional[NgramDraftTable]:
    """Constructor convenience: accept an NgramDraftTable, a path to a
    saved .npz, or None/"" (no table)."""
    if spec is None or spec == "":
        return None
    if isinstance(spec, NgramDraftTable):
        return spec
    return NgramDraftTable.load(spec)
