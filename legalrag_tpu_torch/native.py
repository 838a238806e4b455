"""Host hot loops of the hash encoder: batch FNV-1a and sketch accumulation.

The numpy paths of ``legalrag_tpu/native/__init__.py``, bit-exact with the
compiled ``libhostops`` versions there (``tests/test_native.py``). The port
does not load that library.
"""

from __future__ import annotations

from typing import List

import numpy as np

from legalrag_tpu_torch.tokenize.tokenizers import fnv1a_batch


def fnv1a64_batch(feats: List[str], seed: int = 0) -> np.ndarray:
    """Batch FNV-1a; bit-exact with tokenize.fnv1a."""
    return fnv1a_batch(feats, seed)


def sketch_accumulate(hashes: np.ndarray, rows: np.ndarray, n_rows: int,
                      sketch_dim: int) -> np.ndarray:
    """[n_rows, sketch_dim] signed-count accumulation."""
    out = np.zeros((n_rows, sketch_dim), np.float32)
    if len(hashes):
        buckets = (hashes % np.uint64(sketch_dim)).astype(np.int64)
        signs = np.where((hashes >> np.uint64(62)) & np.uint64(1),
                         1.0, -1.0).astype(np.float32)
        flat = rows.astype(np.int64) * sketch_dim + buckets
        np.add.at(out.ravel(), flat, signs)
    return out
