"""Carry an index and its encoder over from the JAX package.

The JAX package's state, exported as numpy arrays, becomes the port's
objects, so both packages can serve one index (the parity tests do). This
module reads plain numpy arrays only; it imports nothing of the JAX
package.

``arrays`` for :func:`bundle_from_arrays`:

- ``encoder``: the JAX ``HashEncoder.state()`` dict (lang, dim, sketch_dim,
  token_dim, seed, df, n_docs, and proj when trained);
- ``proj``: [sketch_dim, dim] float32, the JAX encoder's projection
  (``np.asarray(encoder._projection())``);
- ``emb``: [n or capacity, dim] dense rows and ``n`` the row count;
- ``impact``: [V_pad, N_pad] float32 BM25 impact matrix;
- ``flat_ids``, ``flat_tfs``, ``offsets``, ``bm25_params``: the BM25 host
  CSR (per-doc term ids and tfs) and (k1, b, epsilon);
- ``tok``, ``mask``: [n or capacity, L, dt] token store and [.., L] mask
  (optional: without them the late channel is off).

bf16 arrays may come as float32 (bf16 values widen exactly) or as
``ml_dtypes.bfloat16``; either way they are rounded to the store dtype,
which leaves bf16 values unchanged.
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence

import numpy as np

from legalrag_tpu_torch.config import AppConfig
from legalrag_tpu_torch.index.bm25_index import BM25Index
from legalrag_tpu_torch.index.bundle import IndexBundle
from legalrag_tpu_torch.models.hash_encoder import HashEncoder
from legalrag_tpu_torch.schemas import LawChunk
from legalrag_tpu_torch.utils.device import DeviceLike


def encoder_from_jax(state: Mapping[str, np.ndarray], proj: np.ndarray,
                     device: DeviceLike = None) -> HashEncoder:
    """A port ``HashEncoder`` with the JAX encoder's state and projection."""
    enc = HashEncoder.from_state(dict(state), device=device)
    enc.use_projection(np.asarray(proj, np.float32))
    return enc


def bundle_from_arrays(arrays: Mapping[str, object],
                       chunks: Sequence[LawChunk], vocab: Dict[str, int],
                       cfg: AppConfig, device: DeviceLike = None
                       ) -> IndexBundle:
    """A port ``IndexBundle`` holding the JAX bundle's arrays (see the
    module docstring for the keys)."""
    state = arrays["encoder"]
    lang = str(state["lang"])
    b = IndexBundle(lang, cfg, device)
    b.encoder = encoder_from_jax(state, arrays["proj"], b.device)
    b.chunks = list(chunks)
    b.id2row = {c.id: i for i, c in enumerate(b.chunks)}
    n = int(arrays["n"])
    b.dense.add(np.asarray(arrays["emb"], np.float32)[:n])
    b.bm25 = BM25Index.from_csr(
        lang, vocab, np.asarray(arrays["flat_ids"]),
        np.asarray(arrays["flat_tfs"]), np.asarray(arrays["offsets"]),
        np.asarray(arrays["bm25_params"]), b.device,
        impact=np.asarray(arrays["impact"], np.float32))
    if "tok" in arrays:
        b.tokens.add(np.asarray(arrays["tok"], np.float32)[:n],
                     np.asarray(arrays["mask"], bool)[:n])
    b.generation = 1
    return b
