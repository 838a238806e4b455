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
  (optional: without them the late channel is off). An int8 ``tok`` is
  the JAX int8 store's payload and stays int8 as it is (no requantization).

:func:`postings_from_arrays` carries the CSR triple of the JAX
``build_postings`` (the large-corpus mode's BM25) to the device.

bf16 arrays may come as float32 (bf16 values widen exactly) or as
``ml_dtypes.bfloat16``; either way they are rounded to the store dtype,
which leaves bf16 values unchanged.
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence, Tuple

import numpy as np
import torch

from legalrag_tpu_torch.config import AppConfig
from legalrag_tpu_torch.index.bm25_index import BM25Index
from legalrag_tpu_torch.index.bundle import IndexBundle
from legalrag_tpu_torch.models.hash_encoder import HashEncoder
from legalrag_tpu_torch.index.token_index import TokenIndex
from legalrag_tpu_torch.schemas import LawChunk
from legalrag_tpu_torch.utils.device import DeviceLike, resolve_device


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
        tok = np.asarray(arrays["tok"])
        mask = np.asarray(arrays["mask"], bool)[:n]
        if tok.dtype == np.int8:
            e = cfg.engine
            b.tokens = TokenIndex(e.late_dim, e.late_doc_maxlen, "int8",
                                  e.capacity_round, b.device)
            b.tokens.add_quantized(tok[:n], mask)
        else:
            b.tokens.add(np.asarray(tok, np.float32)[:n], mask)
    b.generation = 1
    return b


def postings_from_arrays(offsets: np.ndarray, post_docs: np.ndarray,
                         post_w: np.ndarray, device: DeviceLike = None
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The CSR postings of the JAX ``build_postings`` (offsets [V+1], doc
    ids and weights [NNZ_pad]) as int32 / int32 / float32 tensors on the
    device, checked for the layout ``build_postings`` makes."""
    offsets = np.asarray(offsets)
    post_docs = np.asarray(post_docs)
    post_w = np.asarray(post_w)
    if (offsets.ndim != 1 or post_docs.shape != post_w.shape
            or post_docs.ndim != 1 or offsets.size == 0
            or offsets[0] != 0 or np.any(np.diff(offsets) < 0)
            or offsets[-1] > post_docs.size):
        raise ValueError(f"not a CSR postings triple: offsets "
                         f"{offsets.shape}, docs {post_docs.shape}, weights "
                         f"{post_w.shape}")
    dev = resolve_device(device)
    return (torch.from_numpy(offsets.astype(np.int32)).to(dev),
            torch.from_numpy(post_docs.astype(np.int32)).to(dev),
            torch.from_numpy(post_w.astype(np.float32)).to(dev))
