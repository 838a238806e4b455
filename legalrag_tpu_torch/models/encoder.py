"""Encoder backend protocol + factory (port of
``legalrag_tpu/models/encoder.py``).

An encoder turns texts into float32, L2-normalized embeddings on the host
and, for the batched query paths, a query batch into device tensors:

- ``hash``: the deterministic hashed-feature encoder (no weights;
  ``models/hash_encoder.py``);
- ``bert``: a BERT-family bi-encoder from a local HF checkpoint
  (``models/bert.py``), with the configured model and query instruction
  of the language.
"""

from __future__ import annotations

from typing import List, Protocol, Sequence, Tuple

import numpy as np

from legalrag_tpu_torch.utils.device import DeviceLike


class EncoderBackend(Protocol):
    """Contract: float32, L2-normalized outputs; deterministic."""

    dim: int
    token_dim: int

    def encode_passages(self, texts: List[str]) -> np.ndarray:
        """[n, dim], L2-normalized."""
        ...

    def encode_queries(self, texts: List[str]) -> np.ndarray:
        """[n, dim], L2-normalized; may apply a query instruction."""
        ...

    def encode_tokens(self, texts: List[str], maxlen: int,
                      query: bool = False) -> Tuple[np.ndarray, np.ndarray]:
        """([n, maxlen, token_dim] per-token L2-normed, [n, maxlen] bool
        mask); ``query=True`` marks query-side featurization."""
        ...

    def query_inputs(self, texts: Sequence[str], maxlen: int, late: bool):
        """A query batch's host work, copied to the device."""
        ...

    def query_views(self, inputs):
        """``(qvec, q_tok, q_mask)`` on the device for the fused query:
        ``qvec`` is [B, dim] or the hash encoder's (sketch, projection)
        pair; ``q_tok``, ``q_mask`` are None unless ``late``."""
        ...


def get_encoder(cfg, lang: str, device: DeviceLike = None) -> EncoderBackend:
    """The configured encoder for one language."""
    backend = cfg.retrieval.embedding_backend
    if backend == "hash":
        from legalrag_tpu_torch.models.hash_encoder import HashEncoder

        return HashEncoder(lang=lang, dim=cfg.retrieval.embedding_dim,
                           token_dim=cfg.engine.late_dim, device=device)
    if backend == "bert":
        from legalrag_tpu_torch.models.bert import TorchBertEncoder

        r = cfg.retrieval
        model = r.embedding_model_zh if lang == "zh" else r.embedding_model_en
        instruction = (r.query_instruction_zh if lang == "zh"
                       else r.query_instruction_en)
        return TorchBertEncoder.from_pretrained(
            model, instruction=instruction, device=device,
            token_dim=cfg.engine.late_dim)
    raise ValueError(f"unknown embedding backend: {backend}")
