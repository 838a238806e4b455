"""Deterministic hashed-feature encoder (port of
``legalrag_tpu/models/hash_encoder.py:34-202``).

Texts are hashed into a signed feature sketch on the host (words + char
n-grams, tf-log + idf weighting) exactly as in the JAX package; the sketch
is projected to the embedding dimension by a fixed Gaussian matrix on the
device and L2-normalized.

The default projection is ``jax.random.normal(PRNGKey(seed), (sketch_dim,
dim)) / sqrt(dim)``, drawn here in numpy (``models/prng.py``), because it is
not saved with an index. A trained projection (``proj``) overrides it, as in
the JAX package.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from legalrag_tpu_torch.models.prng import jax_normal
from legalrag_tpu_torch.native import fnv1a64_batch, sketch_accumulate
from legalrag_tpu_torch.tokenize import char_ngrams, hash_features, tokenize
from legalrag_tpu_torch.tokenize.tokenizers import fnv1a_batch
from legalrag_tpu_torch.utils.device import DeviceLike, resolve_device


def project_norm(sketch: torch.Tensor, proj: torch.Tensor) -> torch.Tensor:
    """[B, D0] sketch x [D0, d] projection -> L2-normalized [B, d] float32
    (``_project_norm`` / ``fused_query.py:94-98``)."""
    y = torch.matmul(sketch, proj)
    return y / torch.clamp(torch.linalg.vector_norm(y, dim=-1, keepdim=True),
                           min=1e-9)


class HashEncoder:
    def __init__(self, lang: str, dim: int = 768, sketch_dim: int = 16384,
                 token_dim: int = 128, seed: int = 7,
                 device: DeviceLike = None,
                 df: Optional[np.ndarray] = None, n_docs: int = 0,
                 proj: Optional[np.ndarray] = None):
        self.lang = lang
        self.dim = dim
        self.sketch_dim = sketch_dim
        self.token_dim = token_dim
        self.seed = seed
        self.device = resolve_device(device)
        self.df = (np.zeros(sketch_dim, np.int64) if df is None
                   else np.asarray(df, np.int64))
        self.n_docs = int(n_docs)
        # trained projection (contrastive adaptation) overrides the default
        # Gaussian when present; it is saved with the index
        self.trained_proj = None if proj is None else np.asarray(proj, np.float32)
        self._proj: Optional[torch.Tensor] = None  # device [sketch_dim, dim]
        self._tok_cache: Dict[str, np.ndarray] = {}

    # ------------------------------------------------------------------ idf
    def fit_idf(self, texts: List[str]) -> None:
        """Accumulate document frequencies per sketch bucket (build time)."""
        for t in texts:
            h = fnv1a_batch(hash_features(t, self.lang), self.seed)
            b = (h % np.uint64(self.sketch_dim)).astype(np.int64)
            self.df[np.unique(b)] += 1
        self.n_docs += len(texts)

    def _idf(self) -> np.ndarray:
        n = max(self.n_docs, 1)
        return np.log1p((n - self.df + 0.5) / (self.df + 0.5)).astype(np.float32)

    # ---------------------------------------------------------------- sketch
    def _sketch(self, texts: List[str], query: bool = False) -> np.ndarray:
        """Signed-count sketch with sublinear tf and bucket idf:
        ``s[b] = sum of sign(feature)`` then
        ``out[b] = sign(s) * (1 + ln|s|) * idf[b]``."""
        idf = self._idf() if self.n_docs else None
        feats: List[str] = []
        rows: List[int] = []
        for i, text in enumerate(texts):
            fs = hash_features(text, self.lang, query=query)
            feats.extend(fs)
            rows.extend([i] * len(fs))
        h = fnv1a64_batch(feats, self.seed)
        out = sketch_accumulate(h, np.asarray(rows, np.int32), len(texts),
                                self.sketch_dim)
        nz = out != 0
        out[nz] = np.sign(out[nz]) * (1.0 + np.log(np.abs(out[nz])))
        if idf is not None:
            out *= idf[None, :]
        return out

    # ------------------------------------------------------------ projection
    def projection(self) -> torch.Tensor:
        """The [sketch_dim, dim] float32 projection on ``self.device``."""
        if self._proj is None:
            if self.trained_proj is not None:
                proj = self.trained_proj
            else:
                proj = (jax_normal(self.seed, (self.sketch_dim, self.dim))
                        / np.float32(np.sqrt(self.dim)))
            self._proj = torch.as_tensor(proj, device=self.device)
        return self._proj

    def use_projection(self, proj: np.ndarray) -> None:
        """Serve with ``proj`` as the default projection (one carried over
        from the JAX package, ``convert.encoder_from_jax``). It is not saved
        with the index, as the default projection is not."""
        if proj.shape != (self.sketch_dim, self.dim):
            raise ValueError(f"projection shape {proj.shape} != "
                             f"{(self.sketch_dim, self.dim)}")
        self._proj = torch.tensor(np.asarray(proj, np.float32),
                                  device=self.device)

    def sketch_tensor(self, texts: List[str], query: bool = False
                      ) -> torch.Tensor:
        return torch.from_numpy(self._sketch(texts, query)).to(self.device)

    def _project(self, sketch: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(sketch).to(self.device)
        return project_norm(x, self.projection()).cpu().numpy()

    # ---------------------------------------------------------------- public
    def encode_passages(self, texts: List[str]) -> np.ndarray:
        return self._project(self._sketch(texts))

    def encode_queries(self, texts: List[str]) -> np.ndarray:
        # query=True: liberal section-ref emission (tokenizers.py)
        return self._project(self._sketch(texts, query=True))

    def encode_tokens(self, texts: List[str], maxlen: int,
                      query: bool = False
                      ) -> Tuple[np.ndarray, np.ndarray]:
        emb = np.zeros((len(texts), maxlen, self.token_dim), np.float32)
        mask = np.zeros((len(texts), maxlen), bool)
        for i, text in enumerate(texts):
            toks = tokenize(text, self.lang, query)[:maxlen]
            for j, tok in enumerate(toks):
                emb[i, j] = self._token_vec(tok)
                mask[i, j] = True
        return emb, mask

    def _token_vec(self, token: str) -> np.ndarray:
        v = self._tok_cache.get(token)
        if v is not None:
            return v
        feats = [token]
        if self.lang != "zh" and len(token) > 3:
            feats.extend(char_ngrams(token))
        elif self.lang == "zh" and len(token) > 1:
            feats.extend(token)  # component chars
        v = np.zeros(self.token_dim, np.float32)
        h = fnv1a_batch(feats, self.seed + 1)
        np.add.at(v, (h % np.uint64(self.token_dim)).astype(np.int64),
                  np.where((h >> np.uint64(62)) & np.uint64(1), 1.0, -1.0))
        norm = np.linalg.norm(v)
        v = (v / norm if norm > 0 else v).astype(np.float32)
        if len(self._tok_cache) < 1_000_000:
            self._tok_cache[token] = v
        return v

    # -------------------------------------------------------------- persist
    def state(self) -> Dict:
        out = {"lang": self.lang, "dim": self.dim,
               "sketch_dim": self.sketch_dim, "token_dim": self.token_dim,
               "seed": self.seed, "df": self.df, "n_docs": self.n_docs}
        if self.trained_proj is not None:
            out["proj"] = self.trained_proj.astype(np.float16)
        return out

    @classmethod
    def from_state(cls, state: Dict, device: DeviceLike = None) -> "HashEncoder":
        proj = state.get("proj")
        return cls(lang=str(state["lang"]), dim=int(state["dim"]),
                   sketch_dim=int(state["sketch_dim"]),
                   token_dim=int(state["token_dim"]), seed=int(state["seed"]),
                   device=device, df=state["df"], n_docs=int(state["n_docs"]),
                   proj=None if proj is None else np.asarray(proj, np.float32))
