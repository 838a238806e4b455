"""BERT-family encoders on torch (port of ``legalrag_tpu/models/bert.py``).

The ``bert`` embedding backend: HF-format checkpoints (``config.json``,
``model.safetensors`` or ``pytorch_model.bin``, ``vocab.txt``) for
BGE-style bi-encoders and BERT-family cross-encoders, run on the device
the caller names. Semantics are the JAX package's (the reference's
FlagEmbedding usage): queries get the instruction prefix, passages encode
bare, CLS pooling, L2-normalized float32 outputs, max_length 512, inputs
padded to ``max_length``.

The forward pass keeps JAX's arithmetic: float32 throughout (TF32 is off,
``utils/device.py``), the padding mask added as -1e30 before the softmax,
attention as matmul, softmax, matmul, exact (erf) GELU, biased-variance
layer norm, roberta position ids ``cumsum(m) * m + pad``. Tokenization is
the port's own WordPiece (``tokenize/wordpiece.py``); weights are read by
``models/safetensors_io.py``. Module and parameter names are HF's, so a
checkpoint's tensors load by name.
"""

from __future__ import annotations

import json
import math
import time
from pathlib import Path
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from legalrag_tpu_torch.models.safetensors_io import load_weights
from legalrag_tpu_torch.tokenize.wordpiece import WordPieceTokenizer
from legalrag_tpu_torch.utils import get_logger
from legalrag_tpu_torch.utils.device import DeviceLike, resolve_device

log = get_logger("torch.models.bert")

# sequences a forward pass takes at once (encode_passages / encode_tokens
# over a whole corpus); each row's result is independent of the others
ENCODE_BATCH = 64
HF_PREFIXES = ("", "bert.", "roberta.", "model.")
TOKEN_TYPE = "embeddings.token_type_embeddings.weight"


class BertConfig:
    def __init__(self, vocab_size=30522, hidden_size=768,
                 num_hidden_layers=12, num_attention_heads=12,
                 intermediate_size=3072, max_position_embeddings=512,
                 type_vocab_size=2, layer_norm_eps=1e-12,
                 model_type="bert", pad_token_id=0, **_ignored):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.intermediate_size = intermediate_size
        self.max_position_embeddings = max_position_embeddings
        self.type_vocab_size = type_vocab_size
        self.layer_norm_eps = layer_norm_eps
        self.model_type = model_type or "bert"
        self.pad_token_id = 0 if pad_token_id is None else int(pad_token_id)

    @property
    def roberta_positions(self) -> bool:
        """Roberta-family position ids start at pad_token_id + 1 and skip
        padded slots (HF ``create_position_ids_from_input_ids``)."""
        return self.model_type in ("roberta", "xlm-roberta", "camembert")

    @property
    def usable_positions(self) -> int:
        """Longest sequence the position table supports (a roberta table
        holds pad + 1 leading rows no position uses)."""
        off = self.pad_token_id + 1 if self.roberta_positions else 0
        return self.max_position_embeddings - off

    @classmethod
    def from_json(cls, path: Path) -> "BertConfig":
        return cls(**json.loads(Path(path).read_text(encoding="utf-8")))


# ---------------------------------------------------------------------------
# the module (HF names: embeddings.*, encoder.layer.{i}.*)

class _LayerNormOut(nn.Module):
    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.dense = nn.Linear(d_in, d_out)
        self.LayerNorm = nn.LayerNorm(d_out)


class _SelfAttention(nn.Module):
    def __init__(self, h: int):
        super().__init__()
        self.query = nn.Linear(h, h)
        self.key = nn.Linear(h, h)
        self.value = nn.Linear(h, h)


class _Attention(nn.Module):
    def __init__(self, h: int):
        super().__init__()
        self.self = _SelfAttention(h)
        self.output = _LayerNormOut(h, h)


class _Dense(nn.Module):
    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.dense = nn.Linear(d_in, d_out)


class _Layer(nn.Module):
    def __init__(self, h: int, i: int):
        super().__init__()
        self.attention = _Attention(h)
        self.intermediate = _Dense(h, i)
        self.output = _LayerNormOut(i, h)


class _Embeddings(nn.Module):
    def __init__(self, cfg: BertConfig, type_rows: int):
        super().__init__()
        h = cfg.hidden_size
        self.word_embeddings = nn.Embedding(cfg.vocab_size, h)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings, h)
        self.token_type_embeddings = nn.Embedding(type_rows, h)
        self.LayerNorm = nn.LayerNorm(h)


class _Encoder(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.layer = nn.ModuleList(
            _Layer(cfg.hidden_size, cfg.intermediate_size)
            for _ in range(cfg.num_hidden_layers))


class BertModel(nn.Module):
    """The BERT trunk: ``[B, L]`` ids -> ``[B, L, H]`` final hidden states,
    float32 (``bert_forward``, ``legalrag_tpu/models/bert.py:77-134``)."""

    def __init__(self, cfg: BertConfig, type_rows: Optional[int] = None):
        super().__init__()
        self.cfg = cfg
        self.embeddings = _Embeddings(
            cfg, cfg.type_vocab_size if type_rows is None else type_rows)
        self.encoder = _Encoder(cfg)

    @property
    def type_rows(self) -> int:
        return self.embeddings.token_type_embeddings.num_embeddings

    def _norm(self, x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
        # biased variance, eps inside the root: JAX's _layer_norm
        return F.layer_norm(x, ln.normalized_shape, ln.weight, ln.bias,
                            self.cfg.layer_norm_eps)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                token_type_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.cfg
        b, l = input_ids.shape
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        emb = self.embeddings
        if cfg.roberta_positions:
            m = (input_ids != cfg.pad_token_id).to(input_ids.dtype)
            pos = emb.position_embeddings(torch.cumsum(m, dim=1) * m
                                          + cfg.pad_token_id)
        else:
            pos = emb.position_embeddings.weight[None, :l]
        x = (emb.word_embeddings(input_ids) + pos
             + emb.token_type_embeddings(token_type_ids))
        x = self._norm(x, emb.LayerNorm)

        heads = cfg.num_attention_heads
        hd = cfg.hidden_size // heads
        neg = torch.where(attention_mask[:, None, None, :] > 0, 0.0, -1e30)

        def split(t: torch.Tensor) -> torch.Tensor:   # [B, heads, L, hd]
            return t.view(b, l, heads, hd).transpose(1, 2)

        for layer in self.encoder.layer:
            att = layer.attention
            q = split(att.self.query(x))
            k = split(att.self.key(x))
            v = split(att.self.value(x))
            scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(hd) + neg
            ctx = torch.matmul(torch.softmax(scores, dim=-1), v)
            ctx = ctx.transpose(1, 2).reshape(b, l, cfg.hidden_size)
            x = self._norm(x + att.output.dense(ctx), att.output.LayerNorm)
            h = F.gelu(layer.intermediate.dense(x), approximate="none")
            x = self._norm(x + layer.output.dense(h), layer.output.LayerNorm)
        return x


def build_bert(cfg: BertConfig, state: Mapping[str, torch.Tensor],
               device: DeviceLike = None) -> BertModel:
    """A ``BertModel`` on ``device`` holding ``state`` (HF names, float32;
    the token-type table may have fewer rows than ``type_vocab_size``)."""
    dev = resolve_device(device)
    with torch.device("meta"):
        model = BertModel(cfg, type_rows=state[TOKEN_TYPE].shape[0])
    model = model.to_empty(device=dev)
    model.load_state_dict({k: v.float() for k, v in state.items()})
    return model.eval().requires_grad_(False)


def model_device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def linear(p: Mapping[str, torch.Tensor], device: torch.device) -> nn.Linear:
    """An ``nn.Linear`` holding ``{"weight": [out, in], "bias": [out]}``."""
    out_f, in_f = p["weight"].shape
    with torch.device("meta"):
        lin = nn.Linear(in_f, out_f)
    lin = lin.to_empty(device=device)
    lin.load_state_dict({k: v.float() for k, v in p.items()})
    return lin.requires_grad_(False)


def _state_names(cfg: BertConfig) -> List[str]:
    with torch.device("meta"):
        return list(BertModel(cfg).state_dict())


# ---------------------------------------------------------------------------
# weights

def bert_state_from_tensors(tensors: Mapping[str, torch.Tensor],
                            cfg: BertConfig) -> Dict[str, torch.Tensor]:
    """The trunk's state from a checkpoint's tensors, each found under the
    HF prefixes ``""``, ``bert.``, ``roberta.``, ``model.``; a missing
    token-type table (roberta-family checkpoints may omit it) becomes one
    zero row (``load_hf_bert_params``, ``legalrag_tpu/models/bert.py:
    137-182``)."""
    def get(name):
        for prefix in HF_PREFIXES:
            if prefix + name in tensors:
                return tensors[prefix + name]
        raise KeyError(name)

    state = {}
    for name in _state_names(cfg):
        try:
            state[name] = get(name)
        except KeyError:
            if name != TOKEN_TYPE:
                raise
            state[name] = torch.zeros((1, cfg.hidden_size), dtype=torch.float32)
    return state


def load_hf_bert_params(model_dir: Path
                        ) -> Tuple[Dict[str, torch.Tensor], BertConfig]:
    cfg = BertConfig.from_json(Path(model_dir) / "config.json")
    return bert_state_from_tensors(load_weights(model_dir), cfg), cfg


def random_init_bert_params(cfg: BertConfig, seed: int = 0
                            ) -> Dict[str, torch.Tensor]:
    """Random-init trunk state with the JAX package's numpy draws, in its
    order (``random_init_bert_params``, ``legalrag_tpu/models/bert.py:
    206-245``): one seed gives both packages the same bits. A JAX kernel
    ``[in, out]`` is this state's weight transposed."""
    rng = np.random.default_rng(seed)
    h, i = cfg.hidden_size, cfg.intermediate_size
    s = 0.02

    def normal(shape):
        return rng.standard_normal(shape).astype(np.float32) * s

    def lin(name, d_in, d_out):
        return {f"{name}.weight": torch.from_numpy(normal((d_in, d_out)).T.copy()),
                f"{name}.bias": torch.zeros(d_out)}

    def ln(name):
        return {f"{name}.weight": torch.ones(h), f"{name}.bias": torch.zeros(h)}

    state: Dict[str, torch.Tensor] = {}
    for name, rows in (("word_embeddings", cfg.vocab_size),
                       ("position_embeddings", cfg.max_position_embeddings),
                       ("token_type_embeddings", cfg.type_vocab_size)):
        state[f"embeddings.{name}.weight"] = torch.from_numpy(normal((rows, h)))
    state |= ln("embeddings.LayerNorm")
    for n in range(cfg.num_hidden_layers):
        p = f"encoder.layer.{n}"
        for part in ("query", "key", "value"):
            state |= lin(f"{p}.attention.self.{part}", h, h)
        state |= lin(f"{p}.attention.output.dense", h, h)
        state |= ln(f"{p}.attention.output.LayerNorm")
        state |= lin(f"{p}.intermediate.dense", h, i)
        state |= lin(f"{p}.output.dense", i, h)
        state |= ln(f"{p}.output.LayerNorm")
    return state


def resolve_model_dir(name_or_path: str) -> Path:
    """A local checkpoint directory, or the newest snapshot of the model in
    the offline HF cache (``~/.cache/huggingface/hub/models--org--name``)."""
    p = Path(name_or_path)
    if p.exists():
        return p
    hub = Path.home() / ".cache" / "huggingface" / "hub"
    cand = hub / ("models--" + name_or_path.replace("/", "--"))
    snaps = sorted((cand / "snapshots").glob("*")) if cand.exists() else []
    if snaps:
        return snaps[-1]
    raise FileNotFoundError(
        f"model '{name_or_path}' not found locally (zero-egress image?)")


def _l2(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=1e-9)


def cls_view(model: BertModel, ids: torch.Tensor, mask: torch.Tensor
             ) -> torch.Tensor:
    """[B, H] L2-normalized CLS embeddings."""
    with torch.no_grad():
        return _l2(model(ids, mask)[:, 0])


def token_view(model: BertModel, proj: Optional[nn.Linear], token_dim: int,
               ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """[B, L, dt] L2-normalized per-token embeddings: the hidden states
    through ``proj``, else their first ``token_dim`` features."""
    with torch.no_grad():
        h = model(ids, mask)
        return _l2(proj(h) if proj is not None else h[..., :token_dim])


def bert_query_views(model: BertModel, proj: Optional[nn.Linear],
                     token_dim: int, ids_q: torch.Tensor,
                     mask_q: torch.Tensor, ids_t: Optional[torch.Tensor] = None,
                     mask_t: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The CLS query embedding of the instructed input and, when ``ids_t``
    is given, the token view of the bare input
    (``legalrag_tpu/models/bert.py:262-281``)."""
    cls = cls_view(model, ids_q, mask_q)
    if ids_t is None:
        return cls, None
    return cls, token_view(model, proj, token_dim, ids_t, mask_t)


# ---------------------------------------------------------------------------
# public encoders

class TorchBertEncoder:
    """BGE-style bi-encoder: CLS pooling + L2 norm; query instruction
    (``FlaxBertEncoder``, ``legalrag_tpu/models/bert.py:284-377``)."""

    def __init__(self, model: BertModel, tokenizer: WordPieceTokenizer,
                 instruction: str = "", max_length: int = 512,
                 token_dim: int = 128,
                 token_proj: Optional[Mapping[str, torch.Tensor]] = None):
        self.model = model
        self.cfg = model.cfg
        self.tokenizer = tokenizer
        self.instruction = instruction
        self.device = model_device(model)
        # past the usable position table a roberta model would index rows
        # that hold no position
        self.max_length = min(max_length, self.cfg.usable_positions)
        self.dim = self.cfg.hidden_size
        self.token_dim = token_dim
        # optional ColBERT linear head, {"weight": [dt, H], "bias": [dt]}
        self.token_proj = (None if token_proj is None
                           else linear(token_proj, self.device))

    @classmethod
    def from_pretrained(cls, name_or_path: str, instruction: str = "",
                        device: DeviceLike = None, **kw) -> "TorchBertEncoder":
        t0 = time.perf_counter()
        model_dir = resolve_model_dir(name_or_path)
        tokenizer = WordPieceTokenizer.from_dir(model_dir)
        state, cfg = load_hf_bert_params(model_dir)
        model = build_bert(cfg, state, device)
        log.info("loaded %s (%d layers, H=%d) on %s in %.3fs", name_or_path,
                 cfg.num_hidden_layers, cfg.hidden_size, model_device(model),
                 time.perf_counter() - t0)
        return cls(model, tokenizer, instruction=instruction, **kw)

    # ------------------------------------------------------------ host side
    def _instructed(self, texts: Sequence[str]) -> List[str]:
        return ([self.instruction + t for t in texts] if self.instruction
                else list(texts))

    def _tokenize(self, texts: Sequence[str], maxlen: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Ids and mask [n, maxlen] on the device (padded to ``maxlen``)."""
        ids, mask, _ = self.tokenizer.encode(texts, maxlen)
        return (torch.from_numpy(ids).to(self.device),
                torch.from_numpy(mask).to(self.device))

    # ------------------------------------------------------- device views
    def query_inputs(self, texts: Sequence[str], maxlen: int, late: bool):
        """Host work of a query batch: the instructed ids (for the CLS
        view) and, when ``late``, the bare ids at ``maxlen`` (the token
        view), copied to the device. ``query_views`` runs the encoder."""
        ids_q, mask_q = self._tokenize(self._instructed(texts), self.max_length)
        ids_t = mask_t = None
        if late:
            ids_t, mask_t = self._tokenize(texts, maxlen)
        return ids_q, mask_q, ids_t, mask_t

    def query_views(self, inputs):
        """``(qvec [B, d], q_tok [B, maxlen, token_dim] or None, q_mask
        [B, maxlen] bool or None)`` on the device from one
        ``query_inputs``."""
        ids_q, mask_q, ids_t, mask_t = inputs
        cls, tok = bert_query_views(self.model, self.token_proj,
                                    self.token_dim, ids_q, mask_q, ids_t,
                                    mask_t)
        return cls, tok, (None if mask_t is None else mask_t.bool())

    # -------------------------------------------------------------- encode
    def _encode(self, texts: Sequence[str]) -> np.ndarray:
        out = []
        for i in range(0, len(texts), ENCODE_BATCH):
            ids, mask = self._tokenize(texts[i:i + ENCODE_BATCH],
                                       self.max_length)
            out.append(cls_view(self.model, ids, mask).cpu())
        if not out:
            return np.zeros((0, self.dim), np.float32)
        return torch.cat(out).numpy()

    def encode_passages(self, texts: List[str]) -> np.ndarray:
        """[n, dim] L2-normalized CLS embeddings of the bare texts."""
        return self._encode(texts)

    def encode_queries(self, texts: List[str]) -> np.ndarray:
        """[n, dim] L2-normalized CLS embeddings of the instructed texts."""
        return self._encode(self._instructed(texts))

    def encode_query_bundle(self, texts: List[str], token_maxlen: int
                            ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(query embeddings, query token embeddings, token mask) from one
        ``query_views``."""
        cls, tok, mask = self.query_views(
            self.query_inputs(texts, token_maxlen, late=True))
        return (cls.cpu().numpy(), tok.cpu().numpy(), mask.cpu().numpy())

    def encode_tokens(self, texts: List[str], maxlen: int,
                      query: bool = False) -> Tuple[np.ndarray, np.ndarray]:
        """([n, maxlen, token_dim] L2-normalized per-token embeddings,
        [n, maxlen] bool mask) of the bare texts. ``query`` is part of the
        encoder contract; subword tokenization does not branch on it."""
        toks, masks = [], []
        for i in range(0, len(texts), ENCODE_BATCH):
            ids, mask = self._tokenize(texts[i:i + ENCODE_BATCH], maxlen)
            toks.append(token_view(self.model, self.token_proj,
                                   self.token_dim, ids, mask).cpu())
            masks.append(mask.bool().cpu())
        if not toks:
            return (np.zeros((0, maxlen, self.token_dim), np.float32),
                    np.zeros((0, maxlen), bool))
        return torch.cat(toks).numpy(), torch.cat(masks).numpy()


class TorchBertCrossEncoder:
    """bge-reranker-style pair classifier: (q, d) -> relevance logit
    (``FlaxBertCrossEncoder``, ``legalrag_tpu/models/bert.py:380-457``).

    The head is what the checkpoint carries:

    - Roberta-style: CLS -> ``classifier.dense`` -> tanh ->
      ``classifier.out_proj``;
    - BERT-style: CLS -> ``pooler.dense`` -> tanh -> ``classifier``;
    - bare: CLS -> ``classifier``.
    """

    def __init__(self, model: BertModel,
                 head: Mapping[str, Optional[Mapping[str, torch.Tensor]]],
                 tokenizer: WordPieceTokenizer):
        self.model = model
        self.cfg = model.cfg
        self.tokenizer = tokenizer
        self.device = model_device(model)
        self.dense = (None if head.get("dense") is None
                      else linear(head["dense"], self.device))
        self.out = linear(head["out"], self.device)

    @classmethod
    def from_pretrained(cls, name_or_path: str, device: DeviceLike = None
                        ) -> "TorchBertCrossEncoder":
        model_dir = resolve_model_dir(name_or_path)
        tokenizer = WordPieceTokenizer.from_dir(model_dir)
        cfg = BertConfig.from_json(model_dir / "config.json")
        tensors = load_weights(model_dir)
        model = build_bert(cfg, bert_state_from_tensors(tensors, cfg), device)
        return cls(model, head_from_tensors(tensors), tokenizer)

    def score_pairs(self, pairs: Sequence[Tuple[str, str]],
                    max_length: int = 512) -> List[float]:
        max_length = min(max_length, self.cfg.usable_positions)
        ids, mask, types = self.tokenizer.encode(
            [a for a, _ in pairs], max_length, pairs=[b for _, b in pairs])
        if self.model.type_rows < 2:
            # roberta-family models have a one-row segment table: a pair's
            # segment ids must not index past it
            types = np.zeros_like(ids)
        dev = self.device
        with torch.no_grad():
            h = self.model(torch.from_numpy(ids).to(dev),
                           torch.from_numpy(mask).to(dev),
                           torch.from_numpy(types).to(dev))[:, 0]
            if self.dense is not None:
                h = torch.tanh(self.dense(h))
            logits = self.out(h).squeeze(-1)
        return logits.cpu().tolist()


def head_from_tensors(tensors: Mapping[str, torch.Tensor]
                      ) -> Dict[str, Optional[Dict[str, torch.Tensor]]]:
    """The classification head of a cross-encoder checkpoint:
    ``{"dense": {"weight", "bias"} or None, "out": {...}}``."""
    def find(suffix):
        key = next((k for k in tensors if k.endswith(suffix)), None)
        if key is None:
            return None
        return {"weight": tensors[key],
                "bias": tensors[key[: -len("weight")] + "bias"]}

    out = find("classifier.out_proj.weight")
    if out is not None:                            # Roberta-style head
        return {"dense": find("classifier.dense.weight"), "out": out}
    out = find("classifier.weight")
    if out is None:
        raise FileNotFoundError("no classifier head in checkpoint")
    return {"dense": find("pooler.dense.weight"), "out": out}
