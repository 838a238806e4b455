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
- ``emb``: [n or capacity, dim] dense rows and ``n`` the row count. An
  int8 ``emb`` is the JAX unit-int8 store's codes: they go into an int8
  store as they are (``DenseIndex.add_quantized``), never through ``add``,
  which would quantize the codes again as if they were unit floats;
- ``impact``: [V_pad, N_pad] float32 BM25 impact matrix;
- ``flat_ids``, ``flat_tfs``, ``offsets``, ``bm25_params``: the BM25 host
  CSR (per-doc term ids and tfs) and (k1, b, epsilon);
- ``tok``, ``mask``: [n or capacity, L, dt] token store and [.., L] mask
  (optional: without them and without ``codes_c`` the late channel is
  off). An int8 ``tok`` is the JAX int8 store's payload and stays int8 as
  it is (no requantization);
- ``codes_c``, ``packed``, ``centroids``, ``scales``, ``mask``: a JAX nbit4
  store (``Residual4TokenIndex``), carried as it is: the codes, packed
  nibbles and codebook are not trained or encoded again.

:func:`postings_from_arrays` carries the CSR triple of the JAX
``build_postings`` (the large-corpus mode's BM25) to the device.

:func:`bert_params_from_jax` and :func:`cross_encoder_head_from_jax` carry
the JAX BERT param tree and cross-encoder head (numpy arrays; a linear
layer's ``kernel`` is ``[in, out]``) into the port's state dicts (HF names;
``weight`` is ``[out, in]``), so both packages run one set of weights.
:func:`decoder_params_from_jax` does the same for the JAX decoder's tree
(``legalrag_tpu/models/decoder.py``), keeping its dtype.

bf16 arrays may come as float32 (bf16 values widen exactly) or as
``ml_dtypes.bfloat16``; either way they are rounded to the store dtype,
which leaves bf16 values unchanged.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from legalrag_tpu_torch.config import AppConfig
from legalrag_tpu_torch.index.bm25_index import BM25Index
from legalrag_tpu_torch.index.bundle import BundleState, IndexBundle
from legalrag_tpu_torch.index.dense_index import DenseIndex
from legalrag_tpu_torch.models.hash_encoder import HashEncoder
from legalrag_tpu_torch.index.token_index import (
    Residual4TokenIndex,
    TokenIndex,
)
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
    chunks = list(chunks)
    n = int(arrays["n"])
    e = cfg.engine
    emb = np.asarray(arrays["emb"])[:n]
    if emb.dtype == np.int8:
        dense = DenseIndex(emb.shape[1], "int8", e.capacity_round, b.device)
        dense.add_quantized(emb)
    else:
        dense = b.dense  # the new bundle's empty store, filled before publishing
        dense.add(np.asarray(emb, np.float32))
    tokens = b.tokens
    if "codes_c" in arrays:
        tokens = Residual4TokenIndex(e.late_dim, e.late_doc_maxlen,
                                     capacity_round=e.capacity_round,
                                     device=b.device)
        tokens.set_codebook(arrays["centroids"], arrays["scales"])
        tokens.add_encoded(np.asarray(arrays["codes_c"])[:n],
                           np.asarray(arrays["packed"])[:n],
                           np.asarray(arrays["mask"], bool)[:n])
    elif "tok" in arrays:
        tok = np.asarray(arrays["tok"])
        mask = np.asarray(arrays["mask"], bool)[:n]
        if tok.dtype == np.int8:
            tokens = TokenIndex(e.late_dim, e.late_doc_maxlen, "int8",
                                e.capacity_round, b.device)
            tokens.add_quantized(tok[:n], mask)
        else:
            tokens.add(np.asarray(tok, np.float32)[:n], mask)
    bm25 = BM25Index.from_csr(
        lang, vocab, np.asarray(arrays["flat_ids"]),
        np.asarray(arrays["flat_tfs"]), np.asarray(arrays["offsets"]),
        np.asarray(arrays["bm25_params"]), b.device,
        impact=np.asarray(arrays["impact"], np.float32))
    b.state = BundleState(
        encoder_from_jax(state, arrays["proj"], b.device), dense, bm25,
        tokens, chunks, {c.id: i for i, c in enumerate(chunks)}, 1)
    return b


def _f32(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def linear_from_jax(p: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """A JAX linear layer ``{"kernel": [in, out], "bias": [out]}`` as
    ``{"weight": [out, in], "bias": [out]}`` float32."""
    return {"weight": _f32(np.asarray(p["kernel"]).T), "bias": _f32(p["bias"])}


def bert_params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX ``bert_forward`` param tree as the port's ``BertModel``
    state dict."""
    def put(prefix: str, p: Mapping) -> Dict[str, torch.Tensor]:
        p = (linear_from_jax(p) if "kernel" in p
             else {k: _f32(v) for k, v in p.items()})
        return {f"{prefix}.{k}": v for k, v in p.items()}

    emb = tree["embeddings"]
    state = {f"embeddings.{name}.weight": _f32(emb[name])
             for name in ("word_embeddings", "position_embeddings",
                          "token_type_embeddings")}
    state |= put("embeddings.LayerNorm", emb["LayerNorm"])
    for i, layer in enumerate(tree["layers"]):
        p, att = f"encoder.layer.{i}", layer["attention"]
        for part in ("query", "key", "value"):
            state |= put(f"{p}.attention.self.{part}", att[part])
        state |= put(f"{p}.attention.output.dense", att["output"])
        state |= put(f"{p}.attention.output.LayerNorm", att["output_LayerNorm"])
        state |= put(f"{p}.intermediate.dense", layer["intermediate"])
        state |= put(f"{p}.output.dense", layer["output"])
        state |= put(f"{p}.output.LayerNorm", layer["output_LayerNorm"])
    return state


def cross_encoder_head_from_jax(head: Mapping
                                ) -> Dict[str, Optional[Dict[str, torch.Tensor]]]:
    """The JAX cross-encoder head ``{"dense": linear or None, "out":
    linear}`` as the port's (``TorchBertCrossEncoder``'s ``head``)."""
    dense = head.get("dense")
    return {"dense": None if dense is None else linear_from_jax(dense),
            "out": linear_from_jax(head["out"])}


def _same_dtype(a) -> torch.Tensor:
    """A numpy array (``ml_dtypes.bfloat16`` included) as a tensor of the
    same dtype."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _quantized_leaves(node: Mapping, key: str) -> Dict[str, torch.Tensor]:
    """JAX's quantized leaves ``{key}_q`` [in, out] (carried as the port's
    [out, in]) or ``{key}_q4p`` [in / 2, out] (as it is), and
    ``{key}_scale``, of one node, under the port's suffixes (``_q``,
    ``_q4p``, ``_scale``)."""
    if f"{key}_q" in node:
        return {"_q": _swap_last(node[f"{key}_q"]),
                "_scale": _same_dtype(node[f"{key}_scale"])}
    return {"_q4p": _same_dtype(node[f"{key}_q4p"]),
            "_scale": _same_dtype(node[f"{key}_scale"])}


def _swap_last(a) -> torch.Tensor:
    """A numpy array with its last two axes swapped, contiguous."""
    return _same_dtype(np.ascontiguousarray(np.swapaxes(np.asarray(a), -1,
                                                        -2)))


def decoder_params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX decoder's param tree (``embed``, ``lm_head`` [H, V],
    ``final_norm``, ``layers[i]`` with ``input_norm``, ``q``/``k``/``v``
    (``kernel`` [in, out], ``bias``), ``o``, ``post_norm``, ``gate``,
    ``up``, ``down`` or, on a MoE layer, ``moe`` (``router`` [H, E],
    ``gate`` / ``up`` [E, H, F], ``down`` [E, F, H] and Qwen2-MoE's
    ``shared_gate`` [H, 1] and ``shared`` ``gate`` / ``up`` / ``down``)
    and, where the family has them, ``q_norm``, ``k_norm``,
    ``pre_ff_norm`` and ``post_ff_norm``) as the port's ``DecoderModel``
    state dict, in the tree's dtype. A head equal to the embedding's
    transpose is the tied head: the state then has no
    ``lm_head.weight``.

    A tree that ``quantize_weights`` returned carries its ints and scales:
    a node's ``kernel_q`` [in, out] becomes ``weight_q`` [out, in],
    ``kernel_q4p`` ``weight_q4p`` as packed, ``kernel_scale``
    ``weight_scale``; the quantized head (a dict) ``lm_head.*``; the MoE
    stacks' ``gate_q`` / ``up_q`` / ``down_q`` [E, in, out] become [E, out,
    in], the ``*_q4p`` carriers and the scales as they are; the shared
    expert's flat leaves its projections' ``weight_*``."""
    def weight(node, name: str) -> Dict[str, torch.Tensor]:
        if "kernel" in node:
            return {f"{name}.weight": _same_dtype(
                np.asarray(node["kernel"]).T)}
        return {f"{name}.weight{sfx}": t for sfx, t in
                _quantized_leaves(node, "kernel").items()}

    def transposed(a) -> torch.Tensor:
        return _same_dtype(np.asarray(a).T)

    embed = np.asarray(tree["embed"])
    state = {"embed_tokens.weight": _same_dtype(embed),
             "norm.weight": _same_dtype(tree["final_norm"])}
    head = tree["lm_head"]
    if isinstance(head, Mapping):
        state |= weight(head, "lm_head")
    elif not np.array_equal(np.asarray(head), embed.T):
        state["lm_head.weight"] = transposed(head)
    for i, layer in enumerate(tree["layers"]):
        p = f"layers.{i}"
        state[f"{p}.input_layernorm.weight"] = _same_dtype(layer["input_norm"])
        state[f"{p}.post_attention_layernorm.weight"] = _same_dtype(
            layer["post_norm"])
        for x in "qkvo":
            state |= weight(layer[x], f"{p}.self_attn.{x}_proj")
        for x in "qkv":
            state[f"{p}.self_attn.{x}_proj.bias"] = _same_dtype(
                layer[x]["bias"])
        if "moe" in layer:
            moe = layer["moe"]
            state[f"{p}.mlp.router"] = transposed(moe["router"])
            for x in ("gate", "up", "down"):
                if x in moe:
                    state[f"{p}.mlp.{x}"] = _same_dtype(moe[x])
                else:
                    state |= {f"{p}.mlp.{x}{sfx}": t for sfx, t in
                              _quantized_leaves(moe, x).items()}
            if "shared_gate" in moe:
                state[f"{p}.mlp.shared_expert_gate.weight"] = transposed(
                    moe["shared_gate"])
                sh = moe["shared"]
                for x in ("gate", "up", "down"):
                    name = f"{p}.mlp.shared_expert.{x}_proj.weight"
                    if x in sh:
                        state[name] = transposed(sh[x])
                    else:
                        state |= {name + sfx: t for sfx, t in
                                  _quantized_leaves(sh, x).items()}
        else:
            for x in ("gate", "up", "down"):
                state |= weight(layer[x], f"{p}.mlp.{x}_proj")
        for key, name in (("q_norm", "self_attn.q_norm"),
                          ("k_norm", "self_attn.k_norm"),
                          ("pre_ff_norm", "pre_feedforward_layernorm"),
                          ("post_ff_norm", "post_feedforward_layernorm")):
            if key in layer:
                state[f"{p}.{name}.weight"] = _same_dtype(layer[key])
    return state


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
