"""Causal decoder LM: the single-stream generation engine (port of
``legalrag_tpu/models/decoder.py``).

The dense families JAX serves: Qwen2 / Qwen2.5 (q/k/v biases, usually tied
embeddings), Llama (no biases, an untied head), Qwen3 (per-head q/k
RMSNorms before RoPE, an explicit ``head_dim``), Mistral (every layer in
the sliding band), Gemma 1 / 2 / 3 (``1 + w`` RMSNorms, the embedding
scaled by sqrt(hidden), the tanh GELU, Gemma 2 / 3's sandwich norms
around attention and MLP, Gemma 2's logit softcaps, Gemma 3's ``1 + w``
q/k norms and its sliding layers rotating at ``rope_local_base_freq``
without ``rope_scaling``), ``query_pre_attn_scalar``: RMSNorm, rotary
positions (default, linear, llama3 and yarn scaling), grouped-query
attention, banded on the layers ``layer_types`` marks
``"sliding_attention"``, loaded from local HF safetensors in the
checkpoint's dtype (bf16 as released). ``DecoderModel`` computes as JAX's
``decoder_forward`` does:

- projections in the weights' dtype, RMSNorm's variance and RoPE's angles
  in float32; a ``1 + w`` norm weight is added in the weight's dtype;
- attention scores in float32 over the whole preallocated cache (the
  operands' products exact, as ``preferred_element_type=float32``), scaled,
  softcapped, then positions past the filled rows, after the query or
  outside the band masked at -1e30, the softmax in float32 cast to the
  values' dtype, then the product with V;
- the LM head with float32 logits, softcapped, applied by prefill to the
  last real row only (``return_hidden``).

On a CUDA device a bf16 product with float32 output is one cuBLAS call
(``out_dtype``); on the CPU both operands are widened first, which gives
the same exact products.

``TorchDecoderLM`` is the counterpart of ``JaxDecoderLM``: a per-layer
``[1, max_len, Hkv, D]`` KV cache per prompt, prefill padded to
``pad_bucket``, chunked above ``prefill_chunk``, the prefix-cache hit path,
``decode_chunk`` tokens per host round trip (the tokens stay on the card
inside a chunk; the tail below a chunk goes token by token), the capacity
clamp and the ``ValueError`` for a prompt that does not fit, and HF's
warpers. The draw is a Gumbel-max over the warped logits from an explicit
``torch.Generator`` seeded by ``generate_stream``'s ``seed``; JAX's
``jax.random.categorical`` stream is not reproduced. The nucleus filter's
running sum is sequential where XLA's is a reduce-window: where it meets
``top_p`` within rounding (``top_p`` 1.0) the two keep different tails of
tokens too improbable to matter.

The mixture-of-experts families (Mixtral's ``block_sparse_moe``, Qwen2-MoE
with its sigmoid-gated shared expert, its ``decoder_sparse_step`` and
``mlp_only_layers``) take ``MoEBlock`` on the layers ``layer_is_moe``
marks: JAX's dense formulation of ``_moe_block``, every expert on every
token, so a decode chunk still needs no host read.

JAX's quantized serving (``models/quant.py``): ``weight_quant`` swaps
every projection, the quantized LM head and the expert stacks for int8
(W8A8) or grouped int4 weights (``QLinear``; ``MoEBlock`` keeps the expert
axis, and for int4 the group axis, in each integer product's output and
combines the experts after the down projection in float32), and
``kv_quant`` keeps the cache as int8 rows with per-(position, head)
float32 scales: the layer writes quantized rows and attends the
dequantized cache, its own rows included, so chunked prefill and prefix
hits stay exact.

The JSON constraint (``models/constrain.py``, ``json_constraint``):
``generate_stream(constrain=True)`` masks the penalized logits to the
tokens the schema DFA's state allows (EOS only in an accepting state),
with budget-forced completion, before the warpers, in the decode chunks
and the per-token tail alike. Speculation, and the draft models
``from_pretrained`` loads, run in ``models/spec_decode.py``.
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from legalrag_tpu_torch.models.bert import resolve_model_dir
from legalrag_tpu_torch.models.constrain import (
    SECTIONS_SCHEMA,
    JsonConstraint,
    StreamConstraint,
)
from legalrag_tpu_torch.models.quant import (
    QUANT_GROUP,
    Int4Operands,
    QLinear,
    dequantize_kv,
    group_int_mm,
    group_size,
    int_mm,
    quant_acts,
    quantize_kv,
    quantize_weights,
    state_bits,
)
from legalrag_tpu_torch.models.safetensors_io import load_weights
from legalrag_tpu_torch.ops.topk import stable_topk
from legalrag_tpu_torch.utils import get_logger
from legalrag_tpu_torch.utils.device import DeviceLike, resolve_device

log = get_logger("torch.models.decoder")

NEG_INF = -1e30


class DecoderConfig:
    """An HF decoder ``config.json`` as JAX's ``DecoderConfig`` parses it
    (every family's keys, so a config means the same in both packages)."""

    def __init__(self, vocab_size=151936, hidden_size=896,
                 num_hidden_layers=24, num_attention_heads=14,
                 num_key_value_heads=2, intermediate_size=4864,
                 max_position_embeddings=32768, rms_norm_eps=1e-6,
                 rope_theta=1000000.0, tie_word_embeddings=True,
                 head_dim=None, rope_scaling=None, model_type="",
                 hidden_activation=None, query_pre_attn_scalar=None,
                 attn_logit_softcapping=None, final_logit_softcapping=None,
                 sliding_window=None, layer_types=None,
                 rope_local_base_freq=None, sliding_window_pattern=None,
                 num_local_experts=None, num_experts=None,
                 num_experts_per_tok=None, norm_topk_prob=None,
                 moe_intermediate_size=None,
                 shared_expert_intermediate_size=None,
                 decoder_sparse_step=None, mlp_only_layers=None,
                 **_ignored):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.num_key_value_heads = num_key_value_heads
        self.intermediate_size = intermediate_size
        self.max_position_embeddings = max_position_embeddings
        self.rms_norm_eps = rms_norm_eps
        self.rope_theta = rope_theta
        self.tie_word_embeddings = tie_word_embeddings
        # Qwen3 / Gemma configs carry a head_dim other than hidden / heads
        self.head_dim = head_dim or hidden_size // num_attention_heads
        self.rope_scaling = rope_scaling
        rtype = (rope_scaling or {}).get("rope_type") \
            or (rope_scaling or {}).get("type")
        if rtype not in (None, "default", "linear", "llama3", "yarn"):
            raise ValueError(
                f"rope_scaling type {rtype!r} (dynamic/longrope/…) is not "
                "implemented — refusing to load rather than decode with "
                "wrong positions")
        self.model_type = model_type or ""
        self.gemma = self.model_type.startswith("gemma")
        self.gemma3 = self.model_type.startswith("gemma3")
        self.rope_local_base_freq = rope_local_base_freq or 10000.0
        self.hidden_activation = hidden_activation or (
            "gelu_pytorch_tanh" if self.gemma else "silu")
        self.query_pre_attn_scalar = query_pre_attn_scalar
        self.attn_logit_softcapping = attn_logit_softcapping
        self.final_logit_softcapping = final_logit_softcapping
        self.sliding_window = sliding_window
        if layer_types is None and self.gemma3 and sliding_window:
            # gemma3: every Nth layer is full attention
            pat = sliding_window_pattern or 6
            layer_types = ["full_attention" if (i + 1) % pat == 0 else
                           "sliding_attention"
                           for i in range(num_hidden_layers)]
        elif layer_types is None and self.gemma and sliding_window:
            # gemma-2 configs predate layer_types: alternate, as HF does
            layer_types = ["sliding_attention" if (i + 1) % 2 else
                           "full_attention"
                           for i in range(num_hidden_layers)]
        elif (layer_types is None and sliding_window
              and self.model_type in ("mistral", "mixtral")):
            # Mistral/Mixtral v0.1: every layer attends in the band
            layer_types = ["sliding_attention"] * num_hidden_layers
        self.layer_types = layer_types
        # mixture of experts (Mixtral num_local_experts, Qwen2-MoE
        # num_experts)
        self.num_experts = num_local_experts or num_experts or 0
        self.num_experts_per_tok = num_experts_per_tok or 2
        if norm_topk_prob is None:
            norm_topk_prob = self.model_type == "mixtral"
        self.norm_topk_prob = bool(norm_topk_prob)
        self.moe_intermediate_size = moe_intermediate_size
        self.shared_expert_intermediate_size = shared_expert_intermediate_size
        self.decoder_sparse_step = decoder_sparse_step or 1
        self.mlp_only_layers = list(mlp_only_layers or [])

    def layer_is_moe(self, li: int) -> bool:
        if not self.num_experts:
            return False
        if li in self.mlp_only_layers:
            return False
        step = self.decoder_sparse_step
        return step > 0 and (li + 1) % step == 0

    def layer_is_sliding(self, li: int) -> bool:
        """Whether JAX bands layer ``li``: only a ``"sliding_attention"``
        entry of ``layer_types`` with ``sliding_window`` set does."""
        return bool(self.sliding_window and self.layer_types is not None
                    and self.layer_types[li] == "sliding_attention")

    @classmethod
    def from_json(cls, path: Path) -> "DecoderConfig":
        return cls(**json.loads(Path(path).read_text(encoding="utf-8")))


# ---------------------------------------------------------------------------
# functional pieces

def _rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float,
              plus_one: bool = False) -> torch.Tensor:
    """RMSNorm: the variance in float32, the normed rows cast back to
    ``x``'s dtype, then times ``w``, or with ``plus_one`` (Gemma's
    zero-centred weight) times ``1 + w`` added in ``w``'s dtype, as JAX
    adds it."""
    var = x.float().pow(2).mean(-1, keepdim=True)
    normed = (x.float() * torch.rsqrt(var + eps)).to(x.dtype)
    return normed * (1.0 + w) if plus_one else normed * w


def rope_inv_freq(cfg: DecoderConfig, d: int, base: Optional[float] = None,
                  use_scaling: bool = True) -> Tuple[torch.Tensor, float]:
    """(float32 inverse wavelengths [d / 2], cos/sin scale) for the
    default, linear, llama3 and yarn types, computed in float64 as JAX
    computes them."""
    base = base or cfg.rope_theta
    inv = 1.0 / (base ** (np.arange(0, d, 2, dtype=np.float64) / d))
    scale = 1.0
    rs = cfg.rope_scaling if use_scaling else None
    rtype = (rs or {}).get("rope_type") or (rs or {}).get("type")
    if rtype == "linear":
        inv = inv / rs["factor"]
    elif rtype == "llama3":
        factor, lo, hi = rs["factor"], rs["low_freq_factor"], \
            rs["high_freq_factor"]
        orig = rs["original_max_position_embeddings"]
        wavelen = 2 * math.pi / inv
        smooth = (orig / wavelen - lo) / (hi - lo)
        inv = np.where(wavelen > orig / lo, inv / factor,
                       np.where(wavelen < orig / hi, inv,
                                (1 - smooth) / factor * inv + smooth * inv))
    elif rtype == "yarn":
        factor = rs["factor"]
        orig = (rs.get("original_max_position_embeddings")
                or cfg.max_position_embeddings)
        beta_fast = rs.get("beta_fast") or 32
        beta_slow = rs.get("beta_slow") or 1
        scale = rs.get("attention_factor")
        if scale is None:
            def mscale(s, m=1):
                return 1.0 if s <= 1 else 0.1 * m * math.log(s) + 1.0

            ms, msd = rs.get("mscale"), rs.get("mscale_all_dim")
            scale = (mscale(factor, ms) / mscale(factor, msd)
                     if ms and msd else mscale(factor))

        def corr_dim(n_rot):
            return (d * math.log(orig / (n_rot * 2 * math.pi))
                    ) / (2 * math.log(base))

        lo, hi = corr_dim(beta_fast), corr_dim(beta_slow)
        if rs.get("truncate", True):
            lo, hi = math.floor(lo), math.ceil(hi)
        lo, hi = max(lo, 0), min(hi, d - 1)
        if lo == hi:
            hi += 0.001
        ramp = np.clip((np.arange(d // 2, dtype=np.float64) - lo)
                       / (hi - lo), 0, 1)
        extrapolation_factor = 1 - ramp
        inv = (inv / factor) * (1 - extrapolation_factor) \
            + inv * extrapolation_factor
    return torch.from_numpy(np.asarray(inv, np.float32)), float(scale)


def _rope_tables(positions: torch.Tensor, inv: torch.Tensor, scale: float):
    """cos and sin [B, T, 1, D / 2] (float32) of ``positions`` [B, T]."""
    ang = positions[:, :, None].float() * inv.to(positions.device)[None, None]
    return ((torch.cos(ang) * scale)[:, :, None, :],
            (torch.sin(ang) * scale)[:, :, None, :])


def _rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
          ) -> torch.Tensor:
    """Rotate ``x`` [B, T, H, D] by pairs (the half-split convention), in
    float32, cast back to ``x``'s dtype."""
    d = x.shape[-1]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` ([N, K] x [K, M] or batched) with float32 output and
    exact products of 16-bit operands, as ``preferred_element_type=
    float32`` asks."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return torch.bmm(a, b) if a.dim() == 3 else a @ b
    if a.is_cuda:
        return (torch.bmm(a, b, out_dtype=torch.float32) if a.dim() == 3
                else torch.mm(a, b, out_dtype=torch.float32))
    a, b = a.float(), b.float()
    return torch.bmm(a, b) if a.dim() == 3 else a @ b


def _softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    """``cap * tanh(x / cap)`` (Gemma 2's softcap); no cap passes ``x``."""
    return cap * torch.tanh(x / cap) if cap else x


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           mask: torch.Tensor, scale: float,
           softcap: Optional[float] = None) -> torch.Tensor:
    """GQA attention: ``q`` [B, T, H, D], ``k``/``v`` [B, S, Hkv, D],
    ``mask`` [B, T, S] (True where a query may attend); query head h reads
    kv head h // (H / Hkv), as ``jnp.repeat`` pairs them. The scores are
    scaled, then softcapped, then masked. Returns [B, T, H * D] in ``v``'s
    dtype."""
    b, t, h, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    rep = h // hkv
    qg = q.reshape(b, t, hkv, rep, d).permute(0, 2, 3, 1, 4).reshape(
        b * hkv, rep * t, d)
    kg = k.permute(0, 2, 3, 1).reshape(b * hkv, d, s)
    scores = _softcap(_mm_f32(qg, kg).view(b, hkv, rep, t, s) * scale,
                      softcap)
    scores = scores.masked_fill(~mask[:, None, None], NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    vg = v.permute(0, 2, 1, 3).reshape(b * hkv, s, d)
    ctx = torch.bmm(probs.view(b * hkv, rep * t, s), vg)
    return ctx.view(b, hkv, rep, t, d).permute(0, 3, 1, 2, 4).reshape(
        b, t, h * d)


def lm_logits(head: torch.Tensor, x: torch.Tensor,
              softcap: Optional[float] = None) -> torch.Tensor:
    """Final-norm hidden states [..., H] and the head [V, H] (the tied
    embedding or ``lm_head.weight``) → float32 logits [..., V], softcapped
    by ``softcap`` (``final_logit_softcapping``)."""
    return _softcap(_mm_f32(x.reshape(-1, x.shape[-1]), head.t()).view(
        *x.shape[:-1], head.shape[0]), softcap)


def pad_bucket(n: int, lo: int = 16, hi: Optional[int] = None) -> int:
    """Next power of two ≥ n (at least ``lo``), capped at ``hi``: the
    prompt padding buckets."""
    b = lo
    while b < n:
        b *= 2
    return min(b, hi) if hi is not None else b


# ---------------------------------------------------------------------------
# the model

class RMSNorm(nn.Module):
    """``plus_one``: the Gemma families' zero-centred weight, applied as
    ``1 + w``."""

    def __init__(self, dim: int, eps: float, plus_one: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(dim) if plus_one
                                   else torch.ones(dim))
        self.eps = eps
        self.plus_one = plus_one

    def forward(self, x):
        return _rms_norm(x, self.weight, self.eps, self.plus_one)


def linear(in_features: int, out_features: int, bias: bool, bits: int = 0
           ) -> nn.Module:
    """``nn.Linear``, or under weight quantization (``bits`` 8 or 4) its
    ``QLinear``."""
    if bits:
        return QLinear(in_features, out_features, bias, bits)
    return nn.Linear(in_features, out_features, bias=bias)


class Attention(nn.Module):
    """The projections, and Qwen3's / Gemma 3's per-head ``q_norm`` and
    ``k_norm`` when ``qk_norm``. The head counts are the projections'
    widths over ``head_dim``: a tensor-parallel shard
    (``parallel/decoder_tp.py``) runs its own heads through the same
    steps."""

    def __init__(self, cfg: DecoderConfig, bias: bool, qk_norm: bool,
                 bits: int = 0):
        super().__init__()
        self.cfg = cfg
        h, hkv, d = (cfg.num_attention_heads, cfg.num_key_value_heads,
                     cfg.head_dim)
        self.q_proj = linear(cfg.hidden_size, h * d, bias, bits)
        self.k_proj = linear(cfg.hidden_size, hkv * d, bias, bits)
        self.v_proj = linear(cfg.hidden_size, hkv * d, bias, bits)
        self.o_proj = linear(h * d, cfg.hidden_size, False, bits)
        self.q_norm = self.k_norm = None
        if qk_norm:
            self.q_norm = RMSNorm(d, cfg.rms_norm_eps, cfg.gemma)
            self.k_norm = RMSNorm(d, cfg.rms_norm_eps, cfg.gemma)

    def queries(self, y, cos, sin) -> torch.Tensor:
        """The normed rows ``y`` [B, T, H] → rotated queries [B, T, h, D]
        (``q_norm`` first where there is one)."""
        b, t, _ = y.shape
        q = self.q_proj(y).view(b, t, -1, self.cfg.head_dim)
        if self.q_norm is not None:
            q = self.q_norm(q)
        return _rope(q, cos, sin)

    def keys_values(self, y, cos, sin, cache, cache_len, shared=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The keys and values attention reads: the new rows of ``y``
        (keys normed and rotated) without a cache; with ``cache`` (dense
        ``(k, v)``, or the int8 cache's ``(k_q, v_q, k_scale, v_scale)``)
        the new rows written from ``cache_len`` (``_write_rows``; int8
        rows quantized) and the whole cache read back (dequantized), these
        rows included; ``shared``'s pinned rows before them."""
        b, t, _ = y.shape
        d = self.cfg.head_dim
        k = self.k_proj(y).view(b, t, -1, d)
        if self.k_norm is not None:
            k = self.k_norm(k)
        k = _rope(k, cos, sin)
        v = self.v_proj(y).view(b, t, -1, d)
        if cache is not None and len(cache) == 4:
            ckq, cvq, cks, cvs = cache
            for dst, dsc, x_new in ((ckq, cks, k), (cvq, cvs, v)):
                q_new, s_new = quantize_kv(x_new)
                _write_rows(dst, q_new, cache_len)
                _write_rows(dsc, s_new, cache_len)
            k, v = (dequantize_kv(ckq, cks, k.dtype),
                    dequantize_kv(cvq, cvs, v.dtype))
        elif cache is not None:
            ck, cv = cache
            _write_rows(ck, k, cache_len)
            _write_rows(cv, v, cache_len)
            k, v = ck, cv
        if shared is not None:
            sk, sv = shared if len(shared) == 2 else (
                dequantize_kv(shared[0], shared[2], k.dtype),
                dequantize_kv(shared[1], shared[3], v.dtype))
            k = torch.cat([sk.expand(b, *sk.shape[1:]), k], dim=1)
            v = torch.cat([sv.expand(b, *sv.shape[1:]), v], dim=1)
        return k, v

    def context(self, q, k, v, mask) -> torch.Tensor:
        """``attend`` at the family's scale and softcap: [B, T, h * D],
        the o projection's input."""
        cfg = self.cfg
        return attend(q, k, v, mask,
                      (cfg.query_pre_attn_scalar or cfg.head_dim) ** -0.5,
                      cfg.attn_logit_softcapping)

    def forward(self, y, cos, sin, mask, cache, cache_len, shared=None):
        k, v = self.keys_values(y, cos, sin, cache, cache_len, shared)
        return self.o_proj(self.context(self.queries(y, cos, sin), k, v,
                                        mask))


def _act(g: torch.Tensor, gelu: bool) -> torch.Tensor:
    """The tanh GELU or SiLU (JAX's test: the GELU by name, SiLU for any
    other activation)."""
    return F.gelu(g, approximate="tanh") if gelu else F.silu(g)


class MLP(nn.Module):
    def __init__(self, cfg: DecoderConfig, ff: Optional[int] = None,
                 gelu: Optional[bool] = None, bits: int = 0):
        super().__init__()
        hs, ff = cfg.hidden_size, ff or cfg.intermediate_size
        self.gate_proj = linear(hs, ff, False, bits)
        self.up_proj = linear(hs, ff, False, bits)
        self.down_proj = linear(ff, hs, False, bits)
        self.gelu = (cfg.hidden_activation == "gelu_pytorch_tanh"
                     if gelu is None else gelu)

    def hidden(self, y):
        """``act(gate(y)) * up(y)``: the down projection's input."""
        return _act(self.gate_proj(y), self.gelu) * self.up_proj(y)

    def forward(self, y):
        return self.down_proj(self.hidden(y))


class MoEBlock(Int4Operands, nn.Module):
    """JAX's ``_moe_block``, Mixtral's and Qwen2-MoE's, with JAX's stacked
    parameters: ``router`` [E, H] (the checkpoint's ``gate.weight``),
    ``gate`` and ``up`` [E, H, F], ``down`` [E, F, H] (F:
    ``moe_intermediate_size``, else ``intermediate_size``), and with
    ``shared`` Qwen2-MoE's ``shared_expert`` (an ``MLP`` of
    ``shared_expert_intermediate_size``, always SiLU) and
    ``shared_expert_gate`` [1, H] where ``shared_expert_intermediate_size``
    is set.

    The function and its rounding points are JAX's: router logits in the
    hidden dtype; the softmax in float32 over all experts; the top
    ``num_experts_per_tok`` in ``lax.top_k``'s order (a tie to the lower
    expert, ``stable_topk``), renormalised where ``norm_topk_prob``; the
    combine weights cast to the hidden dtype and multiplied into
    ``act * u`` before the down projection, which contracts experts and
    width in one product; then ``sigmoid(y @ shared_gate) * shared(y)``
    added. Dense: every expert runs on every token (one batched product
    over the expert axis for ``gate`` and ``up``), on the CPU and the card
    alike, with no host read.

    Quantized (``bits``, JAX's ``qmoe``): int8 stacks ``gate_q`` / ``up_q``
    [E, F, H], ``down_q`` [E, H, F] (each expert [out, in]) with scales [E,
    F] / [E, H]; int4 carriers ``gate_q4p`` / ``up_q4p`` [E, H / 2, F],
    ``down_q4p`` [E, F / 2, H] with scales [E, groups, out]; the shared
    expert's projections as ``QLinear``. The router, ``shared_expert_gate``
    and the combine stay at full precision. The activations are quantized
    per token for gate and up, per (token, expert) for down; each integer
    product keeps the expert axis (int4: and the group axis) in its output,
    gate and up stay float32, and the combine (cast to the hidden dtype,
    then to float32) weights the down projection's output."""

    def __init__(self, cfg: DecoderConfig, bits: int = 0,
                 group: int = QUANT_GROUP):
        super().__init__()
        e, hs = cfg.num_experts, cfg.hidden_size
        ff = cfg.moe_intermediate_size or cfg.intermediate_size
        self.cfg, self.bits = cfg, bits
        self.router = nn.Parameter(torch.empty(e, hs))
        if bits == 8:
            for name, (o, i) in (("gate", (ff, hs)), ("up", (ff, hs)),
                                 ("down", (hs, ff))):
                self.register_buffer(f"{name}_q", torch.empty(
                    e, o, i, dtype=torch.int8))
                self.register_buffer(f"{name}_scale", torch.empty(e, o))
        elif bits == 4:
            self.groups = {}
            for name, (i, o) in (("gate", (hs, ff)), ("up", (hs, ff)),
                                 ("down", (ff, hs))):
                g = self.groups[name] = group_size(i, group)
                self.register_buffer(f"{name}_q4p", torch.empty(
                    e, i // 2, o, dtype=torch.int8))
                self.register_buffer(f"{name}_scale", torch.empty(
                    e, i // g, o))
        else:
            self.gate = nn.Parameter(torch.empty(e, hs, ff))
            self.up = nn.Parameter(torch.empty(e, hs, ff))
            self.down = nn.Parameter(torch.empty(e, ff, hs))
        self.gelu = cfg.hidden_activation == "gelu_pytorch_tanh"
        self.shared_expert = self.shared_expert_gate = None
        if cfg.shared_expert_intermediate_size:
            self.shared_expert = MLP(cfg, cfg.shared_expert_intermediate_size,
                                     gelu=False, bits=bits)
            self.shared_expert_gate = nn.Linear(hs, 1, bias=False)

    def experts(self) -> List[torch.Tensor]:
        """The expert stacks' tensors (their scales with them)."""
        names = ("gate", "up", "down")
        if self.bits == 8:
            return [getattr(self, f"{n}_{x}") for n in names
                    for x in ("q", "scale")]
        if self.bits == 4:
            return [getattr(self, f"{n}_{x}") for n in names
                    for x in ("q4p", "scale")]
        return [self.gate, self.up, self.down]

    def probs(self, x: torch.Tensor) -> torch.Tensor:
        """The router's float32 softmax over all experts [N, E] of rows
        ``x`` [N, H] (the logits in ``x``'s dtype)."""
        return torch.softmax(F.linear(x, self.router).float(), dim=-1)

    def combine(self, probs: torch.Tensor, chosen: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
        """The combine weights [N, E] in ``dtype``: ``probs`` at the
        ``chosen`` experts [N, k] (renormalised where ``norm_topk_prob``),
        0 elsewhere."""
        topv = probs.gather(-1, chosen)
        if self.cfg.norm_topk_prob:
            topv = topv / topv.sum(-1, keepdim=True)
        return torch.zeros_like(probs).scatter_(-1, chosen, topv).to(dtype)

    def route(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Rows ``x`` [N, H] → (the chosen experts [N, k] in ``lax.top_k``'s
        order, their combine weights [N, E] in ``x``'s dtype)."""
        probs = self.probs(x)
        chosen = stable_topk(probs, self.cfg.num_experts_per_tok)[1]
        return chosen, self.combine(probs, chosen, x.dtype)

    def _gate_up_int8(self, xq, xs, name: str) -> torch.Tensor:
        """``einsum("bth,ehf->btef")`` of int8 rows: [N, E, F] float32."""
        w = getattr(self, f"{name}_q")
        acc = int_mm(xq, w.view(-1, w.shape[-1])).view(xq.shape[0],
                                                        *w.shape[:2])
        return acc.float() * xs[..., None] * getattr(self, f"{name}_scale")

    def _gate_up_int4(self, xq, xs, name: str) -> torch.Tensor:
        """``einsum("btgi,egif->btegf")`` of int8 rows, summed over the
        groups: [N, E, F] float32."""
        scale = getattr(self, f"{name}_scale")                # [E, G, F]
        e, n_g, f = scale.shape
        n, g = xq.shape[0], self.groups[name]
        a = xq.view(n, n_g, g).transpose(0, 1).unsqueeze(0).expand(
            e, n_g, n, g).reshape(e * n_g, n, g)
        acc = group_int_mm(a, self.int4_operand(f"{name}_q4p", g))
        y = acc.view(e, n_g, n, f).mul_(scale[:, :, None]).sum(1)
        return y.transpose(0, 1) * xs[..., None]

    def _down_int8(self, aq: torch.Tensor) -> torch.Tensor:
        """``einsum("btef,efh->bteh")``: [N, E, H] int32."""
        return int_mm(aq.transpose(0, 1), self.down_q).transpose(0, 1)

    def _down_int4(self, aq: torch.Tensor) -> torch.Tensor:
        """``einsum("btegi,egih->btegh")`` rescaled and summed over the
        groups: [N, E, H] float32."""
        scale = self.down_scale                               # [E, G, H]
        e, n_g, h = scale.shape
        n, g = aq.shape[0], self.groups["down"]
        a = aq.view(n, e, n_g, g).permute(1, 2, 0, 3).reshape(e * n_g, n, g)
        acc = group_int_mm(a, self.int4_operand("down_q4p", g))
        y = acc.view(e, n_g, n, h).mul_(scale[:, :, None]).sum(1)
        return y.transpose(0, 1)

    def _experts_quantized(self, x: torch.Tensor, combine: torch.Tensor
                           ) -> torch.Tensor:
        """The quantized experts' combined output [N, H] in float32."""
        xq, xs = quant_acts(x)
        gate_up = self._gate_up_int8 if self.bits == 8 else self._gate_up_int4
        g, u = gate_up(xq, xs, "gate"), gate_up(xq, xs, "up")
        aq, a_s = quant_acts(_act(g, self.gelu) * u)   # per (token, expert)
        if self.bits == 8:
            deq = self._down_int8(aq).float() * a_s * self.down_scale
        else:
            deq = self._down_int4(aq) * a_s
        return (deq * combine.float()[..., None]).sum(1)

    def _gated(self, x: torch.Tensor, combine: torch.Tensor) -> torch.Tensor:
        """``act(x @ gate) * (x @ up) * combine`` over this block's experts,
        laid out [N, E * F] for one down product over experts and width."""
        e, n = self.gate.shape[0], x.shape[0]
        xe = x.unsqueeze(0).expand(e, n, x.shape[1])
        g = torch.bmm(xe, self.gate)                             # [E, N, F]
        mid = _act(g, self.gelu) * torch.bmm(xe, self.up) \
            * combine.t()[:, :, None]
        return mid.transpose(0, 1).reshape(n, -1)

    def partial(self, x: torch.Tensor, combine: torch.Tensor) -> torch.Tensor:
        """Rows ``x`` [N, H] through this block's experts, each weighted by
        its column of ``combine`` [N, E], summed in float32 [N, H]: an
        expert-parallel shard's part (``parallel/decoder_tp.py``), before
        the shards' sum and the shared expert."""
        if self.bits:
            return self._experts_quantized(x, combine)
        return _mm_f32(self._gated(x, combine),
                       self.down.reshape(-1, x.shape[1]))

    def with_shared(self, x: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
        """``out`` plus ``sigmoid(x @ shared_gate) * shared(x)`` where the
        block has Qwen2-MoE's shared expert."""
        if self.shared_expert is None:
            return out
        return out + torch.sigmoid(self.shared_expert_gate(x)) \
            * self.shared_expert(x)

    def forward(self, y):
        shape = y.shape
        x = y.reshape(-1, shape[-1])                             # [N, H]
        _, combine = self.route(x)
        if self.bits:
            out = self._experts_quantized(x, combine).to(x.dtype)
        else:
            out = self._gated(x, combine) @ self.down.reshape(-1, shape[-1])
        return self.with_shared(x, out).view(shape)


def _write_rows(dst: torch.Tensor, rows: torch.Tensor, cache_len) -> None:
    """Write ``rows`` [B, T, ...] into the cache ``dst`` [B, S, ...] from row
    ``cache_len``: an int; a 0-d tensor on the device (the speculative
    engine's offset, never read by the host); or a [B] tensor, each batch
    row from its own offset (the continuous-batching engine's slots).

    A 0-d offset's rows past the cache land on its last row: a frozen
    verify pass near capacity writes there, at or past the write pointer,
    where every later step writes its own row before attending it. A [B]
    offset's rows outside the cache are dropped, as JAX's scatter drops
    them: each is written instead to a row of its batch row that no valid
    entry of this call writes, with that row's own content, so the cache
    is left as it was there (``T <= S`` gives every batch row one)."""
    t = rows.shape[1]
    if isinstance(cache_len, int):
        dst[:, cache_len:cache_len + t] = rows
        return
    if cache_len.dim() == 0:
        idx = (cache_len + torch.arange(t, device=dst.device)).clamp_max(
            dst.shape[1] - 1)
        dst.index_copy_(1, idx, rows.to(dst.dtype))
        return
    b, s = dst.shape[:2]
    r = cache_len[:, None] + torch.arange(t, device=dst.device)[None, :]
    ok = (r >= 0) & (r < s)
    lo = cache_len.clamp(0, s)
    hi = (cache_len + t).clamp(0, s)
    # the row before the written range where there is one, else after it
    sink = torch.where(lo > 0, lo - 1, hi.clamp_max(s - 1))
    brow = torch.arange(b, device=dst.device)
    kept = dst[brow, sink]                                   # [B, ...]
    shape = (b, t) + (1,) * (rows.dim() - 2)
    vals = torch.where(ok.view(shape), rows.to(dst.dtype),
                       kept[:, None].expand_as(rows))
    dst[brow[:, None].expand(b, t), torch.where(ok, r, sink[:, None])] = vals


class DecoderLayer(nn.Module):
    """Pre-norm attention and MLP (``MoEBlock`` with ``moe``); with
    ``sandwich`` (Gemma 2 / 3)
    ``post_attention_layernorm`` normalises the attention output before
    the residual add, ``pre_feedforward_layernorm`` feeds the MLP and
    ``post_feedforward_layernorm`` normalises its output."""

    def __init__(self, cfg: DecoderConfig, bias: bool, qk_norm: bool,
                 sandwich: bool, moe: bool = False, bits: int = 0):
        super().__init__()
        self.cfg = cfg
        hs, eps, g = cfg.hidden_size, cfg.rms_norm_eps, cfg.gemma
        self.input_layernorm = RMSNorm(hs, eps, g)
        self.self_attn = Attention(cfg, bias, qk_norm, bits)
        self.post_attention_layernorm = RMSNorm(hs, eps, g)
        self.mlp = MoEBlock(cfg, bits) if moe else MLP(cfg, bits=bits)
        self.pre_feedforward_layernorm = self.post_feedforward_layernorm = None
        if sandwich:
            self.pre_feedforward_layernorm = RMSNorm(hs, eps, True)
            self.post_feedforward_layernorm = RMSNorm(hs, eps, True)

    def forward(self, x, cos, sin, mask, cache, cache_len, shared=None):
        """``cache_len``: the write offset (``_write_rows``); ``shared``:
        the layer's pinned shared-prefix rows (``DecoderModel.forward``),
        attended before the cache."""
        return self.residual(
            x, lambda y: self.self_attn(y, cos, sin, mask, cache, cache_len,
                                        shared), self.mlp)

    def residual(self, x, attention, mlp):
        """The layer around ``attention`` and ``mlp`` (each a function of
        its normed input rows): pre-norm residual adds, or with the
        sandwich the attention and MLP outputs normed before theirs."""
        out = attention(self.input_layernorm(x))
        if self.pre_feedforward_layernorm is not None:
            x = x + self.post_attention_layernorm(out)
            out = mlp(self.pre_feedforward_layernorm(x))
            return x + self.post_feedforward_layernorm(out)
        x = x + out
        return x + mlp(self.post_attention_layernorm(x))


class DecoderModel(nn.Module):
    """The dense decoder with HF's parameter names (``embed_tokens``,
    ``layers.{i}.self_attn.q_proj``, ..., ``norm``, ``lm_head`` when the
    head is untied), so a checkpoint's tensors load by name; a MoE layer's
    ``mlp`` is a ``MoEBlock`` (``layers.{i}.mlp.router``, ``.gate``,
    ``.up``, ``.down``, ``.shared_expert.*``, ``.shared_expert_gate``).
    ``bias``: whether q/k/v have biases (Qwen2) or not; ``qk_norm``: the
    per-head q/k norms (Qwen3, Gemma 3); ``sandwich``: the feed-forward
    norms (Gemma 2 / 3); ``bits`` (8 or 4): ``quantize_weights``' model,
    every projection a ``QLinear`` (``.weight_q`` or ``.weight_q4p`` with
    ``.weight_scale``), the quantized stacks in each ``MoEBlock`` and a
    quantized ``lm_head``, tied or not."""

    def __init__(self, cfg: DecoderConfig, bias: bool = True,
                 qk_norm: bool = False, sandwich: bool = False,
                 bits: int = 0):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, bias, qk_norm, sandwich, cfg.layer_is_moe(li),
                         bits)
            for li in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, cfg.gemma)
        self.lm_head = (QLinear(cfg.hidden_size, cfg.vocab_size, False, bits)
                        if bits else None if cfg.tie_word_embeddings else
                        nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False))
        self._set_rope()

    def _set_rope(self, device=None) -> None:
        """The global RoPE table, and for Gemma 3 the sliding layers' own
        (``rope_local_base_freq``, no ``rope_scaling``)."""
        cfg = self.cfg
        inv, self.rope_scale = rope_inv_freq(cfg, cfg.head_dim)
        self.register_buffer("rope_inv", inv.to(device), persistent=False)
        inv, self.rope_scale_local = rope_inv_freq(
            cfg, cfg.head_dim, base=cfg.rope_local_base_freq,
            use_scaling=False)
        self.register_buffer("rope_inv_local", inv.to(device),
                             persistent=False)

    @classmethod
    def from_state_dict(cls, cfg: DecoderConfig,
                        state: Dict[str, torch.Tensor]) -> "DecoderModel":
        """A model holding ``state``'s tensors as they are (dtype and
        device kept), built without initialising weights. The head is tied
        when ``state`` has no ``lm_head.weight`` (``cfg`` is set so); the
        biases, q/k norms and feed-forward norms are there when ``state``
        has them; a MoE layer's shared expert where ``cfg`` sets
        ``shared_expert_intermediate_size``; a state that
        ``quantize_weights`` made gives the quantized model of its bits
        (int4 groups of ``QUANT_GROUP``)."""
        bits = state_bits(state)
        if not bits:
            cfg.tie_word_embeddings = "lm_head.weight" not in state
        with torch.device("meta"):
            model = cls(
                cfg, bias="layers.0.self_attn.q_proj.bias" in state,
                qk_norm="layers.0.self_attn.q_norm.weight" in state,
                sandwich="layers.0.pre_feedforward_layernorm.weight" in state,
                bits=bits)
        model.load_state_dict(state, strict=True, assign=True)
        model._set_rope(model.embed_tokens.weight.device)
        return model.eval()

    @property
    def head(self) -> torch.Tensor:
        return (self.embed_tokens.weight if self.lm_head is None
                else self.lm_head.weight)

    @property
    def dtype(self) -> torch.dtype:
        return self.embed_tokens.weight.dtype

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """Final-norm hidden states → float32 logits (softcapped); a
        quantized head's product is float32 (JAX's ``_qdot(x, head,
        float32)``)."""
        cap = self.cfg.final_logit_softcapping
        if isinstance(self.lm_head, QLinear):
            return _softcap(self.lm_head(hidden, torch.float32), cap)
        return lm_logits(self.head, hidden, cap)

    def forward(self, input_ids: torch.Tensor, positions: torch.Tensor,
                kv_cache: Optional[List[Tuple[torch.Tensor, ...]]] = None,
                cache_len=0, return_hidden: bool = False,
                shared_kv: Optional[List[Tuple[torch.Tensor, ...]]] = None,
                kv_offset=None) -> torch.Tensor:
        """[B, T] ids at ``positions`` [B, T] → float32 logits [B, T, V]
        (the final-norm hidden states with ``return_hidden``).

        With ``kv_cache`` (per layer ``(k, v)``, each [B, S, Hkv, D], or the
        int8 cache's ``(k_q, v_q, k_scale, v_scale)``, the scales [B, S,
        Hkv, 1]) the new keys and values are written in place at rows
        ``cache_len`` .. ``cache_len + T - 1`` (an int; a 0-d tensor on the
        device; or a [B] tensor, each batch row at its own offset:
        ``_write_rows``) and attention spans the whole cache (dequantized),
        rows at or past ``cache_len + T`` and after each query's position
        masked. Without it the T tokens attend each other causally. A
        sliding layer also masks the keys ``sliding_window`` or more
        positions before the query. Both masks and both RoPE tables are
        built once per call.

        ``shared_kv`` and ``kv_offset`` (JAX's physically shared prefix, the
        batched engine's ``shared_prefix``): ``shared_kv`` holds per layer
        one read-only [1, P] segment (dense or int8, as the cache) of
        absolute positions 0 .. P - 1, attended by the batch rows whose
        ``kv_offset`` (an int or [B], each 0 or P) is above 0; a cache row
        holds position ``row + kv_offset``, and ``cache_len`` stays
        absolute."""
        x, per_layer, row0 = self.embed_inputs(
            input_ids, positions, kv_cache, cache_len, shared_kv, kv_offset)
        for li, layer in enumerate(self.layers):
            x = layer(x, *per_layer[li],
                      None if kv_cache is None else kv_cache[li], row0,
                      None if shared_kv is None else shared_kv[li])
        x = self.norm(x)
        return x if return_hidden else self.logits(x)

    def embed_inputs(self, input_ids, positions, kv_cache=None, cache_len=0,
                     shared_kv=None, kv_offset=None):
        """``forward``'s inputs to its layers: (the embedded rows, per layer
        its ``(cos, sin, mask)``, the cache write offset)."""
        cfg = self.cfg
        b, t = input_ids.shape
        x = self.embed_tokens(input_ids)
        if cfg.gemma:   # the embedding times sqrt(H), rounded to its dtype
            x = x * torch.tensor(cfg.hidden_size ** 0.5, dtype=x.dtype)
        rope = _rope_tables(positions, self.rope_inv, self.rope_scale)
        if cfg.gemma3:
            rope_local = _rope_tables(positions, self.rope_inv_local,
                                      self.rope_scale_local)
        row0 = cache_len
        if kv_cache is not None:
            s = kv_cache[0][0].shape[1]
            kv_pos = torch.arange(s, device=x.device)[None, None, :]
            vector = torch.is_tensor(cache_len) and cache_len.dim() == 1
            filled = (cache_len + t)[:, None, None] if vector \
                else cache_len + t
            if shared_kv is None and kv_offset is None:
                mask = (kv_pos <= positions[:, :, None]) & (kv_pos < filled)
            else:
                off = torch.as_tensor(0 if kv_offset is None else kv_offset,
                                      device=x.device).expand(b)
                kvp = off[:, None] + kv_pos[0]                   # [B, S]
                seg_ok = torch.ones_like(kvp, dtype=torch.bool)
                if shared_kv is not None:
                    p = shared_kv[0][0].shape[1]
                    kvp = torch.cat([torch.arange(
                        p, device=x.device).expand(b, p), kvp], dim=1)
                    seg_ok = torch.cat([(off > 0)[:, None].expand(b, p),
                                        seg_ok], dim=1)
                kv_pos = kvp[:, None, :]
                mask = ((kv_pos <= positions[:, :, None]) & (kv_pos < filled)
                        & seg_ok[:, None, :])
                if kv_offset is not None:
                    row0 = cache_len - kv_offset
        else:
            kv_pos = positions[:, None, :]
            mask = positions[:, :, None] >= kv_pos
        sliding = [cfg.layer_is_sliding(li) for li in range(len(self.layers))]
        if any(sliding):
            band = mask & (positions[:, :, None] - kv_pos < cfg.sliding_window)
        per_layer = [(*(rope_local if cfg.gemma3 and sliding[li] else rope),
                      band if sliding[li] else mask)
                     for li in range(len(self.layers))]
        return x, per_layer, row0


def load_hf_decoder_params(model_dir: str | Path
                           ) -> Tuple[Dict[str, torch.Tensor], DecoderConfig]:
    """(``DecoderModel`` state dict, config) of a local HF checkpoint
    (``config.json``, ``*.safetensors`` or ``pytorch_model.bin``), in the
    checkpoint's dtype: the q/k biases, Qwen3's and Gemma 3's q/k norms and
    Gemma 2 / 3's feed-forward norms where the checkpoint has them, and on
    each MoE layer the experts stacked as ``MoEBlock`` holds them
    (``moe_state``)."""
    model_dir = Path(model_dir)
    cfg = DecoderConfig.from_json(model_dir / "config.json")
    t = load_weights(model_dir)

    def has(name):
        return any(p + name in t for p in ("model.", ""))

    def get(name):
        for p in ("model.", ""):
            if p + name in t:
                return t[p + name]
        raise KeyError(name)

    h, hkv, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                  cfg.head_dim)
    q0 = get("layers.0.self_attn.q_proj.weight")
    k0 = get("layers.0.self_attn.k_proj.weight")
    if q0.shape[0] != h * hd or k0.shape[0] != hkv * hd:
        raise ValueError(
            f"attention weight shapes q{tuple(q0.shape)}/k{tuple(k0.shape)} "
            f"do not match heads={h}/{hkv} head_dim={hd}; checkpoint uses an "
            "architecture variant this loader does not support")
    embed = get("embed_tokens.weight")
    biased = has("layers.0.self_attn.q_proj.bias")
    optional = []
    if has("layers.0.self_attn.q_norm.weight"):
        optional += ["self_attn.q_norm", "self_attn.k_norm"]
    # JAX reads the sandwich only for a Gemma (Gemma 1 has none)
    if cfg.gemma and has("layers.0.pre_feedforward_layernorm.weight"):
        optional += ["pre_feedforward_layernorm", "post_feedforward_layernorm"]
    state = {"embed_tokens.weight": embed, "norm.weight": get("norm.weight")}
    for i in range(cfg.num_hidden_layers):
        p = f"layers.{i}"
        names = [f"{p}.input_layernorm.weight",
                 f"{p}.post_attention_layernorm.weight",
                 *(f"{p}.self_attn.{x}_proj.weight" for x in "qkvo"),
                 *(f"{p}.{x}.weight" for x in optional)]
        if cfg.layer_is_moe(i):
            state |= moe_state(cfg, p, has, get)
        else:
            names += [f"{p}.mlp.{x}_proj.weight"
                      for x in ("gate", "up", "down")]
        state.update({n: get(n) for n in names})
        if biased:
            for x in "qkv":
                w = state[f"{p}.self_attn.{x}_proj.weight"]
                try:
                    state[f"{p}.self_attn.{x}_proj.bias"] = get(
                        f"{p}.self_attn.{x}_proj.bias")
                except KeyError:
                    state[f"{p}.self_attn.{x}_proj.bias"] = torch.zeros(
                        w.shape[0], dtype=w.dtype)
    if not (cfg.tie_word_embeddings or "lm_head.weight" not in t):
        state["lm_head.weight"] = t["lm_head.weight"]
    return state, cfg


def moe_state(cfg: DecoderConfig, p: str, has, get
              ) -> Dict[str, torch.Tensor]:
    """Layer ``p``'s ``MoEBlock`` tensors from either naming (JAX's
    ``moe_layer``): Mixtral's ``block_sparse_moe.gate`` and
    ``experts.{x}.w1`` / ``w3`` / ``w2`` (gate / up / down), or
    Qwen2-MoE's ``mlp.gate``, ``mlp.experts.{x}.{gate,up,down}_proj``,
    ``mlp.shared_expert.*`` and ``mlp.shared_expert_gate``; the experts
    stacked on a leading axis in JAX's [in, out] layout, in the
    checkpoint's dtype."""
    if has(f"{p}.block_sparse_moe.gate.weight"):
        pre, names = f"{p}.block_sparse_moe", ("w1", "w3", "w2")
    else:
        pre, names = f"{p}.mlp", ("gate_proj", "up_proj", "down_proj")
    out = {f"{p}.mlp.router": get(f"{pre}.gate.weight")}
    for key, name in zip(("gate", "up", "down"), names):
        out[f"{p}.mlp.{key}"] = torch.stack(
            [get(f"{pre}.experts.{x}.{name}.weight").t()
             for x in range(cfg.num_experts)])
    if has(f"{pre}.shared_expert.gate_proj.weight"):
        out[f"{p}.mlp.shared_expert_gate.weight"] = get(
            f"{pre}.shared_expert_gate.weight")
        for x in ("gate", "up", "down"):
            out[f"{p}.mlp.shared_expert.{x}_proj.weight"] = get(
                f"{pre}.shared_expert.{x}_proj.weight")
    return out


def load_decoder_model(state: Dict[str, torch.Tensor], cfg: DecoderConfig,
                       device: torch.device, bits: int = 0) -> DecoderModel:
    """``DecoderModel`` of a loaded checkpoint (``load_hf_decoder_params``),
    its weights quantized on ``device`` to ``bits`` (8 or 4; 0 keeps
    them)."""
    if bits:
        state = quantize_weights({k: v.to(device) for k, v in state.items()},
                                 bits=bits)
    return DecoderModel.from_state_dict(cfg, state)


# ---------------------------------------------------------------------------
# generation

class PrefixKVCache:
    """LRU of recent prompts' KV rows, for exact prefix reuse.

    ``match`` returns (rows, l, sb): reuse the first ``l`` cached rows and
    prefill a suffix padded to bucket ``sb`` (shrinking ``l`` when the
    padded suffix would not fit the cache). ``store`` inserts a prompt's
    rows at the front and evicts past ``size``.
    """

    def __init__(self, size: int, min_len: int = 16):
        self.size = size
        self.min_len = min_len
        self.entries: List = []    # [(prompt_ids, rows, t)]
        self.stats = {"hits": 0, "misses": 0, "saved_tokens": 0}

    def match(self, prompt_ids: List[int], max_len: int):
        t = len(prompt_ids)
        best, best_l = None, 0
        for entry in self.entries:
            l = 0
            for a, b in zip(prompt_ids, entry[0]):
                if a != b:
                    break
                l += 1
            l = min(l, t - 1)  # at least one suffix token must run
            if l > best_l:
                best, best_l = entry, l
        if best is None or best_l < self.min_len:
            self.stats["misses"] += 1
            return None
        sb = pad_bucket(t - best_l, hi=max_len)
        if best_l + sb > max_len:
            best_l = max_len - sb  # shrink so the padded suffix fits
        if best_l < self.min_len:
            self.stats["misses"] += 1
            return None
        self.stats["hits"] += 1
        self.stats["saved_tokens"] += best_l
        return best[1], best_l, sb

    def store(self, prompt_ids: List[int], rows, t: int) -> None:
        """Insert at the LRU front. An entry whose prompt extends this one
        already holds its rows (KV rows depend only on the tokens before
        them): it moves to the front instead; entries this prompt extends
        are dropped."""
        ids = list(prompt_ids)
        for i, e in enumerate(self.entries):
            if len(e[0]) >= t and e[0][:t] == ids:
                self.entries.insert(0, self.entries.pop(i))
                return
        self.entries = [e for e in self.entries
                        if ids[:len(e[0])] != e[0]]
        self.entries.insert(0, (ids, rows, t))
        del self.entries[self.size:]


class TorchDecoderLM:
    """Greedy or sampled generation over a preallocated KV cache (module
    docstring). ``prefix_cache > 0`` keeps the KV rows of that many recent
    prompts: a prompt sharing at least ``_PREFIX_MIN`` leading tokens with
    one prefills only its suffix (RAG prompts share the system template
    and the example)."""

    _PREFIX_MIN = 16

    def __init__(self, model: DecoderModel, tokenizer=None,
                 device: DeviceLike = None, max_len: int = 4096,
                 decode_chunk: int = 8, prefix_cache: int = 0,
                 prefill_chunk: int = 1024, kv_quant: bool = False,
                 json_constraint: Optional[JsonConstraint] = None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.cfg = model.cfg
        self.tokenizer = tokenizer
        self.max_len = max_len
        # the int8 KV cache (quantize_kv): int8 rows, float32 scales
        self.kv_quant = kv_quant
        # prompts longer than this prefill in chunks at cache offsets: a
        # single T-token prefill holds [H, T, max_len] float32 scores
        self.prefill_chunk = max(prefill_chunk, 16)
        self._prefix = (PrefixKVCache(prefix_cache, self._PREFIX_MIN)
                        if prefix_cache else None)
        # tokens decoded per host round trip (1: the per-token loop)
        self.decode_chunk = max(1, decode_chunk)
        # the schema-DFA JSON constraint (models/constrain.py): a stream
        # asking for it (generate_stream(constrain=True)) emits only
        # prefixes of a schema-valid document, EOS once it is complete
        self.json_constraint = json_constraint

    @classmethod
    def from_pretrained(cls, name_or_path: str, device: DeviceLike = None,
                        **kw) -> "TorchDecoderLM":
        """A local checkpoint (a directory, or the offline HF cache) with
        its ``tokenizer.json``. ``weight_quant`` quantizes the weights on
        the engine's device after loading (``quantize_weights``, at
        ``weight_bits`` 8 or 4; ``weight_bits`` alone changes nothing, as
        in JAX); ``kv_quant`` keeps an int8 KV cache. ``constrain_json``
        builds ``SECTIONS_SCHEMA``'s constraint from the tokenizer at the
        model's ``vocab_size``; ``draft_model`` (a checkpoint of the same
        vocabulary) loads a draft model for the speculative engine,
        quantized as the target is, and passes it as ``draft``."""
        from legalrag_tpu_torch.tokenize.bpe import BPETokenizer

        wq, wb = kw.pop("weight_quant", False), kw.pop("weight_bits", 8)
        model_dir = resolve_model_dir(name_or_path)
        state, cfg = load_hf_decoder_params(model_dir)
        tokenizer = BPETokenizer.from_dir(model_dir)
        dev = resolve_device(device)
        model = load_decoder_model(state, cfg, dev, wb if wq else 0)
        if kw.pop("constrain_json", False) and "json_constraint" not in kw:
            kw["json_constraint"] = JsonConstraint.from_tokenizer(
                SECTIONS_SCHEMA, tokenizer, vocab_size=cfg.vocab_size,
                device=dev)
        dm = kw.pop("draft_model", "")
        if dm:
            kw["draft"] = load_decoder_model(
                *load_hf_decoder_params(resolve_model_dir(dm)), dev,
                wb if wq else 0)
        log.info("loaded decoder %s (%d layers, H=%d, GQA %d/%d, %s%s%s)",
                 name_or_path, cfg.num_hidden_layers, cfg.hidden_size,
                 cfg.num_attention_heads, cfg.num_key_value_heads,
                 model.dtype, f", int{wb} weights" if wq else "",
                 ", int8 KV" if kw.get("kv_quant") else "")
        return cls(model, tokenizer, device=dev, **kw)

    # ------------------------------------------------------------ internals
    def _empty_cache(self) -> List[Tuple[torch.Tensor, ...]]:
        """Per layer zeroed (k, v) [1, max_len, Hkv, D] in the weights'
        dtype; under ``kv_quant`` (k_q, v_q, k_scale, v_scale): int8 rows
        and float32 scales [1, max_len, Hkv, 1]."""
        shape = (1, self.max_len, self.cfg.num_key_value_heads,
                 self.cfg.head_dim)

        def zeros(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=self.device)

        if self.kv_quant:
            return [(zeros(shape, torch.int8), zeros(shape, torch.int8),
                     zeros(shape[:3] + (1,), torch.float32),
                     zeros(shape[:3] + (1,), torch.float32))
                    for _ in range(self.cfg.num_hidden_layers)]
        return [(zeros(shape, self.model.dtype), zeros(shape, self.model.dtype))
                for _ in range(self.cfg.num_hidden_layers)]

    def _positions(self, start: int, n: int) -> torch.Tensor:
        return torch.arange(start, start + n, device=self.device)[None, :]

    def _forward_rows(self, ids: List[int], cache, p_len: int, true_len: int
                      ) -> torch.Tensor:
        """Forward the right-padded ``ids`` at cache offset ``p_len``;
        float32 logits [1, V] of row ``true_len - 1``. Pad rows land past
        the real ones: later rows overwrite them before a query can see
        them, and the causal mask hides them meanwhile."""
        x = torch.tensor([ids], dtype=torch.long, device=self.device)
        hidden = self.model(x, self._positions(p_len, len(ids)),
                            kv_cache=cache, cache_len=p_len,
                            return_hidden=True)
        return self.model.logits(hidden[:, true_len - 1])

    @torch.inference_mode()
    def _prefill_prompt(self, prompt_ids: List[int]):
        """Prefill a prompt → (last logits [1, V], cache), through the
        prefix cache when an exact prefix of at least ``_PREFIX_MIN``
        tokens is kept, in chunks above ``prefill_chunk``."""
        t = len(prompt_ids)
        hit = self._prefix.match(prompt_ids, self.max_len) \
            if self._prefix else None
        if hit is not None and t - hit[1] > self.prefill_chunk:
            hit = None  # long suffix: the chunked cold path instead
        cache = self._empty_cache()
        if hit is not None:
            rows, l, sb = hit
            for li, layer in enumerate(cache):
                for dst, stack in zip(layer, rows):
                    dst[:, :stack.shape[2]] = stack[li]
            sfx = list(prompt_ids[l:]) + [0] * (sb - (t - l))
            last = self._forward_rows(sfx, cache, l, t - l)
        elif t > self.prefill_chunk:
            # sequential chunks at cache offsets, each attending the
            # filled cache: the single-shot prefill's arithmetic per row
            c = self.prefill_chunk
            for off in range(0, t, c):
                piece = list(prompt_ids[off:off + c])
                n = len(piece)
                # the padded chunk must fit the cache rows [off, max_len)
                cb = c if n == c else pad_bucket(n, hi=self.max_len - off)
                last = self._forward_rows(piece + [0] * (cb - n), cache,
                                          off, n)
        else:
            bucket = pad_bucket(t, hi=self.max_len)
            last = self._forward_rows(list(prompt_ids) + [0] * (bucket - t),
                                      cache, 0, t)
        if self._prefix is not None:
            tb = pad_bucket(t, hi=self.max_len)
            # one layer-stacked [L, 1, tb, ...] tensor per cache component
            # (k, v, and under kv_quant their scales)
            rows = tuple(torch.stack([layer[c][:, :tb] for layer in cache])
                         for c in range(len(cache[0])))
            self._prefix.store(prompt_ids, rows, t)
        return last, cache

    def _stream_constraint(self, constrain: bool, eos_id: Optional[int],
                           max_new_tokens: int
                           ) -> Optional[StreamConstraint]:
        """A constrained stream's DFA state (None unconstrained), with
        JAX's warning when the budget is below the shortest document."""
        if not constrain:
            return None
        jc = self.json_constraint
        if max_new_tokens < jc.min_budget:
            log.warning("constrained stream budget %d < shortest valid "
                        "document (%d tokens); output will be a valid "
                        "prefix, not a complete document",
                        max_new_tokens, jc.min_budget)
        return StreamConstraint(jc, eos_id)

    @property
    def prefix_stats(self):
        return self._prefix.stats if self._prefix else \
            {"hits": 0, "misses": 0, "saved_tokens": 0}

    @torch.inference_mode()
    def _step(self, token: torch.Tensor, pos: int, cache) -> torch.Tensor:
        """One token [1] at position ``pos`` → float32 logits [1, V]."""
        return self.model(token.view(1, 1), self._positions(pos, 1),
                          kv_cache=cache, cache_len=pos)[:, -1]

    @torch.inference_mode()
    def _pick(self, last, rep_mask, pen, greedy, temp, top_p, top_k, min_p,
              generator, cons: Optional[StreamConstraint] = None,
              left: int = 0) -> torch.Tensor:
        """The next token [1] on the device, the seen mask and the
        constraint's state updated. ``cons`` masks the penalized logits
        before the warpers, with ``left`` tokens of budget left (this one
        included)."""
        scored = apply_repetition_penalty(last, rep_mask, pen)
        if cons is not None:
            scored = cons.mask(scored, left)
        if greedy:
            tok = torch.argmax(scored, dim=-1)
        else:
            tok = _sample_top_p(scored / temp, top_p, generator, top_k, min_p)
        if cons is not None:
            cons.advance(tok)
        rep_mask.scatter_(1, tok.view(1, 1), True)
        return tok

    @torch.inference_mode()
    def _chunk(self, last, pos, cache, n_steps, pick) -> Tuple[list, object]:
        """``n_steps`` pick + decode steps with no host read: (tokens [n]
        on the device, the last logits). ``pick(logits, position)``."""
        toks = []
        for i in range(n_steps):
            tok = pick(last, pos + i)
            last = self._step(tok, pos + i, cache)
            toks.append(tok)
        return torch.cat(toks), last

    def generate_stream(self, prompt_ids: List[int], max_new_tokens: int = 256,
                        temperature: float = 0.0, top_p: float = 0.9,
                        eos_id: Optional[int] = None, seed: int = 0,
                        repetition_penalty: float = 1.0, top_k: int = 0,
                        min_p: float = 0.0, constrain: bool = False
                        ) -> Iterator[int]:
        """Token ids, greedy (``temperature`` 0) or sampled through HF's
        warpers (temperature → top_k → top_p → min_p; ``top_k == 1`` or
        ``min_p == 1.0`` reproduce the greedy stream). Ends at ``eos_id``
        (not yielded), after ``max_new_tokens``, or at the cache's
        capacity. ``constrain`` applies the engine's JSON constraint: every
        token keeps the output a prefix of a schema-valid document, EOS
        only once it is complete, and within the budget the document ends
        complete (``budget_force``)."""
        if constrain and self.json_constraint is None:
            raise ValueError("constrain=True requires an engine built "
                             "with json_constraint / constrain_json")
        t = len(prompt_ids)
        if t >= self.max_len:
            raise ValueError(
                f"prompt ({t} tokens) does not fit the {self.max_len}-token "
                "KV cache; truncate the prompt before generation")
        # positions are absolute and the cache is not a ring: generation
        # stops at capacity
        budget = self.max_len - t
        if max_new_tokens > budget:
            log.warning("max_new_tokens %d exceeds cache budget %d "
                        "(prompt %d / max_len %d); clamping",
                        max_new_tokens, budget, t, self.max_len)
            max_new_tokens = budget
        last, cache = self._prefill_prompt(list(prompt_ids))
        generator = torch.Generator(device=self.device).manual_seed(seed)
        greedy = not temperature > 0
        temp = torch.tensor(max(temperature, 1e-6), device=self.device)
        pen = torch.tensor(repetition_penalty, device=self.device)
        rep_mask = torch.zeros((1, self.cfg.vocab_size), dtype=torch.bool,
                               device=self.device)
        rep_mask[0, torch.tensor(list(prompt_ids), dtype=torch.long,
                                 device=self.device)] = True
        cons = self._stream_constraint(constrain, eos_id, max_new_tokens)
        climit = t + max_new_tokens

        def pick(logits, p):
            return self._pick(logits, rep_mask, pen, greedy, temp, top_p,
                              top_k, min_p, generator, cons, climit - p)

        pos, produced = t, 0
        # whole chunks, one host read each; the tail token by token
        while produced + self.decode_chunk <= max_new_tokens:
            toks, last = self._chunk(last, pos, cache, self.decode_chunk,
                                     pick)
            pos += self.decode_chunk
            produced += self.decode_chunk
            for tok_host in toks.tolist():
                if eos_id is not None and tok_host == eos_id:
                    return
                yield tok_host
        for i in range(max_new_tokens - produced):
            tok = pick(last, pos + i)
            tok_host = int(tok[0])
            if eos_id is not None and tok_host == eos_id:
                return
            yield tok_host
            if produced + i + 1 < max_new_tokens:  # final logits unused
                last = self._step(tok, pos + i, cache)


# ---------------------------------------------------------------------------
# sampling warpers (each on [B, V] rows)

def apply_repetition_penalty(logits: torch.Tensor, seen_mask: torch.Tensor,
                             penalty) -> torch.Tensor:
    """HF's ``RepetitionPenaltyLogitsProcessor``: for every token seen
    (prompt and output), a positive logit is divided by the penalty, a
    negative one multiplied by it. 1.0 leaves the logits' bits."""
    pen = torch.as_tensor(penalty, dtype=logits.dtype, device=logits.device)
    penalized = torch.where(logits > 0, logits / pen, logits * pen)
    return torch.where(seen_mask, penalized, logits)


def _top_k_filter(logits: torch.Tensor, top_k: int) -> torch.Tensor:
    """HF's ``TopKLogitsWarper``: the k highest logits kept (ties at the
    k-th value too), the rest -1e30; ``top_k <= 0`` passes the row."""
    if top_k <= 0:
        return logits
    v = logits.shape[-1]
    kk = min(max(top_k, 1), v)
    thr = torch.sort(logits, dim=-1).values[..., v - kk:v - kk + 1]
    return logits.masked_fill(logits < thr, NEG_INF)


def _top_p_filter(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    """The nucleus filter: logits below the one where the sorted
    probabilities' running sum first reaches ``top_p`` go to -1e30 (an
    index past the row clamps to its last entry, as JAX's gather does)."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
    idx = (cum < top_p).sum(-1, keepdim=True).clamp_max(logits.shape[-1] - 1)
    cutoff = torch.gather(sorted_logits, -1, idx)
    return torch.where(logits >= cutoff, logits,
                       torch.full_like(logits, NEG_INF))


def _min_p_filter(logits: torch.Tensor, min_p: float) -> torch.Tensor:
    """HF's ``MinPLogitsWarper``: tokens whose probability is below
    ``min_p`` times the top one's go to -1e30; ``min_p <= 0`` passes."""
    if min_p <= 0:
        return logits
    probs = torch.softmax(logits, dim=-1)
    cutoff = min_p * probs.max(dim=-1, keepdim=True).values
    return logits.masked_fill(probs < cutoff, NEG_INF)


def _warp_filter(logits: torch.Tensor, top_p: float, top_k: int = 0,
                 min_p: float = 0.0) -> torch.Tensor:
    """HF's warper chain after the temperature: top-k → top-p → min-p."""
    return _min_p_filter(
        _top_p_filter(_top_k_filter(logits, top_k), top_p), min_p)


def _sample_top_p(logits: torch.Tensor, top_p: float,
                 generator: torch.Generator, top_k: int = 0,
                 min_p: float = 0.0) -> torch.Tensor:
    """One token per row [B] from the warped distribution, by Gumbel-max:
    the argmax of the warped logits plus -log(-log(u)), u uniform on
    [tiny, 1) from ``generator`` (an exact draw from their softmax)."""
    filtered = _warp_filter(logits, top_p, top_k, min_p)
    u = torch.rand(filtered.shape, generator=generator,
                   device=filtered.device)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return torch.argmax(filtered - torch.log(-torch.log(u)), dim=-1)
