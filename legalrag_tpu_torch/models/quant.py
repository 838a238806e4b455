"""Weight, activation and KV-cache quantization of the local decoder (port
of the quantized parts of ``legalrag_tpu/models/decoder.py``: ``_quant_*``,
``_pack_nibbles``, ``quantize_weights``, ``_qdot*``, ``quantize_kv``).

The quantizers take JAX's float steps in JAX's order: ``amax`` →
``max(amax, 1e-8) / 127`` (or ``/ 7``), divided once as XLA divides →
``round(x / scale)`` (half to even, as ``jnp.round``) → for int4 the clip
to [-8, 7]. On equal inputs the ints and scales are JAX's bit for bit.

- W8A8 (``bits`` 8): per-output-channel int8 weights; the activations are
  quantized per row on the fly; ``x_q @ w_q`` is an exact s32 sum
  (``torch._int_mm``, cuBLASLt's s8 x s8 -> s32 GEMM on the card, the rows
  zero-padded to ``INT_MM_MIN_ROWS``), rescaled by (row scale x channel
  scale). The port keeps an int8 matrix in ``nn.Linear``'s [out, in]
  orientation, the layout ``_int_mm`` reads transposed.
- Grouped int4 (``bits`` 4): symmetric groups of ``QUANT_GROUP`` along the
  contraction dim (the whole column one group where 64 does not divide
  it), kept in JAX's nibble-packed carrier ([in / 2, out] int8, row 2j in
  the low nibble): 4 bits an element resident. A product unpacks the
  carrier and keeps the group axis in its accumulator: one batched GEMM
  over the groups with bf16 operands and float32 output on the card,
  float32 on the CPU. Every such sum is an integer below
  127 * 8 * 64 = 65,024, so the float32 accumulator is exact, whatever
  the order of its additions; the groups' rescaled sums then add in
  float32: ``sum(acc * scale, groups) * x_scale``.
- The int8 KV cache: per-(position, head) int8 rows with a float32 scale
  [..., 1]; writes quantize, attention reads the dequantized rows.

Embeddings, norms, biases, the MoE router and ``shared_expert_gate`` stay
at full precision. The LM head is quantized from ``lm_head`` (the
embedding's transpose when tied, so a tied model holds the quantized head
beside its full-precision embedding) and computes float32 logits.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch import nn

from legalrag_tpu_torch.index.dense_index import round_up
from legalrag_tpu_torch.ops.topk import INT_MM_MIN_ROWS, true_div

QUANT_GROUP = 64            # int4 group along the contraction dim (JAX's)
INT8_MAX = 127.0
INT4_MAX = 7.0
# the longest run of int8 x int4 products whose integer sum a float32
# accumulator holds exactly: 127 * 8 * n < 2^24
EXACT_RUN = (1 << 24) // (127 * 8)


def _scale(amax: torch.Tensor, qmax: float) -> torch.Tensor:
    return true_div(torch.clamp(amax, min=1e-8), qmax)


def quant_acts(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic symmetric per-row int8 (``_quant_acts``): (q int8 [..., I],
    scale float32 [..., 1])."""
    xf = x.float()
    xs = _scale(xf.abs().amax(dim=-1, keepdim=True), INT8_MAX)
    return quant_rows(xf, xs), xs


def quant_rows(xf: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """float32 rows ``xf`` on the int8 grid of their row scales ``xs``:
    ``round(xf / xs)``, ``quant_acts``' step after its scale."""
    return torch.round(xf / xs).to(torch.int8)


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(position, head) int8 k/v rows (``quantize_kv``): ``x`` [..., D]
    -> (q int8 [..., D], scale float32 [..., 1]), ``quant_acts``' steps."""
    return quant_acts(x)


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    """``(q * scale)`` in float32, cast to the compute dtype."""
    return (q.float() * scale).to(dtype)


def quant_channel(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel int8 of ``w`` [I, O] (``_quant_channel``): (q
    int8 [I, O], scale [O])."""
    wf = w.float()
    scale = _scale(wf.abs().amax(dim=0), INT8_MAX)
    return torch.round(wf / scale).to(torch.int8), scale


def quant_stack(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(expert, output-channel) int8 of ``w`` [E, I, O]
    (``_quant_stack``): (q int8 [E, I, O], scale [E, O])."""
    wf = w.float()
    scale = _scale(wf.abs().amax(dim=1), INT8_MAX)
    return torch.round(wf / scale[:, None, :]).to(torch.int8), scale


def pack_nibbles(q: torch.Tensor) -> torch.Tensor:
    """Values in [-8, 7], [..., I, O] -> int8 [..., I / 2, O]: row 2j in the
    low nibble, row 2j + 1 in the high (``_pack_nibbles``); an odd I
    raises ``ValueError``."""
    i = q.shape[-2]
    if i % 2:
        raise ValueError(f"int4 packing needs an even contraction dim, "
                         f"got {i}")
    q = q.to(torch.int32)
    p = (q[..., 0::2, :] & 0xF) | ((q[..., 1::2, :] & 0xF) << 4)
    return torch.where(p > 127, p - 256, p).to(torch.int8)


def unpack_nibbles(p: torch.Tensor) -> torch.Tensor:
    """The inverse of ``pack_nibbles``: int8 [..., I / 2, O] -> int8 values
    [..., I, O] (arithmetic shifts sign-extend each nibble)."""
    lo = torch.bitwise_right_shift(torch.bitwise_left_shift(p, 4), 4)
    hi = torch.bitwise_right_shift(p, 4)
    return torch.stack([lo, hi], dim=-2).reshape(
        *p.shape[:-2], p.shape[-2] * 2, p.shape[-1])


def group_size(i: int, group: int = QUANT_GROUP) -> int:
    """The int4 group along a contraction dim of ``i``: ``group``, or the
    whole column where ``group`` does not divide it."""
    return group if i % group == 0 else i


def quant_group4(w: torch.Tensor, group: int = QUANT_GROUP
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Grouped symmetric int4 of ``w`` [I, O] (``_quant_group4``): (packed
    int8 [I / 2, O], scale [I / g, O])."""
    i = w.shape[0]
    g = group_size(i, group)
    wf = w.float().reshape(i // g, g, *w.shape[1:])
    scale = _scale(wf.abs().amax(dim=1), INT4_MAX)
    q = torch.clamp(torch.round(wf / scale[:, None]), -8, 7)
    return pack_nibbles(q.reshape(w.shape)), scale


def quant_stack4(w: torch.Tensor, group: int = QUANT_GROUP
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Grouped symmetric int4 of stacked experts ``w`` [E, I, O]
    (``_quant_stack4``): (packed int8 [E, I / 2, O], scale [E, I / g,
    O])."""
    e, i = w.shape[0], w.shape[1]
    g = group_size(i, group)
    wf = w.float().reshape(e, i // g, g, *w.shape[2:])
    scale = _scale(wf.abs().amax(dim=2), INT4_MAX)
    q = torch.clamp(torch.round(wf / scale[:, :, None]), -8, 7)
    return pack_nibbles(q.reshape(w.shape)), scale


# ---------------------------------------------------------------------------
# exact integer products

def int_mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """int8 ``a`` [M, K] x int8 ``w`` [O, K] (transposed) -> the exact int32
    sums [M, O]; with a leading axis on both ([E, M, K], [E, O, K]) one
    product per entry -> [E, M, O]. ``torch._int_mm``; on the card the rows
    are zero-padded to ``INT_MM_MIN_ROWS`` or the next multiple of 8 (the
    widths must be multiples of 8 there, or it raises)."""
    m = a.shape[-2]
    rows = max(INT_MM_MIN_ROWS, round_up(m, 8)) if a.is_cuda else m
    if rows != m or not a.is_contiguous():
        ap = a.new_zeros((*a.shape[:-2], rows, a.shape[-1]))
        ap[..., :m, :] = a
        a = ap
    if a.dim() == 2:
        return torch._int_mm(a, w.t())[:m]
    out = torch.empty((a.shape[0], rows, w.shape[-2]), dtype=torch.int32,
                      device=a.device)
    for e in range(a.shape[0]):
        torch._int_mm(a[e], w[e].t(), out=out[e])
    return out[:, :m]


def int4_operand(packed: torch.Tensor, g: int) -> torch.Tensor:
    """The carrier [..., I / 2, O] unpacked into group-product operands
    [(...) * I / g, g, O] in a float type that holds them exactly (bf16 on
    the card, float32 on the CPU)."""
    w = unpack_nibbles(packed)
    return w.reshape(-1, g, w.shape[-1]).to(
        torch.bfloat16 if w.is_cuda else torch.float32)


def group_int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 ``a`` [N, M, g] x the operands ``b`` [N, g, O]
    (``int4_operand``) -> the exact integer sums [N, M, O], held in
    float32 (JAX's s32 accumulator cast to float32, without the round
    trip): one batched product with float32 output per run of at most
    ``EXACT_RUN`` of the g products, each sum an integer the float32
    accumulator holds exactly; longer runs add in int32."""
    af = a.to(b.dtype)
    parts = []
    for k in range(0, a.shape[-1], EXACT_RUN):
        ak, bk = af[..., k:k + EXACT_RUN].contiguous(), b[:, k:k + EXACT_RUN]
        parts.append(torch.bmm(ak, bk, out_dtype=torch.float32) if ak.is_cuda
                     else torch.bmm(ak, bk))
    if len(parts) == 1:
        return parts[0]
    return sum(p.to(torch.int32) for p in parts).float()


def qdot8(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor,
          out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``x`` [..., I] @ int8 ``w_q`` [O, I] with per-row activation
    quantization (``_qdot2``): ``acc * x_scale * scale`` in float32, cast to
    ``out_dtype`` (``x``'s dtype by default)."""
    xq, xs = quant_acts(x)
    acc = int_mm(xq.reshape(-1, x.shape[-1]), w_q).view(
        *x.shape[:-1], w_q.shape[0])
    return (acc.float() * xs * scale).to(out_dtype or x.dtype)


def qdot4(x: torch.Tensor, operand: torch.Tensor, scale: torch.Tensor,
          out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``x`` [..., I] @ a grouped int4 matrix (its ``int4_operand`` [G, g,
    O], scales [G, O]) (``_qdot4``): the accumulator [G, M, O] (exact
    integers, ``group_int_mm``) keeps the group axis; ``sum(acc * scale,
    groups) * x_scale`` in float32."""
    n_g, g, o = operand.shape
    xq, xs = quant_acts(x)
    a = xq.reshape(-1, n_g, g).transpose(0, 1)
    acc = group_int_mm(a, operand)
    y = acc.mul_(scale[:, None, :]).sum(0).view(*x.shape[:-1], o)
    return (y * xs).to(out_dtype or x.dtype)


# ---------------------------------------------------------------------------
# modules and state

class Int4Operands:
    """A module holding int4 carriers unpacks them at each product; after
    ``hold_unpacked`` it keeps each operand once made (an int8 value as a
    float32 on the CPU, twice int4's bytes on the card as bf16): for a CPU
    reference that decodes many steps. The arithmetic is the same."""

    _held: Optional[Dict[str, torch.Tensor]] = None

    def int4_operand(self, name: str, g: int) -> torch.Tensor:
        if self._held is not None and name in self._held:
            return self._held[name]
        op = int4_operand(getattr(self, name), g)
        if self._held is not None:
            self._held[name] = op
        return op


def hold_unpacked(model: nn.Module) -> None:
    """Every int4 module of ``model`` keeps its unpacked operands
    (``Int4Operands``)."""
    for m in model.modules():
        if isinstance(m, Int4Operands):
            m._held = {}


class QLinear(Int4Operands, nn.Module):
    """``nn.Linear``'s place under ``quantize_weights`` (JAX's quantized
    ``_proj`` node): ``bits`` 8 holds ``weight_q`` [out, in] int8 and
    ``weight_scale`` [out]; ``bits`` 4 ``weight_q4p`` [in / 2, out] (JAX's
    carrier) and ``weight_scale`` [in / g, out]. The bias is added after
    the product is cast to the activations' dtype, as JAX adds it. A row
    shard of a layer (``rows_partial``, ``parallel/decoder_tp.py``) also
    sets ``row0`` and ``scale_group0``; the unsharded layer is its own
    one shard."""

    row0 = 0
    scale_group0 = 0

    def __init__(self, in_features: int, out_features: int, bias: bool,
                 bits: int, group: int = QUANT_GROUP):
        super().__init__()
        self.in_features, self.out_features, self.bits = (
            in_features, out_features, bits)
        if bits == 8:
            self.register_buffer("weight_q", torch.empty(
                out_features, in_features, dtype=torch.int8))
            self.register_buffer("weight_scale", torch.empty(out_features))
        elif bits == 4:
            self.group = group_size(in_features, group)
            self.register_buffer("weight_q4p", torch.empty(
                in_features // 2, out_features, dtype=torch.int8))
            self.register_buffer("weight_scale", torch.empty(
                in_features // self.group, out_features))
        else:
            raise ValueError(f"weight_bits must be 8 or 4, got {bits}")
        self.bias = nn.Parameter(torch.empty(out_features)) if bias else None

    def forward(self, x: torch.Tensor,
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        if self.bits == 8:
            y = qdot8(x, self.weight_q, self.weight_scale, out_dtype)
        else:
            y = qdot4(x, self.int4_operand("weight_q4p", self.group),
                      self.weight_scale, out_dtype)
        return y if self.bias is None else y + self.bias

    def rows_partial(self, xq: torch.Tensor) -> torch.Tensor:
        """A row shard's part of the product, before the shards' sum and
        the row scale: int8 rows ``xq`` [M, w] (this shard's input rows
        ``row0`` .. ``row0 + w - 1`` of the unsharded layer, quantized at
        the whole row's scale) -> int8: the exact int32 sums [M, O];
        int4: ``sum(acc * scale)`` in float32 over the unsharded layer's
        groups (``group``) that the shard's rows reach, a group cut by the
        shard's edges taking only its rows (zero-padded to whole groups:
        one batched product). ``scale_group0`` is the group of the shard's
        first scale row: ``row0 // group`` where the scales split with the
        rows, 0 where each shard holds them all."""
        if self.bits == 8:
            return int_mm(xq, self.weight_q)
        g, r0, w = self.group, self.row0, xq.shape[-1]
        j0, j1 = r0 // g, -(-(r0 + w) // g)
        lo, hi = r0 - j0 * g, j1 * g - r0 - w
        op = int4_operand(self.weight_q4p, w)[0]                   # [w, O]
        if lo or hi:
            xq = nn.functional.pad(xq, (lo, hi))
            op = nn.functional.pad(op, (0, 0, lo, hi))
        n = j1 - j0
        acc = group_int_mm(xq.view(-1, n, g).transpose(0, 1),
                           op.view(n, g, -1))
        k = j0 - self.scale_group0
        return acc.mul_(self.weight_scale[k:k + n, None]).sum(0)


def row_parallel_qdot(xs: List[torch.Tensor], layers: List[QLinear],
                      reduce_sum: Callable, reduce_max: Callable,
                      out_dtype: torch.dtype) -> torch.Tensor:
    """A row-parallel quantized product (o, down under tensor parallelism):
    shard i holds ``layers[i]`` (``QLinear.rows_partial``'s row shard) and
    ``xs[i]``, its slice [..., w] of the activations. Each row is quantized
    at the scale of the whole row, as XLA keeps ``_quant_acts``' max global
    under GSPMD: the max of the shards' maxima (``reduce_max``); a shard
    scaling its own slice would give other integers. The shards' parts are
    summed (``reduce_sum``), then rescaled once: int8 sums the exact int32
    accumulators (``qdot8`` bit for bit), int4 the float32 group sums
    (``qdot4``'s up to their order); times the row scale (and the replicated
    channel scale for int8), cast to ``out_dtype``."""
    xf = [x.float() for x in xs]
    xsc = _scale(reduce_max([x.abs().amax(dim=-1, keepdim=True)
                             for x in xf]), INT8_MAX)
    parts = [lin.rows_partial(quant_rows(x, xsc).reshape(-1, x.shape[-1]))
             for x, lin in zip(xf, layers)]
    y = reduce_sum(parts).view(*xs[0].shape[:-1], -1).float() * xsc
    if layers[0].bits == 8:
        y = y * layers[0].weight_scale
    return y.to(out_dtype)


def linear_leaves(weight: torch.Tensor, bits: int,
                  group: int = QUANT_GROUP) -> Dict[str, torch.Tensor]:
    """``QLinear``'s tensors for an ``nn.Linear`` weight [out, in]: JAX's
    ``qnode`` of its kernel (the weight's transpose)."""
    if bits == 8:
        q, s = quant_channel(weight.t())
        return {"weight_q": q.t().contiguous(), "weight_scale": s}
    q, s = quant_group4(weight.t(), group)
    return {"weight_q4p": q, "weight_scale": s}


def stack_leaves(name: str, w: torch.Tensor, bits: int,
                 group: int = QUANT_GROUP) -> Dict[str, torch.Tensor]:
    """A quantized MoE stack ``name`` of ``w`` [E, in, out] (JAX's layout):
    ``{name}_q`` [E, out, in] int8 and ``{name}_scale`` [E, out], or
    ``{name}_q4p`` [E, in / 2, out] and ``{name}_scale`` [E, in / g, out]
    (``qmoe``)."""
    if bits == 8:
        q, s = quant_stack(w)
        return {f"{name}_q": q.transpose(1, 2).contiguous(),
                f"{name}_scale": s}
    q, s = quant_stack4(w, group)
    return {f"{name}_q4p": q, f"{name}_scale": s}


_PROJECTIONS = tuple(f"self_attn.{x}_proj.weight" for x in "qkvo") + tuple(
    f"{x}_proj.weight" for x in ("gate", "up", "down"))


def quantize_weights(state: Dict[str, torch.Tensor], bits: int = 8,
                     group: int = QUANT_GROUP) -> Dict[str, torch.Tensor]:
    """``DecoderModel``'s state with JAX's ``quantize_weights(bits,
    group)`` applied: q/k/v/o and every MLP's gate/up/down (the dense
    layers' and Qwen2-MoE's shared expert's) become ``QLinear`` leaves, a
    MoE layer's ``gate`` / ``up`` / ``down`` stacks quantize per (expert,
    channel) or per (expert, group, channel), and the head (the embedding
    when tied) becomes ``lm_head.weight_q`` / ``_q4p`` with its scale.
    Computed on the tensors' device; the other tensors are kept. ``bits``
    other than 8 or 4 raise ``ValueError``."""
    if bits not in (8, 4):
        raise ValueError(f"weight_bits must be 8 or 4, got {bits}")
    out = {}
    for k, v in state.items():
        if k.endswith(_PROJECTIONS):
            pre = k[:-len("weight")]
            out |= {pre + n: t for n, t in
                    linear_leaves(v, bits, group).items()}
        elif k.endswith((".mlp.gate", ".mlp.up", ".mlp.down")):
            out |= stack_leaves(k, v, bits, group)
        elif k != "lm_head.weight":
            out[k] = v
    head = state.get("lm_head.weight", state["embed_tokens.weight"])
    out |= {f"lm_head.{n}": t for n, t in
            linear_leaves(head, bits, group).items()}
    return out


def state_bits(state: Dict[str, torch.Tensor]) -> int:
    """The weight bits of a ``DecoderModel`` state: 4, 8, or 0 when it is
    not quantized."""
    if any(k.endswith("_q4p") for k in state):
        return 4
    return 8 if any(k.endswith("_q") for k in state) else 0
