"""Tensor-parallel decoder serving (port of
``legalrag_tpu/parallel/decoder_tp.py``).

JAX's TP is placement alone: ``shard_decoder_params`` puts every leaf on a
``NamedSharding`` and XLA's SPMD partitioner inserts the collectives, so
its engines run sharded params unchanged. PyTorch has no partitioner; the
port writes the Megatron split out by hand, where JAX's ``_spec_for``
places it (``split_dim``):

- q/k/v are column-parallel by whole heads (each shard its heads, their
  biases, and Qwen3 / Gemma 3's per-head q/k norms, the attention softcap
  and the sliding band applied on the shard); k/v replicate when the kv
  heads do not divide, q/k/v/o when the heads do not;
- o is row-parallel, then one sum over the shards (``all_reduce_sum``);
- gate/up are column-parallel and down row-parallel, then a second sum;
  they replicate when ``intermediate_size`` does not divide;
- a MoE layer's expert stacks split on the expert axis (EP): each shard
  weights its experts' outputs by their combine columns, the partials are
  summed; the router and Qwen2-MoE's shared expert replicate;
- the LM head is vocab-parallel (a tied head: vocab slices of the
  embedding), softcapped per shard, its logits gathered
  (``all_gather_vocab``); it replicates when the vocabulary does not
  divide;
- the embedding, norms and o/down's int8 channel scales replicate, and a
  leaf whose shape cannot take the split (an int4 scale with fewer groups
  than shards) replicates.

Replicated work (the embedding, norms, residual adds, the router, the
shared expert, a replicated attention or MLP, the masks and RoPE tables)
runs once on the lead cell. The Gemma 2 / 3 sandwich norms read the
reduced attention and MLP outputs; sampling reads the gathered logits.
Partial products are float32 (a quantized shard's: ``row_parallel_qdot``,
the whole row's activation scale) and summed in shard order, then cast to
the activations' dtype: XLA's psum sums in another order (ROADMAP C).

The grid's cells must all name one device, as on a one-card machine: each
shard's work runs on it at shard shapes, and the KV caches stay whole
tensors whose kv-head slices (dim 2) are the shards' views
(``KVSharding``), so the engines' cache code (slot views, admission
copies, the paged gather and scatter) acts on them unchanged. A grid of
distinct devices would hold each layer's cache as per-cell slices; that
is not built (``TPDecoderModel`` refuses such a grid).
"""

from __future__ import annotations

import copy
from functools import partial
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from legalrag_tpu_torch.models.decoder import (
    DecoderConfig,
    DecoderModel,
    MoEBlock,
    _mm_f32,
)
from legalrag_tpu_torch.models.quant import (
    QLinear,
    row_parallel_qdot,
    state_bits,
)
from legalrag_tpu_torch.parallel.mesh import MODEL_AXIS, Mesh
from legalrag_tpu_torch.utils import get_logger

log = get_logger("torch.parallel.decoder_tp")

# column-parallel projections (output dim split) and row-parallel ones
# (input dim split), by the count that must divide: the heads, the kv
# heads, the MLP width or the vocabulary
_COLUMN = {"self_attn.q_proj": "heads", "self_attn.k_proj": "kv_heads",
           "self_attn.v_proj": "kv_heads", "mlp.gate_proj": "ff",
           "mlp.up_proj": "ff", "lm_head": "vocab"}
_ROW = {"self_attn.o_proj": "heads", "mlp.down_proj": "ff"}
_STACKS = tuple(f".mlp.{n}{sfx}" for n in ("gate", "up", "down")
                for sfx in ("", "_q", "_q4p", "_scale"))


def _divides(cfg: DecoderConfig, tp: int) -> Dict[str, bool]:
    return {"heads": cfg.num_attention_heads % tp == 0,
            "kv_heads": cfg.num_key_value_heads % tp == 0,
            "ff": cfg.intermediate_size % tp == 0,
            "experts": cfg.num_experts % tp == 0,
            "vocab": cfg.vocab_size % tp == 0}


def split_dim(name: str, shape: Sequence[int], cfg: DecoderConfig,
              tp: int) -> Optional[int]:
    """The dim of ``DecoderModel`` state leaf ``name`` that ``tp`` shards
    split, or None (replicated): JAX's ``_spec_for`` over the port's names
    and layouts. A float or int8 weight is torch's [out, in], so JAX's
    column split (``P(None, MODEL)`` of a kernel [in, out]) is its dim 0
    and the row split its dim 1; the int4 carrier [in / 2, out] and its
    scales [in / g, out] keep JAX's layout; a MoE stack's dim 0 is the
    expert axis in every layout. A split that the leaf's shape cannot take
    replicates. Qwen2-MoE's shared expert replicates whole, where JAX's
    rule for [E, O] stack scales also splits its int4 scales' group axis
    (ROADMAP C)."""
    ok = _divides(cfg, tp)
    node, _, leaf = name.rpartition(".")
    dim = None
    col = next((k for k in _COLUMN if node == k or node.endswith("." + k)),
               None)
    row = next((k for k in _ROW if node.endswith("." + k)), None)
    if col is not None and ok[_COLUMN[col]]:
        dim = {"weight": 0, "weight_q": 0, "bias": 0, "weight_q4p": 1,
               "weight_scale": len(shape) - 1}[leaf]
    elif row is not None and ok[_ROW[row]]:
        dim = {"weight": 1, "weight_q": 1, "weight_q4p": 0,
               "weight_scale": 0 if len(shape) == 2 else None}[leaf]
    elif name.endswith(_STACKS) and ok["experts"]:
        dim = 0
    if dim is not None and shape[dim] % tp:
        return None
    return dim


def _tied(state: Dict[str, torch.Tensor]) -> bool:
    return not any(k.startswith("lm_head.") for k in state)


def tp_leaves(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The leaves the table places: ``state``'s, and a tied model's head
    as ``lm_head.weight`` (the embedding), a leaf of its own as in JAX's
    tree."""
    if _tied(state):
        return {**state, "lm_head.weight": state["embed_tokens.weight"]}
    return dict(state)


def shard_decoder_params(state: Dict[str, torch.Tensor], cfg: DecoderConfig,
                         mesh: Mesh) -> List[Dict[str, torch.Tensor]]:
    """Every shard's leaves of a ``DecoderModel`` state over ``mesh``'s
    model axis (``tp_leaves``): a split leaf's slice (contiguous: a view
    where dim 0 splits, else a copy), a replicated leaf as it is. A tied
    head whose vocabulary stays whole is left to the embedding."""
    tp = mesh.shape[MODEL_AXIS]
    leaves = tp_leaves(state)
    shards: List[Dict[str, torch.Tensor]] = [{} for _ in range(tp)]
    for name, t in leaves.items():
        dim = split_dim(name, t.shape, cfg, tp)
        if dim is None and name == "lm_head.weight" and _tied(state):
            continue
        step = 0 if dim is None else t.shape[dim] // tp
        for i, out in enumerate(shards):
            out[name] = t if dim is None else t.narrow(
                dim, i * step, step).contiguous()
    log.info("decoder params split over %d-way %s axis", tp, MODEL_AXIS)
    return shards


def all_reduce_sum(parts: Sequence[torch.Tensor], mesh: Mesh
                   ) -> torch.Tensor:
    """JAX's psum over the model axis: the shards' partials summed on the
    lead device in shard order. Every cell reads the sum; on a grid naming
    one device that is the tensor itself."""
    out = parts[0].to(mesh.lead)
    for p in parts[1:]:
        out = out + p.to(mesh.lead)
    return out


def all_reduce_max(parts: Sequence[torch.Tensor], mesh: Mesh
                   ) -> torch.Tensor:
    """The elementwise max of the shards' tensors, on the lead device."""
    out = parts[0].to(mesh.lead)
    for p in parts[1:]:
        out = torch.maximum(out, p.to(mesh.lead))
    return out


def all_gather_vocab(parts: Sequence[torch.Tensor], mesh: Mesh
                     ) -> torch.Tensor:
    """The vocab shards' logits [..., V / tp] concatenated on the lead
    device into [..., V]."""
    return torch.cat([p.to(mesh.lead) for p in parts], dim=-1)


class KVSharding:
    """A KV cache split on its kv-head axis over the model axis: every
    tensor of a layer (dense ``(k, v)``, the int8 cache's ``(k_q, v_q,
    k_scale, v_scale)``, a paged pool or its gathered view, a pinned
    segment: each ``[*, *, Hkv, *]``) gives shard i heads ``i * Hkv / tp``
    on, as a view of the whole tensor, so a shard's writes land in it."""

    def __init__(self, mesh: Mesh, kv_heads: int):
        self.heads = kv_heads // mesh.shape[MODEL_AXIS]

    def cell(self, layer: Optional[Tuple[torch.Tensor, ...]], i: int
             ) -> Optional[Tuple[torch.Tensor, ...]]:
        if layer is None:
            return None
        return tuple(a.narrow(2, i * self.heads, self.heads) for a in layer)


def tp_kv_cache_sharding(cfg: DecoderConfig, mesh: Mesh
                         ) -> Optional[KVSharding]:
    """The KV cache's split over the kv-head axis when the kv heads divide
    over the model axis, else None (replicated)."""
    if cfg.num_key_value_heads % mesh.shape[MODEL_AXIS] == 0:
        return KVSharding(mesh, cfg.num_key_value_heads)
    return None


def _shard_model(cfg: DecoderConfig, state: Dict[str, torch.Tensor],
                 tp: int, bits: int) -> DecoderModel:
    """A ``DecoderModel`` at one shard's widths holding ``state``'s tensors
    as they are (no copy); a row shard's int4 layers keep the unsharded
    layer's group."""
    ok = _divides(cfg, tp)
    c = copy.copy(cfg)
    for key, attr in (("heads", "num_attention_heads"),
                      ("kv_heads", "num_key_value_heads"),
                      ("ff", "intermediate_size"), ("experts", "num_experts"),
                      ("vocab", "vocab_size")):
        if ok[key]:
            setattr(c, attr, getattr(cfg, attr) // tp)
    c.tie_word_embeddings = "lm_head.weight" not in state
    with torch.device("meta"):
        model = DecoderModel(
            c, bias="layers.0.self_attn.q_proj.bias" in state,
            qk_norm="layers.0.self_attn.q_norm.weight" in state,
            sandwich="layers.0.pre_feedforward_layernorm.weight" in state,
            bits=bits)
    want = set(model.state_dict())
    if want != set(state):
        raise ValueError(f"shard state does not match the model: "
                         f"{sorted(want ^ set(state))[:4]}")
    for name, t in state.items():
        mod_name, _, leaf = name.rpartition(".")
        mod = model.get_submodule(mod_name)
        if leaf in mod._parameters:
            mod._parameters[leaf] = nn.Parameter(t, requires_grad=False)
        else:
            mod._buffers[leaf] = t
    model._set_rope(state["embed_tokens.weight"].device)
    return model.eval()


class TPDecoderModel(nn.Module):
    """``model`` split over ``mesh``'s model axis (module docstring), with
    ``DecoderModel``'s call surface (``forward``, ``logits``, ``dtype``,
    ``head``, ``cfg``), so every engine runs it unchanged. ``shards[i]``
    holds shard i's leaves (``shard_decoder_params``) at its widths; shard
    0 is the lead, whose replicated leaves do the replicated work."""

    def __init__(self, model: DecoderModel, mesh: Mesh):
        super().__init__()
        devs = {torch.device(d) for d in mesh.devices.flat}
        dev = model.embed_tokens.weight.device
        if devs != {dev}:
            raise ValueError(
                f"tensor parallelism here needs a grid whose cells all name "
                f"the model's device {dev}, got {sorted(map(str, devs))}")
        self.cfg, self.mesh = model.cfg, mesh
        self.tp = tp = mesh.shape[MODEL_AXIS]
        state = model.state_dict()
        self.shards = nn.ModuleList(
            _shard_model(self.cfg, s, tp, state_bits(state))
            for s in shard_decoder_params(state, self.cfg, mesh))
        self.split = _divides(self.cfg, tp)
        self.kv = tp_kv_cache_sharding(self.cfg, mesh)
        self._set_row_offsets(model)
        h, hkv = self.cfg.num_attention_heads, self.cfg.num_key_value_heads
        # the kv heads each shard's query heads read, where q splits and
        # k/v replicate: a slice of whole groups, else one per query head
        self._kv_of = []
        if self.split["heads"] and self.kv is None:
            hq, rep = h // tp, h // hkv
            for i in range(tp):
                heads = [j // rep for j in range(i * hq, (i + 1) * hq)]
                first, n = heads[0], heads[-1] - heads[0] + 1
                if hq % n == 0 and heads == [first + j // (hq // n)
                                             for j in range(hq)]:
                    self._kv_of.append((first, n))
                else:
                    self._kv_of.append(torch.tensor(heads, device=dev))

    def _set_row_offsets(self, model: DecoderModel) -> None:
        """Each row shard's int4 layer: the unsharded layer's group, its
        first input row, and the group of its first scale row."""
        full = dict(model.named_modules())
        for i, shard in enumerate(self.shards):
            for name, m in shard.named_modules():
                if not (isinstance(m, QLinear) and m.bits == 4
                        and name.endswith(tuple(_ROW))):
                    continue
                whole = full[name]
                m.group = whole.group
                w = m.weight_q4p.shape[0] * 2
                if w == whole.in_features:
                    continue
                m.row0 = i * w
                if m.weight_scale.shape[0] != whole.weight_scale.shape[0]:
                    m.scale_group0 = m.row0 // m.group

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    @property
    def head(self) -> torch.Tensor:
        if not self.split["vocab"]:
            return self.shards[0].head
        return torch.cat([s.head for s in self.shards])

    def _sum(self, parts):
        return all_reduce_sum(parts, self.mesh)

    def _row_parallel(self, layers, xs, dtype) -> torch.Tensor:
        """The row-parallel product of the shards' ``layers`` on their
        input slices ``xs`` [..., w], summed, in ``dtype``."""
        if isinstance(layers[0], QLinear):
            return row_parallel_qdot(xs, layers, self._sum,
                                     partial(all_reduce_max, mesh=self.mesh),
                                     dtype)
        parts = [_mm_f32(x.reshape(-1, x.shape[-1]), lin.weight.t())
                 for x, lin in zip(xs, layers)]
        return self._sum(parts).view(*xs[0].shape[:-1], -1).to(dtype)

    def _attention(self, li, cos, sin, mask, cache, row0, shared, y):
        attns = [s.layers[li].self_attn for s in self.shards]
        if not self.split["heads"]:
            return attns[0](y, cos, sin, mask, cache, row0, shared)
        ctx = []
        if self.kv is not None:
            for i, a in enumerate(attns):
                k, v = a.keys_values(y, cos, sin, self.kv.cell(cache, i),
                                     row0, self.kv.cell(shared, i))
                ctx.append(a.context(a.queries(y, cos, sin), k, v, mask))
        else:
            k, v = attns[0].keys_values(y, cos, sin, cache, row0, shared)
            for a, sel in zip(attns, self._kv_of):
                if isinstance(sel, tuple):
                    ks, vs = k.narrow(2, *sel), v.narrow(2, *sel)
                else:
                    ks, vs = k.index_select(2, sel), v.index_select(2, sel)
                ctx.append(a.context(a.queries(y, cos, sin), ks, vs, mask))
        return self._row_parallel([a.o_proj for a in attns], ctx, y.dtype)

    def _mlp(self, li, y):
        mlps = [s.layers[li].mlp for s in self.shards]
        if isinstance(mlps[0], MoEBlock):
            if not self.split["experts"]:
                return mlps[0](y)
            x = y.reshape(-1, y.shape[-1])
            _, combine = mlps[0].route(x)
            e = combine.shape[1] // self.tp
            out = self._sum([m.partial(x, combine[:, i * e:(i + 1) * e])
                             for i, m in enumerate(mlps)]).to(x.dtype)
            return mlps[0].with_shared(x, out).view(y.shape)
        if not self.split["ff"]:
            return mlps[0](y)
        return self._row_parallel([m.down_proj for m in mlps],
                                  [m.hidden(y) for m in mlps], y.dtype)

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """Float32 logits: each vocab shard's, softcapped, gathered."""
        if not self.split["vocab"]:
            return self.shards[0].logits(hidden)
        return all_gather_vocab([s.logits(hidden) for s in self.shards],
                                self.mesh)

    def forward(self, input_ids, positions, kv_cache=None, cache_len=0,
                return_hidden: bool = False, shared_kv=None, kv_offset=None):
        """``DecoderModel.forward``'s contract over the shards; ``kv_cache``
        and ``shared_kv`` hold whole tensors (``KVSharding``)."""
        lead = self.shards[0]
        x, per_layer, row0 = lead.embed_inputs(
            input_ids, positions, kv_cache, cache_len, shared_kv, kv_offset)
        for li, layer in enumerate(lead.layers):
            cache = None if kv_cache is None else kv_cache[li]
            shared = None if shared_kv is None else shared_kv[li]
            x = layer.residual(
                x, partial(self._attention, li, *per_layer[li], cache, row0,
                           shared),
                partial(self._mlp, li))
        x = lead.norm(x)
        return x if return_hidden else self.logits(x)


def apply_tp_to_engine(engine, mesh: Mesh) -> None:
    """Tensor-parallelize a decode engine in place: its model becomes the
    ``TPDecoderModel`` over ``mesh``. The batched engine's slot cache
    (``_cache``) and the paged engine's pools (``_pools``) stay the engine's
    whole per-layer tensors on the grid's device: each shard reads and
    writes its kv-head slice of them as a view (``KVSharding``). Refused
    once any slot is active, as in JAX. A speculative engine's draft model
    stays unsharded (JAX shards only ``engine.params``)."""
    slots = getattr(engine, "_slots", None)
    if slots is not None and any(s is not None for s in slots):
        raise RuntimeError(
            "apply_tp_to_engine must run before any stream is admitted "
            f"({sum(s is not None for s in slots)} active slots)")
    engine.model = TPDecoderModel(engine.model, mesh)
