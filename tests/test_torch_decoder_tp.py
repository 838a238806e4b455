"""The port's tensor-parallel decoder (``legalrag_tpu_torch/parallel/
decoder_tp.py``) against the JAX package's (``tests/test_decoder_tp.py``) on
the CPU, float32: JAX on 2 or 4 of its 8 virtual devices, the port on grids
that name the one CPU device tp times.

- every case of ``tests/test_decoder_tp.py`` (dense TP at 4, EP, heads that
  do not divide, speculation, continuous batching, ``apply_tp_to_engine``
  on the batched engine's dense and int8 caches, the single-stream engine
  and the paged engine's pools): the port's greedy streams token-identical
  to JAX's unsharded stream and to JAX's sharded one;
- every leaf's split, or its replication, as JAX's ``shard_decoder_params``
  places it (dense, MoE, int8, int4; tp 2 / 4; heads that do not divide,
  vocab 97, too few int4 groups), each shard's tensors equal to JAX's
  shard carried across, and the one pinned divergence (Qwen2-MoE's int4
  shared-expert scales);
- the row-parallel W8A8 and W4A8 products against JAX's on a sharded
  mesh, with rows whose halves differ 10^3 in scale, so per-shard
  activation scales would fail the check;
- Gemma 2 (the sandwich norms, both softcaps) and Qwen3 (``q_norm``) TP
  streams against JAX's engine;
- each step's logits (a prefill, then single-token steps over the cache)
  within 1e-5 of the unsharded port model."""

import threading
from functools import partial

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from legalrag_tpu.models import decoder as jd
from legalrag_tpu.models.batched_decoder import BatchedDecoderLM
from legalrag_tpu.models.paged_decoder import PagedDecoderLM
from legalrag_tpu.models.spec_decode import SpecLookupDecoderLM
from legalrag_tpu.parallel import decoder_tp as jtp
from legalrag_tpu.parallel.mesh import MODEL_AXIS as JM
from legalrag_tpu.parallel.mesh import make_mesh as jax_make_mesh
from legalrag_tpu_torch.convert import decoder_params_from_jax
from legalrag_tpu_torch.models import decoder as td
from legalrag_tpu_torch.models.batched_decoder import TorchBatchedDecoderLM
from legalrag_tpu_torch.models.paged_decoder import TorchPagedDecoderLM
from legalrag_tpu_torch.models.quant import (
    quant_acts,
    quant_rows,
    quantize_weights,
)
from legalrag_tpu_torch.models.spec_decode import TorchSpecLookupDecoderLM
from legalrag_tpu_torch.parallel.decoder_tp import (
    TPDecoderModel,
    apply_tp_to_engine,
    shard_decoder_params,
    split_dim,
    tp_kv_cache_sharding,
)
from legalrag_tpu_torch.parallel.mesh import make_mesh
from test_decoder_tp import _tiny_params
from test_torch_decoder import PROMPT

CPU = torch.device("cpu")
BASE = dict(vocab_size=97, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2,
            intermediate_size=64, max_position_embeddings=64)
MOE = dict(BASE, vocab_size=96, num_key_value_heads=4, model_type="mixtral",
           num_local_experts=4, num_experts_per_tok=2,
           moe_intermediate_size=32)
LOGIT_ATOL = 1e-5


@pytest.fixture(scope="module")
def cpu8():
    devs = jax.devices("cpu")
    if len(devs) < 8:
        pytest.skip("needs 8 virtual CPU devices")
    return devs[:8]


def configs(**kw):
    """(JAX's config, the port's) of the same keys."""
    return jd.DecoderConfig(**kw), td.DecoderConfig(**kw)


def port_model(params, cfg):
    """The port's unsharded model of JAX's params (carried across)."""
    return td.DecoderModel.from_state_dict(
        cfg, decoder_params_from_jax(jax.tree.map(np.asarray, params)))


def cpu_mesh(tp: int):
    return make_mesh([CPU] * tp, data=1, model=tp)


def jax_mesh(cpu8, tp: int):
    return jax_make_mesh(cpu8[:tp], data=1, model=tp)


def stream(engine, prompt, n):
    return list(engine.generate_stream(list(prompt), max_new_tokens=n))


def concurrently(engine, prompts, n):
    out = {}

    def run(p):
        out[tuple(p)] = stream(engine, p, n)

    threads = [threading.Thread(target=run, args=(p,)) for p in prompts]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=180)
        assert not t.is_alive()
    return out


def shares_storage(view, whole) -> bool:
    return view.untyped_storage().data_ptr() == \
        whole.untyped_storage().data_ptr()


# ----------------------------------------------------- JAX's eight cases

def test_tp_generation_matches_single_device(cpu8):
    """TP 4: q/o/gate/up/down and the kv heads split 4 ways; vocab 97 keeps
    the head whole (the fallback)."""
    jcfg, cfg = configs(**BASE)
    params = _tiny_params(jcfg, seed=2)
    prompt = [5, 6, 7, 5, 6]
    want = stream(jd.JaxDecoderLM(params, jcfg, max_len=48), prompt, 10)
    sharded = jtp.shard_decoder_params(params, jcfg, jax_mesh(cpu8, 4))
    assert stream(jd.JaxDecoderLM(sharded, jcfg, max_len=48), prompt,
                  10) == want
    tpm = TPDecoderModel(port_model(params, cfg), cpu_mesh(4))
    lead = tpm.shards[0]
    assert lead.layers[0].self_attn.q_proj.weight.shape == (8, 32)
    assert lead.layers[0].mlp.down_proj.weight.shape == (32, 16)
    assert lead.lm_head is None and lead.head.shape == (97, 32)
    assert stream(td.TorchDecoderLM(tpm, device="cpu", max_len=48), prompt,
                  10) == want


def test_tp_moe_expert_parallel_matches(cpu8):
    """EP 2: each shard holds 2 of the 4 experts; vocab 96 splits the
    head."""
    jcfg, cfg = configs(**MOE)
    params = _tiny_params(jcfg, seed=3, moe=True)
    prompt = [9, 10, 11, 12]
    want = stream(jd.JaxDecoderLM(params, jcfg, max_len=32), prompt, 8)
    sharded = jtp.shard_decoder_params(params, jcfg, jax_mesh(cpu8, 2))
    assert stream(jd.JaxDecoderLM(sharded, jcfg, max_len=32), prompt,
                  8) == want
    tpm = TPDecoderModel(port_model(params, cfg), cpu_mesh(2))
    assert tpm.shards[0].layers[0].mlp.gate.shape == (2, 32, 32)
    assert tpm.shards[1].lm_head.weight.shape == (48, 32)
    assert stream(td.TorchDecoderLM(tpm, device="cpu", max_len=32), prompt,
                  8) == want


def test_tp_indivisible_heads_replicate(cpu8):
    """3 kv heads on 2 shards: k/v (and the cache) replicate, q splits (3
    query heads a shard, reading kv heads 0, 0, 1 and 1, 2, 2)."""
    kw = dict(BASE, hidden_size=48, num_hidden_layers=1,
              num_attention_heads=6, num_key_value_heads=3)
    jcfg, cfg = configs(**kw)
    params = _tiny_params(jcfg, seed=4)
    want = stream(jd.JaxDecoderLM(params, jcfg, max_len=32), [1, 2, 3], 6)
    jmesh = jax_mesh(cpu8, 2)
    sharded = jtp.shard_decoder_params(params, jcfg, jmesh)
    assert jtp.tp_kv_cache_sharding(jcfg, jmesh) is None
    assert stream(jd.JaxDecoderLM(sharded, jcfg, max_len=32), [1, 2, 3],
                  6) == want
    mesh = cpu_mesh(2)
    assert split_dim("layers.0.self_attn.k_proj.weight", (24, 48), cfg,
                     2) is None
    assert split_dim("layers.0.self_attn.q_proj.weight", (48, 48), cfg,
                     2) == 0
    assert tp_kv_cache_sharding(cfg, mesh) is None
    tpm = TPDecoderModel(port_model(params, cfg), mesh)
    assert stream(td.TorchDecoderLM(tpm, device="cpu", max_len=32),
                  [1, 2, 3], 6) == want


def test_tp_spec_decode_matches(cpu8):
    """Speculative decoding over the TP model (TP 4)."""
    jcfg, cfg = configs(**BASE)
    params = _tiny_params(jcfg, seed=5)
    p = [7, 8, 9, 7, 8, 9, 7]
    want = stream(jd.JaxDecoderLM(params, jcfg, max_len=48), p, 10)
    sharded = jtp.shard_decoder_params(params, jcfg, jax_mesh(cpu8, 4))
    assert stream(SpecLookupDecoderLM(sharded, jcfg, max_len=48, spec_k=4),
                  p, 10) == want
    tpm = TPDecoderModel(port_model(params, cfg), cpu_mesh(4))
    got = stream(TorchSpecLookupDecoderLM(tpm, device="cpu", max_len=48,
                                          spec_k=4), p, 10)
    assert got == want


def test_tp_batched_engine_matches(cpu8):
    """Continuous batching with per-slot speculation on the TP model (TP
    2), two streams at once."""
    jcfg, cfg = configs(**dict(BASE, vocab_size=96))
    params = _tiny_params(jcfg, seed=6)
    prompts = [[5, 6, 7, 5, 6], [9, 10, 11]]
    want = {tuple(p): stream(jd.JaxDecoderLM(params, jcfg, max_len=48), p,
                             8) for p in prompts}
    kw = dict(max_len=48, n_slots=2, decode_chunk=4, spec_k=4, spec_steps=2)
    sharded = jtp.shard_decoder_params(params, jcfg, jax_mesh(cpu8, 2))
    jeng = BatchedDecoderLM(sharded, jcfg, **kw)
    try:
        assert concurrently(jeng, prompts, 8) == want
    finally:
        jeng.close()
    tpm = TPDecoderModel(port_model(params, cfg), cpu_mesh(2))
    engine = TorchBatchedDecoderLM(tpm, device="cpu", **kw)
    try:
        assert concurrently(engine, prompts, 8) == want
    finally:
        engine.close()


def test_apply_tp_to_engine_places_batched_cache(cpu8):
    """``apply_tp_to_engine`` splits the batched engine's model and its
    slot cache on the kv-head axis (each shard's cells are views of the
    engine's tensors), dense and int8 caches; streams identical to JAX's
    unsharded and TP engines."""
    jcfg, cfg = configs(**BASE)
    params = _tiny_params(jcfg, seed=2)
    prompt = [5, 6, 7, 5, 6]
    want = stream(jd.JaxDecoderLM(params, jcfg, max_len=48), prompt, 10)
    model = port_model(params, cfg)
    kw = dict(max_len=48, n_slots=2, decode_chunk=4)
    for kv_quant in (False, True):
        jeng = BatchedDecoderLM(params, jcfg, kv_quant=kv_quant, **kw)
        try:
            jtp.apply_tp_to_engine(jeng, jax_mesh(cpu8, 2))
            assert stream(jeng, prompt, 10) == want, kv_quant
        finally:
            jeng.close()
        engine = TorchBatchedDecoderLM(model, device="cpu",
                                       kv_quant=kv_quant, **kw)
        try:
            apply_tp_to_engine(engine, cpu_mesh(2))
            assert isinstance(engine.model, TPDecoderModel)
            for i in range(2):
                cell = engine.model.kv.cell(engine._cache[0], i)
                for view, whole in zip(cell, engine._cache[0]):
                    assert view.shape[2] == 1 and shares_storage(view, whole)
            assert stream(engine, prompt, 10) == want, kv_quant
        finally:
            engine.close()


def test_apply_tp_to_engine_single_stream_noop_cache(cpu8):
    """The single-stream engine keeps no cache between streams: the model
    alone is split, and the stream stays exact."""
    jcfg, cfg = configs(**BASE)
    params = _tiny_params(jcfg, seed=5)
    prompt = [3, 4, 5]
    want = stream(jd.JaxDecoderLM(params, jcfg, max_len=32), prompt, 6)
    jlm = jd.JaxDecoderLM(params, jcfg, max_len=32)
    jtp.apply_tp_to_engine(jlm, jax_mesh(cpu8, 2))
    assert stream(jlm, prompt, 6) == want
    lm = td.TorchDecoderLM(port_model(params, cfg), device="cpu", max_len=32)
    apply_tp_to_engine(lm, cpu_mesh(2))
    assert stream(lm, prompt, 6) == want


def test_apply_tp_to_engine_places_paged_pools(cpu8):
    """The paged engine's pools [NB + 1, BS, Hkv, *] split on the kv-head
    axis (dense and int8); a radix-reused prefix and a fresh prefill both
    identical to JAX's unsharded and TP streams."""
    jcfg, cfg = configs(**BASE)
    params = _tiny_params(jcfg, seed=3)
    rng = np.random.default_rng(23)
    shared = list(rng.integers(1, 90, 8))
    a = shared + list(rng.integers(1, 90, 4))
    b = shared + list(rng.integers(1, 90, 5))
    model = port_model(params, cfg)
    kw = dict(max_len=48, n_slots=2, decode_chunk=4, block_size=8)
    for kv_quant in (False, True):
        ref = jd.JaxDecoderLM(params, jcfg, max_len=48, kv_quant=kv_quant)
        want = [stream(ref, a, 8), stream(ref, b, 8)]
        jeng = PagedDecoderLM(params, jcfg, kv_quant=kv_quant, **kw)
        try:
            jtp.apply_tp_to_engine(jeng, jax_mesh(cpu8, 2))
            assert [stream(jeng, a, 8), stream(jeng, b, 8)] == want
        finally:
            jeng.close()
        engine = TorchPagedDecoderLM(model, device="cpu", kv_quant=kv_quant,
                                     **kw)
        try:
            apply_tp_to_engine(engine, cpu_mesh(2))
            for view, whole in zip(engine.model.kv.cell(engine._pools[0], 1),
                                   engine._pools[0]):
                assert view.shape[2] == 1 and shares_storage(view, whole)
            got_a = stream(engine, a, 8)
            reused = engine.paged_stats()["reused_blocks"]
            got_b = stream(engine, b, 8)
            assert engine.paged_stats()["reused_blocks"] > reused
        finally:
            engine.close()
        assert [got_a, got_b] == want, kv_quant


def test_tp_refuses_distinct_devices_and_active_slots():
    """A grid naming another device than the model's (here cuda:0 beside
    the CPU) is refused, as is a batched engine with a slot in use (JAX's
    ``apply_tp_to_engine`` refuses it too); the engine keeps its model."""
    jcfg, cfg = configs(**BASE)
    model = port_model(_tiny_params(jcfg, seed=2), cfg)
    with pytest.raises(ValueError, match="all name the model.s device"):
        TPDecoderModel(model, make_mesh([CPU, torch.device("cuda", 0)],
                                        data=1, model=2))
    engine = TorchBatchedDecoderLM(model, device="cpu", max_len=48, n_slots=2)
    try:
        engine._slots[1] = object()
        with pytest.raises(RuntimeError, match="1 active slots"):
            apply_tp_to_engine(engine, cpu_mesh(2))
        assert engine.model is model
    finally:
        engine._slots[1] = None
        engine.close()


# -------------------------------------------------------- the placement

def with_shared_expert(params, cfg, rng):
    """Qwen2-MoE's sigmoid-gated shared expert added to JAX's MoE params."""
    h, f = cfg.hidden_size, cfg.shared_expert_intermediate_size
    for layer in params["layers"]:
        layer["moe"]["shared_gate"] = rng.standard_normal((h, 1)) * 0.05
        layer["moe"]["shared"] = {
            "gate": rng.standard_normal((h, f)) * 0.05,
            "up": rng.standard_normal((h, f)) * 0.05,
            "down": rng.standard_normal((f, h)) * 0.05}
    return jax.tree.map(lambda a: jax.numpy.asarray(a, jax.numpy.float32),
                        params)


WIDE = dict(BASE, vocab_size=96, hidden_size=128, intermediate_size=256)
PLACEMENTS = {
    # name: (config, MoE, tp, bits)
    "dense_tp2": (BASE, False, 2, 0), "dense_tp4": (BASE, False, 4, 0),
    "dense_int8_tp2": (BASE, False, 2, 8),
    "dense_int8_tp4": (BASE, False, 4, 8),
    # int4 at hidden 32 / ff 64: one group a column, too few to split
    "dense_int4_tp2": (BASE, False, 2, 4),
    "dense_int4_tp4": (BASE, False, 4, 4),
    "vocab96_tp2": (dict(BASE, vocab_size=96), False, 2, 0),
    "heads_6_3_tp2": (dict(BASE, hidden_size=48, num_attention_heads=6,
                           num_key_value_heads=3), False, 2, 0),
    # int4 groups that split: 2 of o's at tp 2 (not at 4), 4 of down's
    "wide_int4_tp2": (WIDE, False, 2, 4), "wide_int4_tp4": (WIDE, False, 4, 4),
    "moe_tp2": (MOE, True, 2, 0), "moe_tp4": (MOE, True, 4, 0),
    "moe_int8_tp2": (MOE, True, 2, 8), "moe_int4_tp4": (MOE, True, 4, 4),
    "qwen2_moe_int4_tp2": (dict(MOE, hidden_size=128, model_type="qwen2_moe",
                                shared_expert_intermediate_size=128),
                           True, 2, 4),
}


@pytest.fixture(scope="module")
def placement_params():
    """JAX's params of a placement case (quantized at ``bits``), made once
    for both shard counts."""
    made = {}

    def get(key: str, jcfg, moe: bool, bits: int):
        if key not in made:
            params = _tiny_params(jcfg, seed=7, moe=moe)
            if jcfg.shared_expert_intermediate_size:
                params = with_shared_expert(params, jcfg,
                                            np.random.default_rng(8))
            made[key] = jax.jit(partial(jd.quantize_weights, bits=bits))(
                params) if bits else params
        return made[key]
    return get


def jax_shard_trees(sharded, devs):
    """Each device's shard of every leaf, as numpy trees in mesh order."""
    def on(dev):
        return jax.tree.map(lambda a: np.asarray(next(
            s.data for s in a.addressable_shards if s.device == dev)),
            sharded)
    return [on(d) for d in devs]


@pytest.mark.parametrize("case", sorted(PLACEMENTS))
def test_every_leaf_splits_as_jax_places_it(cpu8, placement_params, case):
    """Each shard's leaves (``shard_decoder_params``) equal JAX's shard of
    the same params on that device, carried across by
    ``decoder_params_from_jax``: the same names (a tied head whose vocab
    splits becomes each shard's ``lm_head.weight``), shapes and values.
    The only leaves apart: the Qwen2-MoE shared expert's int4 scales,
    which JAX splits on their group axis by its rule for [E, O] stack
    scales and the port replicates with the rest of the shared expert."""
    kw, moe, tp, bits = PLACEMENTS[case]
    jcfg, cfg = configs(**kw)
    params = placement_params(case.rsplit("_tp", 1)[0], jcfg, moe, bits)
    state = decoder_params_from_jax(jax.tree.map(np.asarray, params))
    mesh = jax_mesh(cpu8, tp)
    trees = jax_shard_trees(jtp.shard_decoder_params(params, jcfg, mesh),
                            cpu8[:tp])
    apart = set()
    for i, (mine, tree) in enumerate(zip(
            shard_decoder_params(state, cfg, cpu_mesh(tp)), trees)):
        theirs = decoder_params_from_jax(tree)
        assert set(mine) == set(theirs), set(mine) ^ set(theirs)
        for name, t in mine.items():
            if t.shape == theirs[name].shape:
                assert torch.equal(t, theirs[name]), (i, name)
            else:
                apart.add(name)
    want_apart = {n for n in state if ".shared_expert." in n
                  and n.endswith("weight_scale")} if bits == 4 and \
        jcfg.shared_expert_intermediate_size else set()
    assert apart == want_apart
    for name in apart:
        assert split_dim(name, state[name].shape, cfg, tp) is None


# ------------------------------------------- row-parallel quantized products

def row_inputs(i_dim: int, tp: int, rows: int = 5):
    """Activations whose shard slices differ 10^3 in scale: shard 0 large,
    the others small."""
    x = np.random.default_rng(11).standard_normal((rows, i_dim))
    w = i_dim // tp
    x[:, :w] *= 100.0
    x[:, w:] *= 0.1
    return x.astype(np.float32)


@pytest.mark.parametrize("bits,ff,tp", [
    (8, 256, 2), (8, 256, 4),
    (4, 256, 2), (4, 256, 4),      # whole groups a shard, scales split
    (4, 96, 2),                    # one group of 96 cut by both shards
    (4, 192, 2)])                  # 3 groups of 64: the middle one cut
def test_row_parallel_quantized_product_keeps_the_row_scale(cpu8, bits, ff,
                                                            tp):
    """The down projection split by rows (its input dim ``ff``): the port's
    row-parallel W8A8 / W4A8 product against JAX's ``_qdot2`` / ``_qdot4``
    under GSPMD (the activations and the kernel's rows split over tp
    virtual devices) and the unsharded port layer: int8 bit for bit, int4
    within 1e-6. The same shards scaling their own slices give other
    integers and miss both by far."""
    kw = dict(BASE, vocab_size=96, hidden_size=64, intermediate_size=ff,
              num_hidden_layers=1)
    jcfg, cfg = configs(**kw)
    params = jax.jit(partial(jd.quantize_weights, bits=bits))(
        _tiny_params(jcfg, seed=9))
    model = port_model(params, cfg)
    tpm = TPDecoderModel(model, cpu_mesh(tp))
    x = row_inputs(ff, tp)
    w = ff // tp
    xs = [torch.from_numpy(x[:, i * w:(i + 1) * w]) for i in range(tp)]
    layers = [s.layers[0].mlp.down_proj for s in tpm.shards]
    got = tpm._row_parallel(layers, xs, torch.float32).numpy()
    whole = model.layers[0].mlp.down_proj(torch.from_numpy(x)).detach()
    node = params["layers"][0]["down"]
    jmesh = jax_mesh(cpu8, tp)
    row = NamedSharding(jmesh, P(JM, None))
    jx = jax.device_put(x, NamedSharding(jmesh, P(None, JM)))
    scale = jax.device_put(node["kernel_scale"], NamedSharding(jmesh, P()))
    if bits == 8:
        fn, kernel = jd._qdot2, node["kernel_q"]
    else:
        def fn(x, packed, scale):
            return jd._qdot4(x, jd.unpack_weights4({"k_q4p": packed})["k_q"],
                             scale)
        kernel = node["kernel_q4p"]
    want = np.asarray(jax.jit(fn)(jx, jax.device_put(kernel, row), scale))
    tol = 1e-6 * np.abs(want).max()
    if bits == 8:
        assert torch.equal(torch.from_numpy(got), whole)
    np.testing.assert_allclose(got, whole.numpy(), atol=tol, rtol=0)
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)
    own = 0
    for xi, lin in zip(xs, layers):
        xq, s = quant_acts(xi)
        part = lin.rows_partial(quant_rows(xi.float(), s)).float() * s
        own = own + (part * lin.weight_scale if bits == 8 else part)
    assert np.abs(own.numpy() - want).max() > 100 * tol


# ------------------------------------------------- families, step logits

FAMILY_CASES = {
    "gemma2": dict(BASE, vocab_size=96, model_type="gemma2", head_dim=8,
                   query_pre_attn_scalar=16, sliding_window=12,
                   attn_logit_softcapping=50.0, final_logit_softcapping=30.0),
    "qwen3": dict(BASE, vocab_size=96, model_type="qwen3", head_dim=16),
}


def family_params(name: str):
    """(JAX params, JAX config, port config) of a tiny Gemma 2 (the
    sandwich norms, zero-centred norm weights, an untied head) or Qwen3
    (per-head q/k norms)."""
    jcfg, cfg = configs(**FAMILY_CASES[name])
    rng = np.random.default_rng(21)
    params = _tiny_params(jcfg, seed=21)

    def norm(n):
        base = 0.0 if jcfg.gemma else 1.0
        return jax.numpy.asarray(base + 0.2 * rng.standard_normal(n),
                                 jax.numpy.float32)

    h, d = jcfg.hidden_size, jcfg.head_dim
    params["lm_head"] = jax.numpy.asarray(
        rng.standard_normal((h, jcfg.vocab_size)) * 0.3, jax.numpy.float32)
    params["final_norm"] = norm(h)
    for layer in params["layers"]:
        layer["input_norm"], layer["post_norm"] = norm(h), norm(h)
        if name == "gemma2":
            layer["pre_ff_norm"], layer["post_ff_norm"] = norm(h), norm(h)
        else:
            layer["q_norm"], layer["k_norm"] = norm(d), norm(d)
    return params, jcfg, cfg


@pytest.mark.parametrize("name", sorted(FAMILY_CASES))
def test_family_tp_stream_matches_jax(name):
    """Gemma 2 (the sandwich norms read the reduced outputs, the logits
    softcapped per vocab shard, the attention softcap and the band per
    shard) and Qwen3 (``q_norm`` / ``k_norm`` per head on each shard) at
    TP 2: 16 greedy tokens after a 40-token prompt (past Gemma 2's window
    of 12) identical to ``JaxDecoderLM``'s and to the port's unsharded
    stream."""
    params, jcfg, cfg = family_params(name)
    want = stream(jd.JaxDecoderLM(params, jcfg, max_len=96), PROMPT, 16)
    model = port_model(params, cfg)
    assert stream(td.TorchDecoderLM(model, device="cpu", max_len=96),
                  PROMPT, 16) == want
    tpm = TPDecoderModel(model, cpu_mesh(2))
    assert stream(td.TorchDecoderLM(tpm, device="cpu", max_len=96), PROMPT,
                  16) == want


STEP_CASES = {
    # name: (config, MoE, tp, bits)
    "dense_tp2": (dict(BASE, vocab_size=96), False, 2, 0),
    "dense_tp4": (BASE, False, 4, 0),
    "heads_6_3_tp2": (dict(BASE, hidden_size=48, num_attention_heads=6,
                           num_key_value_heads=3), False, 2, 0),
    "moe_tp4": (MOE, True, 4, 0),
    "int8_tp2": (dict(BASE, vocab_size=96), False, 2, 8),
    "int4_tp2": (WIDE, False, 2, 4),
    "moe_int4_tp2": (MOE, True, 2, 4),
    "gemma2_tp2": ("gemma2", False, 2, 0),
    "qwen3_tp2": ("qwen3", False, 2, 0),
}
FEED = [3, 17, 42, 8, 8, 60]      # the tokens the steps read


def step_logits(model, cfg, prompt, kv_quant: bool):
    """The prefill's last-row logits, then each single-token step's
    (feeding ``FEED``), over a 32-row cache (int8 with ``kv_quant``)."""
    shape = (1, 32, cfg.num_key_value_heads, cfg.head_dim)
    if kv_quant:
        cache = [(torch.zeros(shape, dtype=torch.int8),
                  torch.zeros(shape, dtype=torch.int8),
                  torch.zeros(shape[:3] + (1,)), torch.zeros(shape[:3] + (1,)))
                 for _ in range(cfg.num_hidden_layers)]
    else:
        cache = [(torch.zeros(shape), torch.zeros(shape))
                 for _ in range(cfg.num_hidden_layers)]
    with torch.inference_mode():
        out = [model(torch.tensor([prompt]), torch.arange(len(prompt))[None],
                     kv_cache=cache, cache_len=0)[0, -1]]
        for i, tok in enumerate(FEED):
            p = len(prompt) + i
            out.append(model(torch.tensor([[tok]]), torch.tensor([[p]]),
                             kv_cache=cache, cache_len=p)[0, -1])
    return torch.stack(out)


@pytest.mark.parametrize("kv_quant", [False, True])
@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_step_logits_match_the_unsharded_model(case, kv_quant):
    """A 7-token prefill and 6 single-token steps over the KV cache: every
    step's float32 logits within 1e-5 of the unsharded port model's."""
    kw, moe, tp, bits = STEP_CASES[case]
    if isinstance(kw, str):
        params, _jcfg, cfg = family_params(kw)
    else:
        jcfg, cfg = configs(**kw)
        params = _tiny_params(jcfg, seed=12, moe=moe)
    state = decoder_params_from_jax(jax.tree.map(np.asarray, params))
    model = td.DecoderModel.from_state_dict(
        cfg, quantize_weights(state, bits=bits) if bits else state)
    prompt = [5, 6, 7, 5, 6, 9, 1]
    want = step_logits(model, cfg, prompt, kv_quant)
    got = step_logits(TPDecoderModel(model, cpu_mesh(tp)), cfg, prompt,
                      kv_quant)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=LOGIT_ATOL,
                               rtol=0)
