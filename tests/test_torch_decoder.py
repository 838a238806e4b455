"""Port decoder engine (``legalrag_tpu_torch/models/decoder.py``) vs the
JAX package's (``legalrag_tpu/models/decoder.py``) on the CPU, float32.

Tiny random checkpoints are written by transformers' ``Qwen2ForCausalLM``
and ``LlamaForCausalLM`` (the pattern of ``tests/test_checkpoint_parity.py``)
and loaded by both packages' ``load_hf_decoder_params``; the JAX params are
also carried across with ``decoder_params_from_jax``. The weights are drawn
at a gain of ~1.5 (embeddings 0.5, norms 1 + 0.2 noise, biases 0.2 noise)
instead of HF's 0.02: at 0.02 a tiny model repeats one token and every
greedy comparison is near vacuous. Tolerances: logits 1e-4; the warpers
and the repetition penalty 1e-6; greedy streams token-identical; the
sampled draw by a chi-squared test at the 0.999 quantile."""

import json
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legalrag_tpu.models import decoder as jd
from legalrag_tpu_torch.convert import decoder_params_from_jax
from legalrag_tpu_torch.models import decoder as td

# torch's intra-op thread pool. Under pytest-xdist each worker process
# shares the host's cores with the others, and on these tiny shapes a pool
# of every core in each of 6 workers at once runs ~9x slower than one
# thread. Every worker collects every test file, so this module-level call
# sets the pool of the whole worker process, for every test it runs (the
# JAX tests' XLA keeps its own pool): the cores divided among the workers.
# A run without xdist keeps torch's default.
_XDIST_WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
if _XDIST_WORKERS > 1:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // _XDIST_WORKERS))

ATOL = 1e-4
WARP_ATOL = 1e-6
VOCAB = 96
GREEDY = 32          # greedy tokens compared with JAX's engine
MAX_LEN = 128
# the chi-squared distribution's 0.999 quantile by degrees of freedom
CHI2_999 = {1: 10.83, 2: 13.82, 3: 16.27, 4: 18.47, 5: 20.52, 6: 22.46,
            7: 24.32}


def write_ckpt(d, family="qwen2", dtype=torch.float32, seed=0,
               patch=None, drop=(), **over):
    """A tiny random checkpoint saved by transformers (safetensors), its
    ``config.json`` then updated with ``patch`` and without ``drop``."""
    import transformers as tf

    kw = dict(vocab_size=VOCAB, hidden_size=32, num_hidden_layers=2,
              num_attention_heads=4, num_key_value_heads=2,
              intermediate_size=64, max_position_embeddings=256,
              rope_theta=10000.0,
              tie_word_embeddings=family in ("qwen2", "gemma", "gemma2",
                                             "gemma3"),
              attention_dropout=0.0)
    if family.startswith("gemma"):
        kw["head_dim"] = 8
    kw.update(over)
    conf, cls = {"qwen2": ("Qwen2Config", "Qwen2ForCausalLM"),
                 "llama": ("LlamaConfig", "LlamaForCausalLM"),
                 "qwen3": ("Qwen3Config", "Qwen3ForCausalLM"),
                 "mistral": ("MistralConfig", "MistralForCausalLM"),
                 "gemma": ("GemmaConfig", "GemmaForCausalLM"),
                 "gemma2": ("Gemma2Config", "Gemma2ForCausalLM"),
                 "gemma3": ("Gemma3TextConfig", "Gemma3ForCausalLM"),
                 "mixtral": ("MixtralConfig", "MixtralForCausalLM"),
                 "qwen2_moe": ("Qwen2MoeConfig", "Qwen2MoeForCausalLM")
                 }[family]
    torch.manual_seed(seed)
    model = getattr(tf, cls)(getattr(tf, conf)(**kw)).eval()
    g = torch.Generator().manual_seed(seed)
    # Gemma's norm weights are zero-centred (applied as 1 + w)
    norm0 = 0.0 if family.startswith("gemma") else 1.0
    with torch.no_grad():
        for name, p in model.named_parameters():
            r = torch.randn(p.shape, generator=g)
            if name.endswith("norm.weight"):
                p.copy_(norm0 + 0.2 * r)
            elif name.endswith("bias"):
                p.copy_(0.2 * r)
            elif "embed_tokens" in name:
                p.copy_(0.5 * r)
            else:
                p.copy_(1.5 * r / p.shape[1] ** 0.5)
    model.to(dtype).save_pretrained(d, safe_serialization=True)
    if patch or drop:
        conf_path = d / "config.json"
        c = json.loads(conf_path.read_text())
        c.update(patch or {})
        for k in drop:
            c.pop(k, None)
        conf_path.write_text(json.dumps(c))
    return d


def load_both(d):
    """((JAX params, JAX config), port state dict, port config)."""
    jparams, jcfg = jd.load_hf_decoder_params(d)
    state, cfg = td.load_hf_decoder_params(d)
    return (jparams, jcfg), state, cfg


def jax_logits(jparams, jcfg, ids):
    pos = np.broadcast_to(np.arange(ids.shape[1])[None], ids.shape)
    out, _ = jd.decoder_forward(jparams, jcfg, jnp.asarray(ids, jnp.int32),
                                jnp.asarray(pos, jnp.int32))
    return np.asarray(out)


def port_logits(model, ids):
    pos = torch.arange(ids.shape[1])[None].expand(ids.shape[0], -1)
    with torch.no_grad():
        return model(torch.from_numpy(ids), pos).numpy()


QWEN25_CONFIG = {"sliding_window": 32768, "use_sliding_window": False,
                 "max_window_layers": 21}
FORWARD_CASES = {
    "qwen2_tied_gqa": dict(family="qwen2"),
    "llama_untied": dict(family="llama"),
    "qwen2_untied_mha": dict(family="qwen2", tie_word_embeddings=False,
                             num_key_value_heads=4),
    "llama3_rope": dict(family="llama", rope_scaling={
        "rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
        "high_freq_factor": 4.0, "original_max_position_embeddings": 16}),
    "yarn_rope": dict(family="qwen2", rope_scaling={
        "rope_type": "yarn", "factor": 4.0,
        "original_max_position_embeddings": 32}),
    "explicit_head_dim": dict(family="llama", head_dim=16),
    "qwen25_sliding_window_unused": dict(family="qwen2",
                                         patch=QWEN25_CONFIG),
    "qwen25_sliding_window_no_layer_types": dict(
        family="qwen2", patch=QWEN25_CONFIG, drop=("layer_types",)),
}
# the dense families past Qwen2 and Llama, each with its window below the
# 24 tokens so the band bites (tests/test_checkpoint_parity.py's configs)
WINDOW = 5
FAMILY_CASES = {
    "qwen3_qk_norm": dict(family="qwen3", head_dim=16),
    "gemma": dict(family="gemma"),
    "gemma2_softcaps": dict(family="gemma2", query_pre_attn_scalar=16,
                            sliding_window=WINDOW,
                            attn_logit_softcapping=50.0,
                            final_logit_softcapping=30.0),
    "gemma3_local_rope": dict(
        family="gemma3", num_hidden_layers=4, query_pre_attn_scalar=16,
        sliding_window=WINDOW, sliding_window_pattern=2, rope_theta=1e6,
        rope_local_base_freq=1e4,
        rope_scaling={"rope_type": "linear", "factor": 8.0}),
    "mistral_sliding": dict(family="mistral", head_dim=8,
                            sliding_window=WINDOW),
}
FORWARD_CASES |= FAMILY_CASES


@pytest.mark.parametrize("case", sorted(FORWARD_CASES))
def test_forward_logits_match_jax(tmp_path, case):
    """Full-sequence float32 logits of a batch of 2 x 24 ids: the port's
    own load and the JAX params carried across both within 1e-4 of JAX's
    ``decoder_forward``."""
    over = dict(FORWARD_CASES[case])
    d = write_ckpt(tmp_path, seed=len(case), **over)
    (jparams, jcfg), state, cfg = load_both(d)
    if "patch" in over:
        assert cfg.sliding_window == 32768
        assert not any(map(cfg.layer_is_sliding, range(2)))
    if over.get("sliding_window") == WINDOW:
        assert cfg.layer_types == jcfg.layer_types
        assert "sliding_attention" in cfg.layer_types
    ids = np.random.default_rng(1).integers(0, VOCAB, (2, 24))
    want = jax_logits(jparams, jcfg, ids)
    got = port_logits(td.DecoderModel.from_state_dict(cfg, state), ids)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    carried = decoder_params_from_jax(jax.tree.map(np.asarray, jparams))
    assert ("lm_head.weight" in carried) == (not jcfg.tie_word_embeddings)
    got = port_logits(td.DecoderModel.from_state_dict(
        td.DecoderConfig.from_json(d / "config.json"), carried), ids)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert np.abs(want).max() > 1.0       # the logits are not flat


@pytest.fixture(scope="module")
def qwen(tmp_path_factory):
    """The tiny Qwen2 checkpoint's ((JAX params, config), port state,
    port config)."""
    return load_both(write_ckpt(tmp_path_factory.mktemp("qwen2")))


def port_engine(qwen, **kw):
    _j, state, cfg = qwen
    model = td.DecoderModel.from_state_dict(cfg, state)
    return td.TorchDecoderLM(model, device="cpu",
                             max_len=kw.pop("max_len", MAX_LEN), **kw)


def jax_engine(qwen, **kw):
    (jparams, jcfg), _s, _c = qwen
    return jd.JaxDecoderLM(jparams, jcfg, max_len=kw.pop("max_len", MAX_LEN),
                           **kw)


PROMPT = np.random.default_rng(5).integers(0, VOCAB, 40).tolist()
# a prompt sharing PROMPT's first 24 tokens: the prefix cache's donor
DONOR = PROMPT[:24] + np.random.default_rng(6).integers(0, VOCAB, 9).tolist()


def test_kv_cache_path_matches_the_full_forward(qwen):
    """A 10-token prefill into the cache, then 6 single-token steps: each
    row's logits within 1e-4 of the full forward over the 16 tokens."""
    _j, state, cfg = qwen
    model = td.DecoderModel.from_state_dict(cfg, state)
    ids = np.asarray(PROMPT[:16])[None]
    full = port_logits(model, ids)[0]
    cache = [tuple(torch.zeros(1, 32, cfg.num_key_value_heads, cfg.head_dim)
                   for _ in range(2)) for _ in range(cfg.num_hidden_layers)]
    with torch.no_grad():
        got = [model(torch.from_numpy(ids[:, :10]), torch.arange(10)[None],
                     kv_cache=cache, cache_len=0)[0]]
        for p in range(10, 16):
            got.append(model(torch.from_numpy(ids[:, p:p + 1]),
                             torch.tensor([[p]]), kv_cache=cache,
                             cache_len=p)[0])
    np.testing.assert_allclose(torch.cat(got).numpy(), full, atol=ATOL, rtol=0)


def stream(engine, prompt=PROMPT, n=GREEDY, **kw):
    return list(engine.generate_stream(list(prompt), max_new_tokens=n, **kw))


@pytest.fixture(scope="module")
def greedy_ref(qwen):
    """The port's plain greedy stream of PROMPT (decode_chunk 8, prefill
    in one shot)."""
    return stream(port_engine(qwen, decode_chunk=8))


MODES = {"plain": dict(decode_chunk=8),
         "chunked_prefill": dict(decode_chunk=8, prefill_chunk=16),
         "decode_chunk_1": dict(decode_chunk=1),
         "prefix_hit": dict(decode_chunk=8, prefix_cache=2)}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_greedy_stream_matches_jax_engine(qwen, greedy_ref, mode):
    """32 greedy tokens of PROMPT identical to ``JaxDecoderLM``'s in the
    same mode, and to the port's plain stream: prefill in one shot or in
    chunks of 16 (40 tokens: 16, 16, 8 padded to 16), decode_chunk 8 or
    1, or a prefix-cache hit (a donor sharing 24 leading tokens first)."""
    streams = []
    for make in (port_engine, jax_engine):
        engine = make(qwen, **MODES[mode])
        if mode == "prefix_hit":
            stream(engine, DONOR, n=4)
        streams.append(stream(engine))
        if mode == "prefix_hit":
            assert engine.prefix_stats["hits"] == 1
            assert engine.prefix_stats["saved_tokens"] == 24
    got, want = streams
    assert got == want
    assert got == greedy_ref
    assert len(set(got)) > 4                     # not one repeated token


def test_greedy_reproduced_by_top_k_1_and_min_p_1(qwen, greedy_ref):
    engine = port_engine(qwen)
    assert stream(engine, temperature=0.7, top_k=1, seed=3) == greedy_ref
    assert stream(engine, temperature=0.7, min_p=1.0, seed=4) == greedy_ref


def test_repetition_penalty_stream_matches_jax(qwen):
    kw = dict(repetition_penalty=1.3, n=16)
    got = stream(port_engine(qwen), **kw)
    assert got == stream(jax_engine(qwen), **kw)
    assert got != stream(port_engine(qwen), n=16)


def test_sampled_stream_is_seeded(qwen):
    engine = port_engine(qwen)
    kw = dict(temperature=1.0, top_p=0.95, n=16)
    a, b = stream(engine, seed=1, **kw), stream(engine, seed=1, **kw)
    assert a == b and a != stream(engine, seed=2, **kw)


def test_bf16_checkpoint_generates(tmp_path):
    """A bf16 checkpoint loads in bf16 (weights and cache) and decodes."""
    state, cfg = td.load_hf_decoder_params(
        write_ckpt(tmp_path, dtype=torch.bfloat16))
    assert all(t.dtype == torch.bfloat16 for t in state.values())
    engine = td.TorchDecoderLM(td.DecoderModel.from_state_dict(cfg, state),
                               device="cpu", max_len=64)
    assert engine._empty_cache()[0][0].dtype == torch.bfloat16
    toks = stream(engine, n=10)
    assert len(toks) == 10 and all(0 <= t < VOCAB for t in toks)


class Records(logging.Handler):
    """Collects the messages of one logger (the port's loggers do not
    propagate to the root)."""

    def __init__(self, name: str):
        super().__init__()
        self.logger, self.messages = logging.getLogger(name), []

    def emit(self, record):
        self.messages.append(record.getMessage())

    def __enter__(self):
        self.logger.addHandler(self)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self)


def test_capacity_clamp_and_overlong_prompt(qwen, greedy_ref):
    """A 48-row cache leaves 8 tokens after the 40-token prompt: the
    stream stops there with a warning, and its tokens are the plain
    stream's; a prompt of 48 tokens raises, as JAX's engine does."""
    engine = port_engine(qwen, max_len=48)
    with Records("torch.models.decoder") as log:
        toks = stream(engine)
    assert toks == greedy_ref[:8]
    assert any("clamping" in m for m in log.messages)
    for make in (port_engine, jax_engine):
        with pytest.raises(ValueError, match="does not fit"):
            stream(make(qwen, max_len=48), PROMPT + PROMPT[:8])


def test_eos_ends_the_stream(qwen, greedy_ref):
    eos = greedy_ref[5]
    got = stream(port_engine(qwen), eos_id=eos)
    assert got == greedy_ref[:greedy_ref.index(eos)]


# ------------------------------------------------------------------ warpers

def jax_rows(fn, logits, *args):
    return np.asarray(jax.vmap(lambda row: fn(row, *args))(
        jnp.asarray(logits)))


WARPS = [(0, 0.9, 0.0), (5, 0.97, 0.0), (0, 0.5, 0.1), (20, 0.8, 0.05),
         (1, 0.9, 0.0), (0, 0.95, 1.0), (500, 0.3, 0.0), (3, 0.99, 0.3)]


@pytest.mark.parametrize("top_k,top_p,min_p", WARPS)
def test_warpers_match_jax(top_k, top_p, min_p):
    """Each warper and the chain on 4 rows of 500 logits (one row with
    ties at 0.1 steps) within 1e-6 of JAX's."""
    rng = np.random.default_rng(top_k + int(top_p * 100))
    logits = (rng.standard_normal((4, 500)) * 3).astype(np.float32)
    logits[1] = np.round(logits[1], 1)
    t = torch.from_numpy(logits)
    checks = [
        (td._top_k_filter(t, top_k),
         jax_rows(jd._top_k_filter, logits, jnp.int32(top_k))),
        (td._top_p_filter(t, top_p),
         jax_rows(jd._top_p_filter, logits, jnp.float32(top_p))),
        (td._min_p_filter(t, min_p),
         jax_rows(jd._min_p_filter, logits, jnp.float32(min_p))),
        (td._warp_filter(t, top_p, top_k, min_p),
         jax_rows(jd._warp_filter, logits, jnp.float32(top_p),
                  jnp.int32(top_k), jnp.float32(min_p)))]
    for got, want in checks:
        np.testing.assert_allclose(got.numpy(), want, atol=WARP_ATOL, rtol=0)


def test_top_p_one_differs_from_jax_only_in_the_rounding_tail():
    """At top_p 1.0 the running sum reaches 1.0 within rounding, and the
    port's sum (sequential) and XLA's (a reduce-window) round apart: the
    kept sets may differ, only in tokens of probability below 1e-6."""
    rng = np.random.default_rng(7)
    logits = (rng.standard_normal((4, 500)) * 3).astype(np.float32)
    logits[1] = np.round(logits[1], 1)
    got = td._top_p_filter(torch.from_numpy(logits), 1.0).numpy()
    want = jax_rows(jd._top_p_filter, logits, jnp.float32(1.0))
    probs = torch.softmax(torch.from_numpy(logits), -1).numpy()
    differ = got != want
    assert (probs[differ] < 1e-6).all()
    np.testing.assert_allclose(got[~differ], want[~differ], atol=WARP_ATOL,
                               rtol=0)


@pytest.mark.parametrize("penalty", [1.0, 1.05, 1.3, 0.8])
def test_repetition_penalty_matches_jax(penalty):
    rng = np.random.default_rng(int(penalty * 100))
    logits = (rng.standard_normal((2, 300)) * 4).astype(np.float32)
    seen = rng.random((2, 300)) < 0.3
    got = td.apply_repetition_penalty(torch.from_numpy(logits),
                                      torch.from_numpy(seen), penalty)
    want = np.asarray(jd.apply_repetition_penalty(
        jnp.asarray(logits), jnp.asarray(seen), jnp.float32(penalty)))
    np.testing.assert_allclose(got.numpy(), want, atol=WARP_ATOL, rtol=0)
    if penalty == 1.0:
        assert torch.equal(got, torch.from_numpy(logits))


@pytest.mark.parametrize("top_k,top_p,min_p",
                         [(0, 1.0, 0.0), (0, 0.8, 0.0), (5, 0.95, 0.0),
                          (0, 0.95, 0.2)])
def test_sampled_draw_follows_the_warped_distribution(top_k, top_p, min_p):
    """40,000 draws over 8 tokens: tokens the warpers cut are never drawn,
    the others' counts pass a chi-squared test against the softmax of
    the warped logits."""
    logits = torch.tensor([2.0, 1.5, 1.2, 0.7, 0.3, 0.0, -0.6, -1.5])
    n = 40000
    warped = td._warp_filter(logits[None], top_p, top_k, min_p)[0]
    p = torch.softmax(warped, dim=-1).double().numpy()
    g = torch.Generator().manual_seed(top_k + int(100 * top_p))
    draws = td._sample_top_p(logits.expand(n, -1).clone(), top_p, g, top_k,
                            min_p)
    counts = np.bincount(draws.numpy(), minlength=8)
    live = p > 0
    assert counts[~live].sum() == 0 and live.sum() >= 2
    chi2 = (((counts[live] - n * p[live]) ** 2) / (n * p[live])).sum()
    assert chi2 < CHI2_999[int(live.sum()) - 1], (chi2, counts, p)


# ------------------------------------------- configs the port once refused

# the configs the port refused before it computed these families: each
# written with weights (the config keys as they were refused, a window of
# 16 below the 24 tokens), now loaded and held to JAX
ONCE_REFUSED = {
    "mixtral": dict(family="mixtral", num_local_experts=4,
                    sliding_window=16),
    "qwen2_moe": dict(family="qwen2_moe", num_experts=4,
                      moe_intermediate_size=24,
                      shared_expert_intermediate_size=40),
    "gemma": dict(family="gemma", head_dim=8, patch={"model_type": "gemma"}),
    "gemma2": dict(family="gemma2", sliding_window=16,
                   attn_logit_softcapping=50.0, final_logit_softcapping=30.0),
    "gemma3": dict(family="gemma3", sliding_window=16),
    "mistral": dict(family="mistral", sliding_window=16),
    "qwen2_sliding_layers": dict(
        family="qwen2", sliding_window=16, patch={
            "layer_types": ["full_attention", "sliding_attention"]}),
    # transformers writes "sliding_attention" past max_window_layers
    "qwen2_use_sliding_window": dict(family="qwen2", sliding_window=16,
                                     use_sliding_window=True,
                                     max_window_layers=1),
    "qwen3_qk_norms": dict(family="qwen3", head_dim=8),
}


@pytest.mark.parametrize("case", sorted(ONCE_REFUSED))
def test_once_refused_configs_match_jax(tmp_path, case):
    """Each loads through the port's loader (no ``NotImplementedError``)
    and gives float32 logits within 1e-4 of JAX's ``decoder_forward``;
    a layer JAX bands, the port bands; a layer JAX routes, the port
    routes."""
    d = write_ckpt(tmp_path, seed=len(case) + 40, **ONCE_REFUSED[case])
    (jparams, jcfg), state, cfg = load_both(d)
    assert cfg.layer_types == jcfg.layer_types
    assert [cfg.layer_is_sliding(i) for i in range(cfg.num_hidden_layers)] \
        == [bool(jcfg.sliding_window and jcfg.layer_types
                 and jcfg.layer_types[i] == "sliding_attention")
            for i in range(jcfg.num_hidden_layers)]
    model = td.DecoderModel.from_state_dict(cfg, state)
    assert [isinstance(layer.mlp, td.MoEBlock) for layer in model.layers] \
        == ["moe" in layer for layer in jparams["layers"]]
    ids = np.random.default_rng(2).integers(0, VOCAB, (2, 24))
    np.testing.assert_allclose(port_logits(model, ids),
                               jax_logits(jparams, jcfg, ids),
                               atol=ATOL, rtol=0)


def test_engine_runs_on_cuda_unless_told(qwen, monkeypatch):
    """Without a CUDA device the engine raises unless given the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _j, state, cfg = qwen
    with pytest.raises(RuntimeError, match="no CUDA device"):
        td.TorchDecoderLM(td.DecoderModel.from_state_dict(cfg, state))
    assert port_engine(qwen).device == torch.device("cpu")
