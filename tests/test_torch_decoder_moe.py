"""The port's mixture-of-experts decoders (``MoEBlock`` in
``legalrag_tpu_torch/models/decoder.py``: Mixtral's ``block_sparse_moe``,
Qwen2-MoE with its shared expert) against the JAX package's
``_moe_block``, ``decoder_forward`` and ``JaxDecoderLM`` on the CPU,
float32, on tiny checkpoints saved by transformers' ``MixtralForCausalLM``
and ``Qwen2MoeForCausalLM`` (``tests/test_torch_decoder.py``'s
``write_ckpt``):

- the block alone on the same seeded numpy inputs within 1e-5 of
  ``_moe_block`` (Mixtral- and Qwen2-MoE-style, ``norm_topk_prob`` on and
  off, the tanh GELU, routers whose equal columns tie: the experts chosen
  are ``lax.top_k``'s);
- logits within 1e-4 of ``decoder_forward`` (a window below the prompt,
  dense layers among the sparse ones by ``mlp_only_layers`` and by
  ``decoder_sparse_step``) and at the JAX package's own tolerance of HF's
  models (atol 5e-4, rtol 1e-3, ``tests/test_checkpoint_parity.py``);
- ``decoder_params_from_jax`` of the JAX tree equal to the loader's state,
  bit for bit;
- the KV cache, and greedy streams token-identical to ``JaxDecoderLM`` in
  every mode;
- ``local-jax`` chat, stream and ``/rag/answer`` SSE equal to the JAX
  client's on one Qwen2-MoE checkpoint directory."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legalrag_tpu.config import LLMConfig as JaxLLMConfig
from legalrag_tpu.llm.client import LLMClient as JaxLLMClient
from legalrag_tpu.llm.gateway import LLMGateway as JaxGateway
from legalrag_tpu.models import decoder as jd
from legalrag_tpu_torch.config import LLMConfig
from legalrag_tpu_torch.convert import decoder_params_from_jax
from legalrag_tpu_torch.llm.client import LLMClient
from legalrag_tpu_torch.llm.gateway import LLMGateway
from legalrag_tpu_torch.models import decoder as td
from test_torch_bpe import BPE_VOCAB, SPECIALS, rag_messages, write_qwen2_tokenizer
from test_torch_decoder import (ATOL, DONOR, GREEDY, MAX_LEN, MODES, PROMPT,
                                VOCAB, jax_logits, load_both, port_logits,
                                stream, write_ckpt)
from test_torch_server import llm_on_both, served, sse  # noqa: F401  (fixtures)

BLOCK_ATOL = 1e-5
HF_ATOL, HF_RTOL = 5e-4, 1e-3

# ------------------------------------------------------------ the block

BLOCK_CASES = {
    "mixtral": dict(model_type="mixtral", num_local_experts=8,
                    num_experts_per_tok=2, intermediate_size=48),
    "mixtral_no_renorm": dict(model_type="mixtral", num_local_experts=8,
                              num_experts_per_tok=2, intermediate_size=48,
                              norm_topk_prob=False),
    "qwen2_moe_shared": dict(model_type="qwen2_moe", num_experts=6,
                             num_experts_per_tok=4, moe_intermediate_size=24,
                             shared_expert_intermediate_size=40),
    "qwen2_moe_renorm": dict(model_type="qwen2_moe", num_experts=6,
                             num_experts_per_tok=4, moe_intermediate_size=24,
                             shared_expert_intermediate_size=40,
                             norm_topk_prob=True),
    "gelu_tanh": dict(model_type="qwen2_moe", num_experts=4,
                      num_experts_per_tok=2, moe_intermediate_size=16,
                      shared_expert_intermediate_size=24,
                      hidden_activation="gelu_pytorch_tanh"),
    # columns 1, 3 and 4 equal and above the rest: two of three tie at
    # the top-2 boundary on every token
    "tied_router": dict(model_type="mixtral", num_local_experts=6,
                        num_experts_per_tok=2, intermediate_size=16,
                        tie=(1, 3, 4)),
}


def block_inputs(case):
    """(JAX ``moe`` dict, port block, JAX config, the input [2, 9, H]) for
    one case, drawn from a seeded numpy generator."""
    kw = dict(BLOCK_CASES[case])
    tie = kw.pop("tie", None)
    h = 32
    jcfg = jd.DecoderConfig(hidden_size=h, num_attention_heads=4, **kw)
    cfg = td.DecoderConfig(hidden_size=h, num_attention_heads=4, **kw)
    e, f = cfg.num_experts, cfg.moe_intermediate_size or cfg.intermediate_size
    rng = np.random.default_rng(len(case))

    def draw(*shape):
        return (rng.standard_normal(shape) / np.sqrt(shape[-2])).astype(
            np.float32)

    y = rng.standard_normal((2, 9, h)).astype(np.float32)
    moe = {"router": draw(h, e), "gate": draw(e, h, f), "up": draw(e, h, f),
           "down": draw(e, f, h)}
    if tie:
        y = np.abs(y)
        moe["router"] *= 0.1
        moe["router"][:, list(tie)] = 1.0 + 0.1 * np.abs(draw(h, 1))
    shared = cfg.shared_expert_intermediate_size is not None
    if shared:
        fs = cfg.shared_expert_intermediate_size
        moe["shared_gate"] = draw(h, 1)
        moe["shared"] = {"gate": draw(h, fs), "up": draw(h, fs),
                         "down": draw(fs, h)}
    block = td.MoEBlock(cfg)
    state = {"router": moe["router"].T, "gate": moe["gate"],
             "up": moe["up"], "down": moe["down"]}
    if shared:
        state["shared_expert_gate.weight"] = moe["shared_gate"].T
        for x in ("gate", "up", "down"):
            state[f"shared_expert.{x}_proj.weight"] = moe["shared"][x].T
    block.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                           for k, v in state.items()})
    return moe, block, jcfg, y


@pytest.mark.parametrize("case", sorted(BLOCK_CASES))
def test_moe_block_matches_jax(case):
    """The block's output within 1e-5 of ``_moe_block`` on the same
    inputs, and the experts it routes each token to equal to
    ``lax.top_k``'s over JAX's router probabilities, in order."""
    moe, block, jcfg, y = block_inputs(case)
    want = np.asarray(jd._moe_block(jnp.asarray(y), jax.tree.map(
        jnp.asarray, moe), jcfg))
    with torch.no_grad():
        got = block(torch.from_numpy(y)).numpy()
        chosen = block.route(torch.from_numpy(y).reshape(-1, y.shape[-1]))[0]
    np.testing.assert_allclose(got, want, atol=BLOCK_ATOL, rtol=0)
    probs = jax.nn.softmax(jnp.dot(jnp.asarray(y), moe["router"]), axis=-1)
    _, top = jax.lax.top_k(probs, jcfg.num_experts_per_tok)
    np.testing.assert_array_equal(chosen.numpy(),
                                  np.asarray(top).reshape(chosen.shape))
    if "tie" in BLOCK_CASES[case]:
        assert (chosen.numpy() == [1, 3]).all()
    else:    # the routing is not collapsed onto a few experts
        assert len(np.unique(chosen.numpy())) > jcfg.num_experts // 2


# ----------------------------------------------------- the whole decoder

WINDOW = 16
FORWARD_CASES = {
    "mixtral": dict(family="mixtral", num_local_experts=4),
    "mixtral_window": dict(family="mixtral", num_local_experts=4,
                           sliding_window=WINDOW),
    "qwen2_moe_mlp_only_layers": dict(
        family="qwen2_moe", num_hidden_layers=3, num_experts=4,
        moe_intermediate_size=24, shared_expert_intermediate_size=40,
        mlp_only_layers=[1]),
    "qwen2_moe_sparse_step_2": dict(
        family="qwen2_moe", num_hidden_layers=4, num_experts=4,
        moe_intermediate_size=24, shared_expert_intermediate_size=40,
        decoder_sparse_step=2),
}


@pytest.fixture(scope="module", params=sorted(FORWARD_CASES))
def forward_case(request, tmp_path_factory):
    """(name, checkpoint directory, (JAX params, config), port state,
    port config)."""
    d = write_ckpt(tmp_path_factory.mktemp(request.param),
                   seed=len(request.param) + 60,
                   **FORWARD_CASES[request.param])
    return (request.param, d, *load_both(d))


def test_forward_logits_match_jax(forward_case):
    """Float32 logits of a batch of 2 x 24 ids within 1e-4 of JAX's
    ``decoder_forward``; MoE layers where JAX has them (the dense ones
    with ``intermediate_size``), a band where JAX bands."""
    name, _d, (jparams, jcfg), state, cfg = forward_case
    model = td.DecoderModel.from_state_dict(cfg, state)
    moe = [isinstance(layer.mlp, td.MoEBlock) for layer in model.layers]
    assert moe == ["moe" in layer for layer in jparams["layers"]]
    assert any(moe) and (all(moe) == name.startswith("mixtral"))
    assert cfg.layer_types == jcfg.layer_types
    if name == "mixtral_window":
        assert cfg.layer_types == ["sliding_attention"] * 2
    ids = np.random.default_rng(1).integers(0, VOCAB, (2, 24))
    want = jax_logits(jparams, jcfg, ids)
    np.testing.assert_allclose(port_logits(model, ids), want, atol=ATOL,
                               rtol=0)
    assert np.abs(want).max() > 1.0


def test_jax_params_carry_across_bit_for_bit(forward_case):
    """``decoder_params_from_jax`` of JAX's tree is the loader's state:
    the same names, dtypes and bits (the stacked experts, the router and
    the shared expert among them). JAX's loader gives a checkpoint
    without q/k/v biases (Mixtral) zero biases: those are the only extra
    tensors carried."""
    _n, _d, (jparams, _jcfg), state, _cfg = forward_case
    carried = decoder_params_from_jax(jax.tree.map(np.asarray, jparams))
    assert any(k.endswith(".mlp.router") for k in state)
    for k, v in state.items():
        assert carried[k].dtype == v.dtype and torch.equal(carried[k], v), k
    for k in set(carried) - set(state):
        assert k.endswith("_proj.bias") and not carried[k].any(), k


def test_logits_match_hf(forward_case):
    """The port's logits against transformers' own model on the same
    checkpoint, at the JAX package's tolerance of it."""
    import transformers as tf

    _n, d, _j, state, cfg = forward_case
    hf = tf.AutoModelForCausalLM.from_pretrained(d).eval()
    ids = np.random.default_rng(3).integers(0, VOCAB, (2, 24))
    with torch.no_grad():
        want = hf(torch.from_numpy(ids)).logits.float().numpy()
    np.testing.assert_allclose(
        port_logits(td.DecoderModel.from_state_dict(cfg, state), ids), want,
        atol=HF_ATOL, rtol=HF_RTOL)


# ------------------------------------------------------------ the engine

FAMILIES = {k: FORWARD_CASES[k] for k in ("mixtral_window",
                                          "qwen2_moe_mlp_only_layers")}


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def family(request, tmp_path_factory):
    """(name, (JAX params, JAX config), port state, port config)."""
    d = write_ckpt(tmp_path_factory.mktemp(request.param), seed=23,
                   **FAMILIES[request.param])
    return (request.param, *load_both(d))


def test_kv_cache_path_matches_the_full_forward(family):
    """A 10-token prefill into a 40-row cache, then 20 single-token steps
    (past Mixtral's window): each row's logits within 1e-4 of the full
    forward over the 30 tokens."""
    _name, _j, state, cfg = family
    model = td.DecoderModel.from_state_dict(cfg, state)
    ids = np.asarray(PROMPT[:30])[None]
    full = port_logits(model, ids)[0]
    cache = [tuple(torch.zeros(1, 40, cfg.num_key_value_heads, cfg.head_dim)
                   for _ in range(2)) for _ in range(cfg.num_hidden_layers)]
    with torch.no_grad():
        got = [model(torch.from_numpy(ids[:, :10]), torch.arange(10)[None],
                     kv_cache=cache, cache_len=0)[0]]
        for p in range(10, 30):
            got.append(model(torch.from_numpy(ids[:, p:p + 1]),
                             torch.tensor([[p]]), kv_cache=cache,
                             cache_len=p)[0])
    np.testing.assert_allclose(torch.cat(got).numpy(), full, atol=ATOL, rtol=0)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_greedy_stream_matches_jax_engine(family, mode):
    """32 greedy tokens after the 40-token prompt identical to
    ``JaxDecoderLM``'s in the same mode (one shot, chunks of 16, decode
    chunks of 1, a prefix-cache hit) and to the port's plain stream."""
    name, (jparams, jcfg), state, cfg = family
    streams = []
    for make in (
            lambda **kw: td.TorchDecoderLM(
                td.DecoderModel.from_state_dict(cfg, state), device="cpu",
                max_len=MAX_LEN, **kw),
            lambda **kw: jd.JaxDecoderLM(jparams, jcfg, max_len=MAX_LEN,
                                         **kw)):
        engine = make(**MODES[mode])
        if mode == "prefix_hit":
            stream(engine, DONOR, n=4)
        streams.append(stream(engine))
        if mode == "prefix_hit":
            assert engine.prefix_stats["hits"] == 1
    got, want = streams
    assert got == want
    plain = td.TorchDecoderLM(td.DecoderModel.from_state_dict(cfg, state),
                              device="cpu", max_len=MAX_LEN)
    assert got == stream(plain)
    assert len(set(got)) > 4, (name, got)       # not one repeated token
    assert len(PROMPT) + GREEDY > 2 * WINDOW


# ------------------------------------------------------------ the client

NEW_TOKENS = 24


@pytest.fixture(scope="module")
def clients(tmp_path_factory):
    """(the port's ``local-jax`` client on the CPU, the JAX package's),
    both loaded on one Qwen2-MoE directory with a Qwen2-layout
    tokenizer."""
    d = tmp_path_factory.mktemp("qwen2_moe_lm")
    write_ckpt(d, seed=17, vocab_size=-(-(BPE_VOCAB + len(SPECIALS)) // 64)
               * 64, max_position_embeddings=8192,
               **FORWARD_CASES["qwen2_moe_mlp_only_layers"])
    write_qwen2_tokenizer(d)
    kw = dict(provider="local-jax", model=str(d), temperature=0.0,
              max_new_tokens=NEW_TOKENS, max_context_tokens=2048)
    port = LLMClient(LLMConfig(**kw), device="cpu")
    jax_client = JaxLLMClient(JaxLLMConfig(**kw))
    assert any(isinstance(layer.mlp, td.MoEBlock)
               for layer in port._load_jax_lm().model.layers)
    return port, jax_client


def test_chat_and_stream_match_jax(clients, zh_chunks, en_chunks):
    """The pipeline's zh and en RAG messages and a short chat: ``chat``
    text and ``chat_stream`` chunks equal to JAX's, none degraded."""
    port, jax_client = clients
    chats = [rag_messages("合同在什么情况下可以解除？", zh_chunks[:4]),
             rag_messages("What must a buyer do to reject goods?",
                          en_chunks[:4]),
             [{"role": "user", "content": "借款合同的利息如何约定？"}]]
    for msgs in chats:
        got = list(port.chat_stream(msgs))
        assert got == list(jax_client.chat_stream(msgs))
        assert "".join(got) and got[0] != port.degraded_answer(msgs)
        assert port.chat(msgs) == jax_client.chat(msgs) == "".join(got)


def test_rag_answer_sse_matches_jax(served, llm_on_both, clients):  # noqa: F811
    """``/rag/answer`` as SSE through both servers with ``local-jax`` on
    the MoE checkpoint: the same events, token texts included."""
    jc, pc, _cfg = served
    port, jax_client = clients
    llm_on_both(LLMGateway(port), JaxGateway(jax_client))
    events = []
    for c in (pc, jc):
        body = {"question": "合同解除的条件", "stream": True}
        rid = c.post("/rag/retrieve", json_body=body).json()["retrieval_id"]
        r = c.post("/rag/answer", json_body={"retrieval_id": rid,
                                             "stream": True})
        assert r.status == 200
        events.append(sse(r))
    got, want = events
    tokens = [p["text"] for e, p in got if e == "token"]
    assert tokens == [p["text"] for e, p in want if e == "token"]
    assert [e for e, _ in got] == [e for e, _ in want]
    assert got[-1][0] == "done" and "".join(tokens)
    assert "".join(tokens) != port.degraded_answer([])
