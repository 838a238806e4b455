"""The port's quantized local generation (``weight_quant`` with
``weight_bits`` 8 / 4 and ``kv_quant``; ``legalrag_tpu_torch/models/
quant.py`` and ``decoder.py``) against the JAX package's on the CPU,
float32, on tiny checkpoints saved by transformers
(``tests/test_torch_decoder.py``'s ``write_ckpt``):

- ``decoder_forward`` on quantized params (JAX's ``quantize_weights`` tree
  carried by ``decoder_params_from_jax``, and the port's own
  quantization), and with the int8 KV cache (a prefill, then single-token
  steps, against JAX's 4-tuple cache path), within ``ATOL``;
- greedy streams token-identical to ``JaxDecoderLM(weight_quant,
  weight_bits 8 / 4, kv_quant)``, each alone and combined, in every mode
  (one shot, chunked prefill, decode_chunk 1, a prefix-cache hit), on a
  dense Qwen2 and on Qwen2-MoE / Mixtral;
- ``TorchDecoderLM.from_pretrained`` and ``LLMClient`` (``local-jax``)
  with the three knobs: loaded and answering as JAX's client does, chat,
  stream and ``/rag/answer`` SSE.

``ATOL`` (1e-4, the unquantized decoder's): every integer product is
exact and every rescale is JAX's elementwise arithmetic, so the port's
logits differ from JAX's only by the float32 ulps the unquantized
decoder has (norms, attention, activations; 4e-6 here), unless an ulp
moves an activation across a rounding midpoint of its int8 grid, which
at these widths no input here does."""

import jax
import numpy as np
import pytest
import torch

from legalrag_tpu.config import LLMConfig as JaxLLMConfig
from legalrag_tpu.llm.client import LLMClient as JaxLLMClient
from legalrag_tpu.llm.gateway import LLMGateway as JaxGateway
from legalrag_tpu.models import decoder as jd
from legalrag_tpu_torch.config import LLMConfig
from legalrag_tpu_torch.convert import decoder_params_from_jax
from legalrag_tpu_torch.llm.client import LLMClient, unported_engine_knobs
from legalrag_tpu_torch.llm.gateway import LLMGateway
from legalrag_tpu_torch.models import decoder as td
from legalrag_tpu_torch.models import quant as tq
from test_torch_bpe import rag_messages
from test_torch_decoder import (ATOL, DONOR, MAX_LEN, MODES, PROMPT,
                                VOCAB, jax_logits, load_both, port_logits,
                                stream, write_ckpt)
from test_torch_decoder_moe import FORWARD_CASES as MOE_CASES
from test_torch_generation import llm_kw, model_dir  # noqa: F401 (fixture)
from test_torch_server import llm_on_both, served, sse  # noqa: F401

# (weight bits or 0, kv_quant): each knob alone and combined
QUANT = {"w8": (8, False), "w4": (4, False), "kv8": (0, True),
         "w8_kv8": (8, True), "w4_kv8": (4, True)}


def carried(jparams, bits: int):
    """JAX's params quantized at ``bits`` (as they are at 0), and the
    port's state carried from them."""
    if bits:
        jparams = jd.quantize_weights(jparams, bits=bits)
    return jparams, decoder_params_from_jax(jax.tree.map(np.asarray, jparams))


def jax_quant_logits(jparams, jcfg, ids):
    return jax_logits(jd.unpack_weights4(jparams), jcfg, ids)


@pytest.fixture(scope="module")
def qwen(tmp_path_factory):
    """The tiny Qwen2 checkpoint (``test_torch_decoder``'s): (directory,
    (JAX params, config), port state, port config)."""
    d = write_ckpt(tmp_path_factory.mktemp("qwen2_q"))
    return (d, *load_both(d))


@pytest.mark.parametrize("bits", [8, 4])
def test_forward_logits_match_jax(qwen, bits):
    """Float32 logits of a batch of 2 x 24 ids on quantized weights: JAX's
    quantized tree carried across, and the port's own quantization of its
    state, both within ATOL of JAX's ``decoder_forward``; the quantized
    model is near (not equal to) the full-precision one."""
    _d, (jparams, jcfg), state, cfg = qwen
    jq, state_q = carried(jparams, bits)
    ids = np.random.default_rng(1).integers(0, VOCAB, (2, 24))
    want = jax_quant_logits(jq, jcfg, ids)
    for st in (state_q, tq.quantize_weights(state, bits)):
        got = port_logits(td.DecoderModel.from_state_dict(cfg, st), ids)
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    dense = jax_logits(jparams, jcfg, ids)
    off = np.abs(want - dense).max()
    assert 1e-3 < off < (0.2 if bits == 8 else 1.0) * np.abs(dense).max()


def cache_rows(model, cfg, ids, kv_quant: bool, rows: int = 32):
    """The port's logits of ``ids`` [1, 16] by a 10-token prefill into a
    ``rows``-row cache, then 6 single-token steps."""
    shape = (1, rows, cfg.num_key_value_heads, cfg.head_dim)
    cache = [(torch.zeros(shape, dtype=torch.int8),
              torch.zeros(shape, dtype=torch.int8),
              torch.zeros(shape[:3] + (1,)), torch.zeros(shape[:3] + (1,)))
             if kv_quant else (torch.zeros(shape), torch.zeros(shape))
             for _ in range(cfg.num_hidden_layers)]
    with torch.no_grad():
        out = [model(torch.from_numpy(ids[:, :10]), torch.arange(10)[None],
                     kv_cache=cache, cache_len=0)[0]]
        for p in range(10, 16):
            out.append(model(torch.from_numpy(ids[:, p:p + 1]),
                             torch.tensor([[p]]), kv_cache=cache,
                             cache_len=p)[0])
    return torch.cat(out).numpy(), cache


def jax_cache_rows(jparams, jcfg, ids, kv_quant: bool, rows: int = 32):
    engine = jd.JaxDecoderLM(jparams, jcfg, max_len=rows, kv_quant=kv_quant)
    params = jd.unpack_weights4(jparams)
    cache = engine._empty_cache(1)
    pos = np.arange(16, dtype=np.int32)[None]
    logits, cache = jd.decoder_forward(params, jcfg, ids[:, :10], pos[:, :10],
                                       kv_cache=cache, cache_len=0)
    out = [np.asarray(logits)[0]]
    for p in range(10, 16):
        logits, cache = jd.decoder_forward(params, jcfg, ids[:, p:p + 1],
                                           pos[:, p:p + 1], kv_cache=cache,
                                           cache_len=p)
        out.append(np.asarray(logits)[0])
    return np.concatenate(out), cache


@pytest.mark.parametrize("quant", sorted(QUANT))
def test_kv_cache_path_matches_jax(qwen, quant):
    """A prefill and 6 decode steps through the cache (JAX's 4-tuple
    cache under ``kv_quant``): logits within ATOL of JAX's on the same
    path; the int8 cache rows JAX's, their scales within 1e-6 (the k/v
    rows they quantize differ by float32 ulps)."""
    bits, kv_quant = QUANT[quant]
    _d, (jparams, jcfg), _s, cfg = qwen
    jq, state = carried(jparams, bits)
    ids = np.asarray(PROMPT[:16])[None]
    got, cache = cache_rows(td.DecoderModel.from_state_dict(cfg, state), cfg,
                            ids, kv_quant)
    want, jcache = jax_cache_rows(jq, jcfg, ids, kv_quant)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    if kv_quant:
        for layer, jlayer in zip(cache, jcache):
            assert len(layer) == len(jlayer) == 4
            for a, b in zip(layer[:2], jlayer[:2]):
                assert np.array_equal(a[:, :16].numpy(),
                                      np.asarray(b)[:, :16])
            for a, b in zip(layer[2:], jlayer[2:]):
                np.testing.assert_allclose(a[:, :16].numpy(),
                                           np.asarray(b)[:, :16], rtol=1e-6)
        # the cache is not the full-precision one's
        plain, _c = cache_rows(td.DecoderModel.from_state_dict(cfg, state),
                               cfg, ids, False)
        assert np.abs(plain - got).max() > 1e-5


def port_engine(cfg, state, **kw):
    return td.TorchDecoderLM(td.DecoderModel.from_state_dict(cfg, state),
                             device="cpu", max_len=MAX_LEN, **kw)


def check_streams(jq, jcfg, state, cfg, mode, kv_quant):
    """The port's and JAX's greedy streams in ``mode``: equal, equal to the
    port's plain stream, and not one repeated token."""
    streams = []
    for make in (lambda **kw: port_engine(cfg, state, **kw),
                 lambda **kw: jd.JaxDecoderLM(jq, jcfg, max_len=MAX_LEN,
                                              **kw)):
        engine = make(kv_quant=kv_quant, **MODES[mode])
        if mode == "prefix_hit":
            stream(engine, DONOR, n=4)
        streams.append(stream(engine))
        if mode == "prefix_hit":
            assert engine.prefix_stats["hits"] == 1
            assert engine.prefix_stats["saved_tokens"] == 24
    got, want = streams
    assert got == want
    assert got == stream(port_engine(cfg, state, kv_quant=kv_quant))
    assert len(set(got)) > 4, got
    return got


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("quant", sorted(QUANT))
def test_greedy_stream_matches_jax_engine(qwen, quant, mode):
    """32 greedy tokens of PROMPT identical to ``JaxDecoderLM``'s with the
    same weight bits and KV cache, in the same mode."""
    bits, kv_quant = QUANT[quant]
    _d, (jparams, jcfg), _s, cfg = qwen
    jq, state = carried(jparams, bits)
    check_streams(jq, jcfg, state, cfg, mode, kv_quant)


@pytest.fixture(scope="module", params=["mixtral_window",
                                        "qwen2_moe_mlp_only_layers"])
def moe(request, tmp_path_factory):
    """A Mixtral (a window below the prompt) or a Qwen2-MoE with its shared
    expert and a dense layer: ((JAX params, config), port state, port
    config)."""
    d = write_ckpt(tmp_path_factory.mktemp(request.param), seed=23,
                   **MOE_CASES[request.param])
    return load_both(d)


@pytest.mark.parametrize("mode", ["plain", "chunked_prefill", "prefix_hit"])
@pytest.mark.parametrize("quant", ["w8", "w4_kv8"])
def test_moe_greedy_stream_matches_jax_engine(moe, quant, mode):
    """The quantized expert stacks (and shared expert) through the engine:
    greedy streams identical to ``JaxDecoderLM``'s; logits within ATOL
    of ``decoder_forward``'s on the quantized tree."""
    bits, kv_quant = QUANT[quant]
    (jparams, jcfg), _s, cfg = moe
    jq, state = carried(jparams, bits)
    model = td.DecoderModel.from_state_dict(cfg, state)
    assert any(isinstance(layer.mlp, td.MoEBlock) and layer.mlp.bits == bits
               for layer in model.layers)
    if mode == "plain":
        ids = np.random.default_rng(2).integers(0, VOCAB, (2, 24))
        np.testing.assert_allclose(port_logits(model, ids),
                                   jax_quant_logits(jq, jcfg, ids),
                                   atol=ATOL, rtol=0)
    check_streams(jq, jcfg, state, cfg, mode, kv_quant)


# ------------------------------------------------------------ the loader

@pytest.fixture(scope="module")
def tokenized(model_dir):  # noqa: F811
    """``test_torch_generation``'s checkpoint directory (a tokenizer beside
    it): (directory, (JAX params, config))."""
    return model_dir, jd.load_hf_decoder_params(model_dir)


@pytest.mark.parametrize("quant", ["w8", "w4_kv8", "kv8"])
def test_from_pretrained_quantizes_as_jax(tokenized, quant):
    """``from_pretrained(weight_quant, weight_bits, kv_quant)``: the state
    JAX's ``from_pretrained`` quantizes, and its greedy stream."""
    bits, kv_quant = QUANT[quant]
    d, (jparams, jcfg) = tokenized
    kw = dict(weight_quant=bool(bits), weight_bits=bits or 8,
              kv_quant=kv_quant)
    lm = td.TorchDecoderLM.from_pretrained(str(d), device="cpu",
                                           max_len=MAX_LEN, **kw)
    assert lm.kv_quant == kv_quant
    assert len(lm._empty_cache()[0]) == (4 if kv_quant else 2)
    jq, state = carried(jparams, bits)
    got = lm.model.state_dict()
    assert set(got) == set(state)
    for k, v in state.items():
        assert torch.equal(got[k], v), k
    want = stream(jd.JaxDecoderLM(jq, jcfg, max_len=MAX_LEN,
                                  kv_quant=kv_quant))
    assert stream(lm) == want


def test_weight_bits_alone_changes_nothing(tokenized):
    d, (jparams, _jcfg) = tokenized
    lm = td.TorchDecoderLM.from_pretrained(str(d), device="cpu",
                                           max_len=MAX_LEN, weight_bits=4)
    got = lm.model.state_dict()
    assert tq.state_bits(got) == 0
    _jp, state = carried(jparams, 0)
    assert all(torch.equal(got[k], v) for k, v in state.items())
    with pytest.raises(ValueError, match="weight_bits must be 8 or 4"):
        td.TorchDecoderLM.from_pretrained(str(d), device="cpu",
                                          weight_quant=True, weight_bits=6)


def test_quantized_load_runs_on_cuda_unless_told(tokenized, monkeypatch):
    """Without a CUDA device the quantized load raises unless given the
    CPU, before it quantizes anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        td.TorchDecoderLM.from_pretrained(str(tokenized[0]),
                                          weight_quant=True)


# ------------------------------------------------------------ the client

KNOB_SETS = {"w8": dict(weight_quant=True),
             "w4_kv8": dict(weight_quant=True, weight_bits=4, kv_quant=True),
             "kv8": dict(kv_quant=True)}


@pytest.fixture(scope="module", params=sorted(KNOB_SETS))
def knob_clients(request, model_dir):  # noqa: F811
    """(knobs, the port's ``local-jax`` client on the CPU, the JAX
    package's), both loaded with the knobs on one checkpoint directory."""
    knobs = KNOB_SETS[request.param]
    cfg = LLMConfig(**llm_kw(model_dir, **knobs))
    assert unported_engine_knobs(cfg) == []
    port = LLMClient(cfg, device="cpu")
    jax_client = JaxLLMClient(JaxLLMConfig(**llm_kw(model_dir, **knobs)))
    lm = port._load_jax_lm()
    assert lm.kv_quant == knobs.get("kv_quant", False)
    assert tq.state_bits(lm.model.state_dict()) == (
        knobs.get("weight_bits", 8) if knobs.get("weight_quant") else 0)
    return request.param, port, jax_client


def test_chat_and_stream_match_jax(knob_clients, zh_chunks, en_chunks):
    """The pipeline's zh and en RAG messages and a short chat: ``chat``
    text and ``chat_stream`` chunks equal to JAX's, none degraded."""
    _name, port, jax_client = knob_clients
    chats = [rag_messages("合同在什么情况下可以解除？", zh_chunks[:4]),
             rag_messages("What must a buyer do to reject goods?",
                          en_chunks[:4]),
             [{"role": "user", "content": "借款合同的利息如何约定？"}]]
    for msgs in chats:
        got = list(port.chat_stream(msgs))
        assert got == list(jax_client.chat_stream(msgs))
        assert "".join(got) and got[0] != port.degraded_answer(msgs)
        assert port.chat(msgs) == jax_client.chat(msgs) == "".join(got)


def test_rag_answer_sse_matches_jax(served, llm_on_both,  # noqa: F811
                                    knob_clients):
    """``/rag/answer`` as SSE through both servers with ``local-jax`` and
    the knobs: the same events, token texts included."""
    jc, pc, _cfg = served
    _name, port, jax_client = knob_clients
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
