"""The port's quantized local generation (``tests/test_torch_decoder_quant.py``'s
second half, apart so that ``--dist loadfile`` can run the two on two
workers) against the JAX package's on the CPU, float32:

- greedy streams of the quantized expert stacks (and Qwen2-MoE's shared
  expert) token-identical to ``JaxDecoderLM(weight_quant, weight_bits 8 /
  4, kv_quant)`` on Qwen2-MoE / Mixtral, and their logits within ``ATOL``;
- ``TorchDecoderLM.from_pretrained`` and ``LLMClient`` (``local-jax``)
  with the three knobs: loaded and answering as JAX's client does, chat,
  stream and ``/rag/answer`` SSE."""

import numpy as np
import pytest
import torch

from legalrag_tpu.config import LLMConfig as JaxLLMConfig
from legalrag_tpu.llm.client import LLMClient as JaxLLMClient
from legalrag_tpu.llm.gateway import LLMGateway as JaxGateway
from legalrag_tpu.models import decoder as jd
from legalrag_tpu_torch.config import LLMConfig
from legalrag_tpu_torch.llm.client import LLMClient, unported_engine_knobs
from legalrag_tpu_torch.llm.gateway import LLMGateway
from legalrag_tpu_torch.models import decoder as td
from legalrag_tpu_torch.models import quant as tq
from test_torch_bpe import rag_messages
from test_torch_decoder import (ATOL, MAX_LEN, VOCAB, load_both, port_logits,
                                stream, write_ckpt)
from test_torch_decoder_moe import FORWARD_CASES as MOE_CASES
from test_torch_decoder_quant import (QUANT, carried, check_streams,
                                      jax_quant_logits)
from test_torch_generation import llm_kw, model_dir  # noqa: F401 (fixture)
from test_torch_server import llm_on_both, served, sse  # noqa: F401


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
