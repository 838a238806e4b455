"""The port's ``local-jax`` provider (``legalrag_tpu_torch/llm/client.py``:
``TorchDecoderLM`` with the port's BPE tokenizer and chat template) vs the
JAX package's (``JaxDecoderLM`` with ``transformers.AutoTokenizer``) on the
CPU, on one tiny checkpoint directory: a random Qwen2 model saved by
transformers (``tests/test_torch_decoder.py``'s ``write_ckpt``) beside a
Qwen2-layout ``tokenizer.json`` trained on the statutes
(``tests/test_torch_bpe.py``). At temperature 0 ``chat`` and
``chat_stream`` must give the same text and the same chunks, and
``/rag/answer``'s SSE token events from the two servers (over one index
directory, ``tests/test_torch_server.py``'s ``served``) must be equal.
Every knob JAX ignores in the engine selected, and a TP or DP count above
the devices visible, must degrade the answer, none be ignored."""

import numpy as np
import pytest

from legalrag_tpu.config import LLMConfig as JaxLLMConfig
from legalrag_tpu.llm.client import LLMClient as JaxLLMClient
from legalrag_tpu.llm.gateway import LLMGateway as JaxGateway
from legalrag_tpu_torch.config import LLMConfig
from legalrag_tpu_torch.llm import DEGRADED_ANSWER
from legalrag_tpu_torch.llm.client import (
    LLMClient,
    LLMUnavailable,
    unported_engine_knobs,
)
from legalrag_tpu_torch.llm.gateway import LLMGateway
from legalrag_tpu_torch.models.decoder import TorchDecoderLM
from legalrag_tpu_torch.utils.metrics import METRICS
from test_torch_bpe import BPE_VOCAB, SPECIALS, rag_messages, write_qwen2_tokenizer
from test_torch_decoder import write_ckpt
from test_torch_server import llm_on_both, served, sse  # noqa: F401  (fixtures)

NEW_TOKENS = 24
# the model's vocabulary: the tokenizer's ids rounded up to 64, as Qwen's
# 151,936 rows hold 151,665 tokens; the ids past the tokenizer's have no
# token and decode to nothing
VOCAB = -(-(BPE_VOCAB + len(SPECIALS)) // 64) * 64


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("qwen2_lm")
    write_ckpt(d, seed=11, vocab_size=VOCAB, max_position_embeddings=8192)
    write_qwen2_tokenizer(d)
    return d


def llm_kw(model_dir, **over):
    kw = dict(provider="local-jax", model=str(model_dir), temperature=0.0,
              max_new_tokens=NEW_TOKENS, max_context_tokens=2048)
    kw.update(over)
    return kw


@pytest.fixture(scope="module")
def clients(model_dir):
    """(the port's client on the CPU, the JAX package's), both loaded."""
    port = LLMClient(LLMConfig(**llm_kw(model_dir)), device="cpu")
    jax = JaxLLMClient(JaxLLMConfig(**llm_kw(model_dir)))
    assert isinstance(port._load_jax_lm(), TorchDecoderLM)
    return port, jax


def test_chat_and_stream_match_jax(clients, zh_chunks, en_chunks):
    """The pipeline's zh and en RAG messages and a short chat: ``chat``
    text and ``chat_stream`` chunks equal to JAX's, counted in
    ``legalrag_llm_tokens``."""
    port, jax = clients
    chats = [rag_messages("合同在什么情况下可以解除？", zh_chunks[:4]),
             rag_messages("What must a buyer do to reject goods?",
                          en_chunks[:4]),
             [{"role": "user", "content": "借款合同的利息如何约定？"}]]
    key = ("legalrag_llm_tokens", (("provider", "local-jax"),))
    for msgs in chats:
        before = METRICS._counters[key]
        got = list(port.chat_stream(msgs))
        assert got == list(jax.chat_stream(msgs))
        assert "".join(got) and got[0] != port.degraded_answer(msgs)
        assert METRICS._counters[key] > before
        assert port.chat(msgs) == jax.chat(msgs) == "".join(got)


def test_rag_answer_sse_matches_jax(served, llm_on_both, clients):  # noqa: F811
    """``/rag/answer`` as SSE through both servers with ``local-jax``: the
    same events, token texts included."""
    jc, pc, _cfg = served
    port, jax = clients
    llm_on_both(LLMGateway(port), JaxGateway(jax))
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
    assert "".join(tokens) and got[-1][0] == "done" and want[-1][0] == "done"
    assert [e for e, _ in got] == [e for e, _ in want]


# the paged engine's knobs, and the knobs JAX ignores in the engine
# selected: the pinned prelude without batch_slots, spec_adaptive with it
# (batch_slots alone is served: tests/test_torch_batched_decoder.py; the
# constraint and speculation: tests/test_torch_generation_spec.py); and TP
# and DP on more shards or replicas than the devices visible (one CPU),
# which fail the load as JAX's client fails it (served:
# tests/test_torch_decoder_dp.py). Case: (settings, the knob named)
KNOBS = {"batch_slots": ({"batch_slots": 4, "spec_k": 4,
                          "spec_adaptive": 1.5}, "spec_adaptive"),
         "paged_kv": ({"paged_kv": True}, "paged_kv"),
         "kv_block_size": ({"kv_block_size": 32}, "kv_block_size"),
         "kv_pool_blocks": ({"kv_pool_blocks": 64}, "kv_pool_blocks"),
         "shared_prefix_text": ({"shared_prefix_text": "你是法律助手"},
                                "shared_prefix_text"),
         "tp_shards": ({"tp_shards": 2}, "tp_shards"),
         "dp_replicas": ({"dp_replicas": 2}, "dp_replicas")}


# the counts that split or replicate the engine over the visible devices
DEVICE_COUNTS = ("tp_shards", "dp_replicas")


def jax_client_fails_on_one_device(model_dir, settings, monkeypatch):
    """JAX's client with ``settings`` and one visible device: its load
    fails with ``LLMUnavailable`` (DP's ``ValueError``, TP's mesh of the
    wrong size), as the port's must."""
    from legalrag_tpu.llm.client import LLMUnavailable as JaxUnavailable
    from legalrag_tpu.parallel import mesh as jax_mesh_mod

    one = jax_mesh_mod.local_devices()[:1]
    monkeypatch.setattr(jax_mesh_mod, "local_devices", lambda *a, **k: one)
    with pytest.raises(JaxUnavailable):
        JaxLLMClient(JaxLLMConfig(**llm_kw(model_dir, **settings))
                     )._load_jax_lm()


@pytest.mark.parametrize("knob", sorted(KNOBS))
def test_unported_knobs_degrade_the_answer(model_dir, knob, monkeypatch):
    """A knob JAX ignores in the engine selected fails the load naming it;
    so do ``tp_shards`` and ``dp_replicas`` above the one visible device,
    which JAX's client refuses there too, never served on fewer shards:
    the answer degrades (JAX's answer when its load fails), in chat and in
    the stream."""
    settings, refused = KNOBS[knob]
    cfg = LLMConfig(**llm_kw(model_dir, **settings))
    if knob in DEVICE_COUNTS:
        assert unported_engine_knobs(cfg) == []
        jax_client_fails_on_one_device(model_dir, settings, monkeypatch)
    else:
        assert unported_engine_knobs(cfg) == [refused]
    c = LLMClient(cfg, device="cpu")
    with pytest.raises(LLMUnavailable, match=refused):
        c._load_jax_lm()
    msgs = [{"role": "user", "content": "合同可以解除吗"}]
    assert c.chat(msgs) == DEGRADED_ANSWER["zh"]
    assert list(c.chat_stream(msgs)) == [DEGRADED_ANSWER["zh"]]
    assert c._local is None


def test_single_stream_settings_are_not_refused(model_dir):
    """The JAX defaults, and the values that keep its single-stream engine
    unsplit (batch_slots, tp_shards, dp_replicas 0 or 1), refuse
    nothing."""
    assert unported_engine_knobs(LLMConfig()) == []
    assert unported_engine_knobs(LLMConfig(
        batch_slots=1, tp_shards=1, dp_replicas=1, kv_block_size=64,
        weight_bits=8, spec_adaptive=2.0)) == []


def test_engine_reads_the_single_stream_knobs(model_dir):
    """``decode_chunk``, ``prefill_chunk``, ``prefix_cache`` and the cache
    of ``max_context_tokens + max_new_tokens`` rows reach the engine."""
    c = LLMClient(LLMConfig(**llm_kw(model_dir, decode_chunk=3,
                                     prefill_chunk=64, prefix_cache=2)),
                  device="cpu")
    lm = c._load_jax_lm()
    assert (lm.decode_chunk, lm.prefill_chunk, lm.max_len) == \
        (3, 64, 2048 + NEW_TOKENS)
    assert lm._prefix is not None and lm._prefix.size == 2
    assert lm.tokenizer.eos_token_id == BPE_VOCAB + 2
    assert lm.cfg.vocab_size == VOCAB
    ids = lm.tokenizer("借款合同")["input_ids"]
    assert np.all(np.asarray(ids) < BPE_VOCAB)
