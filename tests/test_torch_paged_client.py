"""``local-jax`` with ``batch_slots`` 4 and ``paged_kv`` serving the port's
paged engine (``TorchPagedDecoderLM``) against the JAX client's
``PagedDecoderLM`` on the CPU, on the tiny Qwen2 checkpoint with its
byte-level BPE (``tests/test_torch_generation.py``'s): concurrent chats
and ``/rag/answer`` SSE as JAX answers them, ``max_len`` rounded up to
the block size, ``from_pretrained`` with the quantization, constraint and
draft-model knobs, the load on ``cuda`` unless told the CPU, and the knobs
that JAX ignores under (or without) the paged engine refused by name."""

import threading

import pytest
import torch

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
from legalrag_tpu_torch.models.paged_decoder import TorchPagedDecoderLM
from legalrag_tpu_torch.models.quant import QLinear
from test_torch_bpe import rag_messages
from test_torch_generation import (  # noqa: F401 (model_dir: a fixture)
    DEVICE_COUNTS, NEW_TOKENS, llm_kw, model_dir)
from test_torch_server import llm_on_both, served, sse  # noqa: F401


@pytest.fixture(scope="module")
def paged_clients(model_dir):  # noqa: F811
    """(the port's ``local-jax`` client with ``batch_slots`` 4 and
    ``paged_kv`` on the CPU, the JAX package's), both loaded."""
    kw = llm_kw(model_dir, batch_slots=4, paged_kv=True)
    cfg = LLMConfig(**kw)
    assert unported_engine_knobs(cfg) == []
    port = LLMClient(cfg, device="cpu")
    jax_client = JaxLLMClient(JaxLLMConfig(**kw))
    lm = port._load_jax_lm()
    assert isinstance(lm, TorchPagedDecoderLM)
    jlm = jax_client._load_jax_lm()
    # 2,048 + 24 rows rounded up to whole 64-token blocks, as JAX's
    assert (lm.n_slots, lm.spec_k, lm.block_size, lm.max_len) == (
        4, 0, 64, 2112) == (jlm.n_slots, jlm.spec_k, jlm.block_size,
                            jlm.max_len)
    assert lm.paged_stats() == jlm.paged_stats()
    yield port, jax_client
    port.close()
    jax_client.close()


def concurrently_chat(client, chats):
    out = {}

    def run(i):
        out[i] = list(client.chat_stream(chats[i]))

    ts = [threading.Thread(target=run, args=(i,)) for i in range(len(chats))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=300)
    return [out[i] for i in range(len(chats))]


def test_concurrent_chats_match_jax(paged_clients, zh_chunks):
    """Four zh RAG chats streamed at once through each client: every
    stream's chunks JAX's, none degraded; the prompts' shared system turn
    reused from the tree on the port as on JAX."""
    port, jax_client = paged_clients
    chats = [rag_messages(q, zh_chunks[i:i + 3]) for i, q in enumerate(
        ["合同在什么情况下可以解除？", "借款合同的利息如何约定？",
         "租赁期限届满后承租人应当如何返还租赁物？", "什么是不可抗力？"])]
    got = concurrently_chat(port, chats)
    assert got == concurrently_chat(jax_client, chats)
    for msgs, chunks in zip(chats, got):
        assert "".join(chunks) and chunks[0] != port.degraded_answer(msgs)
    # answered one after another, the second chat reuses blocks
    before = port._local.paged_stats()["reused_blocks"]
    assert list(port.chat_stream(chats[0])) == got[0]
    assert port._local.paged_stats()["reused_blocks"] > before


def test_rag_answer_sse_matches_jax(served, llm_on_both,  # noqa: F811
                                   paged_clients):
    """``/rag/answer`` as SSE through both servers with ``local-jax``,
    ``batch_slots`` 4 and ``paged_kv``: the same events, token texts
    included."""
    jc, pc, _cfg = served
    port, jax_client = paged_clients
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


@pytest.mark.parametrize("settings,refused", [
    (dict(batch_slots=4, paged_kv=True, prefix_cache=2), "prefix_cache"),
    (dict(batch_slots=4, paged_kv=True, shared_prefix_text="你是法律助手"),
     "shared_prefix_text"),
    (dict(batch_slots=4, kv_block_size=32), "kv_block_size"),
    (dict(batch_slots=4, kv_pool_blocks=64), "kv_pool_blocks"),
    (dict(paged_kv=True, kv_block_size=32, kv_pool_blocks=64),
     "paged_kv, kv_block_size, kv_pool_blocks"),
    (dict(batch_slots=4, paged_kv=True, spec_k=4, spec_adaptive=1.5),
     "spec_adaptive"),
    (dict(batch_slots=4, paged_kv=True, tp_shards=2), "tp_shards")])
def test_knobs_that_jax_ignores_are_refused(model_dir, settings,
                                            refused):  # noqa: F811
    """Under ``paged_kv`` JAX's client drops ``prefix_cache`` and
    ``shared_prefix_text``; without ``batch_slots > 1`` it ignores the
    paged knobs, and without ``paged_kv`` the block size and pool; its
    paged engine ignores ``spec_adaptive``. Each fails the load naming the
    knobs, and so does TP over more shards than the one visible device
    (JAX's client fails there too: ``tests/test_torch_generation.py``);
    the answer degrades."""
    cfg = LLMConfig(**llm_kw(model_dir, **settings))
    assert ", ".join(unported_engine_knobs(cfg)) == (
        "" if refused in DEVICE_COUNTS else refused)
    c = LLMClient(cfg, device="cpu")
    with pytest.raises(LLMUnavailable, match=refused):
        c._load_jax_lm()
    msgs = [{"role": "user", "content": "合同可以解除吗"}]
    assert c.chat(msgs) == DEGRADED_ANSWER["zh"]
    assert c._local is None


def test_paged_settings_are_not_refused(model_dir):  # noqa: F811
    """The paged engine's own knobs, and the ones it shares with the
    batched engine, refuse nothing."""
    assert unported_engine_knobs(LLMConfig(**llm_kw(
        model_dir, batch_slots=4, paged_kv=True, kv_block_size=32,
        kv_pool_blocks=300, spec_k=4, draft_model=str(model_dir),
        ngram_draft_path="t.npz", kv_quant=True, weight_quant=True,
        weight_bits=4, constrain_json=True, prefill_chunk=512,
        decode_chunk=4))) == []


def test_from_pretrained_knobs_and_the_default_device(model_dir,  # noqa: F811
                                                     monkeypatch):
    """``from_pretrained`` with int8 weights, the int8 cache, the
    constraint and a draft model loads the port's tokenizer and int8 pools
    and answers as the single-stream engine does with the same settings;
    without ``device`` the load runs on ``cuda`` and raises without it."""
    quant = dict(weight_quant=True, weight_bits=8, kv_quant=True)
    lm = TorchPagedDecoderLM.from_pretrained(
        str(model_dir), device="cpu", max_len=256, n_slots=2, block_size=32,
        constrain_json=True, spec_k=4, draft_model=str(model_dir), **quant)
    ref = TorchDecoderLM.from_pretrained(str(model_dir), device="cpu",
                                         max_len=256, **quant)
    try:
        assert lm.json_constraint is not None and lm.draft is not None
        assert lm._pools[0][0].dtype == torch.int8
        assert len(lm._pools[0]) == 4 and lm.n_blocks == 3 * 8
        assert isinstance(lm.model.lm_head, QLinear)
        assert isinstance(lm.draft.lm_head, QLinear)
        ids = lm.tokenizer("合同在什么情况下可以解除？")["input_ids"]
        assert list(lm.generate_stream(ids, max_new_tokens=NEW_TOKENS)) == \
            list(ref.generate_stream(ids, max_new_tokens=NEW_TOKENS))
        assert lm.cache_bytes == sum(a.numel() * a.element_size()
                                     for layer in lm._pools for a in layer)
        assert lm.view_bytes * (lm.n_blocks + 1) == \
            lm.cache_bytes * lm.n_slots * lm.maxb
    finally:
        lm.close()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchPagedDecoderLM.from_pretrained(str(model_dir), n_slots=2)
