"""The port's continuous-batching engine (``legalrag_tpu_torch/models/
batched_decoder.py``, ``TorchBatchedDecoderLM``) against the JAX package's
``BatchedDecoderLM`` and the port's single-stream ``TorchDecoderLM`` on the
CPU, float32, on the tiny Qwen2 checkpoint of ``tests/test_torch_decoder.py``
(speculation: ``tests/test_torch_batched_spec.py``).

Greedy streams, run concurrently from one thread each, must be
token-identical to JAX's engine's on the same traffic and to the port's
single-stream engine's, and ``legalrag_gen_tokens`` must count what JAX's
counts, in every case of ``tests/test_batched_decoder.py`` and
``tests/test_shared_prefix.py`` (concurrency, slot reuse, a mid-flight
join, EOS, the budget, cancellation, chunked admission, prefix hits, the
pinned shared prefix matched and not, with its LRU) and with ``kv_quant``,
``weight_quant`` 8 and 4, the repetition penalty and the JSON constraint. A
sampled stream's tokens depend on its seed alone: the same alone and beside
others, in any slot, and the single-stream engine's for that seed. Last,
``local-jax`` with ``batch_slots`` serves this engine and answers as JAX's
client does."""

import threading

import numpy as np
import pytest
import torch

from legalrag_tpu.config import LLMConfig as JaxLLMConfig
from legalrag_tpu.llm.client import LLMClient as JaxLLMClient
from legalrag_tpu.llm.gateway import LLMGateway as JaxGateway
from legalrag_tpu.models import batched_decoder as jbd
from legalrag_tpu.utils.metrics import METRICS as JAX_METRICS
from legalrag_tpu_torch.config import LLMConfig
from legalrag_tpu_torch.llm import DEGRADED_ANSWER
from legalrag_tpu_torch.llm.client import (
    LLMClient,
    LLMUnavailable,
    unported_engine_knobs,
)
from legalrag_tpu_torch.llm.gateway import LLMGateway
from legalrag_tpu_torch.models import decoder as td
from legalrag_tpu_torch.models.batched_decoder import TorchBatchedDecoderLM
from legalrag_tpu_torch.utils.metrics import METRICS
from test_torch_bpe import rag_messages
from test_torch_constrain import (EOS, PROMPT as TOY_PROMPT,  # noqa: F401
                                  accepts, toy, toy_constraints, toy_text)
from test_torch_decoder import load_both, write_ckpt
from test_torch_decoder_quant import carried
from test_torch_generation import (  # noqa: F401 (model_dir: a fixture)
    DEVICE_COUNTS, llm_kw, model_dir)
from test_torch_server import llm_on_both, served, sse  # noqa: F401

PROMPTS = [[1, 2, 3], [4, 5, 6, 7, 8], [9, 10], [11, 12, 13, 14],
           [15, 16, 17, 18, 19, 20]]
SHARED = list(range(40, 60)) + [3, 9, 3, 9]     # a 24-token prelude
SUFFIXES = [[70, 71, 72], [80, 81, 82, 83, 84], [7, 9, 3, 9]]
OTHER = [11, 12, 13, 14, 15]                    # does not start with it
CAND = [33, 34, 35, 36] * 5                     # a repeated candidate block
TAILS = [[70, 71], [80, 81, 82], [7, 9]]
_rng = np.random.default_rng(41)
LONG = [_rng.integers(1, 90, n).tolist() for n in (17, 33, 45)]


@pytest.fixture(scope="module")
def qwen(tmp_path_factory):
    """((JAX params, config), port state, port config) of the tiny Qwen2."""
    return load_both(write_ckpt(tmp_path_factory.mktemp("batched"), seed=0))


def port_model(ckpt, state=None):
    _j, st, cfg = ckpt
    return td.DecoderModel.from_state_dict(cfg, st if state is None else state)


def concurrently(engine, prompts, **kw):
    """One ``generate_stream`` per prompt, each on its own thread."""
    out = {}

    def run(i, p):
        out[i] = list(engine.generate_stream(list(p), **kw))

    threads = [threading.Thread(target=run, args=(i, p))
               for i, p in enumerate(prompts)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    return [out.get(i) for i in range(len(prompts))]


def one_by_one(engine, prompts, **kw):
    return [list(engine.generate_stream(list(p), **kw)) for p in prompts]


def gen_tokens(metrics, engine: str) -> float:
    return metrics._counters[("legalrag_gen_tokens", (("engine", engine),))]


def check_case(ckpt, engine_kw, prompts, gen_kw, bits=0, serial=False,
               port_kw=None, jax_kw=None):
    """The port's and JAX's batched engines on the same traffic (concurrent,
    or one prompt after another with ``serial``; ``port_kw`` / ``jax_kw``
    each engine's own settings, such as a draft model), and the port's
    single-stream engine on each prompt: every stream identical, and
    ``legalrag_gen_tokens`` counting the same. Returns (port engine,
    JAX engine, the streams); both engines are closed."""
    (jparams, jcfg), state, _cfg = ckpt
    jq, qstate = carried(jparams, bits) if bits else (jparams, state)
    run = one_by_one if serial else concurrently
    engine = "batched-spec" if engine_kw.get("spec_k") else "batched"
    port = TorchBatchedDecoderLM(port_model(ckpt, qstate), device="cpu",
                                 **engine_kw, **(port_kw or {}))
    jax_engine = jbd.BatchedDecoderLM(jq, jcfg, **engine_kw, **(jax_kw or {}))
    try:
        before = gen_tokens(METRICS, engine), gen_tokens(JAX_METRICS, engine)
        got = run(port, prompts, **gen_kw)
        want = run(jax_engine, prompts, **gen_kw)
        assert got == want
        assert (gen_tokens(METRICS, engine) - before[0]
                == gen_tokens(JAX_METRICS, engine) - before[1]
                == sum(map(len, got)))
    finally:
        port.close()
        jax_engine.close()
    ref = td.TorchDecoderLM(port_model(ckpt, qstate), device="cpu",
                            max_len=engine_kw["max_len"],
                            kv_quant=engine_kw.get("kv_quant", False))
    assert got == one_by_one(ref, prompts, **gen_kw)
    assert any(len(set(s)) >= 4 for s in got), got
    return port, jax_engine, got


# (engine settings, prompts, stream settings, weight bits, one by one)
CASES = {
    "concurrent": (dict(max_len=48, n_slots=3, decode_chunk=4), PROMPTS[:3],
                   dict(max_new_tokens=10), 0, False),
    "slot_reuse": (dict(max_len=48, n_slots=2, decode_chunk=4), PROMPTS,
                   dict(max_new_tokens=10), 0, False),
    "chunked_admission": (dict(max_len=64, n_slots=2, decode_chunk=4,
                               prefill_chunk=16), LONG,
                          dict(max_new_tokens=8), 0, False),
    "kv_quant": (dict(max_len=48, n_slots=2, decode_chunk=4, kv_quant=True),
                 PROMPTS[:3], dict(max_new_tokens=10), 0, False),
    "weight_quant_8": (dict(max_len=48, n_slots=2, decode_chunk=4),
                       PROMPTS[:3], dict(max_new_tokens=10), 8, False),
    "weight_quant_4_kv_quant": (dict(max_len=48, n_slots=2, decode_chunk=4,
                                     kv_quant=True), PROMPTS[:3],
                                dict(max_new_tokens=10), 4, False),
    "repetition_penalty": (dict(max_len=48, n_slots=3, decode_chunk=4),
                           PROMPTS[:3], dict(max_new_tokens=12,
                                             repetition_penalty=1.5), 0,
                           False),
    "prefix_cache": (dict(max_len=96, n_slots=2, decode_chunk=4,
                          prefix_cache=2), [CAND + t for t in TAILS],
                     dict(max_new_tokens=10), 0, True),
    "shared_prefix": (dict(max_len=96, n_slots=3, decode_chunk=4,
                           shared_prefix=SHARED),
                      [SHARED + s for s in SUFFIXES], dict(max_new_tokens=12),
                      0, False),
    "shared_prefix_mixed": (dict(max_len=96, n_slots=2, decode_chunk=4,
                                 shared_prefix=SHARED),
                            [SHARED + SUFFIXES[0], OTHER],
                            dict(max_new_tokens=12), 0, False),
    "shared_prefix_kv_quant": (dict(max_len=96, n_slots=2, decode_chunk=4,
                                    kv_quant=True, shared_prefix=SHARED),
                               [SHARED + s for s in SUFFIXES[:2]],
                               dict(max_new_tokens=10), 0, False),
    "shared_prefix_long_suffix_chunks_penalty": (
        dict(max_len=128, n_slots=2, decode_chunk=4, prefill_chunk=16,
             shared_prefix=SHARED), [SHARED + LONG[2][:40]],
        dict(max_new_tokens=10, repetition_penalty=1.5), 0, False),
    "shared_prefix_with_lru": (dict(max_len=96, n_slots=2, decode_chunk=4,
                                    shared_prefix=SHARED, prefix_cache=4),
                               [SHARED + CAND + t for t in TAILS],
                               dict(max_new_tokens=12), 0, True),
    "shared_prefix_nonmatching_full_lru": (
        dict(max_len=96, n_slots=2, decode_chunk=4, shared_prefix=SHARED,
             prefix_cache=4), [[61, 62] + CAND + t for t in TAILS[:2]],
        dict(max_new_tokens=10), 0, True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_greedy_streams_match_jax_and_single_stream(qwen, case):
    engine_kw, prompts, gen_kw, bits, serial = CASES[case]
    port, _j, _got = check_case(qwen, engine_kw, prompts, gen_kw, bits,
                                serial)
    if case == "prefix_cache":
        assert port.prefix_stats["hits"] == 2
    if case == "shared_prefix_with_lru":
        st = port._prefix_sfx.stats
        assert st["hits"] >= 2 and st["saved_tokens"] >= 2 * len(CAND), st
    if case == "shared_prefix_nonmatching_full_lru":
        assert port.prefix_stats["hits"] >= 1
        assert port._prefix_sfx.stats["hits"] == 0
    if "kv_quant" in case:
        assert port._cache[0][0].dtype == torch.int8
    if case == "shared_prefix_kv_quant":
        assert port._shared_kv[0][0].dtype == torch.int8


def test_mid_flight_join(qwen):
    """A stream joining while another decodes disturbs neither."""
    (jparams, jcfg), _s, _c = qwen
    ref = td.TorchDecoderLM(port_model(qwen), device="cpu", max_len=64)
    want = (list(ref.generate_stream(PROMPTS[0], 24)),
            list(ref.generate_stream(PROMPTS[1], 10)))
    for engine in (TorchBatchedDecoderLM(port_model(qwen), device="cpu",
                                         max_len=64, n_slots=2,
                                         decode_chunk=2),
                   jbd.BatchedDecoderLM(jparams, jcfg, max_len=64, n_slots=2,
                                        decode_chunk=2)):
        try:
            first, second = [], []
            gen_a = engine.generate_stream(PROMPTS[0], max_new_tokens=24)
            first.append(next(gen_a))          # A decodes; B joins now
            th = threading.Thread(target=lambda: second.extend(
                engine.generate_stream(PROMPTS[1], max_new_tokens=10)))
            th.start()
            first.extend(gen_a)
            th.join(timeout=300)
            assert (first, second) == want
        finally:
            engine.close()


def test_eos_budget_and_prompt_validation(qwen):
    """EOS ends a stream before it; the budget is clamped to the cache;
    a prompt that does not fit raises, in both engines."""
    (jparams, jcfg), _s, _c = qwen
    ref = td.TorchDecoderLM(port_model(qwen), device="cpu", max_len=48)
    full = list(ref.generate_stream(PROMPTS[0], 10))
    eos = full[4]
    long_prompt = list(range(1, 13))
    for make in (lambda **kw: TorchBatchedDecoderLM(port_model(qwen),
                                                    device="cpu", **kw),
                 lambda **kw: jbd.BatchedDecoderLM(jparams, jcfg, **kw)):
        engine = make(max_len=48, n_slots=2, decode_chunk=4)
        small = make(max_len=16, n_slots=1, decode_chunk=4)
        try:
            got = list(engine.generate_stream(PROMPTS[0], max_new_tokens=10,
                                              eos_id=eos))
            assert got == full[:full.index(eos)]
            with pytest.raises(ValueError):
                list(small.generate_stream(list(range(1, 20)),
                                           max_new_tokens=4))
            got = list(small.generate_stream(long_prompt, max_new_tokens=100))
            assert got == list(ref.generate_stream(long_prompt, 4))
        finally:
            engine.close()
            small.close()
    shared = TorchBatchedDecoderLM(port_model(qwen), device="cpu", max_len=96,
                                   n_slots=2, decode_chunk=4,
                                   shared_prefix=SHARED)
    try:
        # an unshared prompt has max_len - P rows
        huge = list(shared.generate_stream(OTHER, max_new_tokens=1000))
        assert len(huge) == 96 - len(SHARED) - len(OTHER)
    finally:
        shared.close()
    with pytest.raises(ValueError, match="leaves no slot budget"):
        TorchBatchedDecoderLM(port_model(qwen), device="cpu", max_len=32,
                              shared_prefix=list(range(1, 31)))


def test_cancellation_frees_the_slot_and_close(qwen):
    ref = td.TorchDecoderLM(port_model(qwen), device="cpu", max_len=48)
    engine = TorchBatchedDecoderLM(port_model(qwen), device="cpu", max_len=48,
                                   n_slots=1, decode_chunk=2)
    try:
        gen = engine.generate_stream(PROMPTS[0], max_new_tokens=10)
        assert next(gen) == list(ref.generate_stream(PROMPTS[0], 1))[0]
        gen.close()                     # a client gone mid-generation
        got = list(engine.generate_stream(PROMPTS[1], max_new_tokens=10))
        assert got == list(ref.generate_stream(PROMPTS[1], 10))
    finally:
        engine.close()
    engine.close()                      # idempotent
    with pytest.raises(RuntimeError, match="closed"):
        next(engine.generate_stream([1, 2], max_new_tokens=2))


def test_chunked_admission_skips_long_suffix_prefix_hits(qwen):
    """A prefix hit whose suffix exceeds prefill_chunk takes the chunked
    path, as JAX's engine does."""
    rng = np.random.default_rng(43)
    donor = rng.integers(1, 90, 40).tolist()
    probe = donor[:20] + rng.integers(1, 90, 25).tolist()
    port, jax_engine, _g = check_case(
        qwen, dict(max_len=96, n_slots=1, decode_chunk=4, prefill_chunk=16,
                   prefix_cache=2), [donor, probe], dict(max_new_tokens=8),
        serial=True)
    # the LRU matched (and counted) the hit that admission then dropped
    assert port.prefix_stats == jax_engine._prefix.stats
    assert port.prefix_stats["saved_tokens"] == 20


def test_cache_bytes_shrink_with_the_shared_prefix(qwen):
    """The slot rows shrink by P; the pinned segment is one copy, about a
    slot's share of the per-slot alternative."""
    plain = TorchBatchedDecoderLM(port_model(qwen), device="cpu", max_len=96,
                                  n_slots=3)
    shared = TorchBatchedDecoderLM(port_model(qwen), device="cpu", max_len=96,
                                   n_slots=3, shared_prefix=SHARED)
    try:
        assert shared._cache[0][0].shape[1] == 96 - len(SHARED)
        pinned = sum(a.numel() * a.element_size()
                     for layer in shared._shared_kv for a in layer)
        assert shared.cache_bytes < plain.cache_bytes
        assert pinned <= plain.cache_bytes * len(SHARED) // 96 // 3 * 1.01
    finally:
        plain.close()
        shared.close()


def test_sampled_streams_depend_on_their_seed_alone(qwen):
    """A sampled stream is the single-stream engine's for its seed: alone,
    beside three others (greedy and sampled, other seeds and warpers) in
    another slot, and joining mid-flight."""
    kw = dict(max_new_tokens=10, temperature=0.8, top_p=0.9, seed=3)
    ref = td.TorchDecoderLM(port_model(qwen), device="cpu", max_len=48)
    want = list(ref.generate_stream(PROMPTS[2], **kw))
    engine = TorchBatchedDecoderLM(port_model(qwen), device="cpu", max_len=48,
                                   n_slots=4, decode_chunk=4)
    try:
        assert list(engine.generate_stream(PROMPTS[2], **kw)) == want
        out = {}
        others = [(PROMPTS[0], dict(max_new_tokens=12)),
                  (PROMPTS[1], dict(max_new_tokens=12, temperature=1.2,
                                    top_k=5, seed=9)),
                  (PROMPTS[3], dict(max_new_tokens=12, temperature=0.5,
                                    min_p=0.1, seed=3))]
        gens = [engine.generate_stream(p, **k) for p, k in others]
        firsts = [next(g) for g in gens]      # three slots decoding
        th = threading.Thread(target=lambda: out.setdefault(
            "s", list(engine.generate_stream(PROMPTS[2], **kw))))
        th.start()
        rest = [f + list(g) for f, g in zip([[x] for x in firsts], gens)]
        th.join(timeout=300)
        assert out["s"] == want
        for (p, k), got in zip(others, rest):
            assert got == list(ref.generate_stream(p, **k))
    finally:
        engine.close()


def test_constrained_and_free_streams_share_the_batch(toy):  # noqa: F811
    """A constrained stream (29 tokens at a penalty, beside an
    unconstrained one) identical to JAX's batched engine's and to the
    single-stream engine's, a valid prefix of a sections document; the
    free stream untouched."""
    (jparams, jcfg), state, cfg = toy
    pjc, jjc = toy_constraints()
    free = TOY_PROMPT[:6]
    kws = [dict(max_new_tokens=29, eos_id=EOS, constrain=True,
                repetition_penalty=1.3), dict(max_new_tokens=12)]
    streams = []
    for engine in (TorchBatchedDecoderLM(
            td.DecoderModel.from_state_dict(cfg, state), device="cpu",
            max_len=96, n_slots=2, decode_chunk=4, json_constraint=pjc),
            jbd.BatchedDecoderLM(jparams, jcfg, max_len=96, n_slots=2,
                                 decode_chunk=4, json_constraint=jjc)):
        out = {}
        try:
            ts = [threading.Thread(target=lambda i=i, p=p: out.setdefault(
                i, list(engine.generate_stream(p, **kws[i]))))
                for i, p in enumerate([TOY_PROMPT, free])]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=300)
        finally:
            engine.close()
        streams.append((out[0], out[1]))
    assert streams[0] == streams[1]
    ref = td.TorchDecoderLM(td.DecoderModel.from_state_dict(cfg, state),
                            device="cpu", max_len=96, json_constraint=pjc)
    assert streams[0][0] == list(ref.generate_stream(TOY_PROMPT, **kws[0]))
    assert streams[0][1] == list(ref.generate_stream(free, **kws[1]))
    assert accepts(toy_text(streams[0][0])) is not None
    assert len(set(streams[0][0])) >= 4


# ------------------------------------------------------------ the client

@pytest.fixture(scope="module")
def batched_clients(model_dir):  # noqa: F811
    """(the port's ``local-jax`` client with ``batch_slots`` 4 on the CPU,
    the JAX package's), both loaded."""
    kw = llm_kw(model_dir, batch_slots=4, prefix_cache=2)
    cfg = LLMConfig(**kw)
    assert unported_engine_knobs(cfg) == []
    port = LLMClient(cfg, device="cpu")
    jax_client = JaxLLMClient(JaxLLMConfig(**kw))
    lm = port._load_jax_lm()
    assert isinstance(lm, TorchBatchedDecoderLM)
    assert (lm.n_slots, lm.spec_k, lm.max_len) == (4, 0, kw["max_context_tokens"]
                                                  + kw["max_new_tokens"])
    yield port, jax_client
    port.close()
    jax_client.close()


def test_concurrent_chats_match_jax(batched_clients, zh_chunks):
    """Four zh RAG chats streamed at once through each client: every
    stream's chunks equal to JAX's, none degraded."""
    port, jax_client = batched_clients
    chats = [rag_messages(q, zh_chunks[i:i + 3]) for i, q in enumerate(
        ["合同在什么情况下可以解除？", "借款合同的利息如何约定？",
         "租赁期限届满后承租人应当如何返还租赁物？", "什么是不可抗力？"])]
    got = concurrently_chat(port, chats)
    assert got == concurrently_chat(jax_client, chats)
    for msgs, chunks in zip(chats, got):
        assert "".join(chunks) and chunks[0] != port.degraded_answer(msgs)


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


def test_rag_answer_sse_matches_jax(served, llm_on_both,  # noqa: F811
                                   batched_clients):
    """``/rag/answer`` as SSE through both servers with ``local-jax`` and
    ``batch_slots`` 4: the same events, token texts included."""
    jc, pc, _cfg = served
    port, jax_client = batched_clients
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
    (dict(paged_kv=True, prefix_cache=2), "prefix_cache"),
    (dict(tp_shards=2), "tp_shards"),
    (dict(dp_replicas=2), "dp_replicas"),
    (dict(spec_k=4, spec_adaptive=1.5), "spec_adaptive")])
def test_batch_slots_with_unported_knobs_degrade(model_dir, settings,
                                                 refused):  # noqa: F811
    """With ``batch_slots`` 4 a ``spec_adaptive`` that JAX's batched
    engine ignores and a ``prefix_cache`` that JAX's client drops under
    ``paged_kv`` fail the load naming the knob, and so do TP and DP above
    the one visible device (JAX's client fails there too:
    ``tests/test_torch_generation.py``); the answer degrades."""
    cfg = LLMConfig(**llm_kw(model_dir, batch_slots=4, **settings))
    assert unported_engine_knobs(cfg) == (
        [] if refused in DEVICE_COUNTS else [refused])
    c = LLMClient(cfg, device="cpu")
    with pytest.raises(LLMUnavailable, match=refused):
        c._load_jax_lm()
    msgs = [{"role": "user", "content": "合同可以解除吗"}]
    assert c.chat(msgs) == DEGRADED_ANSWER["zh"]


def test_shared_prefix_text_is_tokenized_and_pinned(model_dir,  # noqa: F811
                                                   monkeypatch):
    """``shared_prefix_text`` becomes the tokenizer's ids, pinned; the
    batched load runs on ``cuda`` unless given the CPU."""
    text = "<|im_start|>system\n你是法律助手"
    lm = TorchBatchedDecoderLM.from_pretrained(
        str(model_dir), device="cpu", max_len=256, n_slots=2,
        shared_prefix_text=text)
    try:
        ids = lm.tokenizer(text)["input_ids"]
        assert lm.shared_prefix == ids and lm.shared_len == len(ids) > 0
        assert lm._cache[0][0].shape[1] == 256 - len(ids)
        assert lm._matches_shared(ids + [5]) and not lm._matches_shared([5])
    finally:
        lm.close()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchBatchedDecoderLM.from_pretrained(str(model_dir), n_slots=2)
