"""Speculation over block tables in the port's paged engine
(``TorchPagedDecoderLM(spec_k > 0)``) against the JAX package's
``PagedDecoderLM`` on the CPU, float32, on the tiny config of
``tests/test_paged_spec.py`` (``check_case``:
``tests/test_torch_paged_decoder.py``).

In every case of ``tests/test_paged_spec.py`` (concurrency, slot reuse,
EOS, the exact budget, a sampled slot beside a greedy one, the headroom
clamp, radix reuse, the corpus n-gram table, a draft model and its
refusal without ``spec_k``, chunked admission, the client's plumbing, the
JSON constraint) the greedy streams must be token-identical to JAX's
engine's on the same traffic, to the port's batched engine's and to the
plain single-stream engine's, with ``paged_stats`` and the paged and
``legalrag_gen_tokens`` counters equal to JAX's."""

import threading

import numpy as np
import pytest

from legalrag_tpu.config import LLMConfig as JaxLLMConfig
from legalrag_tpu.llm.client import LLMClient as JaxLLMClient
from legalrag_tpu.models import constrain as jcons
from legalrag_tpu.models import paged_decoder as jpd
from legalrag_tpu.models.ngram_draft import NgramDraftTable as JaxTable
from legalrag_tpu_torch.config import LLMConfig
from legalrag_tpu_torch.llm.client import LLMClient
from legalrag_tpu_torch.models import constrain as tcons
from legalrag_tpu_torch.models import decoder as td
from legalrag_tpu_torch.models import paged_decoder as tpd
from legalrag_tpu_torch.models.ngram_draft import NgramDraftTable
from legalrag_tpu_torch.models.spec_decode import TorchSpecLookupDecoderLM
from test_torch_paged_decoder import (check_case, one_by_one, port_model,
                                      run_both, tiny_pair)

PROMPTS = [[5, 6, 7, 5, 6, 7, 5, 6],      # bigram structure: accepts
           [22, 81, 14, 60, 33],           # varied: rejections
           [12, 41, 3, 3, 3, 9],
           [2, 2],
           [9, 10, 11, 9, 10]]
SPEC = dict(max_len=96, block_size=16, spec_k=4, spec_steps=2)
DRAFT = dict(hidden_size=16, num_hidden_layers=1, num_attention_heads=2,
             num_key_value_heads=1, intermediate_size=32,
             max_position_embeddings=128)


@pytest.fixture(scope="module")
def tiny():
    return tiny_pair(23, max_position_embeddings=128)


@pytest.fixture(scope="module")
def draft():
    """``tests/test_paged_spec.py``'s draft model (seed 99), both ways."""
    return tiny_pair(99, **DRAFT)


def plain(pair, max_len=96):
    return td.TorchDecoderLM(port_model(pair), device="cpu", max_len=max_len)


_rng = np.random.default_rng(47)
CHUNKED = [list(_rng.integers(1, 90, 12)) * 3, list(_rng.integers(1, 90, 21))]
BASE = list(np.random.default_rng(3).integers(1, 90, 37))

# (engine settings, prompts, stream settings, one by one)
CASES = {
    "concurrent": (SPEC | dict(n_slots=3), PROMPTS[:3],
                   dict(max_new_tokens=12), False),
    "slot_reuse": (SPEC | dict(n_slots=2), PROMPTS, dict(max_new_tokens=12),
                   False),
    "chunked_admission": (SPEC | dict(n_slots=2, prefill_chunk=16), CHUNKED,
                          dict(max_new_tokens=10), False),
    "radix_reuse": (SPEC | dict(n_slots=1), [BASE + [7, 8], BASE + [9]],
                    dict(max_new_tokens=10), True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_spec_greedy_streams_match_jax_batched_and_single_stream(tiny, case):
    engine_kw, prompts, gen_kw, serial = CASES[case]
    _got, stats = check_case(tiny, engine_kw, prompts, gen_kw, serial)
    assert stats["reserved_blocks"] == 0
    if case == "radix_reuse":
        # the 37-token shared prefix: 2 full 16-token blocks reused
        assert stats["reused_blocks"] >= 2, stats


def test_spec_eos(tiny):
    ref = list(plain(tiny).generate_stream(PROMPTS[0], 12))
    eos = ref[4]
    got, _stats = run_both(tiny, SPEC | dict(n_slots=2), one_by_one,
                           [PROMPTS[0]], dict(max_new_tokens=12, eos_id=eos))
    assert got[0] == ref[:ref.index(eos)]


def test_spec_budget_exact(tiny):
    """Budgets of 1, 2, 5 and 11 tokens end exactly there, in both
    engines alike, on the plain engine's tokens."""
    ref = list(plain(tiny).generate_stream(PROMPTS[2], 11))
    for n in (1, 2, 5, 11):
        got, _stats = run_both(tiny, SPEC | dict(n_slots=2, spec_steps=3),
                               one_by_one, [PROMPTS[2]],
                               dict(max_new_tokens=n))
        assert got[0] == ref[:n], n


def test_spec_mixed_greedy_and_sampled(tiny):
    """A greedy slot stays the plain engine's while a sampled slot shares
    the speculative batch; the sampled one is the single-stream
    speculative engine's for its seed."""
    kw = dict(max_new_tokens=10, temperature=0.9, seed=7)
    spec = TorchSpecLookupDecoderLM(port_model(tiny), device="cpu",
                                    max_len=96, spec_k=4, spec_steps=2)
    want = list(spec.generate_stream(PROMPTS[1], **kw))
    engine = tpd.TorchPagedDecoderLM(port_model(tiny), device="cpu",
                                     n_slots=2, **SPEC)
    try:
        out = {}
        ts = [threading.Thread(target=lambda: out.setdefault(
                  "g", list(engine.generate_stream(PROMPTS[0],
                                                   max_new_tokens=12)))),
              threading.Thread(target=lambda: out.setdefault(
                  "s", list(engine.generate_stream(PROMPTS[1], **kw))))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=300)
    finally:
        engine.close()
    assert out["g"] == list(plain(tiny).generate_stream(PROMPTS[0], 12))
    assert out["s"] == want and len(want) == 10
    assert all(0 <= t < 97 for t in want)


def test_spec_headroom_budget_clamp(tiny):
    """``spec_k`` rows of headroom: a 12-token prompt in a 32-token cache
    gets 16 tokens, a 28-token one raises, in both engines."""
    p = list(range(1, 13))
    got, _stats = run_both(tiny, SPEC | dict(max_len=32, block_size=8,
                                             n_slots=1), one_by_one, [p],
                           dict(max_new_tokens=100))
    assert got[0] == list(plain(tiny, 32).generate_stream(p, 16))
    for engine in (tpd.TorchPagedDecoderLM(
            port_model(tiny), device="cpu", n_slots=1,
            **(SPEC | dict(max_len=32, block_size=8))),
            jpd.PagedDecoderLM(*tiny[0], n_slots=1,
                               **(SPEC | dict(max_len=32, block_size=8)))):
        try:
            with pytest.raises(ValueError):
                next(engine.generate_stream(list(range(1, 29)),
                                            max_new_tokens=4))
        finally:
            engine.close()


def test_spec_ngram_table_parity(tiny):
    """A corpus table of streams unrelated to the model changes only
    acceptance."""
    rng = np.random.default_rng(3)
    streams = [rng.integers(0, 97, 64).tolist() for _ in range(8)]
    check_case(tiny, SPEC | dict(n_slots=2), PROMPTS[:3],
               dict(max_new_tokens=12),
               port_kw={"ngram_draft": NgramDraftTable.from_streams(
                   streams, k=4, log2_size=10)},
               jax_kw={"ngram_draft": JaxTable.from_streams(
                   streams, k=4, log2_size=10)})


def test_spec_draft_model_parity(tiny, draft):
    """Draft-model speculation over block tables (the draft's cache
    contiguous): any draft gives the plain engine's greedy streams."""
    check_case(tiny, SPEC | dict(n_slots=2), PROMPTS[:3],
               dict(max_new_tokens=12), port_kw={"draft": port_model(draft)},
               jax_kw={"draft": draft[0]})


def test_spec_draft_requires_spec_k(tiny, draft):
    with pytest.raises(ValueError, match="requires spec_k"):
        tpd.TorchPagedDecoderLM(port_model(tiny), device="cpu", max_len=96,
                                block_size=16, draft=port_model(draft))
    with pytest.raises(ValueError):
        jpd.PagedDecoderLM(*tiny[0], max_len=96, block_size=16,
                           draft=draft[0])


def test_client_plumbs_paged_spec(monkeypatch):
    """``paged_kv`` with ``spec_k`` loads the paged engine with the JAX
    client's settings (``max_len`` rounded up to the block size, no
    ``prefix_cache``), on ``cuda`` unless told the CPU."""
    captured = {}

    def fake(key):
        def load(name, **kw):
            captured[key] = kw
            return object()
        return staticmethod(load)

    monkeypatch.setattr(tpd.TorchPagedDecoderLM, "from_pretrained",
                        fake("port"))
    monkeypatch.setattr(jpd.PagedDecoderLM, "from_pretrained", fake("jax"))
    kw = dict(provider="local-jax", batch_slots=2, spec_k=4, paged_kv=True,
              draft_model="tiny-draft", max_context_tokens=1000)
    LLMClient(LLMConfig(**kw))._load_jax_lm()
    JaxLLMClient(JaxLLMConfig(**kw))._load_jax_lm()
    port = captured["port"]
    assert port.pop("device") is None
    assert port == captured["jax"]
    assert port["spec_k"] == 4 and port["n_slots"] == 2
    assert port["draft_model"] == "tiny-draft"
    assert "prefix_cache" not in port
    assert port["max_len"] == -(-(1000 + LLMConfig().max_new_tokens)
                                // 64) * 64


TEXTS = [None, '{"sections"', ': [', '{"heading"', ': "', 'law', '第五百条',
         '", "items": ["', '", "', '"]}', ', ', ']}', ' ', 'b', '[]}']


def test_spec_constrained_stream_valid():
    """A constrained stream through paged speculation, beside a free one:
    both JAX's engine's, the free one the plain engine's, the constrained
    one the plain constrained engine's and a prefix of a schema-valid
    document (complete on EOS)."""
    pair = tiny_pair(83, vocab_size=len(TEXTS), tie_word_embeddings=True,
                     max_position_embeddings=128)
    tb = [t.encode("utf-8") if t else None for t in TEXTS]
    pjc = tcons.JsonConstraint.from_schema(tcons.SECTIONS_SCHEMA, tb,
                                           device="cpu")
    jjc = jcons.JsonConstraint.from_schema(jcons.SECTIONS_SCHEMA, tb)
    kws = [dict(max_new_tokens=40, eos_id=0, constrain=True),
           dict(max_new_tokens=12)]
    prompts = [[12, 14, 12], [12, 14]]
    streams = []
    for engine in (tpd.TorchPagedDecoderLM(port_model(pair), device="cpu",
                                           n_slots=2, json_constraint=pjc,
                                           **SPEC),
                   jpd.PagedDecoderLM(*pair[0], n_slots=2,
                                      json_constraint=jjc, **SPEC)):
        out = {}
        try:
            ts = [threading.Thread(target=lambda i=i: out.setdefault(
                i, list(engine.generate_stream(prompts[i], **kws[i]))))
                for i in range(2)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=300)
        finally:
            engine.close()
        streams.append((out[0], out[1]))
    assert streams[0] == streams[1]
    got = streams[0]
    ref = td.TorchDecoderLM(port_model(pair), device="cpu", max_len=96,
                            json_constraint=pjc)
    assert got[0] == list(ref.generate_stream(prompts[0], **kws[0]))
    assert got[1] == list(ref.generate_stream(prompts[1], **kws[1]))
    trans, acc = jcons.build_schema_dfa(jcons.SECTIONS_SCHEMA)
    text = "".join(TEXTS[t] for t in got[0] if TEXTS[t])
    st = 0
    for bt in text.encode("utf-8"):
        st = trans[st, bt]
        assert st >= 0, f"invalid constrained output: {text!r}"
    if len(got[0]) < 40:
        assert bool(acc[st]), text
    assert len(set(got[0])) >= 4
