"""The port's continuous-batching engine with per-slot speculation
(``TorchBatchedDecoderLM(spec_k > 0)``) against the JAX package's
``BatchedDecoderLM`` and the port's single-stream engines on the CPU,
float32, on the tiny Qwen2 checkpoint of ``tests/test_torch_decoder.py``
(``check_case``: ``tests/test_torch_batched_decoder.py``).

Greedy streams, concurrent, must be token-identical to JAX's engine's and to
the plain single-stream engine's, with ``legalrag_gen_tokens`` counting what
JAX's counts, in every case of ``tests/test_batched_spec.py`` and the
speculative ones of ``tests/test_shared_prefix.py`` (concurrency, slot
reuse, EOS, the exact budget, the headroom clamp, chunked admission, the
pinned prefix and its LRU), and with the corpus n-gram table, a draft model
(with the shared prefix too), ``kv_quant``, ``weight_quant``, the
repetition penalty and the JSON constraint. A sampled stream is the
single-stream speculative engine's for its seed, beside a greedy one."""

import threading

import pytest

from legalrag_tpu.models import batched_decoder as jbd
from legalrag_tpu.models.ngram_draft import NgramDraftTable as JaxTable
from legalrag_tpu_torch.models import decoder as td
from legalrag_tpu_torch.models.batched_decoder import TorchBatchedDecoderLM
from legalrag_tpu_torch.models.ngram_draft import NgramDraftTable
from legalrag_tpu_torch.models.spec_decode import TorchSpecLookupDecoderLM
from test_torch_batched_decoder import (CAND, LONG, SHARED, SUFFIXES, TAILS,
                                        check_case, concurrently, port_model,
                                        qwen)  # noqa: F401 (fixture)
from test_torch_constrain import (EOS, PROMPT as TOY_PROMPT,  # noqa: F401
                                  accepts, toy, toy_constraints, toy_text)
from test_torch_decoder import load_both, write_ckpt

SPROMPTS = [[5, 6, 7, 5, 6, 7, 5, 6],      # bigram repeats: drafts accepted
            [22, 81, 14, 60, 33],          # no structure: rejections
            [12, 41, 3, 3, 3, 9],
            [2, 2],
            [9, 10, 11, 9, 10]]
SPEC = dict(max_len=96, spec_k=4, spec_steps=2)


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """An uncorrelated draft model of the same vocabulary: one layer, 16
    wide (``tests/test_torch_spec_draft.py``'s)."""
    return load_both(write_ckpt(tmp_path_factory.mktemp("bdraft"), seed=99,
                                hidden_size=16, num_hidden_layers=1,
                                num_attention_heads=2, num_key_value_heads=1,
                                intermediate_size=32))


def draft_kw(small):
    """The draft model as each engine takes it."""
    (jparams, jcfg), _s, _c = small
    return dict(port_kw={"draft": port_model(small)},
                jax_kw={"draft": (jparams, jcfg)})


def tables(qwen):  # noqa: F811
    """The corpus n-gram table of the plain engine's own streams, in both
    packages' classes: drafts that the verify accepts."""
    ref = td.TorchDecoderLM(port_model(qwen), device="cpu", max_len=96)
    streams = [p + list(ref.generate_stream(p, 16)) for p in SPROMPTS]
    return dict(port_kw={"ngram_draft": NgramDraftTable.from_streams(
                    streams, k=4, log2_size=10)},
                jax_kw={"ngram_draft": JaxTable.from_streams(
                    streams, k=4, log2_size=10)})


# (engine settings, prompts, stream settings, weight bits, one by one)
CASES = {
    "concurrent": (SPEC | dict(n_slots=3), SPROMPTS[:3],
                   dict(max_new_tokens=12), 0, False),
    "slot_reuse": (SPEC | dict(n_slots=2), SPROMPTS,
                   dict(max_new_tokens=12), 0, False),
    "chunked_admission": (SPEC | dict(n_slots=2, prefill_chunk=16),
                          [LONG[0][:12] * 3, LONG[1][:21]],
                          dict(max_new_tokens=10), 0, False),
    "repetition_penalty": (SPEC | dict(n_slots=3), SPROMPTS[:3],
                           dict(max_new_tokens=12, repetition_penalty=1.5),
                           0, False),
    "kv_quant": (SPEC | dict(n_slots=2, kv_quant=True), SPROMPTS[:3],
                 dict(max_new_tokens=12), 0, False),
    "weight_quant_8": (SPEC | dict(n_slots=2), SPROMPTS[:3],
                       dict(max_new_tokens=12), 8, False),
    "weight_quant_4": (SPEC | dict(n_slots=2), SPROMPTS[:3],
                       dict(max_new_tokens=12), 4, False),
    "shared_prefix": (SPEC | dict(n_slots=2, shared_prefix=SHARED),
                      [SHARED + s for s in SUFFIXES[:2]],
                      dict(max_new_tokens=12), 0, False),
    "shared_prefix_with_lru": (SPEC | dict(n_slots=2, shared_prefix=SHARED,
                                           prefix_cache=4),
                               [SHARED + CAND + t for t in TAILS],
                               dict(max_new_tokens=12), 0, True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_spec_greedy_streams_match_jax_and_single_stream(qwen, case):  # noqa: F811
    engine_kw, prompts, gen_kw, bits, serial = CASES[case]
    port, jax_engine, _got = check_case(qwen, engine_kw, prompts, gen_kw,
                                        bits, serial)
    if case == "shared_prefix_with_lru":
        assert port._prefix_sfx.stats == jax_engine._prefix_sfx.stats
        assert port._prefix_sfx.stats["hits"] >= 2


@pytest.mark.parametrize("source", ["table", "draft_model",
                                    "draft_model_shared_prefix"])
def test_drafts_from_a_table_or_a_model(qwen, small, source):  # noqa: F811
    """The corpus table and a draft model (with its own slot cache, filled
    with the whole prompt also where the target's rows start past the
    pinned prefix) change acceptance only: the streams stay JAX's and the
    plain engine's."""
    if source == "table":
        check_case(qwen, SPEC | dict(n_slots=2), SPROMPTS[:3],
                   dict(max_new_tokens=15), **tables(qwen))
    elif source == "draft_model":
        check_case(qwen, SPEC | dict(n_slots=2), SPROMPTS,
                   dict(max_new_tokens=14), **draft_kw(small))
    else:
        shared = list(range(1, 9))
        check_case(qwen, SPEC | dict(n_slots=2, shared_prefix=shared),
                   [shared + [70, 71, 72], shared + [7, 9] * 4,
                    [60, 61, 62, 63]], dict(max_new_tokens=12), serial=True,
                   **draft_kw(small))


def test_a_self_draft_accepts_whole_rounds(qwen):  # noqa: F811
    """The target drafting for itself: every round the budget leaves whole
    emits k + 1 tokens, so a 16-token stream takes 3 rounds (the first
    token at admission), counted in ``legalrag_gen_spec_rounds``."""
    from legalrag_tpu_torch.utils.metrics import METRICS

    key = ("legalrag_gen_spec_rounds", (("engine", "batched-spec"),))
    ref = td.TorchDecoderLM(port_model(qwen), device="cpu", max_len=96)
    engine = TorchBatchedDecoderLM(port_model(qwen), device="cpu",
                                   draft=port_model(qwen), n_slots=2, **SPEC)
    try:
        before = METRICS._counters[key]
        got = list(engine.generate_stream(SPROMPTS[1], max_new_tokens=16))
        assert got == list(ref.generate_stream(SPROMPTS[1], 16))
        assert METRICS._counters[key] - before == 3      # 5 + 5 + 5
    finally:
        engine.close()


def test_spec_eos_budget_and_headroom(qwen):  # noqa: F811
    """EOS; exact budgets; ``spec_k`` rows of headroom clamp the budget and
    a prompt leaving none raises; a draft model without ``spec_k``
    raises; in both engines."""
    (jparams, jcfg), _s, _c = qwen
    ref = td.TorchDecoderLM(port_model(qwen), device="cpu", max_len=96)
    full = list(ref.generate_stream(SPROMPTS[0], 12))
    eos = full[4]
    for make in (lambda **kw: TorchBatchedDecoderLM(port_model(qwen),
                                                    device="cpu", **kw),
                 lambda **kw: jbd.BatchedDecoderLM(jparams, jcfg, **kw)):
        engine = make(n_slots=2, **(SPEC | dict(spec_steps=3)))
        small = make(max_len=24, n_slots=1, spec_k=4, spec_steps=2)
        try:
            assert list(engine.generate_stream(
                SPROMPTS[0], max_new_tokens=12, eos_id=eos)) == \
                full[:full.index(eos)]
            for n in (1, 2, 5, 11):
                assert len(list(engine.generate_stream(
                    SPROMPTS[2], max_new_tokens=n))) == n
            p = list(range(1, 13))   # 12 tokens: 24 - 12 - 4 = 8 left
            assert list(small.generate_stream(p, max_new_tokens=100)) == \
                list(ref.generate_stream(p, 8))
            with pytest.raises(ValueError):
                next(small.generate_stream(list(range(1, 21)),
                                           max_new_tokens=4))
        finally:
            engine.close()
            small.close()
    with pytest.raises(ValueError, match="requires spec_k"):
        TorchBatchedDecoderLM(port_model(qwen), device="cpu", max_len=96,
                              draft=port_model(qwen))


def test_sampled_slot_beside_a_greedy_one(qwen):  # noqa: F811
    """A greedy stream stays identical while a sampled one shares the
    batch; the sampled one is the single-stream speculative engine's
    for its seed, alone and in the batch."""
    kw = dict(max_new_tokens=10, temperature=0.9, seed=7)
    spec = TorchSpecLookupDecoderLM(port_model(qwen), device="cpu",
                                    max_len=96, spec_k=4, spec_steps=2)
    want = list(spec.generate_stream(SPROMPTS[1], **kw))
    ref = td.TorchDecoderLM(port_model(qwen), device="cpu", max_len=96)
    engine = TorchBatchedDecoderLM(port_model(qwen), device="cpu", n_slots=2,
                                   **SPEC)
    try:
        assert list(engine.generate_stream(SPROMPTS[1], **kw)) == want
        out = {}
        ts = [threading.Thread(target=lambda: out.setdefault(
                  "g", list(engine.generate_stream(SPROMPTS[0],
                                                   max_new_tokens=12)))),
              threading.Thread(target=lambda: out.setdefault(
                  "s", list(engine.generate_stream(SPROMPTS[1], **kw))))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=300)
        assert out["g"] == list(ref.generate_stream(SPROMPTS[0], 12))
        assert out["s"] == want and len(set(want)) > 2
    finally:
        engine.close()


def test_constrained_speculation_shares_the_batch(toy):  # noqa: F811
    """A constrained greedy stream through the batched verify (the
    per-slot DFA fold over the drafts, budget-forced) beside a free
    stream: both identical to JAX's batched engine's, the constrained one
    to the plain constrained engine's, a valid prefix."""
    (jparams, jcfg), state, cfg = toy
    pjc, jjc = toy_constraints()
    prompts = [TOY_PROMPT, TOY_PROMPT[:6]]
    kws = [dict(max_new_tokens=30, eos_id=EOS, constrain=True),
           dict(max_new_tokens=12)]
    streams = []
    for engine in (TorchBatchedDecoderLM(
            td.DecoderModel.from_state_dict(cfg, state), device="cpu",
            n_slots=2, json_constraint=pjc, **SPEC),
            jbd.BatchedDecoderLM(jparams, jcfg, n_slots=2,
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
    ref = td.TorchDecoderLM(td.DecoderModel.from_state_dict(cfg, state),
                            device="cpu", max_len=96, json_constraint=pjc)
    for got, p, k in zip(streams[0], prompts, kws):
        assert got == list(ref.generate_stream(p, **k))
    assert accepts(toy_text(streams[0][0])) is not None
    assert len(set(streams[0][0])) >= 4


def test_engine_metrics_are_jax_names(qwen):  # noqa: F811
    """``legalrag_gen_launches`` is counted under JAX's ``engine`` and
    ``occupancy`` labels."""
    from legalrag_tpu_torch.utils.metrics import METRICS

    before = dict(METRICS._counters)
    engine = TorchBatchedDecoderLM(port_model(qwen), device="cpu", n_slots=2,
                                   **SPEC)
    try:
        concurrently(engine, SPROMPTS[:2], max_new_tokens=4)
    finally:
        engine.close()
    counted = [dict(k[1]) for k, n in METRICS._counters.items()
               if k[0] == "legalrag_gen_launches" and n > before.get(k, 0)]
    assert counted and all(c["engine"] == "batched-spec"
                           and c["occupancy"] in (1, 2) for c in counted)
