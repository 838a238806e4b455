"""The port's paged engine (``legalrag_tpu_torch/models/paged_decoder.py``,
``TorchPagedDecoderLM``) against the JAX package's ``PagedDecoderLM`` on the
CPU, float32, on JAX's tiny config (``tests/test_paged_decoder.py``), its
weights carried across with ``decoder_params_from_jax``.

In every case of ``tests/test_paged_decoder.py`` (concurrency, slot reuse,
radix reuse of a shared prefix, identical prompts sharing blocks, eviction
under a small pool, admission waiting for blocks, EOS, the budget,
cancellation, sampling, the int8 cache, chunked admission, validation and
close, the sentinel blocks) the greedy streams must be token-identical to
JAX's engine's on the same traffic, to the port's batched engine's and to
its single-stream engine's, with ``paged_stats``, the ``legalrag_paged_*``
counters and gauges and ``legalrag_gen_tokens`` equal to JAX's. A sampled
stream is the single-stream engine's for its seed (speculation:
``tests/test_torch_paged_spec.py``; the radix tree and the pools:
``tests/test_torch_paged_radix.py``; the client:
``tests/test_torch_paged_client.py``).
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from legalrag_tpu.models.decoder import DecoderConfig as JaxDecoderConfig
from legalrag_tpu.models.paged_decoder import PagedDecoderLM
from legalrag_tpu.utils.metrics import METRICS as JAX_METRICS
from legalrag_tpu_torch.convert import decoder_params_from_jax
from legalrag_tpu_torch.models import decoder as td
from legalrag_tpu_torch.models.batched_decoder import TorchBatchedDecoderLM
from legalrag_tpu_torch.models.paged_decoder import TorchPagedDecoderLM
from legalrag_tpu_torch.utils.metrics import METRICS

PROMPTS = [[1, 2, 3], [4, 5, 6, 7, 8], [9, 10], [11, 12, 13, 14],
           [15, 16, 17, 18, 19, 20]]
TINY = dict(vocab_size=97, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2,
            intermediate_size=64, tie_word_embeddings=True)


def jax_params(cfg, seed, scale=0.3):
    """JAX's tiny random tree, drawn as ``tests/test_paged_spec.py::_mk``
    (and, at seed 7, ``tests/test_paged_decoder.py::tiny``) draws it."""
    rng = np.random.default_rng(seed)

    def mat(i, o, s=scale):
        return jnp.asarray(rng.standard_normal((i, o)) * s, jnp.float32)

    h, ff, d = cfg.hidden_size, cfg.intermediate_size, cfg.head_dim
    hkv = cfg.num_key_value_heads
    embed = mat(cfg.vocab_size, h, 0.5)
    return {
        "embed": embed, "lm_head": embed.T,
        "final_norm": jnp.ones(h, jnp.float32),
        "layers": [
            {"input_norm": jnp.ones(h, jnp.float32),
             "q": {"kernel": mat(h, h), "bias": jnp.zeros(h)},
             "k": {"kernel": mat(h, hkv * d), "bias": jnp.zeros(hkv * d)},
             "v": {"kernel": mat(h, hkv * d), "bias": jnp.zeros(hkv * d)},
             "o": {"kernel": mat(h, h)},
             "post_norm": jnp.ones(h, jnp.float32),
             "gate": {"kernel": mat(h, ff)},
             "up": {"kernel": mat(h, ff)},
             "down": {"kernel": mat(ff, h)}}
            for _ in range(cfg.num_hidden_layers)
        ],
    }


def tiny_pair(seed, **over):
    """((JAX params, JAX config), port state, port config) of one tiny
    random model."""
    kw = TINY | over
    jcfg = JaxDecoderConfig(**kw)
    jparams = jax_params(jcfg, seed)
    state = decoder_params_from_jax(jax.tree.map(np.asarray, jparams))
    return (jparams, jcfg), state, td.DecoderConfig(**kw)


@pytest.fixture(scope="module")
def tiny():
    return tiny_pair(7, max_position_embeddings=64)


def port_model(pair):
    _j, state, cfg = pair
    return td.DecoderModel.from_state_dict(cfg, state)


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


PAGED_GAUGES = ("legalrag_paged_free_blocks", "legalrag_paged_cached_blocks",
                "legalrag_paged_reserved_blocks",
                "legalrag_paged_pending_streams")


def paged_counts(metrics, engine: str) -> dict:
    """The paged counters (under JAX's ``engine="paged"`` label),
    ``legalrag_gen_tokens`` of ``engine`` and the paged gauges."""
    c = metrics._counters
    out = {n: c[(n, (("engine", e),))] for n, e in (
        ("legalrag_paged_reused_tokens", "paged"),
        ("legalrag_paged_prefill_tokens", "paged"),
        ("legalrag_gen_tokens", engine))}
    return out | {g: metrics._gauges.get((g, ())) for g in PAGED_GAUGES}


def run_both(pair, engine_kw, run, prompts, gen_kw, port_kw=None,
             jax_kw=None):
    """The port's and JAX's paged engines on the same traffic (``run``:
    ``concurrently`` or ``one_by_one``): the streams equal, and the paged
    stats, counters and gauges. Returns (the streams, the port's stats)."""
    (jparams, jcfg), _s, _c = pair
    engine = "paged-spec" if engine_kw.get("spec_k") else "paged"
    port = TorchPagedDecoderLM(port_model(pair), device="cpu", **engine_kw,
                               **(port_kw or {}))
    before = paged_counts(METRICS, engine)
    try:
        got = run(port, prompts, **gen_kw)
        stats = port.paged_stats()
    finally:
        port.close()
    after = paged_counts(METRICS, engine)
    jax_engine = PagedDecoderLM(jparams, jcfg, **engine_kw, **(jax_kw or {}))
    jbefore = paged_counts(JAX_METRICS, engine)
    try:
        want = run(jax_engine, prompts, **gen_kw)
        assert stats == jax_engine.paged_stats()
    finally:
        jax_engine.close()
    jafter = paged_counts(JAX_METRICS, engine)
    assert got == want
    counted = {k: after[k] - before[k] for k in list(after)[:3]}
    assert counted == {k: jafter[k] - jbefore[k] for k in list(after)[:3]}
    assert counted["legalrag_gen_tokens"] == sum(map(len, got))
    assert [after[g] for g in PAGED_GAUGES] == [jafter[g]
                                                for g in PAGED_GAUGES]
    return got, stats


def check_case(pair, engine_kw, prompts, gen_kw, serial=False, port_kw=None,
               jax_kw=None):
    """``run_both``, then the port's batched engine on the same traffic and
    its single-stream engine on each prompt: every greedy stream the same.
    Returns (the streams, the port's paged stats)."""
    run = one_by_one if serial else concurrently
    got, stats = run_both(pair, engine_kw, run, prompts, gen_kw, port_kw,
                          jax_kw)
    bkw = {k: v for k, v in engine_kw.items()
           if k not in ("block_size", "pool_blocks")}
    batched = TorchBatchedDecoderLM(port_model(pair), device="cpu", **bkw,
                                    **(port_kw or {}))
    try:
        assert run(batched, prompts, **gen_kw) == got
    finally:
        batched.close()
    ref = td.TorchDecoderLM(port_model(pair), device="cpu",
                            max_len=engine_kw["max_len"],
                            kv_quant=engine_kw.get("kv_quant", False))
    assert one_by_one(ref, prompts, **gen_kw) == got
    assert any(len(set(s)) >= 4 for s in got), got
    return got, stats


_rng = np.random.default_rng(41)
LONG = [_rng.integers(1, 90, n).tolist() for n in (17, 33, 45)]
_rng = np.random.default_rng(13)
TWIN = _rng.integers(1, 90, 24).tolist()
_rng = np.random.default_rng(19)
WIDE = [_rng.integers(1, 90, 33).tolist() for _ in range(2)]

# (engine settings, prompts, stream settings)
CASES = {
    "concurrent": (dict(max_len=48, n_slots=3, decode_chunk=4, block_size=8),
                   PROMPTS[:3], dict(max_new_tokens=10)),
    "slot_reuse": (dict(max_len=48, n_slots=2, decode_chunk=4, block_size=8),
                   PROMPTS, dict(max_new_tokens=10)),
    "identical_prompts_share_blocks": (
        dict(max_len=64, n_slots=2, decode_chunk=4, block_size=8),
        [TWIN, list(TWIN)], dict(max_new_tokens=8)),
    "admission_waits_for_the_pool": (
        dict(max_len=48, n_slots=2, decode_chunk=4, block_size=8,
             pool_blocks=7), WIDE, dict(max_new_tokens=10)),
    "kv_quant": (dict(max_len=48, n_slots=2, decode_chunk=4, block_size=8,
                      kv_quant=True), PROMPTS[:3], dict(max_new_tokens=8)),
    "chunked_admission": (dict(max_len=64, n_slots=2, decode_chunk=4,
                               block_size=8, prefill_chunk=16), LONG,
                          dict(max_new_tokens=8)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_greedy_streams_match_jax_batched_and_single_stream(tiny, case):
    engine_kw, prompts, gen_kw = CASES[case]
    _got, stats = check_case(tiny, engine_kw, prompts, gen_kw)
    assert stats["reserved_blocks"] == 0
    assert stats["free_blocks"] + stats["cached_blocks"] == stats["n_blocks"]
    if case == "identical_prompts_share_blocks":
        # the 24-token prompt's 3 full blocks published once, 2 matched
        assert stats["cached_blocks"] == 3 and stats["reused_blocks"] == 2
    if case == "admission_waits_for_the_pool":
        # each stream reserves 6 of the 7 blocks: the second waited
        assert stats["evicted_blocks"] > 0


def test_radix_reuses_shared_prefix_blocks(tiny):
    """Two prompts sharing a 16-token (2-block) prefix, one after the
    other: the second attaches the first's two published blocks by
    reference, in both engines alike, and finished streams leave their
    full prompt blocks cached."""
    rng = np.random.default_rng(11)
    shared = list(rng.integers(1, 90, 16))
    a = shared + list(rng.integers(1, 90, 5))
    b = shared + list(rng.integers(1, 90, 7))
    (jparams, jcfg), _s, _c = tiny
    kw = dict(max_len=64, n_slots=2, decode_chunk=4, block_size=8)
    stats = []
    for engine in (TorchPagedDecoderLM(port_model(tiny), device="cpu", **kw),
                   PagedDecoderLM(jparams, jcfg, **kw)):
        try:
            got_a = list(engine.generate_stream(a, max_new_tokens=8))
            s1 = engine.paged_stats()
            got_b = list(engine.generate_stream(b, max_new_tokens=8))
            stats.append((got_a, got_b, s1, engine.paged_stats()))
        finally:
            engine.close()
    assert stats[0] == stats[1]
    _a, _b, s1, s2 = stats[0]
    assert s2["reused_blocks"] - s1["reused_blocks"] == 2
    assert s2["cached_blocks"] >= 2
    ref = td.TorchDecoderLM(port_model(tiny), device="cpu", max_len=64)
    assert [_a, _b] == one_by_one(ref, [a, b], max_new_tokens=8)
    # the counters and the batched engine through check_case's path
    check_case(tiny, kw, [a, b], dict(max_new_tokens=8), serial=True)


def test_eviction_under_small_pool(tiny):
    """A pool of barely more than one stream's blocks: earlier prompts'
    cached blocks are evicted least recently used first to admit later
    ones, as JAX's are, and every stream decodes exactly."""
    rng = np.random.default_rng(17)
    prompts = [list(rng.integers(1, 90, 20)) for _ in range(4)]
    _got, stats = check_case(
        tiny, dict(max_len=64, n_slots=1, decode_chunk=4, block_size=8,
                   pool_blocks=9), prompts, dict(max_new_tokens=6),
        serial=True)
    assert stats["evicted_blocks"] > 0


def test_eos_budget_cancellation(tiny):
    """EOS ends a stream before it; a client gone after one token frees
    the slot and its blocks; every reservation is returned, as in JAX."""
    (jparams, jcfg), _s, _c = tiny
    ref = td.TorchDecoderLM(port_model(tiny), device="cpu", max_len=48)
    full = list(ref.generate_stream(PROMPTS[0], 10))
    eos = full[4]
    kw = dict(max_len=48, n_slots=1, decode_chunk=2, block_size=8)
    runs = []
    for engine in (TorchPagedDecoderLM(port_model(tiny), device="cpu", **kw),
                   PagedDecoderLM(jparams, jcfg, **kw)):
        try:
            got = list(engine.generate_stream(PROMPTS[0], max_new_tokens=10,
                                              eos_id=eos))
            gen = engine.generate_stream(PROMPTS[0], max_new_tokens=10)
            first = next(gen)
            gen.close()          # the client's disconnect
            got2 = list(engine.generate_stream(PROMPTS[1],
                                               max_new_tokens=10))
            runs.append((got, first, got2, engine.paged_stats()))
        finally:
            engine.close()
    assert runs[0] == runs[1]
    got, first, got2, stats = runs[0]
    assert got == full[:full.index(eos)] and first == full[0]
    assert got2 == list(ref.generate_stream(PROMPTS[1], 10))
    assert stats["reserved_blocks"] == 0
    assert stats["free_blocks"] + stats["cached_blocks"] == stats["n_blocks"]


def test_sampled_streams_depend_on_their_seed_alone(tiny):
    """A sampled stream is deterministic, in the vocabulary, and the
    single-stream engine's for its seed, alone and beside a greedy one
    (JAX's key chain draws other tokens: the port draws as its batched
    engine does)."""
    kw = dict(max_new_tokens=8, temperature=0.8, top_p=0.9, seed=3)
    ref = td.TorchDecoderLM(port_model(tiny), device="cpu", max_len=48)
    want = list(ref.generate_stream(PROMPTS[2], **kw))
    engine = TorchPagedDecoderLM(port_model(tiny), device="cpu", max_len=48,
                                 n_slots=2, decode_chunk=4, block_size=8)
    try:
        out1 = list(engine.generate_stream(PROMPTS[2], **kw))
        out2 = list(engine.generate_stream(PROMPTS[2], **kw))
        out = {}
        ts = [threading.Thread(target=lambda: out.setdefault(
                  "g", list(engine.generate_stream(PROMPTS[0],
                                                   max_new_tokens=10)))),
              threading.Thread(target=lambda: out.setdefault(
                  "s", list(engine.generate_stream(PROMPTS[2], **kw))))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=300)
    finally:
        engine.close()
    assert out1 == out2 == out["s"] == want
    assert len(out1) == 8 and all(0 <= t < 97 for t in out1)
    assert out["g"] == list(ref.generate_stream(PROMPTS[0], 10))


def test_validation_and_close(tiny):
    """``max_len`` off the block grid, a pool under one context and a
    prompt that does not fit raise; the budget is clamped to the cache;
    ``close`` is idempotent and a closed engine refuses streams."""
    (jparams, jcfg), _s, _c = tiny
    for make in (lambda **kw: TorchPagedDecoderLM(port_model(tiny),
                                                  device="cpu", **kw),
                 lambda **kw: PagedDecoderLM(jparams, jcfg, **kw)):
        with pytest.raises(ValueError):
            make(max_len=50, block_size=8)
        with pytest.raises(ValueError):
            make(max_len=48, block_size=8, pool_blocks=5)
        engine = make(max_len=16, n_slots=1, decode_chunk=4, block_size=8)
        try:
            with pytest.raises(ValueError):
                list(engine.generate_stream(list(range(1, 20)),
                                            max_new_tokens=4))
            got = list(engine.generate_stream(list(range(1, 13)),
                                              max_new_tokens=100))
            assert len(got) == 4  # clamped to the 16-token budget
        finally:
            engine.close()
        engine.close()
        with pytest.raises(RuntimeError):
            next(engine.generate_stream([1, 2], max_new_tokens=2))


def test_sentinel_blocks_never_cover_attended_positions(tiny):
    """At every launch each active slot's table holds real blocks below
    its launch horizon (a sentinel entry covers only masked positions, and
    its write-back lands on the scratch block), the scratch block is never
    a table entry, and the streams stay JAX's and the single-stream
    engine's."""
    engine = TorchPagedDecoderLM(port_model(tiny), device="cpu", max_len=48,
                                 n_slots=3, decode_chunk=4, block_size=8)
    violations = []
    orig = engine._top_up_tables

    def checked():
        orig()
        nb, bs = engine.n_blocks, engine.block_size
        assert engine._tables.max() <= nb
        for i, st in enumerate(engine._slots):
            if st is None:
                continue
            horizon = min(len(st.prompt_ids) + st.produced
                          + engine.decode_chunk, st.limit, engine.max_len)
            row = engine._tables[i, :(horizon + bs - 1) // bs]
            if (row >= nb).any():
                violations.append((i, horizon, row.copy()))

    engine._top_up_tables = checked
    try:
        got = concurrently(engine, PROMPTS, max_new_tokens=10)
        assert len(engine._pools[0][0]) == engine.n_blocks + 1
    finally:
        engine.close()
    assert not violations, violations[:3]
    want, _stats = run_both(tiny, dict(max_len=48, n_slots=3, decode_chunk=4,
                                       block_size=8), concurrently, PROMPTS,
                            dict(max_new_tokens=10))
    assert got == want
    ref = td.TorchDecoderLM(port_model(tiny), device="cpu", max_len=48)
    assert got == one_by_one(ref, PROMPTS, max_new_tokens=10)
