"""The port's speculative engine (``legalrag_tpu_torch/models/spec_decode.py``,
``TorchSpecLookupDecoderLM``) vs the JAX package's ``SpecLookupDecoderLM``
and the plain engine, on the CPU in float32, on tiny random checkpoints
written by transformers (``tests/test_torch_decoder.py``'s ``write_ckpt``).

Greedy streams must be token-identical to the port's plain engine and to
JAX's speculative one with prompt lookup, an arbitrary n-gram table and
one built from the streams, EOS, the budget and the capacity tail (the
draft model, quantization, the penalty and the constraint:
``tests/test_torch_spec_draft.py``, ``test_torch_spec_quant.py``);
``last_stats`` (launches, tokens, rounds, the adaptive bail) must be
JAX's; a sampled stream is seeded, and its tokens inside the speculation
loop follow the plain engine's distribution (a chi-squared test at the
0.999 quantile against the exact probabilities). One
divergence is pinned: at the cache's capacity tail JAX's clamped cache
write in a frozen round overwrites valid rows (``spec_steps`` >= 2), and
its stream leaves the plain one; the port's does not."""

import numpy as np
import pytest
import torch

from legalrag_tpu.models import spec_decode as jsd
from legalrag_tpu.models.ngram_draft import NgramDraftTable as JaxTable
from legalrag_tpu_torch.models import decoder as td
from legalrag_tpu_torch.models.ngram_draft import NgramDraftTable
from legalrag_tpu_torch.models.spec_decode import TorchSpecLookupDecoderLM
from test_torch_constrain import (EOS, accepts, toy,  # noqa: F401
                                  toy_constraints, toy_text)
from test_torch_decoder import CHI2_999, VOCAB, load_both, write_ckpt

MAX_LEN = 96
PROMPTS = [[5, 6, 7, 5, 6, 7, 5, 6],       # bigram repeats: drafts accepted
           [12, 41, 3, 3, 3, 3, 9],        # a run and a tail
           [22, 81, 14, 60, 33],           # no structure: rejections
           [2, 2]]                         # the shortest prompt
# the chi-squared distribution's 0.999 quantile by degrees of freedom
CHI2_999 = CHI2_999 | {8: 26.12, 9: 27.88, 10: 29.59, 11: 31.26, 12: 32.91,
                       13: 34.53, 14: 36.12, 15: 37.70, 16: 39.25,
                       17: 40.79, 18: 42.31, 19: 43.82, 20: 45.31}
STATS = ("launches", "tokens", "spec_rounds", "spec_tokens",
         "adaptive_bailed")


@pytest.fixture(scope="module")
def qwen(tmp_path_factory):
    """((JAX params, config), port state, port config) of the tiny Qwen2."""
    return load_both(write_ckpt(tmp_path_factory.mktemp("spec"), seed=0))


def model(ckpt, state=None):
    _j, st, cfg = ckpt
    return td.DecoderModel.from_state_dict(cfg, st if state is None else state)


def plain(ckpt, **kw):
    return td.TorchDecoderLM(model(ckpt), device="cpu",
                             max_len=kw.pop("max_len", MAX_LEN), **kw)


def spec(ckpt, draft=None, **kw):
    return TorchSpecLookupDecoderLM(
        model(ckpt), device="cpu", max_len=kw.pop("max_len", MAX_LEN),
        draft=None if draft is None else model(draft), **kw)


def jax_spec(ckpt, draft=None, **kw):
    (jparams, jcfg), _s, _c = ckpt
    if draft is not None:
        kw["draft"] = draft[0]
    return jsd.SpecLookupDecoderLM(jparams, jcfg,
                                   max_len=kw.pop("max_len", MAX_LEN), **kw)


def run(engine, prompt, n, **kw):
    return list(engine.generate_stream(list(prompt), max_new_tokens=n, **kw))


def same_stats(a, b):
    assert {k: a.last_stats.get(k) for k in STATS} \
        == {k: b.last_stats.get(k) for k in STATS}


@pytest.mark.parametrize("k,steps", [(4, 2), (8, 4), (3, 1)])
def test_greedy_lookup_matches_plain_and_jax(qwen, k, steps):
    """Prompt lookup: every prompt's 21 greedy tokens equal the plain
    engine's and JAX's speculative stream, with JAX's ``last_stats``; one
    host read a launch, one for the first token."""
    ref = plain(qwen, decode_chunk=1)
    eng, jeng = spec(qwen, spec_k=k, spec_steps=steps), \
        jax_spec(qwen, spec_k=k, spec_steps=steps)
    accepted = 0
    for p in PROMPTS:
        want = run(ref, p, 21)
        assert run(eng, p, 21) == want == run(jeng, p, 21), p
        same_stats(eng, jeng)
        st = eng.last_stats
        assert st["host_reads"] == st["launches"] + 1
        accepted += st["tokens"] - 1 - st["spec_rounds"]
    assert accepted > 0                    # some drafts were accepted


def test_last_stats_count_the_adaptive_bail_as_jax(qwen):
    """A bar above k + 1 bails after one launch: the plain engine's chunks
    finish the stream, as JAX's do, with its launches and its flag."""
    ref = plain(qwen, decode_chunk=1)
    kw = dict(spec_k=4, spec_steps=2, spec_adaptive=10.0, decode_chunk=8)
    eng, jeng = spec(qwen, **kw), jax_spec(qwen, **kw)
    for p in PROMPTS:
        want = run(ref, p, 40)
        assert run(eng, p, 40) == want == run(jeng, p, 40), p
        assert eng.last_stats["adaptive_bailed"] is True
        same_stats(eng, jeng)
    eos = want[30]                          # past the bail point
    want = run(ref, PROMPTS[3], 40, eos_id=eos)
    assert run(eng, PROMPTS[3], 40, eos_id=eos) == want


def test_adaptive_keeps_speculating_on_a_quoting_stream(tmp_path):
    """A weakly initialised model repeats itself: the lookup accepts over
    2 tokens a round (JAX's bar for the same test), and a bar of 2 never
    bails."""
    ck = load_both(write_ckpt(tmp_path, seed=3, initializer_range=0.02))
    state = {k: v * 0.1 if v.dim() == 2 else v for k, v in ck[1].items()}
    ck = (ck[0], state, ck[2])
    prompt = np.random.default_rng(3).integers(1, VOCAB - 1, 24).tolist()
    want = run(plain(ck, max_len=256, decode_chunk=8), prompt, 64)
    eng = spec(ck, max_len=256, spec_k=8, spec_steps=4, spec_adaptive=2.0)
    assert run(eng, prompt, 64) == want
    st = eng.last_stats
    assert not st.get("adaptive_bailed")
    assert (st["tokens"] - 1) / st["spec_rounds"] >= 2.0


def table_of(mod, rng, k=8, size=4):
    """An arbitrary table (random keys and continuations) of ``mod``."""
    n = 1 << size
    ka = rng.integers(0, VOCAB, n).astype(np.int32)
    kb = rng.integers(0, VOCAB, n).astype(np.int32)
    ka[rng.random(n) < 0.3] = -1
    return mod(ka, kb, rng.integers(0, VOCAB, (n, k)).astype(np.int32))


@pytest.mark.parametrize("source", ["arbitrary", "oracle"])
def test_ngram_table_drafts_match_plain_and_jax(qwen, source):
    """An arbitrary table, and one built from the plain streams themselves
    (it drafts them exactly): the streams and stats equal JAX's with the
    same table, the oracle accepting more than lookup alone."""
    ref = plain(qwen, decode_chunk=1)
    wants = [run(ref, p, 24) for p in PROMPTS]
    if source == "arbitrary":
        pt = table_of(NgramDraftTable, np.random.default_rng(5))
    else:
        pt = NgramDraftTable.from_streams(
            [p + w for p, w in zip(PROMPTS, wants)], k=8, log2_size=10)
    jt = JaxTable(pt._keys_a, pt._keys_b, pt._vals)
    eng = spec(qwen, spec_k=4, spec_steps=2, ngram_draft=pt)
    jeng = jax_spec(qwen, spec_k=4, spec_steps=2, ngram_draft=jt)
    lookup = spec(qwen, spec_k=4, spec_steps=2)
    rounds = {"table": 0, "lookup": 0}
    for p, want in zip(PROMPTS, wants):
        assert run(eng, p, 24) == want == run(jeng, p, 24), p
        same_stats(eng, jeng)
        rounds["table"] += eng.last_stats["spec_rounds"]
        assert run(lookup, p, 24) == want
        rounds["lookup"] += lookup.last_stats["spec_rounds"]
    if source == "oracle":
        assert rounds["table"] < rounds["lookup"], rounds


def test_table_shorter_than_spec_k_raises(qwen):
    pt = table_of(NgramDraftTable, np.random.default_rng(1), k=2)
    with pytest.raises(ValueError, match="exceeds table draft length"):
        run(spec(qwen, spec_k=4, ngram_draft=pt), PROMPTS[0], 4)


def test_eos_and_budget_match_plain(qwen):
    ref = plain(qwen, decode_chunk=1)
    eng = spec(qwen, spec_k=4, spec_steps=3)
    for p in PROMPTS[:2]:
        full = run(ref, p, 12)
        eos = full[5]
        want = run(ref, p, 12, eos_id=eos)
        assert run(eng, p, 12, eos_id=eos) == want == full[:full.index(eos)]
    for n in (1, 2, 7, 13):
        assert run(eng, PROMPTS[1], n) == run(ref, PROMPTS[1], n)


def test_capacity_tail_matches_plain_where_jax_leaves_it(qwen):
    """A 24-row cache: the speculation freezes within ``spec_k`` rows of
    the end and the plain engine's steps finish. The port's stream is the
    plain one for every spec_steps; JAX's leaves it from spec_steps 2 (a
    frozen round's ``dynamic_update_slice`` clamps its write below the
    write pointer), here at token 14 of 19."""
    p = PROMPTS[2]
    want = run(plain(qwen, max_len=24, decode_chunk=1), p, 100)
    assert len(want) == 24 - len(p)
    for steps in (1, 2, 3):
        for k in (4, 6):
            got = run(spec(qwen, max_len=24, spec_k=k, spec_steps=steps),
                      p, 100)
            assert got == want, (steps, k)
    jgot = run(jax_spec(qwen, max_len=24, spec_k=6, spec_steps=2), p, 100)
    assert jgot[:14] == want[:14] and jgot[14] != want[14]
    assert run(jax_spec(qwen, max_len=24, spec_k=6, spec_steps=1),
               p, 100) == want


def test_sampled_stream_is_seeded_and_constrained_stays_valid(
        qwen, toy):  # noqa: F811
    eng = spec(qwen, spec_k=4, spec_steps=2)
    kw = dict(temperature=0.9, top_p=0.9)
    a = run(eng, PROMPTS[0], 12, seed=5, **kw)
    assert a == run(eng, PROMPTS[0], 12, seed=5, **kw)
    assert a != run(eng, PROMPTS[0], 12, seed=6, **kw)
    pjc, _ = toy_constraints()
    ceng = spec(toy, spec_k=4, spec_steps=2, json_constraint=pjc)
    for seed in range(3):
        toks = run(ceng, [12, 14, 12], 36, temperature=0.9, seed=seed,
                   eos_id=EOS, constrain=True)
        res = accepts(toy_text(toks))
        assert res is not None and (res or len(toks) == 36)


def test_spec_k_zero_is_the_plain_engine(qwen):
    want = run(plain(qwen), PROMPTS[2], 8)
    assert run(spec(qwen, spec_k=0), PROMPTS[2], 8) == want


def test_overlong_prompt_raises(qwen):
    with pytest.raises(ValueError, match="does not fit"):
        run(spec(qwen, max_len=16, spec_k=4), list(range(1, 20)), 2)


def exact_marginals(ckpt, prompt, temperature, top_k, top_p):
    """The plain engine's exact probabilities of the stream's second and
    third tokens under its warpers (top_k, then top_p)."""
    m = model(ckpt).eval()

    def probs(ids):
        with torch.no_grad():
            logits = m(torch.tensor([ids]), torch.arange(len(ids))[None])
        w = td._warp_filter(logits[:, -1] / temperature, top_p, top_k)
        return torch.softmax(w, -1)[0].double().numpy()

    p2, p3 = np.zeros(VOCAB), np.zeros(VOCAB)
    p0 = probs(prompt)
    for x0 in np.flatnonzero(p0):
        p1 = probs(prompt + [x0])
        p2 += p0[x0] * p1
        for x1 in np.flatnonzero(p1):
            p3 += p0[x0] * p1[x1] * probs(prompt + [x0, x1])
    return p2, p3


def chi2(counts, p, n):
    """Pearson's statistic over the cells expecting 5 or more draws, the
    rest pooled; (statistic, degrees of freedom)."""
    e = n * p
    big = e >= 5
    obs = list(counts[big]) + [counts[~big].sum()]
    exp = list(e[big]) + [e[~big].sum()]
    keep = [i for i, x in enumerate(exp) if x > 0]
    stat = sum((obs[i] - exp[i]) ** 2 / exp[i] for i in keep)
    return stat, len(keep) - 1


def test_sampled_speculation_follows_the_plain_distribution(qwen):
    """600 seeded streams of 3 tokens at temperature 1.0, top_k 3 (top_p
    0.9), the
    target drafting for itself (its greedy draft is accepted where the
    draw equals it): the second and third tokens, drawn inside the
    speculation loop, pass a chi-squared test against the plain engine's
    exact marginals."""
    prompt = PROMPTS[2]
    n = 600
    p2, p3 = exact_marginals(qwen, prompt, 1.0, 3, 0.9)
    eng = spec(qwen, qwen, spec_k=4, spec_steps=1)
    c2, c3 = np.zeros(VOCAB), np.zeros(VOCAB)
    accepted = 0
    for seed in range(n):
        toks = run(eng, prompt, 3, temperature=1.0, top_k=3, top_p=0.9,
                   seed=seed)
        c2[toks[1]] += 1
        c3[toks[2]] += 1
        accepted += eng.last_stats["spec_rounds"] == 1
    assert accepted > 20
    for c, p in ((c2, p2), (c3, p3)):
        assert c[p == 0].sum() == 0
        stat, dof = chi2(c, p, n)
        assert dof >= 2 and stat < CHI2_999[dof], (stat, dof)
