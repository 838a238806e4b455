"""The port's speculative engine with a draft model, a repetition penalty
and the JSON constraint
(``TorchSpecLookupDecoderLM``) vs the JAX package's ``SpecLookupDecoderLM``
and the port's plain engine, on the CPU in float32 (the helpers and the
lookup, table, stats and sampling tests are in
``tests/test_torch_spec_decode.py``). Greedy streams must be
token-identical to both."""

import numpy as np
import pytest

from test_torch_constrain import (EOS, accepts, toy,  # noqa: F401
                                  toy_constraints, toy_text)
from test_torch_decoder import load_both, write_ckpt
from test_torch_spec_decode import (PROMPTS, jax_spec, plain, qwen,  # noqa: F401
                                    run, same_stats, spec)


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """An uncorrelated draft model of the same vocabulary: one layer, 16
    wide."""
    return load_both(write_ckpt(tmp_path_factory.mktemp("draft"), seed=99,
                                hidden_size=16, num_hidden_layers=1,
                                num_attention_heads=2, num_key_value_heads=1,
                                intermediate_size=32))


@pytest.mark.parametrize("which", ["self", "uncorrelated"])
def test_draft_model_matches_plain_and_jax(qwen, small, which):
    """The target as its own draft, and an uncorrelated one: the greedy
    streams equal the plain engine's and JAX's, stats included; the self
    draft accepts far more a round."""
    draft = qwen if which == "self" else small
    ref = plain(qwen, decode_chunk=1)
    eng = spec(qwen, draft, spec_k=4, spec_steps=2)
    jeng = jax_spec(qwen, draft, spec_k=4, spec_steps=2)
    per_round = []
    for p in PROMPTS + [list(range(20, 40))]:
        want = run(ref, p, 16)
        assert run(eng, p, 16) == want == run(jeng, p, 16), p
        same_stats(eng, jeng)
        st = eng.last_stats
        per_round.append((st["tokens"] - 1) / st["spec_rounds"])
    if which == "self":
        assert min(per_round) >= 2.0, per_round
    else:
        assert np.mean(per_round) < 3.0, per_round


def test_draft_of_another_vocabulary_raises(qwen, tmp_path):
    other = load_both(write_ckpt(tmp_path, seed=1, vocab_size=64,
                                 hidden_size=16, num_hidden_layers=1,
                                 num_attention_heads=2,
                                 num_key_value_heads=1,
                                 intermediate_size=32))
    with pytest.raises(ValueError, match="draft model vocab 64"):
        spec(qwen, other, spec_k=4)


@pytest.mark.parametrize("pen", [1.3, 0.8])
def test_repetition_penalty_matches_plain_and_jax(qwen, small, pen):
    ref = plain(qwen, decode_chunk=1)
    for draft in (None, small):
        eng = spec(qwen, draft, spec_k=4, spec_steps=2)
        jeng = jax_spec(qwen, draft, spec_k=4, spec_steps=2)
        for p in PROMPTS[:3]:
            kw = dict(repetition_penalty=pen)
            want = run(ref, p, 18, **kw)
            assert run(eng, p, 18, **kw) == want == run(jeng, p, 18, **kw)
    assert want != run(ref, PROMPTS[2], 18)


def test_constrained_spec_matches_constrained_plain_and_jax(toy):  # noqa: F811
    """The constraint folded through the verify rows (each row's DFA state
    after the drafts before it, its own budget): greedy streams equal the
    constrained plain engine's and JAX's, a draft model included; budget
    forcing ends the document complete."""
    pjc, jjc = toy_constraints()
    ref = plain(toy, decode_chunk=1, json_constraint=pjc)
    prompt = [12, 14, 12, 5, 12, 14, 12]
    for draft in (None, toy):
        eng = spec(toy, draft, spec_k=4, spec_steps=2, json_constraint=pjc)
        jeng = jax_spec(toy, draft, spec_k=4, spec_steps=2,
                        json_constraint=jjc)
        for n, pen in ((30, 1.0), (30, 1.3), (pjc.min_budget + 3, 1.0)):
            kw = dict(eos_id=EOS, constrain=True, repetition_penalty=pen)
            want = run(ref, prompt, n, **kw)
            assert run(eng, prompt, n, **kw) == want == \
                run(jeng, prompt, n, **kw), (draft, n, pen)
            assert accepts(toy_text(want)) is not None
    assert accepts(toy_text(want)) is True
