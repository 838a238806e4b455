"""The port's JSON constraint (``legalrag_tpu_torch/models/constrain.py`` and
``TorchDecoderLM(json_constraint=...)``) vs the JAX package's
(``legalrag_tpu/models/constrain.py``, ``JaxDecoderLM``) on the CPU.

The schema DFA, the token tables (dead-end pruning and the unreachable
schema's ``ValueError`` included) and the distances must be equal int for
int; ``from_tokenizer`` over the port's ``BPETokenizer`` must give the
table JAX's gives over ``AutoTokenizer`` of the same ``tokenizer.json``
(byte-level and sentencepiece-style layouts); ``budget_force`` must be
exact; constrained greedy streams of a tiny random checkpoint (written by
transformers, ``tests/test_torch_decoder.py``'s ``write_ckpt``) over a toy
vocabulary that can compose whole documents must be token-identical to
``JaxDecoderLM``'s in every mode, and a budget-forced stream must end
complete. One divergence is pinned: JAX sizes ``from_tokenizer``'s table
to ``len(tokenizer)`` and its engine then fails on a checkpoint whose
``vocab_size`` pads above the tokenizer; the port pads the table with
banned columns, as JAX's ``from_schema`` bans ``None`` entries."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legalrag_tpu.models import constrain as jcons
from legalrag_tpu.models import decoder as jd
from legalrag_tpu_torch.models import constrain as tcons
from legalrag_tpu_torch.models import decoder as td
from legalrag_tpu_torch.tokenize.bpe import BPETokenizer
from test_torch_decoder import Records, load_both, write_ckpt

SCHEMAS = {
    "sections": tcons.SECTIONS_SCHEMA,
    "number_bool": {"n": "number", "ok": "bool"},
    "nested": {"a": [["number"]], "b": {"c": "string", "d": ["bool"]}},
    "string": "string",
}

# id -> text of a toy vocabulary that composes whole SECTIONS documents
# (JAX's tests/test_constrain.py); id 0 has no bytes: it is EOS
TEXTS = [None, '{"sections"', ': [', '{"heading"', ': "', 'law', '第五百条',
         '", "items": ["', '", "', '"]}', ', ', ']}', ' ', 'b', '[]}']
EOS = 0
MAX_LEN = 128


def token_bytes(texts=TEXTS):
    return [t.encode("utf-8") if t else None for t in texts]


def accepts(text: str):
    """None if ``text`` is no prefix of a SECTIONS document, else whether it
    is a complete one (replayed on JAX's byte DFA)."""
    trans, acc = jcons.build_schema_dfa(jcons.SECTIONS_SCHEMA)
    st = 0
    for b in text.encode("utf-8"):
        st = trans[st, b]
        if st < 0:
            return None
    return bool(acc[st])


def toy_text(toks):
    return "".join(TEXTS[t] for t in toks if TEXTS[t])


# ------------------------------------------------------------ the tables

@pytest.mark.parametrize("name", sorted(SCHEMAS))
def test_schema_dfa_matches_jax(name):
    got, got_acc = tcons.build_schema_dfa(SCHEMAS[name])
    want, want_acc = jcons.build_schema_dfa(SCHEMAS[name])
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_acc, want_acc)
    if name == "sections":
        assert got.shape == (104, 256)


# toy vocabularies: whole, one whose '"]}' is missing (every state inside a
# section's items is a dead end, pruned), and one with no '{' (unreachable)
VOCABS = {"whole": TEXTS,
          "dead_ends": [t if t != '"]}' else None for t in TEXTS],
          "byte_pieces": TEXTS + ['{', '"', 's', 'ections', '":', '[', ']',
                                  '}', 'x', '\\', 'u', '0', '\\u4e2d']}


@pytest.mark.parametrize("vocab", sorted(VOCABS))
def test_token_table_and_distances_match_jax(vocab):
    trans, acc = jcons.build_schema_dfa(jcons.SECTIONS_SCHEMA)
    tb = token_bytes(VOCABS[vocab])
    got, got_acc = tcons.compile_token_table(trans.copy(), acc.copy(), tb)
    want, want_acc = jcons.compile_token_table(trans, acc, tb)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_acc, want_acc)
    np.testing.assert_array_equal(tcons.token_dist_to_accept(got, got_acc),
                                  jcons.token_dist_to_accept(want, want_acc))
    if vocab == "dead_ends":
        # transitions of the tokens both vocabularies hold were pruned
        whole, _ = jcons.compile_token_table(trans, acc, token_bytes())
        keep = np.arange(len(TEXTS)) != TEXTS.index('"]}')
        assert (got[:, keep] >= 0).sum() < (whole[:, keep] >= 0).sum()


def test_unreachable_schema_raises_as_in_jax():
    trans, acc = jcons.build_schema_dfa(jcons.SECTIONS_SCHEMA)
    tb = token_bytes([None, 'law', ' ', '"'])
    for mod in (tcons, jcons):
        with pytest.raises(ValueError, match="unreachable"):
            mod.compile_token_table(trans, acc, tb)


def test_budget_force_matches_jax():
    rng = np.random.default_rng(3)
    v, s = 40, 9
    row = rng.integers(-1, s, (6, v)).astype(np.int32)
    allowed = rng.random((6, v)) < 0.5
    allowed[5] = False                     # nothing allowed: stays so
    dist = rng.integers(0, 6, s).astype(np.int32)
    eos_col = np.arange(v) == 7
    left = np.array([[0], [1], [2], [3], [9], [4]], np.int32)
    want = np.asarray(jcons.budget_force(
        jnp.asarray(allowed), jnp.asarray(row), jnp.asarray(dist),
        jnp.asarray(left), jnp.asarray(eos_col)))
    got = tcons.budget_force(
        torch.from_numpy(allowed), torch.from_numpy(row),
        torch.from_numpy(dist), torch.from_numpy(left),
        torch.from_numpy(eos_col)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got != allowed).any()          # the budget bit somewhere


# ------------------------------------------------------- from_tokenizer

@pytest.fixture(scope="module", params=["qwen2", "llama3", "llama2",
                                        "mistral_metaspace", "gemma"])
def tokenizer_dir(request, tmp_path_factory):
    from test_torch_bpe import write_qwen2_tokenizer
    from test_torch_bpe_layouts import write_layout_tokenizer

    d = tmp_path_factory.mktemp(request.param)
    if request.param == "qwen2":
        return write_qwen2_tokenizer(d)
    return write_layout_tokenizer(d, request.param)


def test_from_tokenizer_matches_jax_over_autotokenizer(tokenizer_dir):
    """Byte-level (Qwen2, Llama 3) and sentencepiece-style (Llama 2,
    Mistral, Gemma) layouts: the same table, acceptance, distances and
    shortest budget; special and U+FFFD-decoding ids banned."""
    from transformers import AutoTokenizer

    hf = AutoTokenizer.from_pretrained(str(tokenizer_dir))
    tok = BPETokenizer.from_dir(tokenizer_dir)
    assert len(tok) == len(hf)
    assert sorted(tok.all_special_ids) == sorted(hf.all_special_ids)
    want = jcons.JsonConstraint.from_tokenizer(jcons.SECTIONS_SCHEMA, hf)
    got = tcons.JsonConstraint.from_tokenizer(tcons.SECTIONS_SCHEMA, tok,
                                              device="cpu")
    np.testing.assert_array_equal(got.table.numpy(), np.asarray(want.table))
    np.testing.assert_array_equal(got.accepting.numpy(),
                                  np.asarray(want.accepting))
    np.testing.assert_array_equal(got.dist.numpy(), np.asarray(want.dist))
    assert got.min_budget == want.min_budget
    table = got.table.numpy()
    assert (table[:, tok.all_special_ids] < 0).all()
    assert (table >= 0).any(axis=0).sum() > 50   # many tokens usable


def test_padded_vocabulary_matches_jax_from_schema(tokenizer_dir):
    """The model's ``vocab_size`` above ``len(tokenizer)``: the port's
    table equals JAX's ``from_schema`` over ``token_bytes`` padded with
    ``None``, the padded ids banned; a ``vocab_size`` below it drops the
    ids past it."""
    from transformers import AutoTokenizer

    hf = AutoTokenizer.from_pretrained(str(tokenizer_dir))
    tok = BPETokenizer.from_dir(tokenizer_dir)
    n = len(tok)
    tb = [None if i in set(hf.all_special_ids) else
          (lambda s: s.encode("utf-8") if s and "�" not in s else None)(
              hf.decode([i])) for i in range(n)]
    for vocab in (n + 45, n - 7):
        got = tcons.JsonConstraint.from_tokenizer(
            tcons.SECTIONS_SCHEMA, tok, vocab_size=vocab, device="cpu")
        want = jcons.JsonConstraint.from_schema(
            jcons.SECTIONS_SCHEMA, (tb + [None] * 45)[:vocab])
        assert got.table.shape == (104, vocab)
        np.testing.assert_array_equal(got.table.numpy(),
                                      np.asarray(want.table))
        np.testing.assert_array_equal(got.dist.numpy(),
                                      np.asarray(want.dist))
    assert (got.table.numpy()[:, n:] < 0).all() if vocab > n else True


def test_constraint_pads_its_table_to_the_vocabulary():
    trans, acc = jcons.build_schema_dfa(jcons.SECTIONS_SCHEMA)
    table, acc = jcons.compile_token_table(trans, acc, token_bytes())
    jc = tcons.JsonConstraint(table, acc, device="cpu", vocab_size=20)
    assert jc.table.shape == (104, 20) and jc.table.dtype == torch.int32
    assert (jc.table[:, 15:] == -1).all()
    np.testing.assert_array_equal(jc.table[:, :15].numpy(), table)
    assert jc.nbytes == 104 * 20 * 4 + 104 + 104 * 4


# -------------------------------------------------------------- engines

@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    """A tiny random Qwen2 checkpoint over the toy vocabulary: ((JAX
    params, config), port state, port config)."""
    return load_both(write_ckpt(tmp_path_factory.mktemp("toy"), seed=29,
                                vocab_size=len(TEXTS)))


def toy_constraints(vocab_size=None):
    return (tcons.JsonConstraint.from_schema(
                tcons.SECTIONS_SCHEMA, token_bytes(), device="cpu",
                vocab_size=vocab_size),
            jcons.JsonConstraint.from_schema(jcons.SECTIONS_SCHEMA,
                                             token_bytes()))


def port_engine(toy, jc=None, **kw):
    _j, state, cfg = toy
    return td.TorchDecoderLM(td.DecoderModel.from_state_dict(cfg, state),
                             device="cpu", max_len=kw.pop("max_len", MAX_LEN),
                             json_constraint=jc, **kw)


def jax_engine(toy, jc=None, **kw):
    (jparams, jcfg), _s, _c = toy
    return jd.JaxDecoderLM(jparams, jcfg, max_len=kw.pop("max_len", MAX_LEN),
                           json_constraint=jc, **kw)


PROMPT = np.random.default_rng(7).integers(1, len(TEXTS), 40).tolist()
DONOR = PROMPT[:24] + [12, 13, 5, 12]
MODES = {"plain": dict(decode_chunk=8),
         "chunked_prefill": dict(decode_chunk=8, prefill_chunk=16),
         "decode_chunk_1": dict(decode_chunk=1),
         "prefix_hit": dict(decode_chunk=8, prefix_cache=2)}


def constrained(engine, n, prompt=PROMPT, **kw):
    return list(engine.generate_stream(list(prompt), max_new_tokens=n,
                                       eos_id=EOS, constrain=True, **kw))


@pytest.mark.parametrize("mode", sorted(MODES))
def test_constrained_greedy_stream_matches_jax(toy, mode):
    """29 constrained greedy tokens (3 chunks of 8 and a tail of 5, at a
    repetition penalty that keeps the random model moving) identical to
    ``JaxDecoderLM(json_constraint=...)``'s in the same mode, each a prefix
    of a schema-valid document."""
    pjc, jjc = toy_constraints()
    streams = []
    for make, jc in ((port_engine, pjc), (jax_engine, jjc)):
        engine = make(toy, jc, **MODES[mode])
        if mode == "prefix_hit":
            constrained(engine, 4, DONOR)
        streams.append(constrained(engine, 29, repetition_penalty=1.3))
        if mode == "prefix_hit":
            assert engine.prefix_stats["hits"] == 1
    got, want = streams
    assert got == want
    assert accepts(toy_text(got)) is not None
    assert len(set(got)) >= 4, got


@pytest.mark.parametrize("extra", [0, 4, 11])
def test_budget_forced_stream_ends_complete(toy, extra):
    """``min_budget + extra`` tokens: the stream ends on EOS or its budget
    as one complete document that ``json.loads`` reads, as JAX's does."""
    pjc, jjc = toy_constraints()
    n = pjc.min_budget + extra
    got = constrained(port_engine(toy, pjc, decode_chunk=4), n)
    assert got == constrained(jax_engine(toy, jjc, decode_chunk=4), n)
    assert accepts(toy_text(got)) is True
    assert "sections" in json.loads(toy_text(got))


def test_sampled_constrained_streams_stay_valid(toy):
    pjc, _ = toy_constraints()
    engine = port_engine(toy, pjc, decode_chunk=4)
    for seed in range(3):
        toks = constrained(engine, 40, temperature=0.9, seed=seed)
        text = toy_text(toks)
        assert accepts(text) is (True if len(toks) < 40 else accepts(text))
        assert accepts(text) is not None


def test_short_budget_warns_and_unconstrained_streams_are_untouched(toy):
    pjc, _ = toy_constraints()
    engine = port_engine(toy, pjc, decode_chunk=4)
    with Records("torch.models.decoder") as log:
        toks = constrained(engine, pjc.min_budget - 1)
    assert any("shortest valid document" in m for m in log.messages)
    assert accepts(toy_text(toks)) is False          # a valid prefix
    free = list(engine.generate_stream(PROMPT, max_new_tokens=12))
    assert free == list(port_engine(toy).generate_stream(PROMPT,
                                                         max_new_tokens=12))


def test_constrain_without_a_constraint_raises_as_in_jax(toy):
    for make in (port_engine, jax_engine):
        with pytest.raises(ValueError, match="json_constraint"):
            next(iter(make(toy).generate_stream(PROMPT, max_new_tokens=4,
                                                constrain=True)))


def test_jax_engine_fails_on_a_padded_vocabulary(toy, tmp_path):
    """The reference's fault the port avoids: a table narrower than the
    logits (a tokenizer below the model's ``vocab_size``) fails JAX's
    broadcast; the port's constraint padded to the vocabulary decodes."""
    (jparams, jcfg), state, cfg = load_both(write_ckpt(
        tmp_path, seed=29, vocab_size=len(TEXTS) + 5))
    _, jjc = toy_constraints()
    engine = jd.JaxDecoderLM(jparams, jcfg, max_len=MAX_LEN,
                             json_constraint=jjc)
    with pytest.raises(ValueError, match="Incompatible shapes"):
        list(engine.generate_stream(PROMPT, max_new_tokens=8, eos_id=EOS,
                                    constrain=True))
    pjc, _ = toy_constraints(vocab_size=len(TEXTS) + 5)
    port = td.TorchDecoderLM(td.DecoderModel.from_state_dict(cfg, state),
                             device="cpu", max_len=MAX_LEN,
                             json_constraint=pjc)
    toks = list(port.generate_stream(PROMPT, max_new_tokens=24, eos_id=EOS,
                                     constrain=True))
    assert toks and max(toks) < len(TEXTS)
    assert accepts(toy_text(toks)) is not None


def test_from_pretrained_builds_the_sections_constraint(tmp_path,
                                                        monkeypatch):
    """``constrain_json`` builds SECTIONS_SCHEMA from the checkpoint's
    tokenizer at the model's padded ``vocab_size`` on the engine's device
    (``cuda`` unless told, raising without it)."""
    from test_torch_bpe import BPE_VOCAB, SPECIALS, write_qwen2_tokenizer

    vocab = BPE_VOCAB + len(SPECIALS) + 61
    write_ckpt(tmp_path, seed=3, vocab_size=vocab)
    write_qwen2_tokenizer(tmp_path)
    lm = td.TorchDecoderLM.from_pretrained(str(tmp_path), device="cpu",
                                           constrain_json=True)
    jc = lm.json_constraint
    assert jc.table.shape == (104, vocab) and jc.device.type == "cpu"
    assert (jc.table[:, BPE_VOCAB + len(SPECIALS):] < 0).all()
    want = tcons.JsonConstraint.from_tokenizer(
        tcons.SECTIONS_SCHEMA, BPETokenizer.from_dir(tmp_path),
        vocab_size=vocab, device="cpu")
    assert torch.equal(jc.table, want.table)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        td.TorchDecoderLM.from_pretrained(str(tmp_path), constrain_json=True)
