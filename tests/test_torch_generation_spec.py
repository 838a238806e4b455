"""The port's ``local-jax`` provider with the single-stream engine's JSON
constraint and speculation knobs (``constrain_json``, ``spec_k``,
``spec_adaptive``, ``draft_model``, ``ngram_draft_path``) vs the JAX
package's client, on the CPU, on one tiny checkpoint directory (a random
Qwen2 model saved by transformers beside a Qwen2-layout ``tokenizer.json``
trained on the statutes, ``tests/test_torch_generation.py``'s pattern, its
``vocab_size`` the tokenizer's: JAX's constraint fails on a padded one,
``tests/test_torch_constrain.py``). At temperature 0 ``chat`` and
``chat_stream`` must give JAX's text and chunks, and ``/rag/answer``'s SSE
events must be equal; a constrained answer is a schema-valid document
whose sections the SSE scanner emits. Without ``spec_k`` the speculation
knobs are refused (JAX ignores them)."""

import json

import pytest
import torch

from legalrag_tpu.config import LLMConfig as JaxLLMConfig
from legalrag_tpu.llm.client import LLMClient as JaxLLMClient
from legalrag_tpu.llm.gateway import LLMGateway as JaxGateway
from legalrag_tpu_torch.cli import build_draft_table
from legalrag_tpu_torch.config import LLMConfig
from legalrag_tpu_torch.llm import DEGRADED_ANSWER
from legalrag_tpu_torch.llm.client import (
    LLMClient,
    LLMUnavailable,
    unported_engine_knobs,
)
from legalrag_tpu_torch.llm.gateway import LLMGateway
from legalrag_tpu_torch.models.decoder import TorchDecoderLM
from legalrag_tpu_torch.models.spec_decode import TorchSpecLookupDecoderLM
from test_torch_bpe import BPE_VOCAB, SPECIALS, rag_messages, write_qwen2_tokenizer
from test_torch_constrain import accepts
from test_torch_decoder import write_ckpt
from test_torch_server import llm_on_both, served, sse  # noqa: F401  (fixtures)

NEW_TOKENS = 40
VOCAB = BPE_VOCAB + len(SPECIALS)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory, zh_chunks):
    """(the checkpoint directory, an uncorrelated draft checkpoint of its
    vocabulary, the n-gram table built by the port's CLI from statutes)."""
    root = tmp_path_factory.mktemp("spec_lm")
    d = write_ckpt(root / "target", seed=11, vocab_size=VOCAB,
                   max_position_embeddings=8192)
    write_qwen2_tokenizer(d)
    draft = write_ckpt(root / "draft", seed=12, vocab_size=VOCAB,
                       hidden_size=16, num_hidden_layers=1,
                       num_attention_heads=2, num_key_value_heads=1,
                       intermediate_size=32, max_position_embeddings=8192)
    corpus = root / "corpus.jsonl"
    corpus.write_text("".join(json.dumps({"text": c.text}, ensure_ascii=False)
                              + "\n" for c in zh_chunks[:200]),
                      encoding="utf-8")
    table = root / "draft_table.npz"
    build_draft_table.main(["--tokenizer", str(d), "--input", str(corpus),
                            "--out", str(table), "--k", "8",
                            "--log2-size", "12"])
    return d, draft, table


def llm_kw(dirs, **over):
    d, draft, table = dirs
    kw = dict(provider="local-jax", model=str(d), temperature=0.0,
              max_new_tokens=NEW_TOKENS, max_context_tokens=2048)
    kw.update({k: {"draft": str(draft), "table": str(table)}.get(v, v)
               for k, v in over.items()})
    return kw


# the five knobs over two engines: the constrained speculative engine with
# lookup and the corpus table, and speculation with a draft model
KNOB_SETS = {
    "constrained_table": dict(spec_k=4, ngram_draft_path="table",
                              spec_adaptive=1.5, constrain_json=True),
    "draft_model": dict(spec_k=4, draft_model="draft", spec_adaptive=0.0),
}


@pytest.fixture(scope="module", params=sorted(KNOB_SETS))
def clients(request, dirs):
    """(the knob set's name, the port's client on the CPU, JAX's)."""
    knobs = KNOB_SETS[request.param]
    port = LLMClient(LLMConfig(**llm_kw(dirs, **knobs)), device="cpu")
    jax = JaxLLMClient(JaxLLMConfig(**llm_kw(dirs, **knobs)))
    lm = port._load_jax_lm()
    assert isinstance(lm, TorchSpecLookupDecoderLM) == ("spec_k" in knobs)
    assert (lm.json_constraint is not None) == ("constrain_json" in knobs)
    if "spec_k" in knobs:
        assert (lm.spec_k, lm.spec_adaptive) == (4, knobs["spec_adaptive"])
        assert (lm.ngram_draft is not None) == ("ngram_draft_path" in knobs)
        assert (lm.draft is not None) == ("draft_model" in knobs)
    return request.param, port, jax


def test_chat_and_stream_match_jax(clients, zh_chunks):
    """The pipeline's zh RAG messages: ``chat`` and ``chat_stream`` equal
    to JAX's; a constrained answer is a complete sections document (the
    budget covers the shortest one)."""
    name, port, jax = clients
    msgs = rag_messages("合同在什么情况下可以解除？", zh_chunks[:4])
    got = list(port.chat_stream(msgs))
    assert got == list(jax.chat_stream(msgs))
    text = "".join(got)
    assert text and text != port.degraded_answer(msgs)
    assert port.chat(msgs) == text
    if port.cfg.constrain_json:
        assert accepts(text) is True, text
        assert isinstance(json.loads(text)["sections"], list)


def test_rag_answer_sse_matches_jax(served, llm_on_both, clients):  # noqa: F811
    """``/rag/answer`` as SSE through both servers: the same events and
    token texts; a constrained answer's sections come out of the scanner
    as events."""
    name, port, jax = clients
    jc, pc, _cfg = served
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
    kinds = [e for e, _ in got]
    assert kinds == [e for e, _ in want]
    tokens = [p["text"] for e, p in got if e == "token"]
    assert tokens == [p["text"] for e, p in want if e == "token"]
    text = "".join(tokens)
    assert text and kinds[-1] == "done"
    if port.cfg.constrain_json:
        doc = json.loads(text)
        assert kinds.count("section") == len(doc["sections"])


@pytest.mark.parametrize("knob,value", [("spec_adaptive", 1.5),
                                        ("draft_model", "draft"),
                                        ("ngram_draft_path", "table")])
def test_speculation_knobs_without_spec_k_are_refused(dirs, knob, value):
    """JAX ignores them without ``spec_k``; the port refuses the load
    naming the knob, and the answer degrades."""
    cfg = LLMConfig(**llm_kw(dirs, **{knob: value}))
    assert unported_engine_knobs(cfg) == [knob]
    assert unported_engine_knobs(LLMConfig(**llm_kw(
        dirs, spec_k=2, **{knob: value}))) == []
    c = LLMClient(cfg, device="cpu")
    with pytest.raises(LLMUnavailable, match=knob):
        c._load_jax_lm()
    msgs = [{"role": "user", "content": "合同可以解除吗"}]
    assert c.chat(msgs) == DEGRADED_ANSWER["zh"]


def test_spec_engine_loads_on_cuda_unless_told(dirs, monkeypatch):
    """``TorchSpecLookupDecoderLM.from_pretrained`` with a draft model and
    the constraint runs on ``cuda`` unless given the CPU."""
    d, draft, table = dirs
    kw = dict(spec_k=4, draft_model=str(draft), ngram_draft=str(table),
              constrain_json=True)
    lm = TorchSpecLookupDecoderLM.from_pretrained(str(d), device="cpu", **kw)
    assert lm.draft.device.type == "cpu" and lm.json_constraint.table.shape \
        == (104, VOCAB)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchSpecLookupDecoderLM.from_pretrained(str(d), **kw)
    with pytest.raises(TypeError):   # the plain engine takes no draft
        TorchDecoderLM.from_pretrained(str(d), device="cpu",
                                       draft_model=str(draft))
