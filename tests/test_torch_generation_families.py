"""The port's ``local-jax`` provider on a Gemma 3 and a Llama 3 checkpoint
against the JAX package's, on the CPU, each on one directory: a tiny
random model saved by transformers (``tests/test_torch_decoder.py``'s
``write_ckpt``: Gemma 3 with its local RoPE, q/k norms, a window of 16 on
two layers of three; Llama with llama3 RoPE) beside a tokenizer of its
family's layout trained on the statutes (``tests/test_torch_bpe_layouts``:
Gemma's sentencepiece-style BPE with byte fallback and gemma-3's chat
template; Llama 3's byte-level BPE, its BOS added by the post-processor
after the one the template writes, Llama 3.2's template). At temperature
0, ``chat`` and ``chat_stream`` must give the same text and chunks, and
``/rag/answer``'s SSE events from the two servers must be equal. Gemma
3's template refuses the pipeline's second system message (the selected
example): both packages then give the degraded answer."""

import pytest

from legalrag_tpu.config import LLMConfig as JaxLLMConfig
from legalrag_tpu.llm.client import LLMClient as JaxLLMClient
from legalrag_tpu.llm.gateway import LLMGateway as JaxGateway
from legalrag_tpu_torch.config import LLMConfig
from legalrag_tpu_torch.llm import DEGRADED_ANSWER
from legalrag_tpu_torch.llm.client import LLMClient
from legalrag_tpu_torch.llm.gateway import LLMGateway
from legalrag_tpu_torch.models.decoder import TorchDecoderLM
from test_torch_bpe import rag_messages
from test_torch_bpe_layouts import write_layout_tokenizer
from test_torch_decoder import write_ckpt
from test_torch_server import llm_on_both, served, sse  # noqa: F401  (fixtures)

NEW_TOKENS = 24
CHECKPOINTS = {
    "gemma3": (dict(family="gemma3", tie_word_embeddings=False,
                    num_hidden_layers=3, query_pre_attn_scalar=16,
                    sliding_window=16, sliding_window_pattern=3,
                    rope_theta=1e6, rope_local_base_freq=1e4), "gemma"),
    "llama3": (dict(family="llama", rope_scaling={
        "rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
        "high_freq_factor": 4.0, "original_max_position_embeddings": 64}),
        "llama3"),
}


@pytest.fixture(scope="module", params=sorted(CHECKPOINTS))
def clients(request, tmp_path_factory):
    """(family, the port's client on the CPU, the JAX package's), both
    loaded on one directory; the model's vocabulary is the tokenizer's
    rounded up to 64 (ids past it have no token)."""
    from tokenizers import Tokenizer

    model_kw, layout = CHECKPOINTS[request.param]
    d = write_layout_tokenizer(tmp_path_factory.mktemp(request.param), layout)
    n = Tokenizer.from_file(str(d / "tokenizer.json")).get_vocab_size()
    write_ckpt(d, seed=13, vocab_size=-(-n // 64) * 64,
               max_position_embeddings=8192, **model_kw)
    kw = dict(provider="local-jax", model=str(d), temperature=0.0,
              max_new_tokens=NEW_TOKENS, max_context_tokens=2048)
    port = LLMClient(LLMConfig(**kw), device="cpu")
    jax = JaxLLMClient(JaxLLMConfig(**kw))
    assert isinstance(port._load_jax_lm(), TorchDecoderLM)
    return request.param, port, jax


def test_chat_and_stream_match_jax(clients, zh_chunks, en_chunks):
    """The pipeline's zh and en RAG messages, one user turn, a system turn
    then a user turn: ``chat`` text and ``chat_stream`` chunks equal to
    JAX's; Gemma 3's template refuses the RAG messages, and both degrade."""
    family, port, jax = clients
    chats = {"rag_zh": rag_messages("合同在什么情况下可以解除？", zh_chunks[:4]),
             "rag_en": rag_messages("What must a buyer do to reject goods?",
                                    en_chunks[:4]),
             "user": [{"role": "user", "content": "借款合同的利息如何约定？"}],
             "system_user": [{"role": "system", "content": "你是法律助手。"},
                             {"role": "user", "content": "租赁合同怎么解除？"}]}
    for name, msgs in chats.items():
        got = list(port.chat_stream(msgs))
        assert got == list(jax.chat_stream(msgs)), name
        assert port.chat(msgs) == jax.chat(msgs) == "".join(got)
        degraded = got == [port.degraded_answer(msgs)]
        assert degraded == (family == "gemma3" and name.startswith("rag")), \
            (name, got)
        if not degraded:
            assert "".join(got)


def test_rag_answer_sse_matches_jax(served, llm_on_both, clients):  # noqa: F811
    """``/rag/answer`` as SSE through both servers with ``local-jax``: the
    same events, token texts included (Gemma 3: the degraded answer)."""
    jc, pc, _cfg = served
    family, port, jax = clients
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
    assert [e for e, _ in got] == [e for e, _ in want]
    assert got[-1][0] == "done" and "".join(tokens)
    assert ("".join(tokens) == DEGRADED_ANSWER["zh"]) == (family == "gemma3")
