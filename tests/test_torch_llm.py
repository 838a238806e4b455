"""Port LLM client and gateway (``llm/client.py``, ``llm/gateway.py``,
``llm/context.py``) vs the JAX package's on the CPU. Both clients talk to
one OpenAI-compatible stub on 127.0.0.1 (``chip_smoke.OpenAIStub``): the
same request payloads, replies, streamed chunks, degraded answers and
"generation interrupted" tails, exactly (strings). No test reaches the
network: the keyed case points at a closed loopback port, and the local
provider may read local files only."""

import socket
import sys
import threading
import time
import types

import pytest

from chip_smoke import OpenAIStub
from legalrag_tpu.config import AppConfig as JaxConfig
from legalrag_tpu.llm import client as jax_client
from legalrag_tpu.llm.gateway import LLMGateway as JaxGateway
from legalrag_tpu_torch.config import AppConfig
from legalrag_tpu_torch.llm import (
    DEGRADED_ANSWER,
    LLMClient,
    LLMGateway,
    get_request_id,
    reset_request_id,
    set_request_id,
)
from legalrag_tpu_torch.llm import client as port_client

ZH = [{"role": "system", "content": "你是法律助手"},
      {"role": "user", "content": "合同可以解除吗"}]
EN = [{"role": "user", "content": "Can the buyer reject the goods?"}]
REPLY = "结论：可以解除。分析：依据第五百六十三条。"


def closed_port() -> int:
    """A loopback port with nothing listening (bound, then released)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def configs(**llm):
    jcfg, cfg = JaxConfig(), AppConfig()
    for c in (jcfg, cfg):
        for k, v in llm.items():
            setattr(c.llm, k, v)
    return jcfg, cfg


@pytest.fixture(scope="module")
def stub():
    s = OpenAIStub(lambda messages: REPLY, chunk=5)
    yield s
    s.close()


def test_degraded_answers_match_jax():
    assert DEGRADED_ANSWER == jax_client.DEGRADED_ANSWER
    jcfg, cfg = configs(provider="disabled", api_key=None)
    port, jax = LLMClient(cfg.llm), jax_client.LLMClient(jcfg.llm)
    for msgs in (ZH, EN, []):
        assert port.chat(msgs) == jax.chat(msgs)
        assert list(port.chat_stream(msgs)) == list(jax.chat_stream(msgs))
    assert port.is_degraded and jax.is_degraded


@pytest.mark.parametrize("model", ["gpt-4o-mini", "gpt-5-mini", "o1", "o3-mini",
                                   "turbo1", "qwen-thinking", "Qwen/Qwen2.5-7B"])
def test_openai_payload_matches_jax(model):
    """The reasoning-model quirk: no sampling params, max_completion_tokens."""
    jcfg, cfg = configs(provider="openai", api_key="sk-x", model=model)
    port, jax = LLMClient(cfg.llm), jax_client.LLMClient(jcfg.llm)
    for stream in (False, True):
        for budget in (None, 17):
            assert port._openai_payload(ZH, budget, stream) == \
                jax._openai_payload(ZH, budget, stream)
    assert port_client._is_reasoning_model(model) == \
        jax_client._is_reasoning_model(model)


def test_openai_chat_and_stream_through_a_loopback_stub_match_jax(stub):
    jcfg, cfg = configs(provider="openai", api_key="sk-stub", base_url=stub.url,
                        model="gpt-4o-mini", max_new_tokens=64)
    port, jax = LLMClient(cfg.llm), jax_client.LLMClient(jcfg.llm)
    n0 = len(stub.requests)
    assert port.chat(ZH) == jax.chat(ZH) == REPLY
    got, want = list(port.chat_stream(EN)), list(jax.chat_stream(EN))
    assert got == want and "".join(got) == REPLY and len(got) > 1
    port_plain, jax_plain, port_sse, jax_sse = stub.requests[n0:]
    assert port_plain == jax_plain and port_sse == jax_sse
    assert port_sse["stream"] is True and port_plain["max_tokens"] == 64


def test_openai_without_key_is_disabled():
    jcfg, cfg = configs(provider="openai", api_key=None)
    port, jax = LLMClient(cfg.llm), jax_client.LLMClient(jcfg.llm)
    assert port.provider == jax.provider == "disabled"
    assert port.chat(EN) == jax.chat(EN) == DEGRADED_ANSWER["en"]


def test_unreachable_openai_degrades_after_two_attempts():
    base = f"http://127.0.0.1:{closed_port()}/v1"
    jcfg, cfg = configs(provider="openai", api_key="sk-x", base_url=base,
                        request_timeout=2.0)
    port, jax = LLMClient(cfg.llm), jax_client.LLMClient(jcfg.llm)
    calls = []
    orig = port._chat_openai
    port._chat_openai = lambda *a: calls.append(1) or orig(*a)
    assert port.chat(ZH) == jax.chat(ZH) == DEGRADED_ANSWER["zh"]
    assert len(calls) == 2
    assert list(port.chat_stream(EN)) == list(jax.chat_stream(EN)) == \
        [DEGRADED_ANSWER["en"]]


@pytest.mark.parametrize("msgs", [ZH, EN], ids=["zh", "en"])
def test_stream_dying_mid_answer_ends_with_the_interrupted_tail(msgs):
    def dying(messages, max_new_tokens):
        yield "第一段。"
        yield "第二段"
        raise ConnectionResetError("stream lost")

    jcfg, cfg = configs(provider="openai", api_key="sk-x")
    port, jax = LLMClient(cfg.llm), jax_client.LLMClient(jcfg.llm)
    port._stream_openai = jax._stream_openai = dying
    got = list(port.chat_stream(msgs))
    assert got == list(jax.chat_stream(msgs))
    assert got[:2] == ["第一段。", "第二段"]
    assert "生成中断" in got[-1] or "interrupted" in got[-1]


def test_providers_the_port_lacks_degrade():
    """``local-jax`` with a model that is not on disk (the port's decoder
    engine cannot load it), and a provider no package has, degrade as the
    JAX client degrades for a provider it cannot load."""
    for provider in ("local-jax", "no-such-provider"):
        _j, cfg = configs(provider=provider, model="nonexistent/decoder-model")
        c = LLMClient(cfg.llm)
        assert c.chat(EN) == DEGRADED_ANSWER["en"]
        assert list(c.chat_stream(ZH)) == [DEGRADED_ANSWER["zh"]]


def test_local_provider_reads_local_files_only_and_degrades(monkeypatch):
    """``local`` without transformers (as on the card's machine), or
    without the model on disk, degrades; it asks transformers for local
    files only, so it never downloads."""
    _j, cfg = configs(provider="local", model="nonexistent/causal-lm")
    monkeypatch.setitem(sys.modules, "transformers", None)
    c = LLMClient(cfg.llm)
    assert c.chat(EN) == DEGRADED_ANSWER["en"]
    assert list(c.chat_stream(ZH)) == [DEGRADED_ANSWER["zh"]]

    asked = []

    class Missing:
        @staticmethod
        def from_pretrained(name, **kw):
            asked.append((name, kw.get("local_files_only")))
            raise OSError(f"{name} is not on disk")

    fake = types.ModuleType("transformers")
    fake.AutoTokenizer = fake.AutoModelForCausalLM = Missing
    monkeypatch.setitem(sys.modules, "transformers", fake)
    c = LLMClient(cfg.llm)
    assert c.chat(EN) == DEGRADED_ANSWER["en"]
    assert list(c.chat_stream(ZH)) == [DEGRADED_ANSWER["zh"]]
    assert asked == [("nonexistent/causal-lm", True)] * 2


def test_factories_match_jax():
    jcfg, cfg = configs(provider="disabled")
    assert LLMClient.from_config(cfg) is LLMClient.from_config(cfg)
    a = LLMClient.from_config_with_key(cfg, "sk-user-1")
    b = LLMClient.from_config_with_key(cfg, "sk-user-1")
    c = LLMClient.from_config_with_key(cfg, "sk-user-2")
    assert a is b and a is not c
    j = jax_client.LLMClient.from_config_with_key(jcfg, "sk-user-1")
    assert (a.provider, a.api_key) == (j.provider, j.api_key) == \
        ("openai", "sk-user-1")
    assert cfg.llm.provider == "disabled"  # the server's config is untouched
    assert vars(a.cfg) == {k: getattr(j.cfg, k) for k in vars(a.cfg)}


class Echo:
    """A minimal client for the gateway: replies, or sleeps first."""

    def __init__(self, cfg, sleep=0.0, fail=0):
        self.cfg, self.sleep, self.fail, self.calls = cfg, sleep, fail, 0

    def chat(self, messages, tag="chat", **kw):
        self.calls += 1
        if self.calls <= self.fail:
            raise RuntimeError("transient")
        time.sleep(self.sleep)
        return f"{tag}:{get_request_id()}"

    def chat_stream(self, messages, tag="chat", **kw):
        yield from ("a", "b")

    def degraded_answer(self, messages):
        return "degraded"

    is_degraded = False


@pytest.mark.parametrize("case", ["timeout", "retry", "passthrough"])
def test_gateway_matches_jax(case):
    jcfg, cfg = configs(request_timeout=0.2, max_retries=1, retry_backoff=0.01)
    kw = {"timeout": dict(sleep=1.0), "retry": dict(fail=1),
          "passthrough": {}}[case]
    outs = []
    for cfg_, gw_cls in ((cfg, LLMGateway), (jcfg, JaxGateway)):
        client = Echo(cfg_.llm, **kw)
        gw = gw_cls(client)
        token = set_request_id(f"rid-{case}")
        try:
            outs.append((gw.chat(ZH, tag="answer"), client.calls,
                         list(gw.chat_stream(ZH)), gw.is_degraded))
        finally:
            reset_request_id(token)
            gw.close()
    assert outs[0] == outs[1]
    assert outs[0][0] == {"timeout": "degraded", "retry": f"answer:rid-{case}",
                          "passthrough": f"answer:rid-{case}"}[case]


def test_request_id_survives_the_gateway_thread_hop():
    seen, outer = [], get_request_id()
    token = set_request_id("abc123")
    try:
        t = threading.Thread(target=lambda: seen.append(get_request_id()))
        t.start()
        t.join(timeout=10)
        assert not t.is_alive() and seen == [None]  # a bare thread: no id
        gw = LLMGateway(Echo(AppConfig().llm))
        assert gw.chat(EN) == "chat:abc123"
        gw.close()
    finally:
        reset_request_id(token)
    assert get_request_id() == outer
