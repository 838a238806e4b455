"""The port's data-parallel decode router (``legalrag_tpu_torch/parallel/
decoder_dp.py``) against the JAX package's (``tests/test_decoder_dp.py``)
on the CPU, float32: replicas of the continuous-batching engine behind one
least-busy front, on JAX's virtual devices and on the port's CPU device
named once per replica.

- every case of ``tests/test_decoder_dp.py``: concurrent streams
  token-identical to JAX's unsharded engine and to JAX's router, both
  replicas taking streams; sequential streams on the first replica; 2
  replicas x 2-way TP, each replica holding its own weights; too few
  devices refused; ``local-jax`` handing ``dp_replicas`` / ``tp_shards``
  and the engine's knobs to the router;
- ``from_pretrained`` building DP x TP from a checkpoint directory;
- ``local-jax`` with ``tp_shards``, ``dp_replicas`` or both (batched and
  paged engines, the visible devices patched to four CPU entries as in
  JAX's client test): each answer equal to JAX's client's."""

import threading

import jax
import pytest
import torch

from legalrag_tpu.config import LLMConfig as JaxLLMConfig
from legalrag_tpu.llm.client import LLMClient as JaxLLMClient
from legalrag_tpu.models.batched_decoder import BatchedDecoderLM
from legalrag_tpu.models.decoder import JaxDecoderLM
from legalrag_tpu.parallel import decoder_tp as jtp
from legalrag_tpu.parallel.decoder_dp import DPDecoderRouter as JaxRouter
from legalrag_tpu.parallel.mesh import make_mesh as jax_make_mesh
from legalrag_tpu_torch.config import LLMConfig
from legalrag_tpu_torch.llm.client import LLMClient
from legalrag_tpu_torch.models.batched_decoder import TorchBatchedDecoderLM
from legalrag_tpu_torch.models.decoder import DecoderConfig, TorchDecoderLM
from legalrag_tpu_torch.models.paged_decoder import TorchPagedDecoderLM
from legalrag_tpu_torch.parallel import decoder_dp
from legalrag_tpu_torch.parallel import mesh as mesh_mod
from legalrag_tpu_torch.parallel.decoder_dp import DPDecoderRouter
from legalrag_tpu_torch.parallel.decoder_tp import (
    TPDecoderModel,
    apply_tp_to_engine,
)
from test_decoder_dp import PROMPTS, tiny  # noqa: F401  (fixture)
from test_torch_bpe import rag_messages
from test_torch_decoder_tp import port_model
from test_torch_generation import llm_kw, model_dir  # noqa: F401 (fixture)

CPU = torch.device("cpu")
ENGINE = dict(max_len=96, n_slots=2, decode_chunk=4)


@pytest.fixture(scope="module")
def cpu8():
    devs = jax.devices("cpu")
    if len(devs) < 8:
        pytest.skip("needs 8 virtual CPU devices")
    return devs[:8]


def port_cfg(jcfg) -> DecoderConfig:
    return DecoderConfig(**{k: getattr(jcfg, k) for k in (
        "vocab_size", "hidden_size", "num_hidden_layers",
        "num_attention_heads", "num_key_value_heads", "intermediate_size",
        "max_position_embeddings")})


def replicas(tiny, n: int, tp: int = 1):  # noqa: F811
    """``n`` port engines on the CPU, each on its own copy of the weights
    (split over a grid naming the CPU ``tp`` times)."""
    jcfg, params = tiny
    engines = []
    for _ in range(n):
        eng = TorchBatchedDecoderLM(port_model(params, port_cfg(jcfg)),
                                    device="cpu", **ENGINE)
        if tp > 1:
            apply_tp_to_engine(eng, mesh_mod.make_mesh([CPU] * tp, data=1,
                                                       model=tp))
        engines.append(eng)
    return engines


def jax_replicas(tiny, devs, tp: int = 1):  # noqa: F811
    """JAX's engines as its tests build them: one a device, or one a
    ``tp``-wide submesh."""
    jcfg, params = tiny
    engines = []
    for r in range(len(devs) // tp):
        sub = devs[r * tp:(r + 1) * tp]
        if tp > 1:
            eng = BatchedDecoderLM(params, jcfg, **ENGINE)
            jtp.apply_tp_to_engine(eng, jax_make_mesh(sub, data=1, model=tp))
        else:
            eng = BatchedDecoderLM(jax.device_put(params, sub[0]), jcfg,
                                   device=sub[0], **ENGINE)
        engines.append(eng)
    return engines


def reference(tiny, prompts, n: int):  # noqa: F811
    jcfg, params = tiny
    ref = JaxDecoderLM(params, jcfg, max_len=96, decode_chunk=1)
    return {tuple(p): list(ref.generate_stream(p, max_new_tokens=n))
            for p in prompts}


def concurrently(router, prompts, n: int):
    got, errors = {}, []

    def run(p):
        try:
            got[tuple(p)] = list(router.generate_stream(p, max_new_tokens=n))
        except Exception as e:  # surfaced in the main thread
            errors.append(e)

    threads = [threading.Thread(target=run, args=(p,)) for p in prompts]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive()
    assert not errors, errors
    return got


def spy_acquire(router):
    """The replica indices the router hands out, in order."""
    seen, orig = [], router._acquire

    def spy():
        i = orig()
        seen.append(i)
        return i

    router._acquire = spy
    return seen


def test_dp_router_token_parity_and_balance(tiny, cpu8):  # noqa: F811
    """Four concurrent streams over two 2-slot replicas: every stream equal
    to JAX's unsharded engine's and to JAX's router's; both replicas take
    streams, and none is active after."""
    want = reference(tiny, PROMPTS, 12)
    jrouter = JaxRouter(jax_replicas(tiny, cpu8[:2]))
    try:
        assert concurrently(jrouter, PROMPTS, 12) == want
    finally:
        jrouter.close()
    router = DPDecoderRouter(replicas(tiny, 2))
    try:
        seen = spy_acquire(router)
        assert concurrently(router, PROMPTS, 12) == want
        assert sorted(set(seen)) == [0, 1]
        assert router.active_per_replica == [0, 0]
    finally:
        router.close()


def test_dp_router_sequential_uses_one_then_balances(tiny):  # noqa: F811
    """Streams one after another each find every replica idle and take the
    first (the argmin of equal loads), as in JAX."""
    want = reference(tiny, PROMPTS[:2], 4)
    router = DPDecoderRouter(replicas(tiny, 2))
    try:
        seen = spy_acquire(router)
        for p in PROMPTS[:2]:
            assert list(router.generate_stream(p, max_new_tokens=4)) \
                == want[tuple(p)]
        assert seen == [0, 0]
    finally:
        router.close()


def test_dp_tp_composition(tiny, cpu8):  # noqa: F811
    """Two replicas, each split 2 ways (4 cells: JAX's 4 virtual devices,
    here the CPU 4 times): streams equal to JAX's unsharded engine's and
    to its router's (JAX's test: two in a row); here two at once, one on
    each replica. The replicas share no weight storage."""
    want = reference(tiny, PROMPTS[:2], 10)
    p0 = PROMPTS[0]
    jrouter = JaxRouter(jax_replicas(tiny, cpu8[:4], tp=2))
    try:
        for _ in range(2):
            assert list(jrouter.generate_stream(p0, max_new_tokens=10)) \
                == want[tuple(p0)]
    finally:
        jrouter.close()
    engines = replicas(tiny, 2, tp=2)
    router = DPDecoderRouter(engines)
    try:
        seen = spy_acquire(router)
        assert concurrently(router, PROMPTS[:2], 10) == want
        assert sorted(seen) == [0, 1]
        held = [{t.untyped_storage().data_ptr()
                 for t in e.model.state_dict().values()} for e in engines]
        assert isinstance(engines[0].model, TPDecoderModel)
        assert held[0] and held[1] and not held[0] & held[1]
    finally:
        router.close()


def test_dp_router_needs_devices():
    """No engine, or fewer devices than replicas x shards, is refused,
    before any load (JAX's too)."""
    with pytest.raises(ValueError):
        DPDecoderRouter([])
    with pytest.raises(ValueError):
        DPDecoderRouter.from_pretrained(TorchBatchedDecoderLM, "x",
                                        replicas=99, tp_shards=4)
    with pytest.raises(ValueError, match="needs 4 devices, have 3"):
        DPDecoderRouter.from_pretrained(TorchBatchedDecoderLM, "x",
                                        replicas=2, tp_shards=2,
                                        devices=[CPU] * 3)
    with pytest.raises(ValueError):
        JaxRouter.from_pretrained(BatchedDecoderLM, "x", replicas=99,
                                  tp_shards=4)


def test_client_plumbs_dp_replicas(monkeypatch):
    """``local-jax`` with ``batch_slots`` 2, ``dp_replicas`` 2 and
    ``tp_shards`` 2 hands the router the batched engine, the counts, the
    engine's knobs and the visible devices."""
    captured = {}

    def fake(engine_cls, name, replicas, tp_shards=0, **kw):
        captured.update(kw, engine_cls=engine_cls, replicas=replicas,
                        tp_shards=tp_shards)
        return object()

    monkeypatch.setattr(decoder_dp.DPDecoderRouter, "from_pretrained",
                        staticmethod(fake))
    c = LLMClient(LLMConfig(provider="local-jax", batch_slots=2,
                            dp_replicas=2, tp_shards=2, weight_quant=True),
                  device="cpu")
    c._load_jax_lm()
    assert captured["replicas"] == 2 and captured["tp_shards"] == 2
    assert captured["engine_cls"] is TorchBatchedDecoderLM
    assert captured["n_slots"] == 2 and captured["weight_quant"] is True
    assert captured["devices"] == [CPU]


def test_from_pretrained_builds_dp_x_tp(model_dir):  # noqa: F811
    """Two replicas loaded from a checkpoint directory, each split over
    its own 2-cell submesh: streams equal to the unsharded engine's."""
    prompts = [[5, 6, 7, 8, 9, 10, 11], [40, 41, 42]]
    ref = TorchDecoderLM.from_pretrained(str(model_dir), device="cpu",
                                         max_len=64)
    want = {tuple(p): list(ref.generate_stream(p, max_new_tokens=8))
            for p in prompts}
    router = DPDecoderRouter.from_pretrained(
        TorchBatchedDecoderLM, str(model_dir), replicas=2, tp_shards=2,
        devices=[CPU] * 4, max_len=64, n_slots=2)
    try:
        assert all(isinstance(e.model, TPDecoderModel) and e.model.tp == 2
                   for e in router.engines)
        seen = spy_acquire(router)
        assert concurrently(router, prompts, 8) == want
        assert sorted(seen) == [0, 1]
    finally:
        router.close()


SERVED = {"tp": dict(tp_shards=2),
          "dp": dict(batch_slots=4, dp_replicas=2),
          "dp_tp": dict(batch_slots=4, dp_replicas=2, tp_shards=2),
          "paged_tp": dict(batch_slots=4, paged_kv=True, tp_shards=4)}


@pytest.fixture(scope="module")
def jax_answer(model_dir, zh_chunks):  # noqa: F811
    """JAX's ``local-jax`` answer to the zh RAG messages (unsharded)."""
    msgs = rag_messages("合同在什么情况下可以解除？", zh_chunks[:4])
    return msgs, JaxLLMClient(JaxLLMConfig(**llm_kw(model_dir))).chat(msgs)


@pytest.mark.parametrize("case", sorted(SERVED))
def test_local_jax_serves_tp_and_dp(model_dir, jax_answer, monkeypatch,
                                    case):  # noqa: F811
    """``local-jax`` over four visible devices (``local_devices`` patched
    to the CPU four times, the seam JAX's client test uses): ``tp_shards``
    splits the engine over the first devices, ``dp_replicas`` builds the
    router (each replica on its own submesh with ``tp_shards``), and the
    answer equals JAX's client's."""
    monkeypatch.setattr(mesh_mod, "local_devices",
                        lambda platform=None: [CPU] * 4)
    msgs, want = jax_answer
    settings = SERVED[case]
    c = LLMClient(LLMConfig(**llm_kw(model_dir, **settings)), device="cpu")
    try:
        lm = c._load_jax_lm()
        engines = lm.engines if settings.get("dp_replicas") else [lm]
        assert len(engines) == settings.get("dp_replicas", 1)
        tp = settings.get("tp_shards", 1)
        for e in engines:
            assert isinstance(e, TorchPagedDecoderLM if settings.get(
                "paged_kv") else TorchBatchedDecoderLM if settings.get(
                "batch_slots") else TorchDecoderLM)
            assert (e.model.tp if tp > 1 else 1) == tp
        assert c.chat(msgs) == want
    finally:
        c.close()
