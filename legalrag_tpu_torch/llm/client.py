"""Provider-agnostic LLM client (port of ``legalrag_tpu/llm/client.py``).

- Providers: ``openai`` (chat completions over stdlib HTTP, no SDK),
  ``local`` (a transformers causal LM from local files, imported lazily;
  without transformers, or without the model on disk, it degrades and never
  downloads), ``local-jax`` (the in-repo decoder on the port's device: the
  single-stream ``TorchDecoderLM`` over the dense families, Qwen2 / 2.5 /
  3, Llama, Mistral and Gemma 1 / 2 / 3, and the mixture-of-experts ones,
  Mixtral and Qwen2-MoE, or with ``spec_k > 0`` the speculative
  ``TorchSpecLookupDecoderLM`` (``models/spec_decode.py``), with the port's
  own BPE tokenizer
  in the layout the checkpoint ships, byte-level or sentencepiece-style,
  and its chat template, ``models/decoder.py``, ``tokenize/bpe.py``; the
  provider keeps its name, so one config file serves both packages; with
  ``batch_slots > 1`` the continuous-batching ``TorchBatchedDecoderLM``,
  ``models/batched_decoder.py``, whose concurrent streams share one decode
  loop, with the pinned ``shared_prefix_text``)
  and ``disabled`` (expects a per-request user key; degrades otherwise).
  Any other provider name raises ``LLMUnavailable`` and so gets the
  degraded answer.
- ``local-jax`` loads once, under a lock, with a KV cache of
  ``max_context_tokens + max_new_tokens`` rows, its weights quantized
  under ``weight_quant`` (int8, or int4 with ``weight_bits`` 4) and its
  cache int8 under ``kv_quant``, the JSON constraint under
  ``constrain_json`` (passed to the load and to every stream), and with
  ``spec_k > 0`` speculation with ``spec_adaptive``, ``draft_model`` and
  the corpus table at ``ngram_draft_path``, as JAX's client asks its
  single-stream engines; ``batch_slots > 1`` (without ``paged_kv``) the
  batched engine of that many slots, with ``shared_prefix_text`` and, with
  ``spec_k > 0``, per-slot speculation with ``draft_model`` and the corpus
  table; with ``paged_kv`` the paged engine. Any of them is split over
  ``tp_shards`` devices (``parallel/decoder_tp.py``) and replicated
  ``dp_replicas`` times behind a least-busy router
  (``parallel/decoder_dp.py``), over the visible devices as JAX's client
  takes them; fewer devices than asked fail the load. A knob JAX ignores
  in the engine asked for (``unported_engine_knobs``: a speculation knob
  without ``spec_k``, ``shared_prefix_text`` without ``batch_slots > 1``,
  ``spec_adaptive`` with it, ...) makes the load fail with
  ``LLMUnavailable`` naming it, so the answer degrades as it does in JAX
  when a load fails; no knob is ignored.
- Reasoning models (gpt-5, o1, o3, "thinking") get no temperature or top_p
  and ``max_completion_tokens`` in place of ``max_tokens``.
- ``chat`` makes two attempts, then returns the degraded answer: a fixed
  "model unavailable, showing retrieval only" text instead of an exception,
  so retrieval results always reach the user.
- ``chat_stream`` yields text chunks; the OpenAI SSE frames are parsed as
  they arrive, and ``local-jax`` decodes every token so far, holding text
  back while it ends in a partial UTF-8 character. A stream that dies
  after its first chunk ends with a "generation interrupted" tail; one
  that dies before gives the degraded answer.
- ``from_config`` (one client per ``LLMConfig`` and device) and
  ``from_config_with_key`` (a client per user key, which forces the
  ``openai`` provider).
"""

from __future__ import annotations

import dataclasses
import json
import re
import threading
import urllib.request
from typing import Dict, Generator, List, Optional

from legalrag_tpu_torch.config import AppConfig, LLMConfig
from legalrag_tpu_torch.llm.context import get_request_id
from legalrag_tpu_torch.utils import get_logger, has_chinese
from legalrag_tpu_torch.utils.device import DeviceLike
from legalrag_tpu_torch.utils.metrics import METRICS

log = get_logger("torch.llm.client")

Message = Dict[str, str]

DEGRADED_ANSWER = {
    "zh": "（当前未配置生成模型或模型暂不可用，以下仅展示检索到的相关条文，请结合原文自行判断。）",
    "en": "(No generation model is configured or the model is temporarily "
          "unavailable; showing retrieved provisions only.)",
}


def _is_reasoning_model(model: str) -> bool:
    """gpt-5 / o1 / o3 / "thinking" families reject sampling params. o1 and
    o3 match as whole name segments, so "turbo1" is not one."""
    m = (model or "").lower()
    if "gpt-5" in m or "thinking" in m:
        return True
    return any(seg in ("o1", "o3") for seg in re.split(r"[^a-z0-9]+", m))


class LLMUnavailable(RuntimeError):
    pass


# the speculative engines' knobs, which JAX's client ignores without
# spec_k > 0 and the port refuses there
_SPEC_KNOBS = ("spec_adaptive", "draft_model", "ngram_draft_path")
# the batched and paged engines' knobs, which JAX ignores without
# batch_slots > 1
_BATCHED_KNOBS = ("shared_prefix_text", "paged_kv", "kv_block_size",
                  "kv_pool_blocks")
# the paged engine's shape, which JAX ignores without paged_kv
_PAGED_KNOBS = ("kv_block_size", "kv_pool_blocks")
# the knobs JAX's client drops under paged_kv (the radix tree stands in)
_PAGED_DROPPED_KNOBS = ("prefix_cache", "shared_prefix_text")
# the single-stream speculative engine's knob, which JAX's batched and
# paged ones ignore
_SINGLE_STREAM_SPEC_KNOBS = ("spec_adaptive",)


def unported_engine_knobs(cfg: LLMConfig) -> List[str]:
    """The knobs of ``cfg`` that ``local-jax`` refuses: those set away from
    their defaults that JAX would ignore in the engine ``cfg`` selects (the
    speculation knobs without ``spec_k > 0``, ``shared_prefix_text`` and
    the paged knobs without ``batch_slots > 1``, ``spec_adaptive`` with
    it, the block size and pool without ``paged_kv``, ``prefix_cache`` and
    ``shared_prefix_text`` with it)."""
    default = LLMConfig()
    batched = cfg.batch_slots > 1
    ignored = (_SPEC_KNOBS if cfg.spec_k <= 0
               else _SINGLE_STREAM_SPEC_KNOBS if batched else ())
    if not batched:
        ignored += _BATCHED_KNOBS
    elif cfg.paged_kv:
        ignored += _PAGED_DROPPED_KNOBS
    else:
        ignored += _PAGED_KNOBS
    return [k for k in ignored if getattr(cfg, k) != getattr(default, k)]


class LLMClient:
    _singleton: Optional["LLMClient"] = None
    _keyed_cache: Dict[str, "LLMClient"] = {}
    _cache_lock = threading.Lock()

    def __init__(self, cfg: LLMConfig, api_key: Optional[str] = None,
                 device: DeviceLike = None):
        self.cfg = cfg
        self.api_key = api_key or cfg.api_key
        self.provider = cfg.provider
        if self.provider == "openai" and not self.api_key:
            self.provider = "disabled"
        # local-jax decodes here (None: cuda, and no load without it)
        self.device = device
        # (tokenizer, model) of the local provider, or local-jax's engine
        self._local = None
        # serving threads share this client: one model load, not one each
        self._load_lock = threading.Lock()

    # ------------------------------------------------------------ factories
    @classmethod
    def from_config(cls, cfg: AppConfig, device: DeviceLike = None
                    ) -> "LLMClient":
        with cls._cache_lock:
            if (cls._singleton is None or cls._singleton.cfg is not cfg.llm
                    or cls._singleton.device != device):
                cls._singleton = cls(cfg.llm, device=device)
            return cls._singleton

    @classmethod
    def from_config_with_key(cls, cfg: AppConfig, user_key: str) -> "LLMClient":
        with cls._cache_lock:
            client = cls._keyed_cache.get(user_key)
            if client is None:
                llm_cfg = dataclasses.replace(cfg.llm, provider="openai")
                client = cls(llm_cfg, api_key=user_key)
                if len(cls._keyed_cache) < 256:
                    cls._keyed_cache[user_key] = client
        return client

    # ----------------------------------------------------------------- chat
    def chat(self, messages: List[Message], tag: str = "chat",
             max_new_tokens: Optional[int] = None) -> str:
        rid = get_request_id()
        last_err: Optional[Exception] = None
        for attempt in range(2):
            try:
                if self.provider == "openai":
                    return self._chat_openai(messages, max_new_tokens)
                if self.provider == "local":
                    return self._chat_local(messages, max_new_tokens)
                if self.provider == "local-jax":
                    return "".join(self._stream_jax(messages, max_new_tokens))
                raise LLMUnavailable(f"provider {self.provider!r} is "
                                     "disabled or not available")
            except LLMUnavailable as e:
                last_err = e
                break
            except Exception as e:
                last_err = e
                log.warning("[%s] llm %s attempt %d failed: %s",
                            rid, tag, attempt + 1, e)
        log.info("[%s] llm %s degraded (%s)", rid, tag, last_err)
        return self.degraded_answer(messages)

    def chat_stream(self, messages: List[Message], tag: str = "chat",
                    max_new_tokens: Optional[int] = None
                    ) -> Generator[str, None, None]:
        yielded = False
        try:
            streams = {"openai": self._stream_openai,
                       "local": self._stream_local,
                       "local-jax": self._stream_jax}
            fn = streams.get(self.provider)
            if fn is not None:
                for chunk in fn(messages, max_new_tokens):
                    yielded = True
                    yield chunk
                return
        except Exception as e:
            log.warning("[%s] llm stream %s failed: %s", get_request_id(), tag, e)
        if yielded:
            # the provider died mid-answer: mark the truncation rather than
            # append the "no model is configured" text to half an answer
            text = " ".join(m.get("content", "") for m in messages)
            yield ("……（生成中断）" if has_chinese(text)
                   else " … (generation interrupted)")
        else:
            yield self.degraded_answer(messages)

    def degraded_answer(self, messages: List[Message]) -> str:
        text = " ".join(m.get("content", "") for m in messages)
        return DEGRADED_ANSWER["zh" if has_chinese(text) else "en"]

    @property
    def is_degraded(self) -> bool:
        return self.provider == "disabled"

    def close(self) -> None:
        """Drop the local model or engine (the batched engine's worker
        thread stopped, its open streams ended). Idempotent."""
        local, self._local = self._local, None
        if local is not None and hasattr(local, "close"):
            try:
                local.close()
            except Exception:
                log.warning("local engine close failed", exc_info=True)

    # --------------------------------------------------------------- openai
    def _openai_payload(self, messages: List[Message],
                        max_new_tokens: Optional[int], stream: bool) -> dict:
        payload: dict = {
            "model": self.cfg.model,
            "messages": messages,
            "stream": stream,
        }
        budget = max_new_tokens or self.cfg.max_new_tokens
        if _is_reasoning_model(self.cfg.model):
            # reasoning families reject sampling params and max_tokens
            payload["max_completion_tokens"] = budget
        else:
            # max_tokens keeps OpenAI-compatible local servers working
            payload["max_tokens"] = budget
            payload["temperature"] = self.cfg.temperature
            payload["top_p"] = self.cfg.top_p
        return payload

    def _openai_request(self, payload: dict) -> urllib.request.Request:
        base = (self.cfg.base_url or "https://api.openai.com/v1").rstrip("/")
        return urllib.request.Request(
            f"{base}/chat/completions",
            data=json.dumps(payload).encode("utf-8"),
            headers={"Content-Type": "application/json",
                     "Authorization": f"Bearer {self.api_key}"},
            method="POST")

    def _chat_openai(self, messages: List[Message],
                     max_new_tokens: Optional[int]) -> str:
        req = self._openai_request(self._openai_payload(messages,
                                                        max_new_tokens, False))
        with urllib.request.urlopen(req, timeout=self.cfg.request_timeout) as r:
            obj = json.loads(r.read().decode("utf-8"))
        return obj["choices"][0]["message"]["content"] or ""

    def _stream_openai(self, messages: List[Message],
                       max_new_tokens: Optional[int]
                       ) -> Generator[str, None, None]:
        req = self._openai_request(self._openai_payload(messages,
                                                        max_new_tokens, True))
        with urllib.request.urlopen(req, timeout=self.cfg.request_timeout) as r:
            for raw in r:
                line = raw.decode("utf-8").strip()
                if not line.startswith("data:"):
                    continue
                data = line[5:].strip()
                if data == "[DONE]":
                    break
                try:
                    delta = json.loads(data)["choices"][0]["delta"]
                except (json.JSONDecodeError, KeyError, IndexError):
                    continue
                piece = delta.get("content")
                if piece:
                    yield piece

    # ---------------------------------------------------------------- local
    def _load_local(self):
        with self._load_lock:
            if self._local is None:
                try:
                    import torch
                    from transformers import AutoModelForCausalLM, AutoTokenizer
                except ImportError as e:
                    raise LLMUnavailable(f"transformers unavailable: {e}") from e
                try:
                    # local files only: the server never downloads a model
                    tok = AutoTokenizer.from_pretrained(
                        self.cfg.model, local_files_only=True)
                    cuda = torch.cuda.is_available()
                    model = AutoModelForCausalLM.from_pretrained(
                        self.cfg.model, local_files_only=True,
                        torch_dtype=torch.float16 if cuda else torch.float32)
                    model.to("cuda" if cuda else "cpu")
                except Exception as e:
                    raise LLMUnavailable(f"local model load failed: {e}") from e
                self._local = (tok, model)
            return self._local

    def _local_inputs(self, tok, messages: List[Message]):
        prompt = tok.apply_chat_template(messages, tokenize=False,
                                         add_generation_prompt=True)
        return tok(prompt, return_tensors="pt",
                   truncation=True, max_length=self.cfg.max_context_tokens)

    def _chat_local(self, messages: List[Message],
                    max_new_tokens: Optional[int]) -> str:
        tok, model = self._load_local()
        inputs = self._local_inputs(tok, messages).to(model.device)
        out = model.generate(
            **inputs, max_new_tokens=max_new_tokens or self.cfg.max_new_tokens,
            do_sample=self.cfg.temperature > 0,
            temperature=max(self.cfg.temperature, 1e-5),
            top_p=self.cfg.top_p, repetition_penalty=1.05)
        gen = out[0][inputs["input_ids"].shape[1]:]
        return tok.decode(gen, skip_special_tokens=True)

    def _stream_local(self, messages: List[Message],
                      max_new_tokens: Optional[int]
                      ) -> Generator[str, None, None]:
        tok, model = self._load_local()
        from transformers import TextIteratorStreamer

        inputs = self._local_inputs(tok, messages).to(model.device)
        # a generate() error would otherwise die silently in its thread
        # while the consumer blocks forever
        streamer = TextIteratorStreamer(tok, skip_prompt=True,
                                        skip_special_tokens=True,
                                        timeout=300.0)
        kwargs = dict(**inputs, streamer=streamer,
                      max_new_tokens=max_new_tokens or self.cfg.max_new_tokens,
                      do_sample=self.cfg.temperature > 0,
                      temperature=max(self.cfg.temperature, 1e-5),
                      top_p=self.cfg.top_p)
        thread = threading.Thread(target=model.generate, kwargs=kwargs,
                                  daemon=True)
        thread.start()
        yield from streamer

    # ------------------------------------------------------------ local-jax
    def _load_jax_lm(self):
        """The decoder engine (``TorchDecoderLM``, with ``spec_k > 0``
        ``TorchSpecLookupDecoderLM``, with ``batch_slots > 1``
        ``TorchBatchedDecoderLM``, and with ``paged_kv`` too
        ``TorchPagedDecoderLM``; split and replicated by ``tp_shards`` and
        ``dp_replicas``), loaded once under the lock; ``LLMUnavailable``
        when the config sets a knob that engine ignores or the load
        fails."""
        with self._load_lock:
            if self._local is None:
                knobs = unported_engine_knobs(self.cfg)
                if knobs:
                    raise LLMUnavailable(
                        "local-jax: knobs the selected engine ignores: "
                        + ", ".join(knobs))
                try:
                    from legalrag_tpu_torch.models.decoder import \
                        TorchDecoderLM

                    # a full-context prompt can still generate
                    # max_new_tokens (generation clamps at capacity)
                    kw = dict(max_len=self.cfg.max_context_tokens
                              + self.cfg.max_new_tokens,
                              decode_chunk=self.cfg.decode_chunk,
                              prefix_cache=self.cfg.prefix_cache,
                              kv_quant=self.cfg.kv_quant,
                              weight_quant=self.cfg.weight_quant,
                              weight_bits=self.cfg.weight_bits,
                              constrain_json=self.cfg.constrain_json)
                    if self.cfg.prefill_chunk:
                        kw["prefill_chunk"] = self.cfg.prefill_chunk
                    engine_cls = TorchDecoderLM
                    if self.cfg.batch_slots > 1 and self.cfg.paged_kv:
                        # the paged KV pool with radix prefix reuse: the
                        # cache rounded up to whole blocks; spec_k > 0
                        # speculates over the block tables
                        from legalrag_tpu_torch.models.paged_decoder \
                            import TorchPagedDecoderLM

                        engine_cls = TorchPagedDecoderLM
                        kw.pop("prefix_cache")
                        bs = self.cfg.kv_block_size
                        kw["max_len"] = -(-kw["max_len"] // bs) * bs
                        kw.update(n_slots=self.cfg.batch_slots,
                                  spec_k=max(self.cfg.spec_k, 0),
                                  block_size=bs,
                                  pool_blocks=self.cfg.kv_pool_blocks)
                        if self.cfg.spec_k > 0:
                            if self.cfg.ngram_draft_path:
                                kw["ngram_draft"] = self.cfg.ngram_draft_path
                            if self.cfg.draft_model:
                                kw["draft_model"] = self.cfg.draft_model
                    elif self.cfg.batch_slots > 1:
                        # continuous batching: concurrent streams share one
                        # decode loop; spec_k > 0 adds per-slot speculation
                        from legalrag_tpu_torch.models.batched_decoder \
                            import TorchBatchedDecoderLM

                        engine_cls = TorchBatchedDecoderLM
                        kw.update(n_slots=self.cfg.batch_slots,
                                  spec_k=max(self.cfg.spec_k, 0),
                                  shared_prefix_text=self.cfg
                                  .shared_prefix_text)
                        if self.cfg.spec_k > 0:
                            if self.cfg.ngram_draft_path:
                                kw["ngram_draft"] = self.cfg.ngram_draft_path
                            if self.cfg.draft_model:
                                kw["draft_model"] = self.cfg.draft_model
                    elif self.cfg.spec_k > 0:
                        # speculation: prompt lookup, the corpus table and
                        # a draft model, k drafts verified a pass
                        from legalrag_tpu_torch.models.spec_decode import \
                            TorchSpecLookupDecoderLM

                        engine_cls = TorchSpecLookupDecoderLM
                        kw.update(spec_k=self.cfg.spec_k,
                                  spec_adaptive=self.cfg.spec_adaptive)
                        if self.cfg.ngram_draft_path:
                            kw["ngram_draft"] = self.cfg.ngram_draft_path
                        if self.cfg.draft_model:
                            kw["draft_model"] = self.cfg.draft_model
                    self._local = self._replicated(engine_cls, kw)
                except Exception as e:
                    raise LLMUnavailable(f"decoder load failed: {e}") from e
            return self._local

    def _replicated(self, engine_cls, kw: dict):
        """``engine_cls`` loaded as JAX's client loads it: with
        ``dp_replicas > 1`` a ``DPDecoderRouter`` of that many replicas over
        the visible devices (each on its own ``tp_shards``-wide submesh
        with ``tp_shards > 1``); else one engine, split over the first
        ``tp_shards`` devices with ``tp_shards > 1``. Too few devices
        raise, so the load fails: never fewer shards than asked."""
        tp, dp = self.cfg.tp_shards, self.cfg.dp_replicas
        if tp <= 1 and dp <= 1:
            return engine_cls.from_pretrained(self.cfg.model,
                                              device=self.device, **kw)
        from legalrag_tpu_torch.parallel import mesh as mesh_mod
        from legalrag_tpu_torch.parallel.decoder_dp import DPDecoderRouter
        from legalrag_tpu_torch.parallel.decoder_tp import \
            apply_tp_to_engine
        from legalrag_tpu_torch.utils.device import resolve_device

        devs = mesh_mod.local_devices(resolve_device(self.device).type)
        if dp > 1:
            return DPDecoderRouter.from_pretrained(
                engine_cls, self.cfg.model, replicas=dp, tp_shards=tp,
                devices=devs, **kw)
        if len(devs) < tp:
            raise ValueError(f"tp_shards={tp} needs {tp} devices, have "
                             f"{len(devs)}")
        engine = engine_cls.from_pretrained(self.cfg.model, device=devs[0],
                                            **kw)
        try:
            apply_tp_to_engine(engine, mesh_mod.make_mesh(devs[:tp], data=1,
                                                          model=tp))
        except BaseException:
            getattr(engine, "close", lambda: None)()
            raise
        return engine

    def _stream_jax(self, messages: List[Message],
                    max_new_tokens: Optional[int]
                    ) -> Generator[str, None, None]:
        lm = self._load_jax_lm()
        tok = lm.tokenizer
        prompt = tok.apply_chat_template(messages, tokenize=False,
                                         add_generation_prompt=True)
        ids = tok(prompt, truncation=True,
                  max_length=self.cfg.max_context_tokens)["input_ids"]
        out_ids: List[int] = []
        emitted = ""
        try:
            for t in lm.generate_stream(
                    ids,
                    max_new_tokens=max_new_tokens or self.cfg.max_new_tokens,
                    temperature=self.cfg.temperature, top_p=self.cfg.top_p,
                    top_k=self.cfg.top_k, min_p=self.cfg.min_p,
                    eos_id=tok.eos_token_id,
                    constrain=self.cfg.constrain_json,
                    repetition_penalty=self.cfg.repetition_penalty):
                out_ids.append(t)
                text = tok.decode(out_ids, skip_special_tokens=True)
                if len(text) > len(emitted) and not text.endswith("\ufffd"):
                    yield text[len(emitted):]
                    emitted = text
            # the stream can end inside a character held back above (eos
            # or the budget after the first bytes of a zh character)
            final = tok.decode(out_ids, skip_special_tokens=True)
            if len(final) > len(emitted):
                yield final[len(emitted):]
        finally:
            METRICS.inc("legalrag_llm_tokens", len(out_ids),
                        provider="local-jax")
            METRICS.inc("legalrag_llm_streams", provider="local-jax")
