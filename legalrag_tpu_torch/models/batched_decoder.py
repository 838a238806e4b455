"""Continuous batching for generation: concurrent streams, one decode loop
(port of ``legalrag_tpu/models/batched_decoder.py``).

Concurrent ``/rag/answer`` streams share one batched decode loop instead of
each running its own: decode reads the weights once a step, so one step
serves ``n_slots`` streams for nearly the launches of one.

- **Slots.** Per layer one ``[S, max_len, Hkv, D]`` KV cache (dense, or the
  int8 cache's 4-tuple under ``kv_quant``). A request is admitted into a
  free slot, decodes in the shared batch, and frees the slot at EOS, its
  budget or cancellation.
- **Admission.** A prompt is prefilled into its slot's rows with B=1: one
  forward right-padded to ``pad_bucket``, or, above ``prefill_chunk``,
  sequential chunks at slot-row offsets; the prefix LRU (``prefix_cache``)
  installs a kept prompt's rows and forwards only the suffix. Pad rows land
  past the prompt: every later step writes its row before it attends it,
  so neither pad nor a previous occupant's rows are ever read.
- **The pinned shared prefix** (``shared_prefix``): one ``[1, P]`` copy of a
  system prelude's KV rows, built at start, attended by every slot whose
  prompt starts with it (``DecoderModel.forward``'s ``shared_kv`` /
  ``kv_offset``); slot rows then hold positions from P on, so the cache
  is ``[S, max_len - P]``. A matching prompt keeps the whole ``max_len``;
  another is served unshared within ``max_len - P``, with a second,
  suffix-keyed LRU for the matching ones.
- **Decode.** ``decode_chunk`` steps a launch, one host read of the
  launch's tokens: per slot the repetition penalty, the JSON constraint
  with ``budget_force`` (state -2: an unconstrained slot), greedy or HF's
  warpers, a [S, 1] forward writing each slot's row at its own position,
  and the slot frozen at its EOS or ``limit``.
- **Speculation** (``spec_k > 0``): a round drafts per slot (the trigram /
  bigram lookup over the slot's token row, the corpus n-gram table, a
  draft model with its own ``[S, max_len]`` cache), verifies every slot's
  draft in one ``[S, k + 1]`` forward at per-slot offsets, and accepts per
  slot; ``spec_steps`` rounds a launch. Admission samples the first token
  and reserves ``spec_k`` rows of headroom (the budget is clamped).
- **Host worker.** A daemon thread owns the device state: it admits
  waiting requests into free slots, runs a launch and fans the tokens out
  to per-stream queues. ``generate_stream`` is ``TorchDecoderLM``'s
  contract, thread-safe.

Greedy streams are token-identical to JAX's engine and to the port's
single-stream ones. JAX samples from a PRNG key chain per slot; the port
gives each sampled stream its own ``torch.Generator`` seeded by its
``seed`` and draws from it exactly as ``TorchDecoderLM`` (and, with
``spec_k``, ``TorchSpecLookupDecoderLM``) draws a stream's tokens, so a
stream's draws depend on its seed, its prompt and the model alone, not on
its slot, its neighbours or when it joined. As in ``models/spec_decode.py``
the draft model runs every round, where JAX's ``lax.cond`` would skip it.
"""

from __future__ import annotations

import queue
import threading
from collections import deque
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from legalrag_tpu_torch.models.bert import resolve_model_dir
from legalrag_tpu_torch.models.constrain import (
    SECTIONS_SCHEMA,
    JsonConstraint,
    budget_force,
)
from legalrag_tpu_torch.models.decoder import (
    NEG_INF,
    DecoderModel,
    PrefixKVCache,
    _warp_filter,
    apply_repetition_penalty,
    load_decoder_model,
    load_hf_decoder_params,
    pad_bucket,
)
from legalrag_tpu_torch.models.ngram_draft import resolve_ngram_draft
from legalrag_tpu_torch.models.spec_decode import _HASH_MULT
from legalrag_tpu_torch.utils import get_logger
from legalrag_tpu_torch.utils.device import DeviceLike, resolve_device
from legalrag_tpu_torch.utils.metrics import METRICS

log = get_logger("torch.models.batched_decoder")

Cache = List[Tuple[torch.Tensor, ...]]


class _Stream:
    """Host bookkeeping for one in-flight request."""

    __slots__ = ("out", "prompt_ids", "max_new", "eos_id", "temperature",
                 "top_p", "top_k", "min_p", "seed", "produced", "cancelled",
                 "error", "repetition_penalty", "shared", "constrained",
                 "generator")

    def __init__(self, prompt_ids, max_new, eos_id, temperature, top_p, seed,
                 repetition_penalty=1.0, top_k=0, min_p=0.0):
        self.out: "queue.Queue" = queue.Queue()
        self.prompt_ids = prompt_ids
        self.max_new = max_new
        self.eos_id = eos_id
        self.temperature = temperature
        self.top_p = top_p
        self.top_k = top_k
        self.min_p = min_p
        self.seed = seed
        self.repetition_penalty = repetition_penalty
        self.produced = 0
        self.cancelled = False
        self.error: Optional[BaseException] = None
        self.shared = False       # the prompt starts with the shared prefix
        self.constrained = False  # the engine's JSON constraint applies
        self.generator: Optional[torch.Generator] = None  # sampled streams


class TorchBatchedDecoderLM:
    """Slot-based continuous batching over ``DecoderModel`` (module
    docstring); any thread may call :meth:`generate_stream` concurrently,
    and streams join and leave the shared batch mid-flight."""

    _PAD_BUCKET_MIN = 16
    ENGINE = "batched"            # the ``engine`` label of the gen metrics
    _new_stream = _Stream

    def __init__(self, model: DecoderModel, tokenizer=None,
                 device: DeviceLike = None, max_len: int = 4096,
                 n_slots: int = 4, decode_chunk: int = 8, spec_k: int = 0,
                 spec_steps: int = 4, prefix_cache: int = 0,
                 kv_quant: bool = False, prefill_chunk: int = 1024,
                 shared_prefix: Optional[List[int]] = None,
                 json_constraint: Optional[JsonConstraint] = None,
                 ngram_draft=None, draft: Optional[DecoderModel] = None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.cfg = model.cfg
        self.tokenizer = tokenizer
        self.max_len = max_len
        self.n_slots = n_slots
        self.kv_quant = kv_quant
        self.decode_chunk = max(1, decode_chunk)
        self.spec_k = spec_k
        self.spec_steps = spec_steps
        self.prefill_chunk = max(prefill_chunk, 16)
        self.shared_prefix = list(shared_prefix) if shared_prefix else None
        if self.shared_prefix and len(self.shared_prefix) >= max_len - 16:
            raise ValueError(
                f"shared_prefix ({len(self.shared_prefix)} tokens) leaves no "
                f"slot budget in max_len={max_len}")
        self.shared_len = len(self.shared_prefix or [])
        self.slot_len = max_len - self.shared_len
        # the full-prompt LRU, and with a shared prefix a suffix-keyed one
        # whose rows sit at position - P (the pinned rows never copied)
        self._prefix = PrefixKVCache(prefix_cache) if prefix_cache else None
        self._prefix_sfx = (PrefixKVCache(prefix_cache)
                            if prefix_cache and self.shared_prefix else None)
        self.json_constraint = json_constraint
        self.ngram_draft = resolve_ngram_draft(ngram_draft)
        self.draft = None
        if draft is not None:
            if not spec_k:
                raise ValueError("draft model requires spec_k > 0")
            if draft.cfg.vocab_size != self.cfg.vocab_size:
                raise ValueError(
                    f"draft model vocab {draft.cfg.vocab_size} != target "
                    f"vocab {self.cfg.vocab_size}")
            self.draft = draft.to(self.device).eval()
        dev, v, s = self.device, self.cfg.vocab_size, n_slots
        with torch.inference_mode():
            self._shared_kv = (self._build_shared_rows()
                               if self.shared_prefix else None)
            self._cache = self._empty_cache()
            self._dcache = (self._zeros_cache(self.draft.cfg, s, max_len,
                                              False, self.draft.dtype)
                            if self.draft is not None else None)
            self._cstate = torch.full((s,), -2, dtype=torch.long, device=dev)
            self._last = torch.zeros((s, v), device=dev)
            self._pos = torch.zeros((s,), dtype=torch.long, device=dev)
            self._rep = torch.zeros((s, v), dtype=torch.bool, device=dev)
            if spec_k:
                # each slot's token row, and a sink column for the rows a
                # round does not emit
                self._tokens = torch.zeros((s, max_len + 1), dtype=torch.long,
                                           device=dev)
                self._pend = torch.zeros((s,), dtype=torch.long, device=dev)
        k = max(spec_k, 0)
        self._iota = torch.arange(k + 1, device=dev)
        self._sidx = torch.arange(s, device=dev)
        # (verify row i, draft j) for j < i: row i has seen draft[0 .. i-1]
        pairs = [(i, j) for i in range(1, k + 1) for j in range(i)]
        self._seen_rows = torch.tensor([p[0] for p in pairs],
                                       dtype=torch.long, device=dev)
        self._seen_cols = torch.tensor([p[1] for p in pairs],
                                       dtype=torch.long, device=dev)

        # admitted prompts, by whether they matched the pinned prefix
        self.admissions = {"shared": 0, "unshared": 0}
        self._slots: List[Optional[_Stream]] = [None] * n_slots
        self._admitted_firsts: List = []  # speculation's first tokens
        self._pending: "deque[_Stream]" = deque()
        self._cond = threading.Condition()
        self._closed = False
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="batched-decoder")
        self._worker.start()

    # ------------------------------------------------------------ factory
    @classmethod
    def from_pretrained(cls, name_or_path: str, device: DeviceLike = None,
                        shared_prefix_text: str = "", **kw
                        ) -> "TorchBatchedDecoderLM":
        """A local checkpoint with its ``tokenizer.json``, loaded as
        ``TorchDecoderLM.from_pretrained`` loads it (``weight_quant`` /
        ``weight_bits``, ``constrain_json``, ``draft_model``).
        ``shared_prefix_text`` is tokenized by the checkpoint's tokenizer
        into the pinned ids; a prompt whose ids do not start with them is
        served unshared."""
        from legalrag_tpu_torch.tokenize.bpe import BPETokenizer

        wq, wb = kw.pop("weight_quant", False), kw.pop("weight_bits", 8)
        model_dir = resolve_model_dir(name_or_path)
        state, cfg = load_hf_decoder_params(model_dir)
        tokenizer = BPETokenizer.from_dir(model_dir)
        dev = resolve_device(device)
        model = load_decoder_model(state, cfg, dev, wb if wq else 0)
        if kw.pop("constrain_json", False) and "json_constraint" not in kw:
            kw["json_constraint"] = JsonConstraint.from_tokenizer(
                SECTIONS_SCHEMA, tokenizer, vocab_size=cfg.vocab_size,
                device=dev)
        if shared_prefix_text and "shared_prefix" not in kw:
            kw["shared_prefix"] = tokenizer(shared_prefix_text)["input_ids"]
        dm = kw.pop("draft_model", "")
        if dm:
            kw["draft"] = load_decoder_model(
                *load_hf_decoder_params(resolve_model_dir(dm)), dev,
                wb if wq else 0)
        lm = cls(model, tokenizer, device=dev, **kw)
        log.info("loaded %s %s (%d slots, chunk %d, max_len %d, shared "
                 "prefix %d)", cls.__name__, name_or_path, lm.n_slots,
                 lm.decode_chunk, lm.max_len, lm.shared_len)
        return lm

    # ------------------------------------------------------------- caches
    def _zeros_cache(self, cfg, s: int, rows: int, kv_quant: bool,
                     dtype: torch.dtype) -> Cache:
        shape = (s, rows, cfg.num_key_value_heads, cfg.head_dim)

        def zeros(shape, dt):
            return torch.zeros(shape, dtype=dt, device=self.device)

        if kv_quant:
            return [(zeros(shape, torch.int8), zeros(shape, torch.int8),
                     zeros(shape[:3] + (1,), torch.float32),
                     zeros(shape[:3] + (1,), torch.float32))
                    for _ in range(cfg.num_hidden_layers)]
        return [(zeros(shape, dtype), zeros(shape, dtype))
                for _ in range(cfg.num_hidden_layers)]

    def _empty_cache(self) -> Optional[Cache]:
        """The launches' KV storage: the ``[S, slot_len]`` slot cache (the
        paged engine keeps block pools instead and gathers a view of them
        for each launch)."""
        return self._zeros_cache(self.cfg, self.n_slots, self.slot_len,
                                 self.kv_quant, self.model.dtype)

    @staticmethod
    def _slot_view(cache: Cache, slot: int) -> Cache:
        """One slot's rows as a B=1 cache (views: writes land in place)."""
        return [tuple(a[slot:slot + 1] for a in layer) for layer in cache]

    @property
    def cache_bytes(self) -> int:
        """Bytes of the slot cache and the pinned shared rows."""
        return sum(a.numel() * a.element_size()
                   for c in (self._cache, self._shared_kv or [])
                   for layer in c for a in layer)

    @property
    def prefix_stats(self) -> Dict[str, int]:
        return self._prefix.stats if self._prefix else \
            {"hits": 0, "misses": 0, "saved_tokens": 0}

    def _build_shared_rows(self) -> Cache:
        """Prefill the shared prefix once, in chunks, into a read-only [1, P]
        segment (int8 under ``kv_quant``)."""
        ids, p = self.shared_prefix, self.shared_len
        p_pad = pad_bucket(p)
        cache = self._zeros_cache(self.cfg, 1, p_pad, self.kv_quant,
                                  self.model.dtype)
        c = self.prefill_chunk
        for off in range(0, p, c):
            piece = list(ids[off:off + c])
            n = len(piece)
            cb = c if n == c else pad_bucket(n, hi=p_pad - off)
            self.model(self._ids(piece + [0] * (cb - n)),
                       self._positions(off, cb), kv_cache=cache,
                       cache_len=off, return_hidden=True)
        rows = [tuple(a[:, :p].clone() for a in layer) for layer in cache]
        log.info("shared prefix pinned: %d tokens, %.1f MB KV", p,
                 sum(a.numel() * a.element_size() for l in rows for a in l)
                 / 1e6)
        return rows

    def _matches_shared(self, ids: List[int]) -> bool:
        p = self.shared_len
        return bool(p and len(ids) > p and list(ids[:p]) == self.shared_prefix)

    # ---------------------------------------------------------- admission
    def _ids(self, ids: List[int]) -> torch.Tensor:
        return torch.tensor([ids], dtype=torch.long, device=self.device)

    def _positions(self, start: int, n: int) -> torch.Tensor:
        return torch.arange(start, start + n, device=self.device)[None, :]

    def _offset_forward(self, p_len: int, ids: List[int], slot: int,
                        true_len: int, shared: bool) -> torch.Tensor:
        """Forward the right-padded chunk ``ids`` at absolute offset
        ``p_len`` over the slot's filled rows (and with ``shared`` the pinned
        segment, the slot's rows at position - P); the float32 logits [1, V]
        of its last real token. A one-shot prefill is the chunk at 0."""
        hidden = self.model(
            self._ids(ids), self._positions(p_len, len(ids)),
            kv_cache=self._slot_view(self._cache, slot), cache_len=p_len,
            return_hidden=True,
            shared_kv=self._shared_kv if shared else None,
            kv_offset=self.shared_len if shared else None)
        return self.model.logits(hidden[:, true_len - 1])

    def _chunked_slot_prefill(self, ids: List[int], slot: int,
                              shared: bool) -> torch.Tensor:
        """Sequential chunks into the slot's rows, each attending the rows
        before it; with ``shared`` the first P tokens are the pinned rows
        and only the suffix runs."""
        c = self.prefill_chunk
        start = self.shared_len if shared else 0
        sfx = ids[start:]
        last = None
        for off in range(0, len(sfx), c):
            piece = list(sfx[off:off + c])
            n = len(piece)
            cb = c if n == c else pad_bucket(n, hi=self.slot_len - off)
            last = self._offset_forward(start + off, piece + [0] * (cb - n),
                                        slot, n, shared)
        return last

    def _match_prefix(self, ids: List[int], shared: bool):
        """The LRU probe: (hit, key offset). A matching prompt probes the
        suffix-keyed LRU (key ``ids[P:]``), another the full-prompt one; a
        hit whose suffix exceeds ``prefill_chunk`` is dropped for the
        chunked path."""
        lru, sfx0 = ((self._prefix_sfx, self.shared_len) if shared
                     else (self._prefix, 0))
        if lru is None:
            return None, sfx0
        hit = lru.match(ids[sfx0:], self.slot_len)
        if hit is not None and len(ids) - sfx0 - hit[1] > self.prefill_chunk:
            hit = None
        return hit, sfx0

    def _store_prefix(self, ids: List[int], slot: int, shared: bool) -> None:
        lru = self._prefix_sfx if shared else self._prefix
        if lru is None:
            return
        key = ids[self.shared_len:] if shared else ids
        tb = pad_bucket(len(key), hi=self.slot_len)
        rows = [tuple(a[slot:slot + 1, :tb].clone() for a in layer)
                for layer in self._cache]
        lru.store(key, rows, len(key))

    def _prefill_slot(self, st: _Stream, slot: int) -> torch.Tensor:
        """The prompt's rows into ``slot`` (a prefix hit, chunks, or one
        bucketed forward); the last prompt token's logits [1, V]."""
        ids = st.prompt_ids
        hit, sfx0 = self._match_prefix(ids, st.shared)
        if hit is None and (st.shared or len(ids) > self.prefill_chunk):
            last = self._chunked_slot_prefill(ids, slot, st.shared)
        elif hit is not None:
            rows, l, sb = hit
            for layer, kept in zip(self._cache, rows):
                for dst, src in zip(layer, kept):
                    dst[slot:slot + 1, :src.shape[1]] = src
            tail = ids[sfx0 + l:]
            last = self._offset_forward(sfx0 + l,
                                        tail + [0] * (sb - len(tail)), slot,
                                        len(tail), st.shared)
        else:
            bucket = pad_bucket(len(ids), lo=self._PAD_BUCKET_MIN,
                                hi=self.slot_len)
            last = self._offset_forward(0, ids + [0] * (bucket - len(ids)),
                                        slot, len(ids), False)
        self._store_prefix(ids, slot, st.shared)
        return last

    def _admit(self, st: _Stream, slot: int) -> None:
        ids = st.prompt_ids
        last = self._prefill_slot(st, slot)
        self._last[slot] = last[0]
        self._pos[slot] = len(ids)
        self._rep[slot] = False
        self._rep[slot, torch.tensor(ids, dtype=torch.long,
                                     device=self.device)] = True
        jc = self.json_constraint
        self._cstate[slot] = jc.start if st.constrained else -2
        self._slots[slot] = st

    def _draft_admit(self, ids: List[int], slot: int) -> None:
        """The slot's draft-model rows: the whole prompt at absolute
        positions, whichever path the target's admission took."""
        c = self.prefill_chunk
        view = self._slot_view(self._dcache, slot)
        for off in range(0, len(ids), c):
            piece = list(ids[off:off + c])
            n = len(piece)
            cb = c if n == c else pad_bucket(n, hi=self.max_len - off)
            self.draft(self._ids(piece + [0] * (cb - n)),
                       self._positions(off, cb), kv_cache=view,
                       cache_len=off, return_hidden=True)

    def _spec_admit(self, st: _Stream, slot: int) -> None:
        """Speculative admission: the prompt's rows, its token row, and the
        first token sampled from the prefill's logits under the prompt's
        penalty and the constraint's first mask (no budget forcing, as
        JAX's). Its host read is deferred to the next launch's."""
        ids, dev = st.prompt_ids, self.device
        last = self._prefill_slot(st, slot)
        mask_row = torch.zeros((1, self.cfg.vocab_size), dtype=torch.bool,
                               device=dev)
        mask_row[0, torch.tensor(ids, dtype=torch.long, device=dev)] = True
        scored = apply_repetition_penalty(
            last, mask_row, torch.tensor(st.repetition_penalty, device=dev))
        jc = self.json_constraint
        cs0 = jc.start if (jc is not None and st.constrained) else -2
        eos = -1 if st.eos_id is None else st.eos_id
        if cs0 >= 0:
            allowed = jc.table[cs0] >= 0
            if eos >= 0:
                allowed[eos] = jc.accepting[cs0]
            scored = scored.masked_fill(~allowed, NEG_INF)
        if st.temperature > 0:
            temp = torch.tensor(max(st.temperature, 1e-6), device=dev)
            tok = self._sample((scored / temp)[:, None], [st])[:, 0]
        else:
            tok = torch.argmax(scored, dim=-1)
        total = len(ids)
        tb = pad_bucket(total, hi=self.max_len)
        self._tokens[slot, :tb] = torch.tensor(ids + [0] * (tb - total),
                                               dtype=torch.long, device=dev)
        self._tokens[slot, total] = tok[0]
        self._pos[slot] = total
        self._pend[slot] = tok[0]
        self._rep[slot] = mask_row[0]
        self._rep[slot, tok] = True
        if cs0 >= 0:
            nxt = jc.table[cs0, tok[0]].clamp_min(0).long()
            self._cstate[slot] = torch.where(tok[0] == eos,
                                             torch.tensor(cs0, device=dev),
                                             nxt)
        else:
            self._cstate[slot] = cs0
        if self.draft is not None:
            self._draft_admit(ids, slot)
        self._slots[slot] = st
        self._admitted_firsts.append((st, slot, tok))

    # ------------------------------------------------------------ a launch
    def _sample(self, scaled: torch.Tensor, streams: List[_Stream]
                ) -> torch.Tensor:
        """Tokens [n, R] of the rows ``scaled`` [n, R, V] (logits already
        divided by each stream's temperature), drawn through HF's warpers
        with stream i's generator: the draw ``_sample_top_p`` makes of a
        [R, V] row block, so a stream's draws are its own. Rows sharing
        warper settings are filtered together."""
        n, r, v = scaled.shape
        filtered = torch.empty_like(scaled)
        groups: Dict[tuple, List[int]] = {}
        for i, st in enumerate(streams):
            groups.setdefault((st.top_p, st.top_k, st.min_p), []).append(i)
        for (top_p, top_k, min_p), members in groups.items():
            idx = torch.tensor(members, device=scaled.device)
            filtered[idx] = _warp_filter(scaled[idx].view(-1, v), top_p,
                                         top_k, min_p).view(-1, r, v)
        u = torch.stack([torch.rand((r, v), generator=st.generator,
                                    device=scaled.device)
                         for st in streams])
        u = u.clamp_min(torch.finfo(torch.float32).tiny)
        return torch.argmax(filtered - torch.log(-torch.log(u)), dim=-1)

    def _control_vectors(self):
        s = self.n_slots
        temp = np.zeros(s, np.float32)
        pen = np.ones(s, np.float32)
        eos = np.full(s, -1, np.int64)
        limit = np.zeros(s, np.int64)
        offv = np.zeros(s, np.int64)
        active = np.zeros(s, bool)
        for i, st in enumerate(self._slots):
            if st is None:
                continue
            temp[i] = st.temperature
            pen[i] = st.repetition_penalty
            eos[i] = -1 if st.eos_id is None else st.eos_id
            cap = self.max_len if st.shared else self.slot_len
            limit[i] = min(len(st.prompt_ids) + st.max_new, cap)
            offv[i] = self.shared_len if st.shared else 0
            active[i] = True
        dev = self.device
        return (torch.from_numpy(np.maximum(temp, 1e-6)).to(dev),
                torch.from_numpy(pen).to(dev), torch.from_numpy(eos).to(dev),
                torch.from_numpy(limit).to(dev),
                torch.from_numpy(offv).to(dev) if self.shared_len else None,
                torch.from_numpy(active).to(dev))

    def _constraint_mask(self, scored, cstate, eos, left):
        """The per-slot JSON constraint on ``scored`` [S, V]: state -2 (an
        unconstrained slot) passes; else the DFA row's allowed tokens, EOS
        only when accepting, budget-forced with ``left`` [S] tokens left."""
        jc = self.json_constraint
        st_ = cstate.clamp_min(0)
        row = jc.table[st_]                                      # [S, V]
        uncon = (cstate < 0)[:, None]
        eos_col = (torch.arange(row.shape[1], device=row.device)[None, :]
                   == eos[:, None])
        allowed = torch.where(eos_col, (jc.accepting[st_] | (cstate < 0))
                              [:, None], (row >= 0) | uncon)
        forced = budget_force(allowed, row, jc.dist, left[:, None], eos_col)
        allowed = torch.where(uncon, allowed, forced)
        return torch.where(allowed, scored, torch.full_like(scored, NEG_INF))

    def _decode_launch(self, ctrl) -> torch.Tensor:
        """``decode_chunk`` sample + decode steps over every slot (frozen
        slots emit -1 and keep their sampling state; their garbage row
        write lands where a row is rewritten before it is read): the tokens
        [n_steps, S] on the device, for the launch's one host read."""
        temp, pen, eos, limit, offv, active = ctrl
        live = [st for st in self._slots if st is not None]
        sampled = [i for i, st in enumerate(self._slots)
                   if st is not None and st.temperature > 0]
        sidx = torch.tensor(sampled, device=self.device)
        penalized = any(st.repetition_penalty != 1.0 for st in live)
        constrained = any(st.constrained for st in live)
        last, pos, rep, cstate = self._last, self._pos, self._rep, self._cstate
        emits = []
        for _ in range(self.decode_chunk):
            scored = (apply_repetition_penalty(last, rep, pen[:, None])
                      if penalized else last)
            if constrained:
                scored = self._constraint_mask(scored, cstate, eos,
                                               limit - pos)
            tok = torch.argmax(scored, dim=-1)
            if sampled:
                stok = self._sample((scored[sidx] / temp[sidx, None])[:, None],
                                    [self._slots[i] for i in sampled])[:, 0]
                tok = tok.index_copy(0, sidx, stok)
            emits.append(torch.where(active, tok, -1))
            safe = pos.clamp_max(self.max_len - 1)
            logits = self.model(tok[:, None], safe[:, None],
                                kv_cache=self._cache, cache_len=safe,
                                shared_kv=self._shared_kv, kv_offset=offv)
            last = torch.where(active[:, None], logits[:, -1], last)
            rep = rep.scatter(1, tok[:, None], True)
            hit_eos = active & (tok == eos)
            if constrained:
                nstate = self.json_constraint.table[cstate.clamp_min(0),
                                                    tok].clamp_min(0).long()
                cstate = torch.where((cstate < 0) | hit_eos | ~active, cstate,
                                     nstate)
            pos = pos + active.long()
            active = active & ~hit_eos & (pos < limit)
        self._last, self._pos, self._rep, self._cstate = last, pos, rep, cstate
        return torch.stack(emits)

    def _lookup_draft(self, tokens, pos, pending, ng):
        """Sources 1 and 2 per slot: (drafts [S, k], whether a full window
        or a table hit was found)."""
        k, n = self.spec_k, self.max_len
        idx = torch.arange(n, device=self.device)[None, :]
        a_tok = tokens.gather(1, (pos - 1).clamp_min(0)[:, None])[:, 0]
        a2_tok = tokens.gather(1, (pos - 2).clamp_min(0)[:, None])[:, 0]
        prev = torch.cat([tokens[:, :1], tokens[:, :-1]], dim=1)
        prev2 = torch.cat([tokens[:, :2], tokens[:, :-2]], dim=1)
        hit2 = ((idx >= 1) & (idx < pos[:, None]) & (prev == a_tok[:, None])
                & (tokens == pending[:, None]))
        hit3 = (hit2 & (idx >= 2) & (prev2 == a2_tok[:, None])
                & (pos >= 2)[:, None])
        full = idx <= (pos - k)[:, None]

        def last(m):
            return torch.where(m, idx, -1).max(dim=1).values

        j3f, j2f = last(hit3 & full), last(hit2 & full)
        jf = torch.where(j3f >= 0, j3f, j2f)
        j3, j2 = last(hit3), last(hit2)
        j = torch.where(jf >= 0, jf, torch.where(j3 >= 0, j3, j2))
        # JAX's dynamic_slice: the start clamped so the window fits
        start = (j + 1).clamp(0, n - k)
        draft = tokens.gather(1, start[:, None] + self._iota[None, :k])
        havek = jf >= 0
        if ng is not None:
            nka, nkb, nvals = ng
            h = (((a_tok * _HASH_MULT + pending) & 0xFFFFFFFF)
                 & (nka.shape[0] - 1))
            ok = ~havek & (nka[h] == a_tok) & (nkb[h] == pending)
            draft = torch.where(ok[:, None], nvals[h], draft)
            havek = havek | ok
        return draft, havek

    def _spec_round(self, st, ctrl, flags, ng):
        """One speculation round over every slot; the emissions [S, k + 1]
        (-1 where nothing is emitted)."""
        temp, pen, eos, limit, offv, _active = ctrl
        sampled, penalized, constrained = flags
        k, s, iota = self.spec_k, self.n_slots, self._iota
        pos, pending, active = st["pos"], st["pending"], st["active"]
        draft, havek = self._lookup_draft(st["tokens"][:, :self.max_len], pos,
                                          pending, ng)
        if self.draft is not None:
            # k greedy [S, 1] draft-model steps, taken where 1 and 2 missed
            tok_i, out = pending, []
            for i in range(k):
                lg = self.draft(tok_i[:, None], (pos + i)[:, None],
                                kv_cache=self._dcache, cache_len=pos + i)
                tok_i = torch.argmax(lg[:, -1], dim=-1)
                out.append(tok_i)
            draft = torch.where(havek[:, None], draft, torch.stack(out, 1))
        seq = torch.cat([pending[:, None], draft], dim=1)
        positions = pos[:, None] + iota[None, :]
        logits = self.model(seq, positions, kv_cache=self._cache,
                            cache_len=pos, shared_kv=self._shared_kv,
                            kv_offset=offv)                     # [S, k+1, V]
        v = logits.shape[-1]
        if penalized:
            # verify row i's seen set: the slot's and its draft[0 .. i-1]
            masks = st["rep"][:, None, :].expand(s, k + 1, v).clone()
            masks[self._sidx[:, None], self._seen_rows[None, :],
                  draft[:, self._seen_cols]] = True
            logits = apply_repetition_penalty(logits, masks,
                                              pen[:, None, None])
        jc = self.json_constraint
        if constrained:
            # row i's DFA state: after draft[0 .. i-1]; -1 past an invalid
            # draft (that row is never used) and -2 unconstrained pass
            sts = [st["cstate"]]
            for i in range(k):
                prev = sts[-1]
                sts.append(torch.where(
                    prev >= 0, jc.table[prev.clamp_min(0), draft[:, i]].long(),
                    -1))
            st_mat = torch.stack(sts, dim=1)                     # [S, k+1]
            st_c = st_mat.clamp_min(0)
            row_c = jc.table[st_c]                               # [S, k+1, V]
            eos_col = (torch.arange(v, device=self.device)[None, None, :]
                       == eos[:, None, None])
            allow = torch.where(eos_col, jc.accepting[st_c][:, :, None],
                                row_c >= 0)
            left = limit[:, None] - pos[:, None] - 1 - iota[None, :]
            allow = budget_force(allow, row_c, jc.dist, left[:, :, None],
                                 eos_col)
            allow = torch.where((st_mat >= 0)[:, :, None], allow, True)
            logits = logits.masked_fill(~allow, NEG_INF)
        targets = torch.argmax(logits, dim=-1)                   # [S, k+1]
        if sampled:
            sidx = torch.tensor(sampled, device=self.device)
            stok = self._sample(logits[sidx] / temp[sidx, None, None],
                                [self._slots[i] for i in sampled])
            targets = targets.index_copy(0, sidx, stok)
        if self.draft is not None:
            # the draft cache's rows pos .. pos + k from the true tokens
            self.draft(torch.cat([pending[:, None], targets[:, :k]], dim=1),
                       positions, kv_cache=self._dcache, cache_len=pos,
                       return_hidden=True)
        a = torch.cumprod((draft == targets[:, :k]).long(), dim=1).sum(1)
        cand = iota[None, :] <= a[:, None]
        ie = torch.where(cand & (targets == eos[:, None]), iota[None, :],
                         k + 1).min(dim=1).values
        emit = (active[:, None] & cand & (iota[None, :] < ie[:, None])
                & (pos[:, None] + 1 + iota[None, :] < limit[:, None]))
        emissions = torch.where(emit, targets, -1)
        wr = torch.where(emit, pos[:, None] + 1 + iota[None, :], self.max_len)
        st["tokens"] = st["tokens"].scatter(1, wr, targets)
        seen = torch.zeros_like(st["rep"], dtype=torch.int32).scatter_add_(
            1, targets, emit.int())
        st["rep"] = st["rep"] | (seen > 0)
        new_pending = targets.gather(1, a.clamp_max(k)[:, None])[:, 0]
        st["pending"] = torch.where(active & (ie > a), new_pending, pending)
        n_emit = emit.long().sum(1)
        st["pos"] = pos = pos + torch.where(active, n_emit, 0)
        if constrained:
            cs = st["cstate"]
            for i in range(k + 1):
                nxt = torch.where(cs >= 0, jc.table[cs.clamp_min(0),
                                                    targets[:, i]].long(), cs)
                cs = torch.where(emit[:, i], nxt, cs)
            st["cstate"] = cs
        step_eos = active & (ie <= a)
        st["hit_eos"] = st["hit_eos"] | step_eos
        capv = (self.max_len if offv is None else self.slot_len + offv)
        st["active"] = (active & ~step_eos & (pos + 1 < limit)
                        & (pos + k <= capv - 1))
        return emissions

    def _spec_launch(self, ctrl, firsts) -> torch.Tensor:
        """``spec_steps`` rounds: the deferred first tokens, the emissions
        [spec_steps, S, k + 1] and hit_eos [S], flattened on the device for
        the launch's one host read."""
        live = [x for x in self._slots if x is not None]
        sampled = [i for i, x in enumerate(self._slots)
                   if x is not None and x.temperature > 0]
        flags = (sampled, any(x.repetition_penalty != 1.0 for x in live),
                 any(x.constrained for x in live))
        ng = (self.ngram_draft.device_arrays(self.spec_k, self.device)
              if self.ngram_draft is not None else None)
        st = {"tokens": self._tokens, "pos": self._pos,
              "pending": self._pend, "rep": self._rep,
              "cstate": self._cstate, "active": ctrl[-1],
              "hit_eos": torch.zeros_like(ctrl[-1])}
        rows = [self._spec_round(st, ctrl, flags, ng).flatten()
                for _ in range(self.spec_steps)]
        self._tokens, self._pos, self._pend = (st["tokens"], st["pos"],
                                               st["pending"])
        self._rep, self._cstate = st["rep"], st["cstate"]
        return torch.cat(firsts + rows + [st["hit_eos"].long()])

    # --------------------------------------------------------------- worker
    def _finish(self, slot: int) -> None:
        st = self._slots[slot]
        if st is not None:
            st.out.put(None)
            self._slots[slot] = None

    def _run(self) -> None:
        while True:
            with self._cond:
                while (not self._closed and not self._pending
                       and not any(s is not None for s in self._slots)):
                    self._cond.wait()
                if self._closed:
                    for st in self._pending:
                        st.out.put(None)
                    self._pending.clear()
                    for i in range(self.n_slots):
                        self._finish(i)
                    return
                pending, self._pending = self._pending, deque()
            try:
                with torch.inference_mode():
                    self._tick(pending)
            except BaseException as e:  # pragma: no cover - defensive
                log.exception("batched decoder worker error: %s", e)
                for st in list(pending):
                    st.error = e
                    st.out.put(None)
                self._admitted_firsts.clear()
                for i in range(self.n_slots):
                    st = self._slots[i]
                    if st is not None:
                        st.error = e
                    self._finish(i)

    def _admit_stream(self, st: _Stream, slot: int) -> None:
        """Admit ``st`` into the free ``slot`` (its generator when sampled)."""
        if st.temperature > 0:
            st.generator = torch.Generator(
                device=self.device).manual_seed(st.seed)
        if self.spec_k:
            self._spec_admit(st, slot)
        else:
            self._admit(st, slot)

    def _admission_failed(self, st: _Stream, slot: int,
                          e: BaseException) -> None:
        log.exception("admission failed: %s", e)
        st.error = e
        st.out.put(None)
        self._slots[slot] = None
        self._admitted_firsts = [f for f in self._admitted_firsts
                                 if f[0] is not st]

    def _admit_pending(self, pending: "deque[_Stream]") -> None:
        """Fill free slots from ``pending``; an admission failure fails only
        its stream."""
        for i in range(self.n_slots):
            if not pending:
                break
            if self._slots[i] is None:
                st = pending.popleft()
                try:
                    self._admit_stream(st, i)
                    self.admissions["shared" if st.shared else "unshared"] += 1
                except BaseException as e:
                    self._admission_failed(st, i, e)

    def _tick(self, pending: "deque[_Stream]") -> bool:
        """Admit, launch once and fan the tokens out; whether it launched."""
        # drop cancelled streams (a client gone mid-generation)
        for i, st in enumerate(self._slots):
            if st is not None and st.cancelled:
                self._finish(i)
        while pending and pending[0].cancelled:
            pending.popleft().out.put(None)
        self._admit_pending(pending)
        if pending:  # no free slot: requeued, served as slots free up
            with self._cond:
                pending.extend(self._pending)
                self._pending = pending
        if not any(s is not None for s in self._slots):
            return False
        ctrl = self._control_vectors()
        occ = sum(s is not None for s in self._slots)
        engine = f"{self.ENGINE}-spec" if self.spec_k else self.ENGINE
        METRICS.inc("legalrag_gen_launches", engine=engine, occupancy=occ)
        if self.spec_k:
            firsts = self._admitted_firsts
            self._admitted_firsts = []
            host = self._spec_launch(
                ctrl, [tok for _s, _i, tok in firsts]).tolist()
            for (st, slot, _tok), first in zip(firsts, host):
                if self._slots[slot] is not st:
                    continue
                if st.eos_id is not None and first == st.eos_id:
                    self._finish(slot)   # this launch's row is discarded
                    continue
                st.produced = 1
                METRICS.inc("legalrag_gen_tokens", 1, engine=engine)
                if not st.cancelled:
                    st.out.put(first)
                if st.produced >= st.max_new:
                    self._finish(slot)
            w = self.spec_k + 1
            em = np.asarray(host[len(firsts):-self.n_slots]).reshape(
                self.spec_steps, self.n_slots, w)
            hit_eos = host[-self.n_slots:]
            n_launch_toks = 0
            for i, st in enumerate(self._slots):
                if st is None:
                    continue
                for r in range(self.spec_steps):
                    row = [t for t in em[r, i].tolist() if t >= 0]
                    for t in row:
                        st.produced += 1
                        n_launch_toks += 1
                        if not st.cancelled:
                            st.out.put(int(t))
                    if row:
                        METRICS.inc("legalrag_gen_spec_rounds", engine=engine)
                if hit_eos[i] or st.produced >= st.max_new:
                    self._finish(i)
            METRICS.inc("legalrag_gen_tokens", n_launch_toks, engine=engine)
            return True
        toks = self._decode_launch(ctrl).tolist()
        n_launch_toks = 0
        for i, st in enumerate(self._slots):
            if st is None:
                continue
            for step in toks:
                t = step[i]
                if t < 0:
                    break
                if st.eos_id is not None and t == st.eos_id:
                    self._finish(i)
                    break
                st.produced += 1
                n_launch_toks += 1
                if not st.cancelled:
                    st.out.put(int(t))
                if st.produced >= st.max_new:
                    self._finish(i)
                    break
        METRICS.inc("legalrag_gen_tokens", n_launch_toks, engine=engine)
        return True

    # ------------------------------------------------------------------ API
    def generate_stream(self, prompt_ids: List[int],
                        max_new_tokens: int = 256, temperature: float = 0.0,
                        top_p: float = 0.9, eos_id: Optional[int] = None,
                        seed: int = 0, repetition_penalty: float = 1.0,
                        top_k: int = 0, min_p: float = 0.0,
                        constrain: bool = False) -> Iterator[int]:
        """``TorchDecoderLM.generate_stream``'s contract; any number of
        threads may stream at once, joining the batch as slots free up
        (FIFO). A prompt that starts with the shared prefix has ``max_len``
        rows, another ``max_len - P``; with ``spec_k`` the budget keeps
        ``spec_k`` rows of headroom. ``constrain`` applies the engine's
        JSON constraint to this stream."""
        if constrain and self.json_constraint is None:
            raise ValueError("constrain=True requires an engine built "
                             "with json_constraint / constrain_json")
        t = len(prompt_ids)
        shared = self._matches_shared(prompt_ids)
        cap = self.max_len if shared else self.slot_len
        if t >= cap:
            raise ValueError(
                f"prompt ({t} tokens) does not fit the {cap}-token budget "
                f"(shared prefix matched: {shared}); truncate the prompt "
                "before generation")
        budget = cap - t - self.spec_k
        if budget < 1:
            raise ValueError(
                f"prompt ({t} tokens) leaves no budget in the "
                f"{self.max_len}-token cache with spec_k={self.spec_k}")
        if max_new_tokens > budget:
            log.warning("max_new_tokens %d exceeds cache budget %d (prompt "
                        "%d / cap %d / spec_k %d); clamping", max_new_tokens,
                        budget, t, cap, self.spec_k)
            max_new_tokens = budget
        if constrain and max_new_tokens < self.json_constraint.min_budget:
            log.warning("constrained stream budget %d < shortest valid "
                        "document (%d tokens); output will be a valid "
                        "prefix, not a complete document", max_new_tokens,
                        self.json_constraint.min_budget)
        st = self._new_stream(list(prompt_ids), max_new_tokens, eos_id,
                              temperature, top_p, seed, repetition_penalty,
                              top_k, min_p)
        st.shared = shared
        st.constrained = constrain
        with self._cond:
            if self._closed:
                raise RuntimeError(f"{type(self).__name__} is closed")
            self._pending.append(st)
            self._cond.notify()
        try:
            while True:
                # poll in slices: a dead worker fails the stream at once
                waited = 0.0
                while True:
                    try:
                        item = st.out.get(timeout=30)
                        break
                    except queue.Empty:
                        waited += 30
                        if not self._worker.is_alive():
                            raise RuntimeError(
                                "decode worker died") from st.error
                        if waited >= 1800:
                            raise RuntimeError(
                                "generation stalled for 30 minutes")
                if item is None:
                    if st.error is not None:
                        raise RuntimeError("generation failed") from st.error
                    return
                yield item
        finally:
            st.cancelled = True  # an early close frees the slot

    def close(self) -> None:
        """Stop the worker thread and end open streams. Idempotent."""
        with self._cond:
            self._closed = True
            self._cond.notify()
        self._worker.join(timeout=30)
