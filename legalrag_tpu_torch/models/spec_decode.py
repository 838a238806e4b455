"""Speculative single-stream decoding on the device (port of
``legalrag_tpu/models/spec_decode.py``).

RAG answers quote the retrieved provisions, which sit in the prompt. Each
speculation round drafts ``spec_k`` tokens and verifies them with ONE forward
pass of ``k + 1`` tokens: decode reads the weights once a pass, so an
accepted draft is a nearly free token. Greedy output is token-identical to
the plain engine's (the correction token at the first mismatch is the true
greedy token); sampled output follows the plain engine's distribution (each
position is drawn from the true conditional given the accepted prefix, and
a draft is accepted where the draw equals it).

Draft sources, in JAX's order of preference:

1. the most recent earlier occurrence of the current trigram, then bigram,
   in the sequence so far, preferring a match whose ``k`` following tokens
   are all written (a full window), and the ``k`` tokens after it;
2. where no full window exists, the corpus n-gram table
   (``models/ngram_draft.py``): one hash probe of the current bigram;
3. where neither exists, a draft model (``draft``: a ``DecoderModel`` of the
   same vocabulary, ``llm.draft_model``): ``k`` greedy steps of it over its
   own KV cache. The device cannot skip work without a host read, so the
   draft model runs every round and its draft is taken only where 1 and 2
   found none; its cache rows past the write pointer are rewritten by a
   catch-up pass over the round's targets either way, as JAX's are.

``spec_steps`` rounds run per host read, JAX's launch cadence: the round's
state (the token buffer, the write pointer, the pending token, the budget,
EOS, the repetition mask and the constraint's DFA state) stays on the
device, and the host reads one emissions array a launch. ``last_stats``
counts JAX's launches, tokens and rounds, and ``host_reads``. Under the
JSON constraint each verify row is masked by the DFA state after the drafts
before it, with its own budget (``budget_force``); under a repetition
penalty each row's seen set is the prompt's plus the drafts before it.
Rejected draft rows stay in the cache past the write pointer; the mask
(``kv_pos <= position``) hides them, and each later pass writes its rows
before it attends them. Near the cache's end (within ``spec_k`` rows), and
after ``spec_adaptive``'s bail, the stream finishes with the plain engine's
decode chunks.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Dict, Iterator, List, Optional

import torch

from legalrag_tpu_torch.models.constrain import budget_force
from legalrag_tpu_torch.models.decoder import (
    DecoderModel,
    TorchDecoderLM,
    _sample_top_p,
    apply_repetition_penalty,
)
from legalrag_tpu_torch.models.ngram_draft import resolve_ngram_draft
from legalrag_tpu_torch.utils import get_logger
from legalrag_tpu_torch.utils.device import DeviceLike
from legalrag_tpu_torch.utils.metrics import METRICS

log = get_logger("torch.models.spec_decode")

_HASH_MULT = 2654435761


class TorchSpecLookupDecoderLM(TorchDecoderLM):
    """``TorchDecoderLM`` with speculative decoding (module docstring):
    ``spec_k`` drafts verified a round, ``spec_steps`` rounds a host read.
    ``spec_k <= 0`` is the plain engine. ``spec_adaptive > 0``: after one
    launch (``spec_steps`` rounds) a stream emitting fewer tokens a round
    than halfway to that bar, or after two launches fewer than the bar,
    finishes with the plain decode chunks (``last_stats["adaptive_bailed"]``).
    """

    def __init__(self, model: DecoderModel, tokenizer=None,
                 device: DeviceLike = None, max_len: int = 4096,
                 decode_chunk: int = 8, spec_k: int = 8, spec_steps: int = 4,
                 prefix_cache: int = 0, prefill_chunk: int = 1024,
                 kv_quant: bool = False, json_constraint=None,
                 ngram_draft=None, draft: Optional[DecoderModel] = None,
                 spec_adaptive: float = 0.0):
        super().__init__(model, tokenizer, device=device, max_len=max_len,
                         decode_chunk=decode_chunk, prefix_cache=prefix_cache,
                         prefill_chunk=prefill_chunk, kv_quant=kv_quant,
                         json_constraint=json_constraint)
        self.spec_k = spec_k
        self.spec_steps = spec_steps
        self.spec_adaptive = float(spec_adaptive)
        self.ngram_draft = resolve_ngram_draft(ngram_draft)
        self.draft = None
        if draft is not None:
            if draft.cfg.vocab_size != self.cfg.vocab_size:
                raise ValueError(
                    f"draft model vocab {draft.cfg.vocab_size} != target "
                    f"vocab {self.cfg.vocab_size}")
            # the draft's own dense cache and chunked prefill (no prefix
            # cache), at the target's capacity
            self.draft = TorchDecoderLM(draft, device=self.device,
                                        max_len=max_len,
                                        prefill_chunk=self.prefill_chunk)
        self.last_stats: Dict[str, float] = {}
        k = max(spec_k, 0)
        self._iota = torch.arange(k + 1, device=self.device)
        self._idx = torch.arange(max_len, device=self.device)
        # (row i, draft j) for j < i: verify row i has seen draft[0..i-1]
        pairs = [(i, j) for i in range(1, k + 1) for j in range(i)]
        self._seen_rows = torch.tensor([p[0] for p in pairs], dtype=torch.long,
                                       device=self.device)
        self._seen_cols = torch.tensor([p[1] for p in pairs], dtype=torch.long,
                                       device=self.device)

    # ------------------------------------------------------------- rounds
    def _lookup_draft(self, st: SimpleNamespace, ng):
        """Sources 1 and 2: (draft [k], whether a full window or a table
        hit was found)."""
        k, n = self.spec_k, self.max_len
        tokens, pos, pending, idx = st.buf[:n], st.pos, st.pending, self._idx
        a_tok = tokens[(pos - 1).clamp_min(0)]
        a2_tok = tokens[(pos - 2).clamp_min(0)]
        prev = torch.cat([tokens[:1], tokens[:-1]])
        prev2 = torch.cat([tokens[:2], tokens[:-2]])
        hit2 = (idx >= 1) & (idx < pos) & (prev == a_tok) & (tokens == pending)
        hit3 = hit2 & (idx >= 2) & (prev2 == a2_tok) & (pos >= 2)
        full = idx <= pos - k          # tokens[j + 1 .. j + k] all written

        def last(m):
            return torch.where(m, idx, -1).max()

        jf = torch.where(last(hit3 & full) >= 0, last(hit3 & full),
                         last(hit2 & full))
        j = torch.where(jf >= 0, jf, torch.where(last(hit3) >= 0, last(hit3),
                                                 last(hit2)))
        # JAX's dynamic_slice: the start clamped so the window fits
        draft = tokens[(j + 1).clamp(0, n - k) + self._iota[:k]]
        havek = jf >= 0
        if ng is not None:
            nka, nkb, nvals = ng
            h = (((a_tok * _HASH_MULT + pending) & 0xFFFFFFFF)
                 & (nka.shape[0] - 1))
            ok = ~havek & (nka[h] == a_tok) & (nkb[h] == pending)
            draft = torch.where(ok, nvals[h], draft)
            havek = havek | ok
        return draft, havek

    def _model_draft(self, st: SimpleNamespace) -> torch.Tensor:
        """Source 3: ``k`` greedy steps of the draft model from ``pending``
        at ``pos``, over its cache."""
        tok, out = st.pending, []
        for i in range(self.spec_k):
            p = st.pos + i
            logits = self.draft.model(tok.view(1, 1), p.view(1, 1),
                                      kv_cache=st.dcache, cache_len=p)
            tok = torch.argmax(logits[0, -1])
            out.append(tok)
        return torch.stack(out)

    def _round(self, st: SimpleNamespace, ng, sample) -> torch.Tensor:
        """One speculation round on the device: draft, verify, accept,
        advance; the emissions [k + 1] (-1 where nothing is emitted). A
        frozen stream (EOS, budget or capacity) runs the pass and emits
        nothing."""
        k, n, iota = self.spec_k, self.max_len, self._iota
        draft, havek = self._lookup_draft(st, ng)
        if self.draft is not None:
            draft = torch.where(~havek, self._model_draft(st), draft)
        # --- verify: [pending, draft] at pos .. pos + k
        seq = torch.cat([st.pending.view(1), draft]).view(1, k + 1)
        positions = (st.pos + iota).view(1, k + 1)
        lg = self.model(seq, positions, kv_cache=st.cache,
                        cache_len=st.pos)[0]                     # [k+1, V]
        if st.penalized:
            # row i's seen set: the stream's and draft[0 .. i-1]
            masks = st.rep.expand(k + 1, -1).clone()
            masks[self._seen_rows, draft[self._seen_cols]] = True
            lg = apply_repetition_penalty(lg, masks, st.pen)
        cons = st.cons
        if cons is not None:
            # row i's DFA state: after draft[0 .. i-1] (-1 past an invalid
            # draft: that row is never used, and stays unmasked)
            table = cons.jc.table
            states = [cons.state]
            for i in range(k):
                s = states[-1]
                states.append(torch.where(
                    s >= 0, table[s.clamp_min(0), draft[i]].long(), -1))
            st_mat = torch.stack(states)
            st_c = st_mat.clamp_min(0)
            row_c = table[st_c]                                  # [k+1, V]
            eos_col = cons.eos_col[None, :]
            allow = torch.where(eos_col, cons.jc.accepting[st_c][:, None],
                                row_c >= 0)
            # row i emits after i earlier targets: its budget is c_left - i
            allow = budget_force(allow, row_c, cons.jc.dist,
                                 (st.c_left - iota)[:, None], eos_col)
            allow = torch.where((st_mat >= 0)[:, None], allow, True)
            lg = lg.masked_fill(~allow, -1e30)
        targets = sample(lg)                                      # [k+1]
        if self.draft is not None:
            # the draft cache's rows pos .. pos + k from the true tokens
            self.draft.model(torch.cat([st.pending.view(1), targets[:k]])
                             .view(1, k + 1), positions, kv_cache=st.dcache,
                             cache_len=st.pos)
        # --- acceptance: the longest draft prefix equal to the targets
        a = torch.cumprod((draft == targets[:k]).long(), 0).sum()
        cand = iota <= a
        ie = torch.where(cand & (targets == st.eos), iota, k + 1).min()
        emit = st.active & cand & (iota < ie) & (iota < st.c_left)
        emissions = torch.where(emit, targets, -1)
        n_emit = emit.sum()
        # --- advance (no-ops when frozen); unemitted rows write the sink
        st.buf.index_put_((torch.where(emit, st.pos + 1 + iota, n),), targets)
        st.rep |= torch.zeros(st.rep.shape[0], dtype=torch.int32,
                              device=self.device).index_add_(
            0, targets, emit.int()) > 0
        new_pending = targets[a.clamp_max(k)]
        st.pending = torch.where(st.active & (ie > a), new_pending,
                                 st.pending)
        st.pos = st.pos + torch.where(st.active, n_emit, 0)
        st.c_left = st.c_left - n_emit
        if cons is not None:
            cs = cons.state
            for i in range(k + 1):
                nxt = torch.where(cs >= 0, table[cs.clamp_min(0),
                                                 targets[i]].long(), cs)
                cs = torch.where(emit[i], nxt, cs)
            cons.state = cs
        step_eos = st.active & (ie <= a)
        st.hit_eos = st.hit_eos | step_eos
        st.active = (st.active & ~step_eos & (st.c_left > 0)
                     & (st.pos + k <= n - 1))
        return emissions

    @torch.inference_mode()
    def _launch(self, st: SimpleNamespace, budget_left: int, ng,
                sample) -> List[int]:
        """``spec_steps`` rounds, then one host read: the emissions
        [spec_steps, k + 1] flattened, then active, hit_eos, emitted, pos,
        pending."""
        st.c_left = torch.tensor(budget_left, device=self.device)
        st.active = torch.tensor(True, device=self.device)
        st.hit_eos = torch.tensor(False, device=self.device)
        rows = [self._round(st, ng, sample) for _ in range(self.spec_steps)]
        packed = torch.stack([st.active.long(), st.hit_eos.long(),
                              budget_left - st.c_left, st.pos, st.pending])
        return torch.cat(rows + [packed]).tolist()

    @torch.inference_mode()
    def _first_token(self, last2d, rep, pen, cons, max_new_tokens: int,
                     pick_one) -> int:
        """The admission-time token: the prompt's penalty and the
        constraint at the whole budget, as the plain engine's first step."""
        last = apply_repetition_penalty(last2d, rep[None, :], pen)
        if cons is not None:
            last = cons.mask(last, max_new_tokens)
        return int(pick_one(last)[0])

    # ---------------------------------------------------------------- API
    def generate_stream(self, prompt_ids: List[int], max_new_tokens: int = 256,
                        temperature: float = 0.0, top_p: float = 0.9,
                        eos_id: Optional[int] = None, seed: int = 0,
                        repetition_penalty: float = 1.0, top_k: int = 0,
                        min_p: float = 0.0, constrain: bool = False
                        ) -> Iterator[int]:
        if constrain and self.json_constraint is None:
            raise ValueError("constrain=True requires an engine built "
                             "with json_constraint / constrain_json")
        stats = {"launches": 0, "tokens": 0, "spec_rounds": 0,
                 "host_reads": 0}
        gen = self._generate_impl(prompt_ids, max_new_tokens, temperature,
                                  top_p, eos_id, seed, repetition_penalty,
                                  stats, top_k, min_p, constrain)
        try:
            yield from gen
        finally:
            if stats.get("tokens"):
                for name in ("tokens", "launches", "spec_rounds"):
                    METRICS.inc(f"legalrag_gen_{name}", stats[name],
                                engine="spec")

    def _generate_impl(self, prompt_ids, max_new_tokens, temperature, top_p,
                       eos_id, seed, repetition_penalty, stats, top_k, min_p,
                       constrain) -> Iterator[int]:
        if self.spec_k <= 0:
            yield from super().generate_stream(
                prompt_ids, max_new_tokens, temperature, top_p, eos_id, seed,
                repetition_penalty, top_k, min_p, constrain)
            return
        t = len(prompt_ids)
        if t >= self.max_len:
            raise ValueError(
                f"prompt ({t} tokens) does not fit the {self.max_len}-token "
                "KV cache; truncate the prompt before generation")
        budget = self.max_len - t
        if max_new_tokens > budget:
            log.warning("max_new_tokens %d exceeds cache budget %d; clamping",
                        max_new_tokens, budget)
            max_new_tokens = budget
        self.last_stats = stats
        dev, k = self.device, self.spec_k
        greedy = not temperature > 0
        last2d, cache = self._prefill_prompt(list(prompt_ids))
        dcache = (self.draft._prefill_prompt(list(prompt_ids))[1]
                  if self.draft is not None else None)
        generator = torch.Generator(device=dev).manual_seed(seed)
        temp = torch.tensor(max(temperature, 1e-6), device=dev)
        pen = torch.tensor(repetition_penalty, device=dev)
        rep = torch.zeros(self.cfg.vocab_size, dtype=torch.bool, device=dev)
        rep[torch.tensor(list(prompt_ids), dtype=torch.long,
                         device=dev)] = True
        cons = self._stream_constraint(constrain, eos_id, max_new_tokens)
        ng = (self.ngram_draft.device_arrays(k, dev)
              if self.ngram_draft is not None else None)

        def sample(lg):
            if greedy:
                return torch.argmax(lg, dim=-1)
            return _sample_top_p(lg / temp, top_p, generator, top_k, min_p)

        pending_h = self._first_token(last2d, rep, pen, cons, max_new_tokens,
                                      sample)
        stats["host_reads"] += 1
        rep[pending_h] = True
        if eos_id is not None and pending_h == eos_id:
            return
        if cons is not None:
            cons.advance(torch.tensor([pending_h], device=dev))
        yield pending_h
        produced = 1
        stats["tokens"] = 1
        if produced >= max_new_tokens:
            return
        buf = torch.zeros(self.max_len + 1, dtype=torch.long, device=dev)
        buf[:t] = torch.tensor(list(prompt_ids), dtype=torch.long, device=dev)
        buf[t] = pending_h
        st = SimpleNamespace(buf=buf, pos=torch.tensor(t, device=dev),
                    pending=torch.tensor(pending_h, device=dev), cache=cache,
                    dcache=dcache, rep=rep, pen=pen, cons=cons,
                    penalized=repetition_penalty != 1.0,
                    eos=-1 if eos_id is None else eos_id)
        pos_h = t
        # a verify pass writes rows pos .. pos + k: launch only where they fit
        while pos_h + k <= self.max_len - 1:
            host = self._launch(st, max_new_tokens - produced, ng, sample)
            stats["launches"] += 1
            stats["host_reads"] += 1
            for r in range(self.spec_steps):
                row = [tok for tok in host[r * (k + 1):(r + 1) * (k + 1)]
                       if tok >= 0]
                for tok in row:
                    yield tok
                    produced += 1
                    stats["tokens"] += 1
                    stats["spec_tokens"] = stats.get("spec_tokens", 0) + 1
                if row:
                    stats["spec_rounds"] += 1
            _active, hit_eos, _emitted, pos_h, pending_h = host[-5:]
            if hit_eos or produced >= max_new_tokens:
                return
            if self.spec_adaptive > 0.0:
                rounds = stats["spec_rounds"]
                per_round = stats.get("spec_tokens", 0) / max(rounds, 1)
                # after one launch bail only below halfway to the bar (a
                # quoting stream may need a launch to start repeating);
                # after two, below the bar
                bar = (self.spec_adaptive if rounds >= 2 * self.spec_steps
                       else 1.0 + 0.5 * (self.spec_adaptive - 1.0))
                if rounds >= self.spec_steps and per_round < bar:
                    stats["adaptive_bailed"] = True
                    log.info("speculation off after %d rounds: %.2f "
                             "tokens/round < %.2f bar; finishing with "
                             "chunk-%d decode", rounds, per_round, bar,
                             self.decode_chunk)
                    break
        # the adaptive bail, or within spec_k rows of capacity: the plain
        # engine's decode chunks finish the stream
        yield from self._finish_chunked(
            cache, pending_h, pos_h, rep, cons, generator, produced,
            max_new_tokens, greedy, temp, top_p, top_k, min_p, pen, eos_id,
            stats)

    def _finish_chunked(self, cache, pending_h: int, pos_h: int, rep, cons,
                        generator, produced: int, max_new_tokens: int,
                        greedy: bool, temp, top_p, top_k, min_p, pen, eos_id,
                        stats: Dict) -> Iterator[int]:
        """Continue a stream with the plain engine's decode chunks. On
        entry cache rows ``0 .. pos_h - 1`` are valid and ``pending_h`` (the
        token at ``pos_h``) was emitted but not forwarded. A chunk past the
        budget runs whole and its surplus is dropped."""
        last = self._step(torch.tensor([pending_h], device=self.device),
                          pos_h, cache)
        stats["launches"] += 1
        pos = pos_h + 1
        rep2 = rep.view(1, -1)
        climit = pos + (max_new_tokens - produced)

        def pick(logits, p):
            return self._pick(logits, rep2, pen, greedy, temp, top_p, top_k,
                              min_p, generator, cons, climit - p)

        while (produced < max_new_tokens
               and pos + self.decode_chunk <= self.max_len):
            emit_n = min(self.decode_chunk, max_new_tokens - produced)
            toks, last = self._chunk(last, pos, cache, self.decode_chunk, pick)
            stats["launches"] += 1
            stats["host_reads"] += 1
            pos += self.decode_chunk
            produced += emit_n
            for tok_host in toks.tolist()[:emit_n]:
                if eos_id is not None and tok_host == eos_id:
                    return
                yield tok_host
                stats["tokens"] += 1
        for i in range(max_new_tokens - produced):
            if pos + i >= self.max_len:
                return
            tok = pick(last, pos + i)
            tok_host = int(tok[0])
            stats["host_reads"] += 1
            if eos_id is not None and tok_host == eos_id:
                return
            yield tok_host
            stats["tokens"] += 1
            if (produced + i + 1 < max_new_tokens
                    and pos + i + 1 < self.max_len):
                last = self._step(tok, pos + i, cache)
                stats["launches"] += 1
