"""Schema-constrained JSON decoding: a token-level DFA mask (port of
``legalrag_tpu/models/constrain.py``).

The RAG answer contract is structured JSON (``{"sections": [{"heading":
…, "items": […]}]}``, ``prompts/prompt_*.json``; the SSE scanner
``api/answer_scanner.py`` parses it as it streams). Constrained decoding
keeps every emitted token's output a prefix of a schema-valid document and
lets EOS through only once the document is complete.

1. ``build_schema_dfa`` compiles a schema (fixed-key objects, homogeneous
   arrays, string / number / bool leaves) into a byte-level DFA.
2. ``compile_token_table`` lifts it to the tokenizer's vocabulary:
   ``table[s, v]`` is the state after token ``v``'s bytes from state ``s``
   (-1 forbidden), with the token-level dead ends pruned.
3. ``token_dist_to_accept`` gives each state's fewest tokens to acceptance;
   ``budget_force`` keeps only the transitions that can still finish within
   a stream's remaining budget.

The numpy half is JAX's, line for line, so the tables come out equal int for
int. ``JsonConstraint`` holds them as torch tensors on the engine's device,
and ``budget_force`` runs on torch tensors. The engines apply the mask
after the repetition penalty and before the warpers (``models/decoder.py``,
``models/spec_decode.py``).

One difference from JAX: ``JsonConstraint`` takes the model's
``vocab_size`` and sizes the table to it. Released checkpoints pad their
embedding above the tokenizer (Qwen2.5: 151,936 rows for 151,665 tokens);
the ids past the tokenizer have no bytes and are banned, as JAX's
``from_schema`` bans a ``None`` entry of ``token_bytes``. JAX's
``from_tokenizer`` sizes the table to ``len(tokenizer)``, and its engines
then fail to broadcast the mask against the wider logits.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from legalrag_tpu_torch.utils.device import DeviceLike, resolve_device

WS = b" \t\n\r"
STRING_BODY_EXTRA = bytes(range(0x80, 0x100))  # raw UTF-8 continuation ok


class _DFA:
    """Mutable byte-DFA builder: states are ints, trans[s][byte] = s'."""

    def __init__(self):
        self.trans: List[Dict[int, int]] = []
        self.accepting: List[bool] = []
        self.number_aliases: List[Tuple[int, Tuple[int, ...]]] = []

    def state(self, accepting: bool = False) -> int:
        self.trans.append({})
        self.accepting.append(accepting)
        return len(self.trans) - 1

    def edge(self, src: int, chars: bytes, dst: int) -> None:
        for c in chars:
            self.trans[src][c] = dst

    def ws_loop(self, s: int) -> None:
        self.edge(s, WS, s)


def _add_string(d: _DFA, start: int, end: int) -> None:
    """Wire a JSON string literal from ``start`` (expects ``"``) to
    ``end`` (just after the closing quote). Handles escapes and \\uXXXX;
    any byte ≥ 0x20 except ``"``/``\\`` passes raw (incl. UTF-8 bytes)."""
    body = d.state()
    esc = d.state()
    hexs = [d.state() for _ in range(4)]
    d.edge(start, b'"', body)
    raw = bytes(c for c in range(0x20, 0x80) if c not in b'"\\')
    d.edge(body, raw + STRING_BODY_EXTRA, body)
    d.edge(body, b"\\", esc)
    d.edge(body, b'"', end)
    d.edge(esc, b'"\\/bfnrt', body)
    d.edge(esc, b"u", hexs[0])
    hexdig = b"0123456789abcdefABCDEF"
    for i in range(3):
        d.edge(hexs[i], hexdig, hexs[i + 1])
    d.edge(hexs[3], hexdig, body)


def _add_number(d: _DFA, start: int, end: int) -> None:
    """JSON number from ``start``; a number has no terminator byte of its
    own, so the complete-number states (int/frac/exp) are recorded as
    ALIASES of ``end`` — at finalize time they inherit ``end``'s outgoing
    delimiter/whitespace edges (which the parent wires after this call)
    and its accepting flag, without inheriting each other's digit edges
    (so ``12 3`` stays invalid)."""
    digits = b"0123456789"
    neg = d.state()
    ni = d.state()                               # integer part complete
    d.edge(start, b"-", neg)
    d.edge(start, digits, ni)
    d.edge(neg, digits, ni)
    d.edge(ni, digits, ni)
    dot = d.state()
    frac = d.state()
    d.edge(ni, b".", dot)
    d.edge(dot, digits, frac)
    d.edge(frac, digits, frac)
    e = d.state()
    esign = d.state()
    exp = d.state()
    d.edge(ni, b"eE", e)
    d.edge(frac, b"eE", e)
    d.edge(e, b"+-", esign)
    d.edge(e, digits, exp)
    d.edge(esign, digits, exp)
    d.edge(exp, digits, exp)
    d.number_aliases.append((end, (ni, frac, exp)))


def _add_literal(d: _DFA, start: int, word: bytes, end: int) -> None:
    s = start
    for i, c in enumerate(word):
        nxt = end if i == len(word) - 1 else d.state()
        d.edge(s, bytes([c]), nxt)
        s = nxt


def _add_value(d: _DFA, schema, start: int, end: int) -> None:
    """Wire one schema node from ``start`` (expects the value's first
    byte, whitespace-tolerant) to ``end`` (just after the value)."""
    d.ws_loop(start)
    if schema == "string":
        _add_string(d, start, end)
    elif schema == "number":
        _add_number(d, start, end)
    elif schema == "bool":
        _add_literal(d, start, b"true", end)
        _add_literal(d, start, b"false", end)
    elif isinstance(schema, list):
        # homogeneous array, zero or more elements
        assert len(schema) == 1, "array schema takes one element type"
        opened = d.state()
        d.edge(start, b"[", opened)
        d.ws_loop(opened)
        d.edge(opened, b"]", end)
        elem_end = d.state()
        _add_value(d, schema[0], opened, elem_end)
        d.ws_loop(elem_end)
        d.edge(elem_end, b"]", end)
        again = d.state()
        d.edge(elem_end, b",", again)
        _add_value(d, schema[0], again, elem_end)
    elif isinstance(schema, dict):
        # fixed keys, fixed order, all required
        assert schema, "object schema needs at least one key"
        opened = d.state()
        d.edge(start, b"{", opened)
        d.ws_loop(opened)
        cur = opened
        keys = list(schema.items())
        for i, (key, sub) in enumerate(keys):
            after_key = d.state()
            # the key is a fixed literal string
            _add_literal(d, cur, b'"' + key.encode("utf-8") + b'"',
                         after_key)
            d.ws_loop(after_key)
            colon = d.state()
            d.edge(after_key, b":", colon)
            val_end = d.state()
            _add_value(d, sub, colon, val_end)
            d.ws_loop(val_end)
            if i + 1 < len(keys):
                nxt = d.state()
                d.edge(val_end, b",", nxt)
                d.ws_loop(nxt)
                cur = nxt
            else:
                d.edge(val_end, b"}", end)
    else:
        raise ValueError(f"unsupported schema node: {schema!r}")


def build_schema_dfa(schema) -> Tuple[np.ndarray, np.ndarray]:
    """Schema → (trans [S, 256] int32 with −1 = forbidden, accepting [S]
    bool). Accepting = document complete (only trailing whitespace may
    follow)."""
    d = _DFA()
    start = d.state()
    end = d.state(accepting=True)
    _add_value(d, schema, start, end)
    d.ws_loop(end)
    # number aliases: complete-number states inherit their end state's
    # delimiter/whitespace edges and accepting flag (wired by the parent
    # after _add_number ran), keeping their own digit/dot/exp edges
    for base, aliases in d.number_aliases:
        for alias in aliases:
            for c, dst in d.trans[base].items():
                if c not in d.trans[alias]:
                    d.trans[alias][c] = dst
            if d.accepting[base]:
                d.accepting[alias] = True
    n = len(d.trans)
    trans = np.full((n, 256), -1, np.int32)
    for s, edges in enumerate(d.trans):
        for c, dst in edges.items():
            trans[s, c] = dst
    return trans, np.asarray(d.accepting, bool)


def compile_token_table(trans: np.ndarray, accepting: np.ndarray,
                        token_bytes: List[Optional[bytes]]
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Lift the byte DFA to the vocab: returns (table [S, V] int32 with
    −1 = forbidden, accepting [S] bool). ``token_bytes[v] = None`` (or
    ``b""``) bans token v everywhere (special / undecodable tokens)."""
    n_states, v = trans.shape[0], len(token_bytes)
    max_len = max((len(t) for t in token_bytes if t), default=1)
    mat = np.zeros((v, max_len), np.int32)
    lens = np.zeros(v, np.int32)
    for i, t in enumerate(token_bytes):
        if t:
            b = np.frombuffer(t, np.uint8)
            mat[i, :len(b)] = b
            lens[i] = len(b)
    # walk all (state, token) pairs one byte position at a time; a
    # forbidden transition pins the pair at -1
    state = np.broadcast_to(np.arange(n_states, dtype=np.int32)[:, None],
                            (n_states, v)).copy()
    for pos in range(max_len):
        mask = (lens > pos)[None, :] & (state >= 0)
        nxt = trans[np.maximum(state, 0), mat[:, pos][None, :]]
        state = np.where(mask, nxt, state)
    table = np.where((lens > 0)[None, :], state, -1).astype(np.int32)
    # prune DEAD ENDS at the token level: a byte-DFA state can be
    # reachable yet have no continuation in THIS vocab (e.g. a banned
    # byte mid-literal). Iteratively drop transitions into states that
    # are neither accepting nor lead (transitively) to a live state —
    # then every state the mask can reach has a token path to acceptance
    # and the engines never face an all-masked logits row.
    live = accepting.copy()
    while True:
        into_live = (table >= 0) & live[np.maximum(table, 0)]
        new_live = live | into_live.any(axis=1)
        if (new_live == live).all():
            break
        live = new_live
    if not live[0]:
        raise ValueError(
            "schema is unreachable with this vocabulary (every path hits "
            "a token-level dead end) — check token_bytes coverage")
    table = np.where((table >= 0) & live[np.maximum(table, 0)], table, -1)
    # post-condition the engines rely on (their in-scan advance clamps a
    # -1 transition to state 0 only as defense-in-depth): every state the
    # table can transition INTO is live — accepting, or with at least one
    # outgoing token transition — so a constrained slot can never face an
    # all-masked logits row / dead state at decode time.
    reached = np.unique(table[table >= 0])
    dead = reached[~(accepting[reached] | (table[reached] >= 0).any(axis=1))]
    assert dead.size == 0, f"token DFA kept dead states {dead.tolist()}"
    return table.astype(np.int32), accepting


def budget_force(allowed: torch.Tensor, row: torch.Tensor,
                 cdist: torch.Tensor, left, eos_col: torch.Tensor
                 ) -> torch.Tensor:
    """Budget-forced completion: restrict ``allowed`` ([..., V] bool) to the
    transitions whose ``dist[next] <= left - 1``, so the remaining budget
    still finishes the document. ``row`` is the DFA transition row ([..., V]
    int), ``left`` the budget left INCLUDING the token being picked
    (broadcastable to [..., 1]), ``eos_col`` the EOS column mask (EOS keeps
    its ``allowed`` value: it is legal only in accepting states, whose
    distance is 0). Where nothing fits (the budget was short from the
    start) the row keeps plain ``allowed``: a valid prefix rather than an
    all-masked row."""
    feas = allowed & (eos_col | (cdist[row.clamp_min(0).long()] <= left - 1))
    ok = feas.any(dim=-1, keepdim=True)
    return torch.where(ok, feas, allowed)


def token_dist_to_accept(table: np.ndarray,
                         accepting: np.ndarray) -> np.ndarray:
    """Minimum number of TOKENS from each DFA state to an accepting
    state, over the token-level table ([S, V] int32, −1 forbidden).

    Powers budget-forced completion: near the end of a stream's token
    budget the engines restrict the mask to transitions whose
    ``dist[next] <= tokens_left − 1``, so a constrained stream ends as a
    COMPLETE schema-valid document whenever the budget allows one (the
    jsonformer/outlines max-length guarantee; the reference has no
    structured output at all). ``compile_token_table`` prunes dead ends,
    so every state has finite distance; unreachable is clamped large."""
    big = np.int32(1 << 24)
    s_n = table.shape[0]
    # compact adjacency (unique successor states per state): the value
    # iteration is then O(iters × total_edges), not O(iters × S × V)
    nexts = [np.unique(table[s][table[s] >= 0]) for s in range(s_n)]
    dist = np.where(accepting, 0, int(big)).astype(np.int64)
    changed = True
    while changed:
        changed = False
        for s in range(s_n):
            if nexts[s].size:
                nd = 1 + dist[nexts[s]].min()
                if nd < dist[s]:
                    dist[s] = nd
                    changed = True
    return np.minimum(dist, big).astype(np.int32)


SECTIONS_SCHEMA = {"sections": [{"heading": "string",
                                 "items": ["string"]}]}


class JsonConstraint:
    """A constraint ready for an engine: ``table`` [S, V] int32 (-1
    forbidden), ``accepting`` [S] bool and ``dist`` [S] int32 (fewest tokens
    to acceptance) on ``device``, the ``start`` state and ``min_budget``
    (the fewest tokens of a complete document). With ``vocab_size`` above
    the table's width the table gains -1 columns up to it: those ids are
    banned. One instance per engine, on its device; streams opt in per
    call."""

    def __init__(self, table: np.ndarray, accepting: np.ndarray,
                 start: int = 0, device: DeviceLike = None,
                 vocab_size: Optional[int] = None):
        table = np.asarray(table, np.int32)
        accepting = np.asarray(accepting, bool)
        # banned columns change no distance: measure before padding
        dist = token_dist_to_accept(table, accepting)
        if vocab_size is not None and vocab_size > table.shape[1]:
            table = np.concatenate([table, np.full(
                (table.shape[0], vocab_size - table.shape[1]), -1, np.int32)],
                axis=1)
        self.device = resolve_device(device)
        self.table = torch.from_numpy(table).to(self.device)
        self.accepting = torch.from_numpy(accepting).to(self.device)
        self.dist = torch.from_numpy(dist).to(self.device)
        self.min_budget = int(dist[start])
        self.start = start

    @property
    def nbytes(self) -> int:
        """Bytes of the tensors on the device."""
        return sum(t.numel() * t.element_size()
                   for t in (self.table, self.accepting, self.dist))

    @classmethod
    def from_schema(cls, schema, token_bytes: List[Optional[bytes]],
                    device: DeviceLike = None,
                    vocab_size: Optional[int] = None) -> "JsonConstraint":
        trans, acc = build_schema_dfa(schema)
        table, acc = compile_token_table(trans, acc, token_bytes)
        return cls(table, acc, device=device, vocab_size=vocab_size)

    @classmethod
    def from_tokenizer(cls, schema, tokenizer,
                       vocab_size: Optional[int] = None,
                       device: DeviceLike = None) -> "JsonConstraint":
        """From the port's ``BPETokenizer`` (or any tokenizer with
        ``decode([i])``, ``__len__`` and ``all_special_ids``), read as JAX
        reads a transformers tokenizer: special tokens, and tokens that do
        not decode to clean text (empty, or holding U+FFFD: a byte-level
        piece of a character, a byte-fallback byte), are banned.
        ``vocab_size`` (the model's) sizes the table: the ids from
        ``len(tokenizer)`` up to it are banned (the table is compiled over
        the tokenizer's ids and padded, which gives what compiling the
        banned ids would), and ids past it dropped."""
        v = len(tokenizer)
        if vocab_size is not None:
            v = min(v, vocab_size)
        token_bytes: List[Optional[bytes]] = [None] * v
        specials = set(getattr(tokenizer, "all_special_ids", []) or [])
        for i in range(v):
            if i in specials:
                continue
            text = tokenizer.decode([i])
            if not text or "�" in text:
                continue
            token_bytes[i] = text.encode("utf-8")
        return cls.from_schema(schema, token_bytes, device=device,
                               vocab_size=vocab_size)


class StreamConstraint:
    """One constrained stream's DFA state, a 0-d tensor on the device (no
    host read). ``mask`` bans what the state forbids (EOS but in an
    accepting state) and, with ``left`` tokens of budget left including
    this one, what could not finish in time (``budget_force``); ``advance``
    moves the state over a picked token, staying put on EOS (a forbidden
    transition, which the mask never lets through, lands on state 0)."""

    def __init__(self, jc: JsonConstraint, eos_id: Optional[int]):
        self.jc = jc
        self.state = torch.tensor(jc.start, device=jc.device)
        self.eos = -1 if eos_id is None else int(eos_id)
        self.eos_col = torch.arange(jc.table.shape[1],
                                    device=jc.device) == self.eos

    def mask(self, scored: torch.Tensor, left) -> torch.Tensor:
        """``scored`` [1, V] with the banned ids at -1e30."""
        jc = self.jc
        row = jc.table[self.state]
        allowed = torch.where(self.eos_col, jc.accepting[self.state],
                              row >= 0)
        allowed = budget_force(allowed, row, jc.dist, left, self.eos_col)
        return scored.masked_fill(~allowed, -1e30)

    def advance(self, tok: torch.Tensor) -> None:
        """Move over ``tok`` [1]."""
        nxt = self.jc.table[self.state, tok[0]].clamp_min(0).long()
        self.state = torch.where(tok[0] == self.eos, self.state, nxt)
