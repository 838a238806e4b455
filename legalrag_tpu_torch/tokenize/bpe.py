"""Byte-level BPE over a local ``tokenizer.json`` (the port's counterpart of
the ``transformers.AutoTokenizer`` that the JAX decoder engine loads for
Qwen2-family checkpoints, ``legalrag_tpu/models/decoder.py:1089-1091``,
and that the JAX client drives, ``legalrag_tpu/llm/client.py:390-428``).

The layout Qwen2 and Qwen2.5 ship, and the only one read here:

- added tokens (``<|endoftext|>``, ``<|im_start|>``, ``<|im_end|>``, ...)
  matched in the raw text first, leftmost and longest, as the
  ``tokenizers`` library's added vocabulary does (only the default
  options: no ``lstrip``, ``rstrip``, ``single_word`` or normalized
  added tokens);
- normalizer NFC;
- pre-tokenizer: a ``Split`` on Qwen2's pattern (``QWEN2_PATTERN``,
  isolated), then ``ByteLevel`` without a prefix space or its own regex.
  Python's ``re`` has no ``\\p{L}`` or ``\\p{N}``, so the pattern runs as
  a hand-written scanner (``split_words``) over ``unicodedata``'s
  categories and Unicode's White_Space set, which is what Oniguruma's
  ``\\s`` matches; its alternatives are tried in order at each position,
  with the regex's backtracking worked out per alternative;
- the GPT-2 byte-to-unicode map;
- BPE by merge rank, the lowest rank first and, among equal ranks, the
  leftmost pair, as ``tokenizers``' ``Word::merge_all`` does; merges are
  read as ``"a b"`` strings or ``["a", "b"]`` pairs;
- decoder ``ByteLevel``: ids with no token are dropped, the bytes are
  decoded as UTF-8 with U+FFFD for each invalid sequence.

``tokenizer_config.json`` gives the special tokens (``eos_token``, ...),
``chat_template``, ``clean_up_tokenization_spaces`` and
``model_max_length``. ``apply_chat_template`` renders the template with
``jinja2`` as transformers does. Any other layout raises
``TokenizerNotSupported``.

Character classes come from Python's ``unicodedata``; a code point that a
newer Unicode assigns and Python's does not (category ``Cn``) may split
otherwise than in ``tokenizers``.
"""

from __future__ import annotations

import heapq
import json
import re
import unicodedata
from pathlib import Path
from typing import Dict, List, Optional, Sequence

from legalrag_tpu_torch.tokenize.wordpiece import TokenizerNotSupported

QWEN2_PATTERN = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|"
                 r"\p{N}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")
# Unicode's White_Space property: what \s matches in Oniguruma
WHITE_SPACE = frozenset(map(chr, (*range(0x9, 0xE), 0x20, 0x85, 0xA0, 0x1680,
                                  *range(0x2000, 0x200B), 0x2028, 0x2029,
                                  0x202F, 0x205F, 0x3000)))
CONTRACTIONS = ("s", "t", "re", "ve", "m", "ll", "d")
SPECIAL_ATTRS = ("bos_token", "eos_token", "unk_token", "sep_token",
                 "pad_token", "cls_token", "mask_token")
_CACHE_MAX = 1 << 17


def _kind(ch: str) -> str:
    """'L' letter, 'N' number, 'S' white space, 'P' anything else."""
    if ch in WHITE_SPACE:
        return "S"
    cat = unicodedata.category(ch)[0]
    return cat if cat in "LN" else "P"


def _contraction(text: str, i: int) -> int:
    """End of ``(?i:'s|'t|'re|'ve|'m|'ll|'d)`` at ``text[i] == "'"``, or 0."""
    for c in CONTRACTIONS:
        j = i + 1 + len(c)
        if j <= len(text) and all(ch.casefold() == x
                                  for ch, x in zip(text[i + 1:j], c)):
            return j
    return 0


def split_words(text: str) -> List[str]:
    """``text`` split by ``QWEN2_PATTERN`` (every character lies in one
    match, so the pieces are the matches)."""
    kinds = [_kind(ch) for ch in text]
    n, i, out = len(text), 0, []
    while i < n:
        ch, k = text[i], kinds[i]
        j = _contraction(text, i) if ch == "'" else 0
        if not j and (k == "L" or (ch not in "\r\n" and k in "SP"
                                   and i + 1 < n and kinds[i + 1] == "L")):
            # [^\r\n\p{L}\p{N}]?\p{L}+
            j = i + 1 if k == "L" else i + 2
            while j < n and kinds[j] == "L":
                j += 1
        elif not j and k == "N":
            j = i + 1                                       # \p{N}
        elif not j and (k == "P" or (ch == " " and i + 1 < n
                                     and kinds[i + 1] == "P")):
            # ' ?[^\s\p{L}\p{N}]+[\r\n]*'
            j = i + 1 if k == "P" else i + 2
            while j < n and kinds[j] == "P":
                j += 1
            while j < n and text[j] in "\r\n":
                j += 1
        elif not j:                                         # white space
            r = i
            while r < n and kinds[r] == "S":
                r += 1
            nl = max(text.rfind("\r", i, r), text.rfind("\n", i, r))
            if nl >= 0:
                j = nl + 1                                  # \s*[\r\n]+
            elif r == n or r - i == 1:
                j = r                                       # \s+(?!\S), \s+
            else:
                j = r - 1                                   # \s+(?!\S)
        out.append(text[i:j])
        i = j
    return out


def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's map of the 256 byte values to printable characters."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


def _content(tok) -> Optional[str]:
    return tok.get("content") if isinstance(tok, dict) else tok


class BPETokenizer:
    """A Qwen2-layout byte-level BPE tokenizer (module docstring)."""

    def __init__(self, spec: dict, config: Optional[dict] = None):
        config = config or {}
        self._check_layout(spec)
        model = spec["model"]
        self.vocab: Dict[str, int] = dict(model["vocab"])
        self.ignore_merges = bool(model.get("ignore_merges"))
        self.ranks: Dict[tuple, tuple] = {}
        for rank, m in enumerate(model["merges"]):
            a, b = m.split(" ", 1) if isinstance(m, str) else m
            self.ranks[(self.vocab[a], self.vocab[b])] = (rank,
                                                          self.vocab[a + b])
        self.byte_map = bytes_to_unicode()
        self.byte_inv = {c: b for b, c in self.byte_map.items()}
        if any(c not in self.vocab for c in self.byte_map.values()):
            raise TokenizerNotSupported("byte-level BPE needs all 256 byte "
                                        "symbols in the vocabulary")
        self.added: Dict[str, int] = {t["content"]: t["id"]
                                      for t in spec.get("added_tokens", [])}
        self.special_ids = {t["id"] for t in spec.get("added_tokens", [])
                            if t.get("special")}
        self.id_to_token: Dict[int, str] = {i: t for t, i in self.vocab.items()}
        self.id_to_token.update({i: t for t, i in self.added.items()})
        self._added_re = (re.compile("|".join(
            re.escape(t) for t in sorted(self.added, key=len, reverse=True)))
            if self.added else None)
        self.special_tokens: Dict[str, object] = {}
        for attr in SPECIAL_ATTRS:
            tok = _content(config.get(attr))
            if tok:
                if tok not in self.added and tok not in self.vocab:
                    raise TokenizerNotSupported(
                        f"{attr} {tok!r} is not a token of tokenizer.json")
                self.special_tokens[attr] = tok
        extra = [_content(t) for t in config.get("additional_special_tokens")
                 or []]
        if extra:
            self.special_tokens["additional_special_tokens"] = extra
        self.chat_template = config.get("chat_template")
        self.clean_up_tokenization_spaces = bool(
            config.get("clean_up_tokenization_spaces", False))
        self.model_max_length = config.get("model_max_length")
        eos = self.special_tokens.get("eos_token")
        self.eos_token_id = None if eos is None else self.token_id(eos)
        self._cache: Dict[str, List[int]] = {}

    @staticmethod
    def _check_layout(spec: dict) -> None:
        model = spec.get("model") or {}
        norm = spec.get("normalizer") or {}
        pre = spec.get("pre_tokenizer") or {}
        steps = pre.get("pretokenizers", []) if pre.get("type") == "Sequence" \
            else []
        post = spec.get("post_processor")
        want = [
            (model.get("type") == "BPE", "a BPE model"),
            (not model.get("dropout") and not model.get("byte_fallback")
             and not model.get("continuing_subword_prefix")
             and not model.get("end_of_word_suffix"),
             "BPE without dropout, byte fallback or subword affixes"),
            (norm.get("type") == "NFC", "an NFC normalizer"),
            (len(steps) == 2 and steps[0].get("type") == "Split"
             and (steps[0].get("pattern") or {}).get("Regex") == QWEN2_PATTERN
             and steps[0].get("behavior") == "Isolated"
             and not steps[0].get("invert")
             and steps[1].get("type") == "ByteLevel"
             and not steps[1].get("add_prefix_space")
             and not steps[1].get("use_regex"),
             "Qwen2's Split pattern, then ByteLevel without its regex"),
            ((spec.get("decoder") or {}).get("type") == "ByteLevel",
             "a ByteLevel decoder"),
            (post is None or post.get("type") == "ByteLevel",
             "no post-processor that adds tokens"),
            (all(not (t.get("lstrip") or t.get("rstrip") or t.get("single_word")
                      or t.get("normalized"))
                 for t in spec.get("added_tokens", [])),
             "added tokens with the default options"),
        ]
        missing = [what for ok, what in want if not ok]
        if missing:
            raise TokenizerNotSupported(
                "tokenizer.json is not the Qwen2 byte-level BPE layout: "
                "needs " + "; ".join(missing))

    @classmethod
    def from_dir(cls, model_dir: str | Path) -> "BPETokenizer":
        """The tokenizer of a checkpoint directory (``tokenizer.json``,
        ``tokenizer_config.json`` when present)."""
        d = Path(model_dir)
        path = d / "tokenizer.json"
        if not path.exists():
            raise TokenizerNotSupported(f"no tokenizer.json under {d}")
        conf = d / "tokenizer_config.json"
        config = (json.loads(conf.read_text(encoding="utf-8"))
                  if conf.exists() else {})
        return cls(json.loads(path.read_text(encoding="utf-8")), config)

    # ------------------------------------------------------------- encode
    def token_id(self, token: str) -> int:
        return self.added[token] if token in self.added else self.vocab[token]

    def _bpe(self, word: str) -> List[int]:
        """One pre-token's ids (``word`` in byte-level characters)."""
        ids = self._cache.get(word)
        if ids is not None:
            return ids
        if self.ignore_merges and word in self.vocab:
            ids = [self.vocab[word]]
        else:
            sym = [self.vocab[c] for c in word]
            n = len(sym)
            prev, nxt = list(range(-1, n - 1)), list(range(1, n + 1))
            alive = [True] * n
            # (rank, position, merged id): the lowest rank, then the
            # leftmost pair first
            heap = [(self.ranks[p][0], i, self.ranks[p][1])
                    for i, p in enumerate(zip(sym, sym[1:])) if p in self.ranks]
            heapq.heapify(heap)
            while heap:
                _rank, i, new = heapq.heappop(heap)
                j = nxt[i]
                if not alive[i] or j >= n:
                    continue
                m = self.ranks.get((sym[i], sym[j]))
                if m is None or m[1] != new:
                    continue                         # an expired entry
                sym[i], alive[j] = new, False
                nxt[i] = nxt[j]
                if nxt[j] < n:
                    prev[nxt[j]] = i
                for a, b, at in ((prev[i], i, prev[i]), (i, nxt[i], i)):
                    if a >= 0 and b < n:
                        m = self.ranks.get((sym[a], sym[b]))
                        if m is not None:
                            heapq.heappush(heap, (m[0], at, m[1]))
            ids = [s for s, ok in zip(sym, alive) if ok]
        if len(self._cache) < _CACHE_MAX:
            self._cache[word] = ids
        return ids

    def _encode_text(self, text: str) -> List[int]:
        ids: List[int] = []
        for piece in split_words(unicodedata.normalize("NFC", text)):
            ids += self._bpe("".join(self.byte_map[b]
                                     for b in piece.encode("utf-8")))
        return ids

    def encode(self, text: str) -> List[int]:
        """Ids of ``text``: added tokens first, the rest by BPE."""
        if self._added_re is None:
            return self._encode_text(text)
        ids: List[int] = []
        at = 0
        for m in self._added_re.finditer(text):
            ids += self._encode_text(text[at:m.start()])
            ids.append(self.added[m.group()])
            at = m.end()
        return ids + self._encode_text(text[at:])

    def __call__(self, text: str, truncation: bool = False,
                 max_length: Optional[int] = None) -> Dict[str, List[int]]:
        """``{"input_ids": ...}`` of one text, as the transformers
        tokenizer gives them (no special tokens added); ``truncation``
        keeps the first ``max_length`` (default ``model_max_length``)."""
        ids = self.encode(text)
        limit = max_length or self.model_max_length
        if truncation and limit:
            ids = ids[:limit]
        return {"input_ids": ids}

    # ------------------------------------------------------------- decode
    def decode(self, ids: Sequence[int], skip_special_tokens: bool = False
               ) -> str:
        """Text of ``ids``: ids with no token dropped (special ones too
        with ``skip_special_tokens``), the byte-level characters turned
        back into bytes (a token with a character outside the byte map
        gives its own UTF-8), decoded with U+FFFD for invalid bytes."""
        raw = bytearray()
        for i in ids:
            tok = self.id_to_token.get(int(i))
            if tok is None or (skip_special_tokens
                               and int(i) in self.special_ids):
                continue
            try:
                raw += bytes(self.byte_inv[c] for c in tok)
            except KeyError:
                raw += tok.encode("utf-8")
        text = raw.decode("utf-8", errors="replace")
        if self.clean_up_tokenization_spaces:
            for a, b in ((" .", "."), (" ?", "?"), (" !", "!"), (" ,", ","),
                         (" ' ", "'"), (" n't", "n't"), (" 'm", "'m"),
                         (" 's", "'s"), (" 've", "'ve"), (" 're", "'re")):
                text = text.replace(a, b)
        return text

    # ------------------------------------------------------- chat template
    def apply_chat_template(self, messages: List[Dict[str, str]],
                            tokenize: bool = False,
                            add_generation_prompt: bool = False, **kwargs):
        """The config's ``chat_template`` rendered as transformers renders
        it: a sandboxed jinja2 environment with ``trim_blocks``,
        ``lstrip_blocks`` and the loop controls, ``raise_exception`` and a
        ``tojson`` that does not escape HTML, the special tokens as
        variables; the ids of the text with ``tokenize``."""
        if not self.chat_template:
            raise ValueError("the tokenizer has no chat_template")
        text = _compile_template(self.chat_template).render(
            messages=messages, tools=None, documents=None,
            add_generation_prompt=add_generation_prompt,
            **{**self.special_tokens, **kwargs})
        return self.encode(text) if tokenize else text


_TEMPLATES: Dict[str, object] = {}


def _compile_template(source: str):
    """The compiled template (one per source text)."""
    tpl = _TEMPLATES.get(source)
    if tpl is not None:
        return tpl
    import jinja2
    import jinja2.ext
    from jinja2.sandbox import ImmutableSandboxedEnvironment

    def raise_exception(message):
        raise jinja2.exceptions.TemplateError(message)

    def tojson(x, ensure_ascii=False, indent=None, separators=None,
               sort_keys=False):
        return json.dumps(x, ensure_ascii=ensure_ascii, indent=indent,
                          separators=separators, sort_keys=sort_keys)

    env = ImmutableSandboxedEnvironment(
        trim_blocks=True, lstrip_blocks=True,
        extensions=[jinja2.ext.loopcontrols])
    env.filters["tojson"] = tojson
    env.globals["raise_exception"] = raise_exception
    tpl = _TEMPLATES[source] = env.from_string(source)
    return tpl
