"""BPE over a local ``tokenizer.json`` (the port's counterpart of the
``transformers.AutoTokenizer`` that the JAX decoder engine loads,
``legalrag_tpu/models/decoder.py:1089-1091``, and that the JAX client
drives, ``legalrag_tpu/llm/client.py:390-428``).

Two layouts are read, each as the ``tokenizers`` library runs it:

Byte-level (Qwen2, Qwen2.5, Qwen3, Llama 3):

- normalizer NFC or none;
- pre-tokenizer: a ``Split`` on Qwen2's pattern (``QWEN2_PATTERN``) or on
  Llama 3's (``LLAMA3_PATTERN``: digits in runs of up to three), isolated,
  then ``ByteLevel`` without a prefix space or its own regex. Python's
  ``re`` has no ``\\p{L}`` or ``\\p{N}``, so the pattern runs as a
  hand-written scanner (``split_words``) over ``unicodedata``'s categories
  and Unicode's White_Space set, which is what Oniguruma's ``\\s``
  matches; its alternatives are tried in order at each position, with the
  regex's backtracking worked out per alternative;
- the GPT-2 byte-to-unicode map (every byte is a symbol, so
  ``byte_fallback`` never applies);
- decoder ``ByteLevel``: the bytes are decoded as UTF-8 with U+FFFD for
  each invalid sequence.

Sentencepiece-style (Llama 2, Mistral, Gemma):

- normalizer ``Prepend("▁")`` and ``Replace(" ", "▁")``, alone or in a
  ``Sequence``; or, in newer conversions, no normalizer and a
  ``Metaspace`` pre-tokenizer (``replacement`` "▁", ``prepend_scheme``
  ``always`` / ``first`` / ``never``, ``split``);
- without a pre-tokenizer a whole segment between added tokens is one BPE
  word;
- the word's characters are its symbols; a character absent from the
  vocabulary becomes its UTF-8 bytes as ``<0xNN>`` tokens
  (``byte_fallback``), else ``unk_token`` (runs fused with ``fuse_unk``);
- decoder: a ``Sequence`` of ``Replace("▁", " ")``, ``ByteFallback``
  (a run of ``<0xNN>`` tokens that is not UTF-8 becomes one U+FFFD per
  byte), ``Fuse`` and ``Strip``.

Common to both:

- added tokens matched in the raw text first, leftmost and longest, as the
  ``tokenizers`` library's added vocabulary does (only the default
  options: no ``lstrip``, ``rstrip``, ``single_word`` or normalized added
  tokens); a special token of ``tokenizer_config.json`` that is not an
  added token is added as a special one, as transformers adds it; the
  normalizer runs on each segment between them;
- BPE by merge rank, the lowest rank first and, among equal ranks, the
  leftmost pair, with a heap and linked neighbours as ``tokenizers``'
  ``Word::merge_all`` does; merges are read as ``"a b"`` strings or
  ``["a", "b"]`` pairs; with ``ignore_merges`` (Llama 3) a word found
  whole in the vocabulary is one token;
- a ``TemplateProcessing`` post-processor (alone or after ``ByteLevel``):
  its single-sequence special tokens around the ids when ``__call__`` adds
  special tokens (the default, as transformers' ``__call__``), truncation
  leaving room for them; a ``LlamaTokenizer`` or ``GemmaTokenizer`` config
  rebuilds it from ``add_bos_token`` and ``add_eos_token``, as
  transformers' ``update_post_processor`` does;
- decoding drops ids with no token (and special ones with
  ``skip_special_tokens``); added tokens go through the decoder as other
  tokens do.

``tokenizer_config.json`` gives the special tokens (``eos_token``, ...),
``chat_template``, ``clean_up_tokenization_spaces`` and
``model_max_length``. ``apply_chat_template`` renders the template with
``jinja2`` as transformers does. Any other layout (Unigram, WordPiece,
another split pattern or normalizer) raises ``TokenizerNotSupported``.

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
from typing import Dict, List, Optional, Sequence, Tuple

from legalrag_tpu_torch.tokenize.wordpiece import TokenizerNotSupported

QWEN2_PATTERN = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|"
                 r"\p{N}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")
LLAMA3_PATTERN = QWEN2_PATTERN.replace(r"\p{N}|", r"\p{N}{1,3}|")
# the split patterns read, by their longest run of digits in one piece
SPLIT_DIGITS = {QWEN2_PATTERN: 1, LLAMA3_PATTERN: 3}
# Unicode's White_Space property: what \s matches in Oniguruma
WHITE_SPACE = frozenset(map(chr, (*range(0x9, 0xE), 0x20, 0x85, 0xA0, 0x1680,
                                  *range(0x2000, 0x200B), 0x2028, 0x2029,
                                  0x202F, 0x205F, 0x3000)))
CONTRACTIONS = ("s", "t", "re", "ve", "m", "ll", "d")
SPECIAL_ATTRS = ("bos_token", "eos_token", "unk_token", "sep_token",
                 "pad_token", "cls_token", "mask_token")
SPIECE = "▁"
# transformers' classes that rebuild the post-processor from the config
BOS_EOS_CLASSES = ("LlamaTokenizer", "LlamaTokenizerFast", "GemmaTokenizer",
                   "GemmaTokenizerFast")
_CACHE_MAX = 1 << 17
_CACHE_WORD = 256           # longer words are not cached, as tokenizers'


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


def split_words(text: str, max_digits: int = 1) -> List[str]:
    """``text`` split by ``QWEN2_PATTERN``, or with ``max_digits`` 3 by
    ``LLAMA3_PATTERN`` (every character lies in one match, so the pieces
    are the matches)."""
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
            # \p{N} or \p{N}{1,3}
            j = i + 1
            while j < min(n, i + max_digits) and kinds[j] == "N":
                j += 1
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


def _steps(node: Optional[dict], key: str) -> List[dict]:
    """A component's steps: the members of a ``Sequence`` (under ``key``),
    the component alone, or none."""
    if not node:
        return []
    return list(node.get(key) or []) if node.get("type") == "Sequence" \
        else [node]


def _byte_token(tok: str) -> Optional[int]:
    """The byte of a ``<0xNN>`` token (``ByteFallback``'s test), else
    None."""
    if len(tok.encode("utf-8")) == 6 and tok.startswith("<0x") \
            and tok.endswith(">"):
        try:
            return int(tok[3:5], 16)
        except ValueError:
            return None
    return None


class Layout:
    """What of a ``tokenizer.json`` the tokenizer runs (module docstring);
    anything else raises ``TokenizerNotSupported`` naming it."""

    def __init__(self, spec: dict):
        model = spec.get("model") or {}
        pre = spec.get("pre_tokenizer")
        dec = spec.get("decoder") or {}
        self.normalizers: List[Tuple] = []
        for n in _steps(spec.get("normalizer"), "normalizers"):
            pat = (n.get("pattern") or {}).get("String")
            if n.get("type") == "NFC":
                self.normalizers.append(("NFC",))
            elif n.get("type") == "Prepend" and n.get("prepend"):
                self.normalizers.append(("prepend", n["prepend"]))
            elif n.get("type") == "Replace" and pat:
                self.normalizers.append(("replace", pat, n.get("content", "")))
            else:
                self._refuse(f"the normalizer {n.get('type')!r}")
        pres = _steps(pre, "pretokenizers")
        self.byte_level = dec.get("type") == "ByteLevel"
        self.max_digits, self.metaspace = 0, None
        if self.byte_level:
            pattern = ((pres[0].get("pattern") or {}).get("Regex")
                       if pres else None)
            if not (len(pres) == 2 and pres[0].get("type") == "Split"
                    and pattern in SPLIT_DIGITS
                    and pres[0].get("behavior") == "Isolated"
                    and not pres[0].get("invert")
                    and pres[1].get("type") == "ByteLevel"
                    and not pres[1].get("add_prefix_space")
                    and not pres[1].get("use_regex")):
                self._refuse("Qwen2's or Llama 3's Split pattern, then "
                             "ByteLevel without its regex")
            self.max_digits = SPLIT_DIGITS[pattern]
            if any(n[0] != "NFC" for n in self.normalizers):
                self._refuse("an NFC normalizer or none")
        else:
            if pres:
                m = pres[0]
                if not (len(pres) == 1 and m.get("type") == "Metaspace"
                        and m.get("replacement") == SPIECE
                        and m.get("prepend_scheme", "always") in (
                            "always", "first", "never")
                        and not self.normalizers):
                    self._refuse("a Metaspace pre-tokenizer alone, or none")
                self.metaspace = (m.get("prepend_scheme", "always"),
                                  bool(m.get("split", True)))
            elif not any(n[0] == "replace" and n[1] == " " and n[2] == SPIECE
                         for n in self.normalizers):
                self._refuse("a Replace(' ', '▁') normalizer or a Metaspace "
                             "pre-tokenizer")
            self.decoders = []
            for d in _steps(dec, "decoders"):
                t = d.get("type")
                pat = (d.get("pattern") or {}).get("String")
                if t == "Replace" and pat:
                    self.decoders.append(("replace", pat,
                                          d.get("content", "")))
                elif t in ("ByteFallback", "Fuse"):
                    self.decoders.append((t,))
                elif t == "Strip" and len(d.get("content", "")) == 1:
                    self.decoders.append(("strip", d["content"],
                                          int(d.get("start", 0)),
                                          int(d.get("stop", 0))))
                else:
                    self._refuse(f"the decoder {t!r}")
            if not self.decoders:
                self._refuse("a decoder")
        if model.get("type") != "BPE":
            self._refuse(f"a BPE model, not {model.get('type')!r}")
        if model.get("dropout") or model.get("continuing_subword_prefix") \
                or model.get("end_of_word_suffix"):
            self._refuse("BPE without dropout or subword affixes")
        self.prefix: List[int] = []
        self.suffix: List[int] = []
        for p in _steps(spec.get("post_processor"), "processors"):
            if p.get("type") == "TemplateProcessing":
                self._template(p)
            elif p.get("type") != "ByteLevel":
                self._refuse(f"the post-processor {p.get('type')!r}")
        if any(t.get("lstrip") or t.get("rstrip") or t.get("single_word")
               or t.get("normalized") for t in spec.get("added_tokens", [])):
            self._refuse("added tokens with the default options")

    def _template(self, p: dict) -> None:
        """The special tokens before and after ``$A`` in the single
        template."""
        at = self.prefix
        for piece in p.get("single", []):
            if "Sequence" in piece:
                if piece["Sequence"].get("id") != "A" or at is self.suffix:
                    self._refuse("a single template with one sequence A")
                at = self.suffix
            else:
                name = piece["SpecialToken"]["id"]
                at += p["special_tokens"][name]["ids"]
        if at is not self.suffix:
            self._refuse("a single template with one sequence A")

    @staticmethod
    def _refuse(what: str):
        raise TokenizerNotSupported(
            "tokenizer.json is not a byte-level or sentencepiece-style BPE "
            "layout this tokenizer reads: needs " + what)


class BPETokenizer:
    """A byte-level or sentencepiece-style BPE tokenizer (module
    docstring)."""

    def __init__(self, spec: dict, config: Optional[dict] = None):
        config = config or {}
        self.layout = lay = Layout(spec)
        model = spec["model"]
        self.vocab: Dict[str, int] = dict(model["vocab"])
        self.ignore_merges = bool(model.get("ignore_merges"))
        self.byte_fallback = bool(model.get("byte_fallback"))
        self.fuse_unk = bool(model.get("fuse_unk"))
        self.unk_token = model.get("unk_token")
        self.ranks: Dict[tuple, tuple] = {}
        for rank, m in enumerate(model["merges"]):
            a, b = m.split(" ", 1) if isinstance(m, str) else m
            self.ranks[(self.vocab[a], self.vocab[b])] = (rank,
                                                          self.vocab[a + b])
        if lay.byte_level:
            self.byte_map = bytes_to_unicode()
            self.byte_inv = {c: b for b, c in self.byte_map.items()}
            if any(c not in self.vocab for c in self.byte_map.values()):
                raise TokenizerNotSupported("byte-level BPE needs all 256 "
                                            "byte symbols in the vocabulary")
        self.added: Dict[str, int] = {t["content"]: t["id"]
                                      for t in spec.get("added_tokens", [])}
        self.special_ids = {t["id"] for t in spec.get("added_tokens", [])
                            if t.get("special")}
        self.id_to_token: Dict[int, str] = {i: t for t, i in self.vocab.items()}
        self.special_tokens: Dict[str, object] = {}
        for attr in SPECIAL_ATTRS:
            tok = _content(config.get(attr))
            if tok:
                self.special_tokens[attr] = tok
        extra = [_content(t) for t in config.get("additional_special_tokens")
                 or []]
        if extra:
            self.special_tokens["additional_special_tokens"] = extra
        for tok in [t for a, t in self.special_tokens.items()
                    if a != "additional_special_tokens"] + extra:
            if tok not in self.added:
                if tok not in self.vocab:
                    raise TokenizerNotSupported(
                        f"special token {tok!r} is not a token of "
                        "tokenizer.json")
                self.added[tok] = self.vocab[tok]   # as transformers adds it
            self.special_ids.add(self.added[tok])
        self.id_to_token.update({i: t for t, i in self.added.items()})
        self._added_re = (re.compile("|".join(
            re.escape(t) for t in sorted(self.added, key=len, reverse=True)))
            if self.added else None)
        self.prefix, self.suffix = list(lay.prefix), list(lay.suffix)
        if config.get("tokenizer_class") in BOS_EOS_CLASSES:
            self.prefix = ([self.token_id(self.special_tokens["bos_token"])]
                           if config.get("add_bos_token", True) else [])
            self.suffix = ([self.token_id(self.special_tokens["eos_token"])]
                           if config.get("add_eos_token", False) else [])
        self.chat_template = config.get("chat_template")
        self.clean_up_tokenization_spaces = bool(
            config.get("clean_up_tokenization_spaces", False))
        self.model_max_length = config.get("model_max_length")
        eos = self.special_tokens.get("eos_token")
        self.eos_token_id = None if eos is None else self.token_id(eos)
        self._cache: Dict[str, List[int]] = {}

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

    def __len__(self) -> int:
        """The tokens of the vocabulary and the added ones, counted once
        each (transformers' ``len(tokenizer)``)."""
        return len(self.vocab.keys() | self.added.keys())

    @property
    def all_special_ids(self) -> List[int]:
        """The ids of the configured special tokens (``bos_token`` ...,
        ``additional_special_tokens``), as transformers lists them."""
        toks = [t for a, t in self.special_tokens.items()
                if a != "additional_special_tokens"]
        toks += self.special_tokens.get("additional_special_tokens", [])
        return list(dict.fromkeys(self.token_id(t) for t in toks))

    # ------------------------------------------------------------- encode
    def token_id(self, token: str) -> int:
        return self.added[token] if token in self.added else self.vocab[token]

    def _symbols(self, word: str) -> List[int]:
        """The ids a word starts from: its characters, a character absent
        from the vocabulary as its ``<0xNN>`` bytes (byte fallback) or as
        the unknown token, a run of unknowns fused with ``fuse_unk``."""
        if self.layout.byte_level:
            return [self.vocab[c] for c in word]
        sym: List[int] = []
        unk = False              # an unknown token is pending
        for c in word:
            i = self.vocab.get(c)
            if i is not None:
                if unk:
                    sym.append(self.vocab[self.unk_token])
                    unk = False
                sym.append(i)
                continue
            if self.byte_fallback:
                ids = [self.vocab.get(f"<0x{b:02X}>") for b in c.encode()]
                if None not in ids:
                    sym += ids   # a pending unknown stays pending
                    continue
            if self.unk_token is not None:
                if unk and not self.fuse_unk:
                    sym.append(self.vocab[self.unk_token])
                unk = True
        if unk:
            sym.append(self.vocab[self.unk_token])
        return sym

    def _bpe(self, word: str) -> List[int]:
        """One pre-token's ids (``word`` in byte-level characters, or a
        sentencepiece-style segment)."""
        ids = self._cache.get(word)
        if ids is not None:
            return ids
        if self.ignore_merges and word in self.vocab:
            ids = [self.vocab[word]]
        else:
            sym = self._symbols(word)
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
        if len(word) < _CACHE_WORD and len(self._cache) < _CACHE_MAX:
            self._cache[word] = ids
        return ids

    def _normalize(self, text: str) -> str:
        for n in self.layout.normalizers:
            if n[0] == "NFC":
                text = unicodedata.normalize("NFC", text)
            elif n[0] == "prepend":
                text = n[1] + text if text else text
            else:
                text = text.replace(n[1], n[2])
        return text

    def _words(self, text: str, at_start: bool) -> List[str]:
        """A normalized segment's pre-tokens; ``at_start``: the segment
        begins the text (Metaspace's ``first`` scheme)."""
        lay = self.layout
        if lay.byte_level:
            return ["".join(self.byte_map[b] for b in piece.encode("utf-8"))
                    for piece in split_words(text, lay.max_digits)]
        if lay.metaspace is None:
            return [text] if text else []
        scheme, split = lay.metaspace
        text = text.replace(" ", SPIECE)
        if not text.startswith(SPIECE) and (
                scheme == "always" or (scheme == "first" and at_start)):
            text = SPIECE + text
        if not split:
            return [text] if text else []
        # split on "▁", each one merged with the piece after it
        return [w for w in re.split(f"(?={SPIECE})", text) if w]

    def _encode_text(self, text: str, at_start: bool) -> List[int]:
        ids: List[int] = []
        if text:
            for word in self._words(self._normalize(text), at_start):
                ids += self._bpe(word)
        return ids

    def encode(self, text: str) -> List[int]:
        """Ids of ``text``: added tokens first, the rest by BPE (no
        special tokens added)."""
        if self._added_re is None:
            return self._encode_text(text, True)
        ids: List[int] = []
        at = 0
        for m in self._added_re.finditer(text):
            ids += self._encode_text(text[at:m.start()], at == 0)
            ids.append(self.added[m.group()])
            at = m.end()
        return ids + self._encode_text(text[at:], at == 0)

    def __call__(self, text: str, truncation: bool = False,
                 max_length: Optional[int] = None,
                 add_special_tokens: bool = True) -> Dict[str, List[int]]:
        """``{"input_ids": ...}`` of one text, as the transformers
        tokenizer gives them: the post-processor's special tokens around
        the ids with ``add_special_tokens``; ``truncation`` keeps the
        first ``max_length`` (default ``model_max_length``) ids, special
        tokens included."""
        ids = self.encode(text)
        pre, suf = (self.prefix, self.suffix) if add_special_tokens \
            else ([], [])
        limit = max_length or self.model_max_length
        if truncation and limit:
            ids = ids[:max(limit - len(pre) - len(suf), 0)]
        return {"input_ids": pre + ids + suf}

    # ------------------------------------------------------------- decode
    def decode(self, ids: Sequence[int], skip_special_tokens: bool = False
               ) -> str:
        """Text of ``ids``: ids with no token dropped (special ones too
        with ``skip_special_tokens``), the rest through the decoder."""
        toks = []
        for i in ids:
            tok = self.id_to_token.get(int(i))
            if tok is not None and not (skip_special_tokens
                                        and int(i) in self.special_ids):
                toks.append(tok)
        text = (self._decode_bytes(toks) if self.layout.byte_level
                else self._decode_chain(toks))
        if self.clean_up_tokenization_spaces:
            for a, b in ((" .", "."), (" ?", "?"), (" !", "!"), (" ,", ","),
                         (" ' ", "'"), (" n't", "n't"), (" 'm", "'m"),
                         (" 's", "'s"), (" 've", "'ve"), (" 're", "'re")):
                text = text.replace(a, b)
        return text

    def _decode_bytes(self, toks: List[str]) -> str:
        """``ByteLevel``: the byte-level characters turned back into bytes
        (a token with a character outside the byte map gives its own
        UTF-8), decoded with U+FFFD for invalid bytes."""
        raw = bytearray()
        for tok in toks:
            try:
                raw += bytes(self.byte_inv[c] for c in tok)
            except KeyError:
                raw += tok.encode("utf-8")
        return raw.decode("utf-8", errors="replace")

    def _decode_chain(self, toks: List[str]) -> str:
        """The sentencepiece-style decoder steps over the tokens."""
        for step in self.layout.decoders:
            if step[0] == "replace":
                toks = [t.replace(step[1], step[2]) for t in toks]
            elif step[0] == "ByteFallback":
                toks = _byte_fallback(toks)
            elif step[0] == "Fuse":
                toks = ["".join(toks)]
            else:
                toks = [_strip(t, *step[1:]) for t in toks]
        return "".join(toks)

    # ------------------------------------------------------- chat template
    def apply_chat_template(self, messages: List[Dict[str, str]],
                            tokenize: bool = False,
                            add_generation_prompt: bool = False, **kwargs):
        """The config's ``chat_template`` rendered as transformers renders
        it (``_compile_template``), the special tokens as variables; the
        ids of the text, with no special tokens added, with ``tokenize``."""
        if not self.chat_template:
            raise ValueError("the tokenizer has no chat_template")
        text = _compile_template(self.chat_template).render(
            messages=messages, tools=None, documents=None,
            add_generation_prompt=add_generation_prompt,
            **{**self.special_tokens, **kwargs})
        return self.encode(text) if tokenize else text


def _byte_fallback(toks: List[str]) -> List[str]:
    """``ByteFallback``: each run of ``<0xNN>`` tokens as its UTF-8 text,
    or one U+FFFD per byte when the run is not UTF-8."""
    out: List[str] = []
    run = bytearray()
    for tok in toks + [None]:
        b = None if tok is None else _byte_token(tok)
        if b is not None:
            run.append(b)
            continue
        if run:
            try:
                out.append(run.decode("utf-8"))
            except UnicodeDecodeError:
                out += ["�"] * len(run)
            run = bytearray()
        if tok is not None:
            out.append(tok)
    return out


def _strip(tok: str, ch: str, start: int, stop: int) -> str:
    """``Strip``: up to ``start`` leading and ``stop`` trailing ``ch``."""
    a = 0
    while a < min(start, len(tok)) and tok[a] == ch:
        a += 1
    b = len(tok)
    while len(tok) - b < stop and b > a and tok[b - 1] == ch:
        b -= 1
    return tok[a:b]


_TEMPLATES: Dict[str, object] = {}


def _compile_template(source: str):
    """The compiled template (one per source text): a sandboxed jinja2
    environment with ``trim_blocks``, ``lstrip_blocks``, the loop controls
    and a ``{% generation %}`` block that renders its body, and the
    globals transformers' renderer supplies: ``raise_exception``,
    ``strftime_now`` (the local time) and a ``tojson`` that does not escape
    HTML."""
    tpl = _TEMPLATES.get(source)
    if tpl is not None:
        return tpl
    from datetime import datetime

    import jinja2
    import jinja2.ext
    from jinja2.sandbox import ImmutableSandboxedEnvironment

    class Generation(jinja2.ext.Extension):
        """``{% generation %}...{% endgeneration %}``: the body as is
        (transformers marks the assistant's tokens with it)."""
        tags = {"generation"}

        def parse(self, parser):
            lineno = next(parser.stream).lineno
            body = parser.parse_statements(("name:endgeneration",),
                                           drop_needle=True)
            return jinja2.nodes.Scope(body).set_lineno(lineno)

    def raise_exception(message):
        raise jinja2.exceptions.TemplateError(message)

    def tojson(x, ensure_ascii=False, indent=None, separators=None,
               sort_keys=False):
        return json.dumps(x, ensure_ascii=ensure_ascii, indent=indent,
                          separators=separators, sort_keys=sort_keys)

    def strftime_now(fmt):
        return datetime.now().strftime(fmt)

    env = ImmutableSandboxedEnvironment(
        trim_blocks=True, lstrip_blocks=True,
        extensions=[Generation, jinja2.ext.loopcontrols])
    env.filters["tojson"] = tojson
    env.globals["raise_exception"] = raise_exception
    env.globals["strftime_now"] = strftime_now
    tpl = _TEMPLATES[source] = env.from_string(source)
    return tpl
