"""BERT WordPiece tokenization over a local ``vocab.txt`` (the port's
counterpart of the ``transformers.AutoTokenizer`` that the JAX encoders
load, ``legalrag_tpu/models/bert.py:313-315, 433``).

It gives ``BertTokenizerFast``'s ids, attention masks and token type ids
for ``padding="max_length", truncation=True``:

- special tokens in the raw text (``[CLS]``, ``[SEP]``, ``[PAD]``,
  ``[UNK]``, ``[MASK]``, case-sensitive) stand for themselves;
- normalizer: control characters (categories Cc, Cf, Co, Cs but tab,
  newline and carriage return), NUL and U+FFFD dropped, whitespace mapped
  to a space; the CJK ranges of ``_is_chinese_char`` padded with spaces;
  with ``do_lower_case``: NFD with nonspacing marks dropped (unless
  ``strip_accents`` is false), then a lowercase mapping per character;
- pre-tokenizer: split on whitespace, and each punctuation character (ASCII
  33-47, 58-64, 91-96, 123-126 and Unicode ``P*``) made a word;
- WordPiece: greedy longest match with the ``##`` prefix; a word longer
  than 100 characters, or one that does not split, is ``[UNK]``;
- ``[CLS] A [SEP]`` with type ids 0, ``[CLS] A [SEP] B [SEP]`` with type
  ids 0 then 1; ``longest_first`` truncation of pairs as the ``tokenizers``
  library does it; ``[PAD]`` with mask 0 and type id 0 up to ``max_length``.

A checkpoint whose directory has no ``vocab.txt`` (the sentencepiece
tokenizers of the XLM-RoBERTa family) is not supported yet.
"""

from __future__ import annotations

import json
import re
import unicodedata
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

SPECIAL = ("[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]")
MAX_WORD_CHARS = 100
_CJK = ((0x4E00, 0x9FFF), (0x3400, 0x4DBF), (0x20000, 0x2A6DF),
        (0x2A700, 0x2B73F), (0x2B740, 0x2B81F), (0x2B920, 0x2CEAF),
        (0xF900, 0xFAFF), (0x2F800, 0x2FA1F))
_CONTROL = ("Cc", "Cf", "Co", "Cs")
_WORD_CACHE_MAX = 1 << 17


class TokenizerNotSupported(NotImplementedError):
    """The checkpoint's tokenizer is not one the port implements."""


def _is_punct(ch: str) -> bool:
    cp = ord(ch)
    return (33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96
            or 123 <= cp <= 126 or unicodedata.category(ch).startswith("P"))


def _clean(ch: str) -> str:
    """The clean_text and CJK-padding steps of one character."""
    if ch in "\t\n\r":
        return " "
    if ch in "\x00\ufffd" or unicodedata.category(ch) in _CONTROL:
        return ""
    if ch.isspace():
        return " "
    cp = ord(ch)
    if any(lo <= cp <= hi for lo, hi in _CJK):
        return f" {ch} "
    return ch


class WordPieceTokenizer:
    def __init__(self, vocab: Dict[str, int], do_lower_case: bool = True,
                 strip_accents: Optional[bool] = None):
        missing = [t for t in SPECIAL[:4] if t not in vocab]
        if missing:
            raise KeyError(f"vocabulary lacks the special tokens {missing}")
        self.vocab = vocab
        self.lower = bool(do_lower_case)
        self.strip = self.lower if strip_accents is None else bool(strip_accents)
        self.pad_id, self.unk_id, self.cls_id, self.sep_id = (
            vocab[t] for t in SPECIAL[:4])
        special = [t for t in SPECIAL if t in vocab]
        self._special = re.compile("(" + "|".join(map(re.escape, special))
                                   + ")")
        self._chars: Dict[str, str] = {}
        self._words: Dict[str, List[int]] = {}

    @classmethod
    def from_dir(cls, model_dir: str | Path) -> "WordPieceTokenizer":
        """The tokenizer of a checkpoint directory: its ``vocab.txt`` (token
        ids by line, as ``transformers`` reads them) and the
        ``do_lower_case`` / ``strip_accents`` of its
        ``tokenizer_config.json`` (defaults True / None)."""
        d = Path(model_dir)
        vocab_file = d / "vocab.txt"
        if not vocab_file.exists():
            raise TokenizerNotSupported(
                f"tokenizer of {d} not supported by the port yet: no "
                f"vocab.txt (the port reads WordPiece vocabularies only)")
        vocab: Dict[str, int] = {}
        with open(vocab_file, encoding="utf-8") as f:
            for i, line in enumerate(f.readlines()):
                vocab[line.rstrip("\n")] = i
        conf: Dict = {}
        conf_file = d / "tokenizer_config.json"
        if conf_file.exists():
            conf = json.loads(conf_file.read_text(encoding="utf-8"))
        return cls(vocab, conf.get("do_lower_case", True),
                   conf.get("strip_accents"))

    # ------------------------------------------------------------- pieces
    def _normalize(self, text: str) -> str:
        out = []
        for ch in text:
            c = self._chars.get(ch)
            if c is None:
                c = self._chars[ch] = _clean(ch)
            out.append(c)
        s = "".join(out)
        if self.strip:
            s = "".join(c for c in unicodedata.normalize("NFD", s)
                        if unicodedata.category(c) != "Mn")
        if self.lower:
            # per character, as the tokenizers library maps it (no
            # final-sigma context, which str.lower applies)
            s = "".join(c.lower() for c in s)
        return s

    def _wordpiece(self, word: str) -> List[int]:
        ids = self._words.get(word)
        if ids is None:
            if len(self._words) >= _WORD_CACHE_MAX:
                self._words.clear()
            ids = self._words[word] = self._split(word)
        return ids

    def _split(self, word: str) -> List[int]:
        if len(word) > MAX_WORD_CHARS:
            return [self.unk_id]
        ids: List[int] = []
        start = 0
        while start < len(word):
            end = len(word)
            while end > start:
                piece = word[start:end] if start == 0 else "##" + word[start:end]
                tid = self.vocab.get(piece)
                if tid is not None:
                    break
                end -= 1
            else:
                return [self.unk_id]
            ids.append(tid)
            start = end
        return ids

    def words(self, text: str) -> List[str]:
        """The normalized words of ``text``: split on whitespace, each
        punctuation character a word of its own (special tokens are not
        looked for)."""
        out: List[str] = []
        for chunk in self._normalize(text).split():
            start = 0
            for j, ch in enumerate(chunk):
                if _is_punct(ch):
                    if j > start:
                        out.append(chunk[start:j])
                    out.append(ch)
                    start = j + 1
            if start < len(chunk):
                out.append(chunk[start:])
        return out

    def tokenize_ids(self, text: str) -> List[int]:
        """The token ids of ``text`` without special tokens around it."""
        ids: List[int] = []
        for i, part in enumerate(self._special.split(text)):
            if i % 2:
                ids.append(self.vocab[part])
                continue
            for word in self.words(part):
                ids += self._wordpiece(word)
        return ids

    # ------------------------------------------------------------- encode
    def encode(self, texts: Sequence[str], max_length: int,
               pairs: Optional[Sequence[str]] = None
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """``(input_ids, attention_mask, token_type_ids)``, each [n,
        max_length] int64, of ``texts`` (or of the pairs ``(texts[i],
        pairs[i])``), truncated and padded to ``max_length``."""
        n = len(texts)
        ids = np.full((n, max_length), self.pad_id, np.int64)
        mask = np.zeros((n, max_length), np.int64)
        types = np.zeros((n, max_length), np.int64)
        for r, text in enumerate(texts):
            a = self.tokenize_ids(text)
            if pairs is None:
                seq = [self.cls_id] + a[:max_length - 2] + [self.sep_id]
                n_a = len(seq)
            else:
                b = self.tokenize_ids(pairs[r])
                la, lb = truncate_pair(len(a), len(b), max_length - 3)
                seq = ([self.cls_id] + a[:la] + [self.sep_id] + b[:lb]
                       + [self.sep_id])
                n_a = la + 2
            ids[r, :len(seq)] = seq
            mask[r, :len(seq)] = 1
            types[r, n_a:len(seq)] = 1
        return ids, mask, types


def truncate_pair(n1: int, n2: int, max_len: int) -> Tuple[int, int]:
    """The lengths ``longest_first`` keeps of a pair of ``n1`` and ``n2``
    tokens within ``max_len`` (the ``tokenizers`` library's
    ``truncate_encodings``): the shorter one whole if it fits in half,
    else both cut to half (the second gets the odd token)."""
    if n1 + n2 <= max_len:
        return n1, n2
    swap = n1 > n2
    if swap:
        n1, n2 = n2, n1
    n2 = n1 if n1 > max_len else max(n1, max_len - n1)
    if n1 + n2 > max_len:
        n1 = max_len // 2
        n2 = n1 + max_len % 2
    return (n2, n1) if swap else (n1, n2)
