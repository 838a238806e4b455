"""Host-side tokenization (BM25 + hash-feature extraction).

Parity notes:
- en BM25 tokens: ``[A-Za-z0-9]+('...)?`` lowercased, matching the reference
  builder regex (``bm25_builder.py:18-19``).
- zh BM25 tokens: ``jieba.cut`` (``bm25_builder.py:43``). jieba is imported
  lazily; a char-bigram fallback keeps the stack importable without it.

Feature hashing uses 64-bit FNV-1a (stable across processes — Python's
``hash()`` is salted and must never reach an index artifact).
"""

from __future__ import annotations

import re
from functools import lru_cache
from typing import Iterable, List

_EN_TOKEN = re.compile(r"[A-Za-z0-9]+(?:'[A-Za-z0-9]+)?")
_ZH_CHAR = re.compile(r"[一-鿿]")
# hyphenated statute section references ("2-306", "2A-201", "9-102a";
# the same shapes whether written "§ 2-306", "Section 2-306" or bare).
# The word regex above shreds them into high-df digit runs ("2", "306"),
# which erases the only exact lexical route from a citation-shaped query
# to its section — the dominant en retrieval failure (EVAL.md round-3 en
# held split). Emitted as ONE canonical uppercase token alongside the
# word tokens, giving BM25 a low-df exact term and the hash encoder an
# exact-match feature. A bare all-digit match ("12-31") also fits dates
# and ranges (ADVICE r4), so those emit only with a citation cue just
# before the match; article-letter shapes ("2A-201", "9-102a") are
# unambiguous and always emit.
_EN_SECREF = re.compile(r"\b(\d{1,2}[A-Za-z]?)\s*[-–—]\s*(\d{1,4}[A-Za-z]?)\b")
_EN_SECREF_CUE = re.compile(r"(?:§§?|\bsections?\b|\bsecs?\.?\b"
                            r"|\barticles?\b)\s*$", re.IGNORECASE)

# Doc-side featurization version, recorded in every index manifest
# (index/bundle.py) and checked on load: bump this whenever tokenization
# or hash-feature emission changes shape, so stale indexes REFUSE to
# load instead of silently serving query featurization that diverges
# from the stored doc vectors (ADVICE r4: the round-4 secref tokens were
# inert against round-3 indexes). History: v1 = pre-secref, v2 =
# round-4 unconditional secrefs, v3 = cue-gated bare secrefs.
TOKENIZE_FINGERPRINT = "secref-cued-v3"

_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_MASK64 = (1 << 64) - 1


def fnv1a(data: str, seed: int = 0) -> int:
    """Stable 64-bit FNV-1a hash of a UTF-8 string."""
    h = (_FNV_OFFSET ^ seed) & _MASK64
    for b in data.encode("utf-8"):
        h ^= b
        h = (h * _FNV_PRIME) & _MASK64
    return h


def fnv1a_batch(feats, seed: int = 0):
    """Vectorized FNV-1a over a list of strings → uint64 array.

    Bit-exact with :func:`fnv1a` (tested); the byte-chain recurrence is
    vectorized across features (one numpy pass per byte position), which is
    ~100× the pure-Python loop on corpus-sized feature streams.
    """
    import numpy as np

    n = len(feats)
    if n == 0:
        return np.zeros(0, np.uint64)
    bs = [f.encode("utf-8") for f in feats]
    lens = np.fromiter((len(b) for b in bs), np.int64, n)
    maxlen = int(lens.max())
    flat = b"".join(b.ljust(maxlen, b"\0") for b in bs)
    arr = np.frombuffer(flat, np.uint8).reshape(n, maxlen).astype(np.uint64)
    prime = np.uint64(_FNV_PRIME)
    h = np.full(n, np.uint64((_FNV_OFFSET ^ seed) & _MASK64))
    with np.errstate(over="ignore"):
        for i in range(maxlen):
            h2 = (h ^ arr[:, i]) * prime
            h = np.where(lens > i, h2, h)
    return h


@lru_cache(maxsize=1)
def _jieba():
    try:
        import jieba  # type: ignore

        jieba.setLogLevel(60)
        jieba.initialize()
        return jieba
    except ImportError:
        return None


@lru_cache(maxsize=8192)
def _tokenize_en_cached(text: str) -> tuple:
    return tuple(t.lower() for t in _EN_TOKEN.findall(text))


@lru_cache(maxsize=8192)
def _tokenize_zh_cached(text: str) -> tuple:
    j = _jieba()
    if j is not None:
        return tuple(t for t in j.cut(text) if t.strip())
    chars = _ZH_CHAR.findall(text)
    toks = chars + [a + b for a, b in zip(chars, chars[1:])]
    return tuple(toks) + _tokenize_en_cached(text)


@lru_cache(maxsize=8192)
def _secrefs_en_cached(text: str, query: bool) -> tuple:
    out = []
    for m in _EN_SECREF.finditer(text):
        lettered = any(c.isalpha() for c in m.group(1) + m.group(2))
        if not lettered and not query:
            # DOC side, bare digits: require a citation cue just before
            # the match ("§ 2-306", "Section 2-306") so dates/ranges
            # ("12-31", "10-15 days") stay out of the stored term
            # stream. QUERY side stays liberal: a bare citation query
            # ("what does 2-306 cover") must still reach the cued doc
            # term, and a spurious query token merely misses the vocab.
            prefix = text[max(0, m.start() - 12):m.start()]
            if _EN_SECREF_CUE.search(prefix) is None:
                continue
        out.append(f"{m.group(1)}-{m.group(2)}".upper())
    return tuple(out)


def secrefs_en(text: str, query: bool = False) -> List[str]:
    """Canonical section-ref tokens found in ``text`` ("2A-201" style);
    ``query=True`` = liberal emission (see _secrefs_en_cached)."""
    return list(_secrefs_en_cached(text, query))


def tokenize_en(text: str) -> List[str]:
    # LRU'd: one query is tokenized by three encode paths per request
    # (BM25 term ids, sketch features, token vectors). Word tokens only —
    # section-ref tokens are appended by :func:`tokenize` (keeps the
    # native tokenize_ascii parity contract byte-for-byte).
    return list(_tokenize_en_cached(text))


def tokenize_zh(text: str) -> List[str]:
    return list(_tokenize_zh_cached(text))


def tokenize(text: str, lang: str, query: bool = False) -> List[str]:
    if lang == "zh":
        return tokenize_zh(text)
    return tokenize_en(text) + secrefs_en(text, query)


def char_ngrams(token: str, n_min: int = 3, n_max: int = 4) -> Iterable[str]:
    t = f"#{token}#"
    for n in range(n_min, n_max + 1):
        for i in range(len(t) - n + 1):
            yield t[i:i + n]


def hash_features(text: str, lang: str, *, with_ngrams: bool = True,
                  query: bool = False) -> List[str]:
    """Feature strings for the hashed encoder: word tokens plus subword /
    char-level context features for fuzzy matching."""
    toks = tokenize(text, lang, query)
    feats: List[str] = list(toks)
    if lang == "zh":
        # char bigrams across the raw CJK stream add cross-word context
        chars = _ZH_CHAR.findall(text)
        feats.extend(a + b for a, b in zip(chars, chars[1:]))
    if with_ngrams:
        for t in toks:
            # section-ref tokens ("2-306") stay exact-match only: char
            # ngrams would bleed similarity onto ADJACENT sections
            # (2-305 vs 2-306 are different provisions)
            if lang != "zh" and len(t) > 3 and "-" not in t:
                feats.extend(char_ngrams(t))
    return feats
