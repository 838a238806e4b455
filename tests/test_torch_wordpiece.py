"""The port's WordPiece tokenizer against ``transformers``'
``BertTokenizerFast`` (the tokenizer the JAX encoders load) over one
vocabulary: ids, attention masks and token type ids equal, for single
texts and pairs, at ``padding="max_length", truncation=True``. The
vocabulary holds CJK characters, accented words, full-width punctuation
(the zh query instruction's ``：``) and word pieces; the texts add
control and whitespace characters, special tokens in the text, CJK
compatibility ideographs, an over-long word, and pairs cut
``longest_first``."""

import random

import numpy as np
import pytest

from legalrag_tpu_torch.tokenize.wordpiece import (
    TokenizerNotSupported,
    WordPieceTokenizer,
    truncate_pair,
)

VOCAB = (["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
         + "the contract buyer seller goods law article shall of a b ##b ##s "
           "##er ##a ab sell café cafe naive straße σ ς Σ $ % - 1 12 ##1 ##2 "
           "represent this legal question for retrieving relevant provisions "
           ":".split()
         + list("为这个法律问题生成表示以用于检索相关条文：，。（）、合同当事人侵权"))
ZH_INSTRUCTION = "为这个法律问题生成表示以用于检索相关条文："
EN_INSTRUCTION = ("Represent this legal question for retrieving relevant "
                  "provisions: ")
CASES = [
    ZH_INSTRUCTION + "当事人订立合同（侵权）、法律。",
    EN_INSTRUCTION + "the buyer's goods",
    "Café, naïve STRASSE Straße — ΑΣ σς",
    "sellers contracter abbb ab1 12 121 $12%",
    "a\tb\nc\r\x0b\x0c\x85\x00�​　 d",
    "the [SEP] law[MASK]of [sep] [PAD]",
    "豈 \U0002B820\U0002B920 𠀀",
    "x" * 101 + " " + "b" * 100,
    "", "   ", "。。。",
]


@pytest.fixture(scope="module")
def vocab_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("wordpiece")
    (d / "vocab.txt").write_text("\n".join(VOCAB), encoding="utf-8")
    return d


def pair_of(vocab_dir, lower):
    from transformers import BertTokenizerFast

    hf = BertTokenizerFast(vocab_file=str(vocab_dir / "vocab.txt"),
                           do_lower_case=lower)
    mine = WordPieceTokenizer({t: i for i, t in enumerate(VOCAB)}, lower)
    return hf, mine


def assert_same(hf, mine, texts, max_length, pairs=None):
    args = (texts,) if pairs is None else (texts, pairs)
    want = hf(*args, padding="max_length", truncation=True,
              max_length=max_length, return_tensors="np")
    got = mine.encode(texts, max_length, pairs=pairs)
    for name, g in zip(("input_ids", "attention_mask", "token_type_ids"), got):
        assert g.dtype == np.int64 and g.shape == (len(texts), max_length)
        np.testing.assert_array_equal(g, want[name], err_msg=name)


@pytest.mark.parametrize("lower", [True, False])
@pytest.mark.parametrize("max_length", [6, 16, 64])
def test_single_texts_match_bert_tokenizer_fast(vocab_dir, lower, max_length):
    hf, mine = pair_of(vocab_dir, lower)
    assert_same(hf, mine, CASES, max_length)


@pytest.mark.parametrize("lower", [True, False])
@pytest.mark.parametrize("max_length", [7, 12, 13, 40])
def test_pairs_match_bert_tokenizer_fast(vocab_dir, lower, max_length):
    """``longest_first`` truncation of pairs of every length mix: the
    shorter one fits, both over half, one empty."""
    hf, mine = pair_of(vocab_dir, lower)
    a = [c for c in CASES for _ in CASES]
    b = [c for _ in CASES for c in CASES]
    assert_same(hf, mine, a, max_length, pairs=b)


@pytest.mark.parametrize("lower", [True, False])
def test_random_texts_match_bert_tokenizer_fast(vocab_dir, lower):
    """Seeded random strings over the vocabulary's pieces and hard
    characters, single and paired."""
    hf, mine = pair_of(vocab_dir, lower)
    alphabet = (list("abcΣσς 为这个法律问题：，。（）$%-12\t\n　​\x0b"
                     "\x85éÉßİ[]") + ["[SEP]", "[MASK]", "café", "naïve",
                                      "contract", "sellers", "�",
                                      "\x00", "\U0002B920", "豈", "x" * 120])
    rng = random.Random(0)
    for trial in range(40):
        texts = ["".join(rng.choice(alphabet)
                         for _ in range(rng.randint(0, 30))) for _ in range(8)]
        pairs = ["".join(rng.choice(alphabet)
                         for _ in range(rng.randint(0, 30))) for _ in range(8)]
        max_length = rng.choice([5, 9, 16, 33])
        assert_same(hf, mine, texts, max_length,
                    pairs=pairs if trial % 2 else None)


def test_truncate_pair_cases():
    assert truncate_pair(3, 4, 10) == (3, 4)       # fits
    assert truncate_pair(2, 20, 10) == (2, 8)      # the shorter one whole
    assert truncate_pair(20, 2, 10) == (8, 2)
    assert truncate_pair(9, 20, 10) == (5, 5)      # both over half
    assert truncate_pair(20, 9, 11) == (6, 5)      # the second gets the odd one
    assert truncate_pair(30, 40, 11) == (5, 6)
    assert truncate_pair(0, 20, 10) == (0, 10)


def test_from_dir_reads_vocab_and_config(vocab_dir, tmp_path):
    """``from_dir`` takes the ids by line and ``do_lower_case`` /
    ``strip_accents`` from ``tokenizer_config.json``, as transformers'
    directory loading does; a directory without ``vocab.txt`` is not
    supported."""
    from transformers import AutoTokenizer, BertTokenizerFast

    for lower, strip in ((True, None), (False, None), (True, False)):
        d = tmp_path / f"{lower}-{strip}"
        BertTokenizerFast(vocab_file=str(vocab_dir / "vocab.txt"),
                          do_lower_case=lower,
                          strip_accents=strip).save_pretrained(d)
        hf = AutoTokenizer.from_pretrained(str(d))
        mine = WordPieceTokenizer.from_dir(d)
        assert (mine.lower, mine.strip) == (lower, lower if strip is None
                                            else strip)
        assert_same(hf, mine, CASES, 24)
    with pytest.raises(TokenizerNotSupported, match="no vocab.txt"):
        WordPieceTokenizer.from_dir(tmp_path / "none")
    with pytest.raises(KeyError, match="special tokens"):
        WordPieceTokenizer({"a": 0})
