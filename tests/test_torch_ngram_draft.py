"""The port's corpus n-gram draft tables (``legalrag_tpu_torch/models/
ngram_draft.py``) and their CLI (``legalrag_tpu_torch/cli/
build_draft_table.py``) vs the JAX package's (``legalrag_tpu/models/
ngram_draft.py``, ``scripts/build_draft_table.py``) on the CPU: the built
arrays equal int for int (collisions included), each package loads the
other's ``.npz``, the device probe's int64 hash equals the uint32 Knuth
hash of ``_slot``, and for one ``tokenizer.json`` and corpus the two CLIs
write the same arrays."""

import json
import sys

import numpy as np
import pytest
import torch

from legalrag_tpu.models import ngram_draft as jng
from legalrag_tpu_torch.cli import build_draft_table as cli
from legalrag_tpu_torch.models import ngram_draft as tng
from legalrag_tpu_torch.models.spec_decode import _HASH_MULT

ARRAYS = ("_keys_a", "_keys_b", "_vals")


def streams(seed: int, n: int = 40, vocab: int = 300):
    """Seeded token streams with repeated phrases (so bigrams recur with
    competing continuations)."""
    rng = np.random.default_rng(seed)
    phrases = [rng.integers(0, vocab, rng.integers(3, 9)).tolist()
               for _ in range(12)]
    return [sum((phrases[i] for i in rng.integers(0, 12, 6)), [])
            + rng.integers(0, vocab, 5).tolist() for _ in range(n)]


def same_arrays(a, b):
    for name in ARRAYS:
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype == np.int32
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("k,log2_size,seed", [(8, 16, 0), (4, 6, 1),
                                               (3, 4, 2), (1, 8, 3)])
def test_from_streams_matches_jax(k, log2_size, seed):
    """Counts, argmax chains, 0-padding and the collision rule (the more
    frequent bigram keeps a slot): the same arrays and stats as JAX's."""
    s = streams(seed)
    got = tng.NgramDraftTable.from_streams(s, k=k, log2_size=log2_size)
    want = jng.NgramDraftTable.from_streams(s, k=k, log2_size=log2_size)
    same_arrays(got, want)
    assert got.stats() == want.stats()
    assert got.stats()["filled"] > 0
    for a, b in [(x[0], x[1]) for x in s[:10]] + [(7, 7)]:
        assert got.lookup(a, b) == want.lookup(a, b)


def test_npz_loads_both_ways(tmp_path):
    s = streams(4)
    mine = tng.NgramDraftTable.from_streams(s, k=4, log2_size=8)
    theirs = jng.NgramDraftTable.from_streams(s, k=4, log2_size=8)
    mine.save(tmp_path / "port.npz")
    theirs.save(tmp_path / "jax.npz")
    same_arrays(jng.NgramDraftTable.load(tmp_path / "port.npz"), theirs)
    same_arrays(tng.NgramDraftTable.load(tmp_path / "jax.npz"), mine)
    with np.load(tmp_path / "port.npz") as z:
        assert sorted(z.files) == ["keys_a", "keys_b", "vals"]
    table = tng.resolve_ngram_draft(str(tmp_path / "jax.npz"))
    assert tng.resolve_ngram_draft(table) is table
    assert tng.resolve_ngram_draft("") is None
    assert tng.resolve_ngram_draft(None) is None


def test_device_probe_hash_is_the_uint32_knuth_slot():
    """The engine's probe, ``((a * 2654435761 + b) & 0xFFFFFFFF) & (size -
    1)`` in int64, equals ``_slot`` (JAX's uint32 wrap) up to Qwen's ids."""
    rng = np.random.default_rng(0)
    a = rng.integers(0, 151936, 4000)
    b = rng.integers(0, 151936, 4000)
    for size in (16, 1 << 18):
        got = ((torch.from_numpy(a) * _HASH_MULT + torch.from_numpy(b))
               & 0xFFFFFFFF) & (size - 1)
        want = [jng._slot(int(x), int(y), size) for x, y in zip(a, b)]
        assert got.tolist() == want
        assert want == [tng._slot(int(x), int(y), size)
                        for x, y in zip(a, b)]


def test_device_arrays_and_refusals():
    t = tng.NgramDraftTable.from_streams([[1, 2, 3, 4, 5]], k=3, log2_size=4)
    ka, kb, vals = t.device_arrays(2, "cpu")
    assert ka.dtype == torch.int64 and vals.shape == (16, 2)
    assert t.device_arrays(2, "cpu")[0] is ka          # placed once
    with pytest.raises(ValueError, match="exceeds table draft length"):
        t.device_arrays(4, "cpu")
    with pytest.raises(ValueError, match="power of two"):
        tng.NgramDraftTable(np.full(6, -1, np.int32),
                            np.full(6, -1, np.int32),
                            np.zeros((6, 4), np.int32))


def test_device_arrays_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    t = tng.NgramDraftTable.from_streams([[1, 2, 3, 4]], k=2, log2_size=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t.device_arrays(2)


def test_cli_writes_the_jax_scripts_arrays(tmp_path, monkeypatch, zh_chunks,
                                           en_chunks):
    """Both CLIs over one Qwen2-layout ``tokenizer.json`` and a jsonl of
    statute chunks (zh and en): the same arrays; the port's prints and
    returns its stats."""
    from scripts import build_draft_table as jcli
    from test_torch_bpe import write_qwen2_tokenizer

    tok = write_qwen2_tokenizer(tmp_path / "tok")
    corpus = tmp_path / "corpus"
    corpus.mkdir()
    for name, chunks in (("law_zh.jsonl", zh_chunks[:300]),
                         ("law_en.jsonl", en_chunks[:150])):
        (corpus / name).write_text("".join(
            json.dumps({"text": c.text}, ensure_ascii=False) + "\n"
            for c in chunks), encoding="utf-8")
    args = ["--tokenizer", str(tok), "--input", str(corpus), "--k", "6",
            "--log2-size", "12"]
    out = cli.main(args + ["--out", str(tmp_path / "port.npz")])
    monkeypatch.setattr(sys, "argv", ["build_draft_table"] + args + [
        "--out", str(tmp_path / "jax.npz")])
    jcli.main()
    got = tng.NgramDraftTable.load(tmp_path / "port.npz")
    same_arrays(got, tng.NgramDraftTable.load(tmp_path / "jax.npz"))
    assert out == {"out": str(tmp_path / "port.npz"), **got.stats()}
    assert got.stats()["filled"] > 1000 and got.k == 6
