"""Port bundle build vs the JAX one at full width (zh Civil Code, en UCC),
and bundles saved by one package loading in the other."""

import json

import numpy as np
import pytest

from legalrag_tpu.config import AppConfig as JaxConfig
from legalrag_tpu.index.bundle import IndexBundle as JaxBundle
from legalrag_tpu_torch.config import AppConfig
from legalrag_tpu_torch.index.bundle import IndexBundle, StaleIndexError
from legalrag_tpu_torch.schemas import LawChunk


def port_chunks(chunks):
    return [LawChunk.from_json(c.model_dump_json(exclude_none=True))
            for c in chunks]


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    """The spacing of bf16 values at |x| (8 significant bits)."""
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(x), 1e-38))) - 7)


@pytest.fixture(scope="module", params=["zh", "en"])
def built(request, zh_chunks, en_chunks):
    lang = request.param
    chunks = zh_chunks if lang == "zh" else en_chunks
    jb = JaxBundle.build_from_chunks(chunks, JaxConfig(), lang)
    tb = IndexBundle.build_from_chunks(port_chunks(chunks), AppConfig(), lang,
                                       device="cpu")
    return lang, jb, tb


def test_full_width_shapes(built):
    lang, jb, tb = built
    n = {"zh": 1260, "en": 591}[lang]
    assert tb.n_docs == jb.n_docs == n
    assert tuple(tb.dense.emb.shape) == tuple(jb.dense.emb.shape)
    assert tb.dense.emb.shape[1] == 768
    assert tuple(tb.tokens.tok.shape) == tuple(jb.tokens.tok.shape)
    assert tb.tokens.tok.shape[1:] == (220, 128)
    assert tuple(tb.bm25.impact.shape) == tuple(jb.bm25.impact.shape)


def test_bm25_and_tokens_bit_equal(built):
    _, jb, tb = built
    assert tb.bm25.vocab == jb.bm25.vocab
    np.testing.assert_array_equal(tb.bm25.impact.numpy(),
                                  np.asarray(jb.bm25.impact))
    np.testing.assert_array_equal(tb.tokens.tok.float().numpy(),
                                  np.asarray(jb.tokens.tok, np.float32))
    np.testing.assert_array_equal(tb.tokens.mask.numpy(),
                                  np.asarray(jb.tokens.mask))
    np.testing.assert_array_equal(tb.encoder.df, jb.encoder.df)


def test_dense_rows_within_one_bf16_ulp(built):
    """The float32 projection sums in another order (and the port's default
    projection differs from JAX's by erfinv's residue), so a row element may
    round to the neighbouring bf16 value. Near zero (|x| < ~1e-4) a bf16 ulp
    is finer than the float32 rows' own difference (< 1e-6 absolute), so
    there the bound is that difference."""
    _, jb, tb = built
    texts = [c.text for c in jb.chunks[:64]]
    f32_diff = np.abs(tb.encoder.encode_passages(texts)
                      - jb.encoder.encode_passages(texts)).max()
    assert f32_diff < 1e-6
    got = tb.dense.emb.float().numpy()
    want = np.asarray(jb.dense.emb, np.float32)
    ulp = bf16_ulp(np.maximum(np.abs(got), np.abs(want)))
    assert (np.abs(got - want) <= np.maximum(ulp, 1e-6)).all()
    assert (got == want).mean() > 0.99


def test_jax_saved_bundle_loads_in_port(built, tmp_path):
    """The npz stores rows as float16, so a saved bundle is compared with
    the same directory loaded by the JAX package."""
    lang, saved, _ = built
    saved.save(tmp_path / lang)
    jb = JaxBundle.load(tmp_path / lang, JaxConfig(), lang)
    tb = IndexBundle.load(tmp_path / lang, AppConfig(), lang, device="cpu")
    assert [c.id for c in tb.chunks] == [c.id for c in jb.chunks]
    assert tb.chunks[5].text == jb.chunks[5].text
    np.testing.assert_array_equal(tb.dense.emb.float().numpy(),
                                  np.asarray(jb.dense.emb, np.float32))
    np.testing.assert_array_equal(tb.bm25.impact.numpy(),
                                  np.asarray(jb.bm25.impact))
    np.testing.assert_array_equal(tb.tokens.tok.float().numpy(),
                                  np.asarray(jb.tokens.tok, np.float32))
    np.testing.assert_array_equal(tb.tokens.mask.numpy(),
                                  np.asarray(jb.tokens.mask))
    np.testing.assert_array_equal(tb.encoder.df, jb.encoder.df)
    assert tb.generation == jb.generation


def test_port_saved_bundle_loads_in_jax(built, tmp_path):
    lang, _, saved = built
    saved.save(tmp_path / lang)
    jb = JaxBundle.load(tmp_path / lang, JaxConfig(), lang)
    tb = IndexBundle.load(tmp_path / lang, AppConfig(), lang, device="cpu")
    np.testing.assert_array_equal(np.asarray(jb.dense.emb, np.float32),
                                  tb.dense.emb.float().numpy())
    np.testing.assert_array_equal(np.asarray(jb.bm25.impact),
                                  tb.bm25.impact.numpy())
    np.testing.assert_array_equal(np.asarray(jb.tokens.tok, np.float32),
                                  tb.tokens.tok.float().numpy())
    assert jb.bm25.vocab == tb.bm25.vocab
    lines = (tmp_path / lang / "chunks.jsonl").read_text(encoding="utf-8")
    want = "".join(c.model_dump_json(exclude_none=True) + "\n"
                   for c in jb.chunks)
    assert lines == want
    manifest = json.loads((tmp_path / lang / "manifest.json").read_text())
    assert manifest["n_docs"] == tb.n_docs


def test_stale_fingerprint_refuses_to_load(en_chunks, tmp_path):
    cfg = AppConfig()
    cfg.engine.capacity_round = 64
    cfg.engine.late_doc_maxlen = 32
    tb = IndexBundle.build_from_chunks(port_chunks(en_chunks[:30]), cfg, "en",
                                       device="cpu")
    d = tmp_path / "stale"
    tb.save(d)
    back = IndexBundle.load(d, cfg, "en", device="cpu")
    assert back.dense.capacity == 64 and back.n_docs == 30
    m = json.loads((d / "manifest.json").read_text())
    m["tokenize_fingerprint"] = "v1"
    (d / "manifest.json").write_text(json.dumps(m))
    with pytest.raises(StaleIndexError):
        IndexBundle.load(d, cfg, "en", device="cpu")
