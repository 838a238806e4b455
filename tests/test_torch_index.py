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


# ------------------------------------------------ the serving path's methods

QUERIES = ["buyer in ordinary course of business",
           "security interest attaches when value is given",
           "negotiable instrument payable to bearer", "",
           "zebra astronomy"]


def assert_rows_up_to_ties(ws, wr, gs, gr, atol=1e-5, tie=1e-6):
    """Scores within atol; rows equal except where the JAX scores tie."""
    np.testing.assert_allclose(gs, ws, atol=atol)
    for q, p in np.argwhere(np.asarray(wr) != np.asarray(gr)):
        j = np.nonzero(wr[q] == gr[q, p])[0]
        ref = ws[q, j[0]] if len(j) else gs[q, p]
        assert abs(ref - ws[q, p]) < tie, (q, p, wr[q], gr[q])


@pytest.fixture(scope="module")
def carried(en_chunks):
    """The JAX bundle of en[:150] (small config) and its port copy."""
    from test_torch_engine import carry

    jcfg, cfg = JaxConfig(), AppConfig()
    for c in (jcfg, cfg):
        c.engine.capacity_round = 256
        c.engine.late_doc_maxlen = 64
    jb = JaxBundle.build_from_chunks(en_chunks[:150], jcfg, "en")
    return jb, carry(jb, cfg)


@pytest.mark.parametrize("k", [1, 10, 40, 150, 300])
def test_dense_topk_matches_jax(carried, k):
    jb, tb = carried
    q = jb.encoder.encode_queries(QUERIES)
    ws, wr = jb.dense.topk(q, k)
    gs, gr = tb.dense.topk(np.asarray(q), k)
    assert gs.shape == ws.shape == (len(QUERIES), min(k, 150))
    assert_rows_up_to_ties(ws, wr, gs, gr)


def test_dense_score_rows_matches_jax(carried):
    jb, tb = carried
    q = np.asarray(jb.encoder.encode_queries(QUERIES[:1]))[0]
    rows = np.array([0, 5, 149, 5, 77], np.int32)
    np.testing.assert_allclose(tb.dense.score_rows(q, rows),
                               jb.dense.score_rows(q, rows), atol=1e-6)
    assert tb.dense.score_rows(q, np.zeros(0, np.int32)).shape == (0,)


def test_bm25_query_methods_match_jax(carried):
    jb, tb = carried
    np.testing.assert_array_equal(tb.bm25.query_vectors(QUERIES),
                                  jb.bm25.query_vectors(QUERIES))
    np.testing.assert_allclose(tb.bm25.scores(QUERIES),
                               jb.bm25.scores(QUERIES), atol=1e-5)
    for k in (1, 10, 40, 150):
        ws, wr = jb.bm25.topk(QUERIES, k)
        gs, gr = tb.bm25.topk(QUERIES, k)
        assert gs.shape == ws.shape
        assert_rows_up_to_ties(ws, wr, gs, gr)
    # the last two queries match nothing: their lists are rows 0..k-1
    assert tb.bm25.topk(QUERIES, 10)[1][4].tolist() == list(range(10))


def test_bm25_add_texts_matches_jax(en_chunks):
    from legalrag_tpu.index.bm25_index import BM25Index as JaxBM25
    from legalrag_tpu_torch.index.bm25_index import BM25Index

    texts = [c.text for c in en_chunks[:60]]
    jx, tx = JaxBM25("en"), BM25Index("en", device="cpu")
    jx.build_from_texts(texts[:40])
    tx.build_from_texts(texts[:40])
    jx.add_texts(texts[40:])
    tx.add_texts(texts[40:])
    assert tx.n == jx.n == 60 and tx.vocab == jx.vocab
    np.testing.assert_array_equal(tx.impact.numpy(), np.asarray(jx.impact))
    for a, b in zip(tx.doc_term_freqs, jx.doc_term_freqs):
        np.testing.assert_array_equal(a, b)


def test_token_index_methods_match_jax(carried):
    jb, tb = carried
    q_tok, q_mask = jb.encoder.encode_tokens(QUERIES, 64, query=True)
    cand = np.array([[0, 3, 149, 3], [7, 8, 9, 10], [1, 2, 3, 4],
                     [0, 1, 2, 3], [140, 141, 142, 143]], np.int32)
    np.testing.assert_allclose(tb.tokens.score_candidates(q_tok, q_mask, cand),
                               jb.tokens.score_candidates(q_tok, q_mask, cand),
                               atol=1e-5)
    for k in (1, 10, 40, 150):
        ws, wr = jb.tokens.topk(q_tok, q_mask, k)
        gs, gr = tb.tokens.topk(q_tok, q_mask, k)
        assert gs.shape == ws.shape
        assert_rows_up_to_ties(ws, wr, gs, gr)
    for start, stop in ((0, 10), (140, 400)):
        for g, w in zip(tb.tokens.dequantized_rows(start, stop),
                        jb.tokens.dequantized_rows(start, stop)):
            np.testing.assert_array_equal(g, w)
    assert tb.tokens.dequantized()[0].shape == (256, 64, 128)


def test_int8_token_store_methods_match_jax():
    from legalrag_tpu.index.token_index import TokenIndex as JaxTokens
    from legalrag_tpu_torch.index.token_index import TokenIndex

    rng = np.random.default_rng(3)
    tok = rng.normal(size=(40, 16, 32)).astype(np.float32)
    tok /= np.linalg.norm(tok, axis=-1, keepdims=True)
    mask = rng.random((40, 16)) > 0.3
    jt = JaxTokens(32, 16, "int8", 64)
    jt.add(tok, mask)
    tt = TokenIndex(32, 16, "int8", 64, device="cpu")
    tt.add_quantized(np.asarray(jt.tok)[:40], mask)
    for g, w in zip(tt.dequantized_rows(0, 64), jt.dequantized_rows(0, 64)):
        np.testing.assert_array_equal(g, w)
    q = rng.normal(size=(2, 8, 32)).astype(np.float32)
    qm = np.ones((2, 8), bool)
    cand = rng.integers(0, 40, (2, 6))
    np.testing.assert_allclose(tt.score_candidates(q, qm, cand),
                               jt.score_candidates(q, qm, cand), atol=1e-5)


def test_add_chunks_then_search_matches_jax(en_chunks):
    """A carried bundle of en[:100] and the JAX one both take en[90:150]
    (ten already in): the same rows, vocabulary, stores and encoder
    statistics after it, and the same BM25 and MaxSim rankings."""
    from test_torch_engine import carry

    jcfg, cfg = JaxConfig(), AppConfig()
    for c in (jcfg, cfg):
        c.engine.capacity_round = 128  # the stores grow from 128 to 256 rows
        c.engine.late_doc_maxlen = 64
    jb = JaxBundle.build_from_chunks(en_chunks[:100], jcfg, "en")
    tb = carry(jb, cfg)
    # the carried encoder owns its document frequencies
    assert tb.encoder.df is not jb.encoder.df
    assert jb.add_chunks(en_chunks[90:150]) == 50
    assert tb.add_chunks(port_chunks(en_chunks[90:150])) == 50
    assert tb.add_chunks(port_chunks(en_chunks[:3])) == 0
    assert (tb.n_docs, tb.generation, tb.dense.capacity) == \
        (jb.n_docs, jb.generation, jb.dense.capacity) == (150, 2, 256)
    assert tb.id2row == jb.id2row and tb.bm25.vocab == jb.bm25.vocab
    assert [c.id for c in tb.row_chunks([0, 149, 7])] == \
        [c.id for c in jb.row_chunks([0, 149, 7])]
    np.testing.assert_array_equal(tb.encoder.df, jb.encoder.df)
    assert tb.encoder.n_docs == jb.encoder.n_docs
    np.testing.assert_array_equal(tb.bm25.impact.numpy(),
                                  np.asarray(jb.bm25.impact))
    np.testing.assert_array_equal(tb.tokens.tok.float().numpy(),
                                  np.asarray(jb.tokens.tok, np.float32))
    # fresh rows: one bf16 ulp at most (the projection's float32 sums)
    got = tb.dense.emb.float().numpy()
    want = np.asarray(jb.dense.emb, np.float32)
    ulp = bf16_ulp(np.maximum(np.abs(got), np.abs(want)))
    assert (np.abs(got - want) <= np.maximum(ulp, 1e-6)).all()
    ws, wr = jb.bm25.topk(QUERIES, 20)
    gs, gr = tb.bm25.topk(QUERIES, 20)
    assert_rows_up_to_ties(ws, wr, gs, gr)
    q_tok, q_mask = jb.encoder.encode_tokens(QUERIES, 64, query=True)
    ws, wr = jb.tokens.topk(q_tok, q_mask, 20)
    gs, gr = tb.tokens.topk(q_tok, q_mask, 20)
    assert_rows_up_to_ties(ws, wr, gs, gr)
    q = np.asarray(jb.encoder.encode_queries(QUERIES))
    ws, wr = jb.dense.topk(q, 20)
    gs, gr = tb.dense.topk(q, 20)
    assert_rows_up_to_ties(ws, wr, gs, gr, atol=1e-4, tie=1e-4)
