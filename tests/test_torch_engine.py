"""Port FusedQueryEngine vs the JAX engine on one carried index: the JAX
bundle's arrays and encoder go to the port through ``convert``, both
engines answer the same queries, and their top-10 rows, packed components
and hits must agree."""

import re
import tempfile

import numpy as np
import pytest

from legalrag_tpu.config import AppConfig as JaxConfig
from legalrag_tpu.index.bundle import IndexBundle as JaxBundle
from legalrag_tpu.retrieval.engine import FusedQueryEngine as JaxEngine
from legalrag_tpu_torch.config import AppConfig
from legalrag_tpu_torch.convert import bundle_from_arrays
from legalrag_tpu_torch.retrieval.engine import FusedQueryEngine, bucket_batch
from legalrag_tpu_torch.schemas import LawChunk

QUERIES = ["buyer in ordinary course of business",
           "security interest attaches when value is given",
           "negotiable instrument payable to bearer"]
TIE = 1e-5  # adjacent fused scores closer than this may swap


def carry(jb, cfg):
    """The JAX bundle's state as numpy arrays -> a port bundle on the CPU."""
    enc = jb.encoder
    with tempfile.TemporaryDirectory() as d:
        jb.bm25.save(d + "/bm25.npz")
        z = dict(np.load(d + "/bm25.npz"))
    arrays = {
        "encoder": enc.state(), "proj": np.asarray(enc._projection()),
        "emb": np.asarray(jb.dense.emb, np.float32), "n": jb.dense.n,
        "impact": np.asarray(jb.bm25.impact),
        "tok": np.asarray(jb.tokens.tok, np.float32),
        "mask": np.asarray(jb.tokens.mask),
        "flat_ids": z["flat_ids"], "flat_tfs": z["flat_tfs"],
        "offsets": z["offsets"], "bm25_params": z["params"]}
    chunks = [LawChunk.from_json(c.model_dump_json(exclude_none=True))
              for c in jb.chunks]
    return bundle_from_arrays(arrays, chunks, dict(jb.bm25.vocab), cfg, "cpu")


def sample_queries(chunks, n, seed=0):
    """Sentence-sampled self-retrieval queries (bench.py's make_queries)."""
    rng = np.random.default_rng(seed)
    out = []
    for row in rng.permutation(len(chunks)):
        sents = [s for s in re.split(r"[。；！? .;!?\n]", chunks[int(row)].text)
                 if 8 <= len(s) <= 80]
        if sents:
            out.append(sents[rng.integers(len(sents))])
        if len(out) >= n:
            break
    return out


def assert_same_ranking(want_s, want_r, got_s, got_r):
    """Rows identical, except where the JAX engine's own fused scores tie
    within TIE: such rows may swap (the float32 sums run in another order).
    Returns the number of swaps accepted."""
    np.testing.assert_allclose(got_s, want_s, atol=1e-4)
    swaps = 0
    for q in range(want_r.shape[0]):
        for p in np.nonzero(want_r[q] != got_r[q])[0]:
            # the port's row at p sits in the JAX list within a tie group of
            # p, or past its end with a score tied to position p
            where = np.nonzero(want_r[q] == got_r[q, p])[0]
            ref = want_s[q, where[0]] if len(where) else got_s[q, p]
            assert abs(ref - want_s[q, p]) < TIE, (q, p, want_r[q], got_r[q])
            swaps += 1
    return swaps


def compare(jeng, teng, queries, top_k=10):
    ws, wr, wc = jeng.search_batch(queries, top_k)
    gs, gr, gc = teng.search_batch(queries, top_k)
    assert gr.shape == wr.shape and gs.shape == ws.shape
    swaps = assert_same_ranking(ws, wr, gs, gr)
    assert set(gc) == set(wc) == {"dense", "bm25", "rrf_norm",
                                  "weighted_sum", "colbert"}
    same = wr == gr
    for name in wc:
        np.testing.assert_allclose(gc[name][same], wc[name][same], atol=1e-4)
    return swaps


# ------------------------------------------------- the small configuration

@pytest.fixture(scope="module")
def small(en_chunks):
    jcfg = JaxConfig()
    jcfg.engine.capacity_round = 256
    jcfg.engine.late_doc_maxlen = 64
    jb = JaxBundle.build_from_chunks(en_chunks[:200], jcfg, "en")
    cfg = AppConfig()
    cfg.engine.capacity_round = 256
    cfg.engine.late_doc_maxlen = 64
    return JaxEngine(jb, jcfg), FusedQueryEngine(carry(jb, cfg), cfg)


def test_small_config_top10_and_components(small):
    jeng, teng = small
    queries = QUERIES + sample_queries(jeng.bundle.chunks, 13)
    swaps = compare(jeng, teng, queries)
    assert swaps <= 2


def test_small_config_params_match(small):
    jeng, teng = small
    for k in (1, 5, 10, 40):
        jp, tp = jeng._params(k), teng._params(k)
        assert (tp.eff_k, tp.final_k) == (jp.eff_k, jp.final_k)
        assert (tp.rrf_k, tp.alpha, tp.w_dense, tp.w_bm25, tp.w_late) == \
            (jp.rrf_k, jp.alpha, jp.w_dense, jp.w_bm25, jp.w_late)


def test_search_hits_fields_equal(small):
    jeng, teng = small
    want = jeng.search_hits(QUERIES, top_k=5)
    got = teng.search_hits(QUERIES, top_k=5)
    assert len(got) == len(want)
    for hs_w, hs_g in zip(want, got):
        assert [h.chunk.id for h in hs_g] == [h.chunk.id for h in hs_w]
        for hw, hg in zip(hs_w, hs_g):
            assert (hg.rank, hg.source) == (hw.rank, hw.source)
            assert hg.chunk.to_json() == hw.chunk.model_dump_json(
                exclude_none=True)
            np.testing.assert_allclose(hg.score, hw.score, atol=1e-4)
            np.testing.assert_allclose(hg.semantic_score, hw.semantic_score,
                                       atol=1e-4)
            bw, bg = hw.score_breakdown, hg.score_breakdown
            assert bg["fusion_method"] == bw["fusion_method"]
            assert set(bg["per_channel"]) == set(bw["per_channel"])
            for name in bw["per_channel"]:
                np.testing.assert_allclose(bg["per_channel"][name]["score"],
                                           bw["per_channel"][name]["score"],
                                           atol=1e-4)


def test_batch_bucketing():
    assert bucket_batch(1) == 1
    assert bucket_batch(3) == 4
    assert bucket_batch(64) == 64
    assert bucket_batch(200) == 200


def test_padded_batch_matches_single(small):
    _jeng, teng = small
    s1, r1, _ = teng.search_batch([QUERIES[0]], 5)
    s3, r3, _ = teng.search_batch(QUERIES, 5)  # padded to bucket 4
    assert (r1[0] == r3[0]).all()
    np.testing.assert_allclose(s1[0], s3[0], atol=1e-5)


# ------------------------------------------- full width: zh Civil Code

def test_full_width_zh_top10(zh_chunks):
    """d=768, sketch 16384, token_dim 128, doc_maxlen 220, Lq 64, 8 queries."""
    jcfg = JaxConfig()
    jb = JaxBundle.build_from_chunks(zh_chunks, jcfg, "zh")
    cfg = AppConfig()
    tb = carry(jb, cfg)
    assert tb.dense.capacity == 2048 and tb.bm25.impact.shape[1] == 1280
    jeng, teng = JaxEngine(jb, jcfg), FusedQueryEngine(tb, cfg)
    queries = sample_queries(jb.chunks, 8)
    swaps = compare(jeng, teng, queries)
    assert swaps <= 2
