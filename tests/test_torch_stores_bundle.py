"""Bundles of the quantized configurations on the real corpora, port
against the JAX package: Q8 (``EngineConfig(dtype="int8")``: the unit-int8
dense store and an int8 token store) and N4 (``token_dtype="nbit4"``) at
the small config of ``tests/test_token_nbit4.py:103-111`` (the first 150
chunks, capacity 256, doc_maxlen 64). JAX builds each bundle; its arrays
go to the port through ``convert`` with the quantized payloads as they are.

Tolerances: int8 and nbit4 payloads equal; bf16 rows equal, or within one
bf16 step where each package encoded them itself; the BM25 impact within
1e-6; fused scores within 1e-4 and rows equal but for JAX scores that tie
within 1e-5 (``assert_same_ranking``, at most one such swap); channel
lists' rows equal, scores within 1e-5."""

import tempfile

import numpy as np
import pytest
import torch

from legalrag_tpu.config import AppConfig as JaxConfig
from legalrag_tpu.index.bundle import IndexBundle as JaxBundle
from legalrag_tpu.index.token_index import Residual4TokenIndex as JaxR4
from legalrag_tpu.retrieval.engine import FusedQueryEngine as JaxEngine
from legalrag_tpu.retrieval.hybrid import HybridRetriever as JaxHybrid
from legalrag_tpu_torch.config import AppConfig
from legalrag_tpu_torch.convert import bundle_from_arrays
from legalrag_tpu_torch.index.bundle import IndexBundle
from legalrag_tpu_torch.index.token_index import Residual4TokenIndex
from legalrag_tpu_torch.retrieval.engine import FusedQueryEngine
from legalrag_tpu_torch.retrieval.hybrid import HybridRetriever
from legalrag_tpu_torch.schemas import LawChunk
from scripts.parity_gate import make_queries, recall_mrr
from test_torch_engine import assert_same_ranking, sample_queries

STORES = {"q8": {"dtype": "int8"}, "n4": {"token_dtype": "nbit4"}}


def small_configs(store):
    """The small config of ``tests/test_token_nbit4.py:103-111`` with the
    store's engine overrides, for both packages."""
    jcfg, cfg = JaxConfig(), AppConfig()
    for c in (jcfg, cfg):
        c.engine.capacity_round = 256
        c.engine.late_doc_maxlen = 64
        for key, value in STORES[store].items():
            setattr(c.engine, key, value)
    return jcfg, cfg


def carry_stores(jb, cfg):
    """The JAX bundle's state as numpy arrays, its quantized stores as
    they are (int8 codes, nbit4 codes and codebook) -> a port bundle on the
    CPU."""
    enc = jb.encoder
    with tempfile.TemporaryDirectory() as d:
        jb.bm25.save(d + "/bm25.npz")
        z = dict(np.load(d + "/bm25.npz"))
    arrays = {
        "encoder": enc.state(), "proj": np.asarray(enc._projection()),
        "emb": np.asarray(jb.dense.emb), "n": jb.dense.n,
        "impact": np.asarray(jb.bm25.impact), "mask": np.asarray(
            jb.tokens.mask), "flat_ids": z["flat_ids"],
        "flat_tfs": z["flat_tfs"], "offsets": z["offsets"],
        "bm25_params": z["params"]}
    if isinstance(jb.tokens, JaxR4):
        arrays |= {"codes_c": np.asarray(jb.tokens.codes_c),
                   "packed": np.asarray(jb.tokens.packed),
                   "centroids": jb.tokens.centroids,
                   "scales": jb.tokens.scales}
    else:
        arrays["tok"] = np.asarray(jb.tokens.tok)
    if arrays["emb"].dtype != np.int8:
        arrays["emb"] = arrays["emb"].astype(np.float32)
    chunks = [LawChunk.from_json(c.model_dump_json(exclude_none=True))
              for c in jb.chunks]
    return bundle_from_arrays(arrays, chunks, dict(jb.bm25.vocab), cfg, "cpu")


def assert_same_stores(tb, jb, encoded_apart=False):
    """The port bundle's stores hold the JAX bundle's values: int8 and
    nbit4 payloads exactly, the BM25 impact within 1e-6, bf16 rows exactly,
    or, for rows each package encoded itself (``encoded_apart``: float32
    projections summed in another order), within one bf16 step (at most
    2^-7 relative)."""
    n = jb.dense.n
    assert tb.dense.n == n and tb.dense.capacity == jb.dense.capacity
    got = tb.dense.emb[:n].float().numpy()
    want = np.asarray(jb.dense.emb[:n], np.float32)
    if encoded_apart and tb.dense.dtype == torch.bfloat16:
        np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=1e-7)
    else:
        np.testing.assert_array_equal(got, want)
    assert tb.tokens.n == jb.tokens.n
    if isinstance(jb.tokens, JaxR4):
        assert isinstance(tb.tokens, Residual4TokenIndex)
        np.testing.assert_array_equal(tb.tokens.centroids, jb.tokens.centroids)
        np.testing.assert_array_equal(tb.tokens.scales, jb.tokens.scales)
        names = ("codes_c", "packed", "mask")
    else:
        names = ("tok", "mask")
    for name in names:
        np.testing.assert_array_equal(
            getattr(tb.tokens, name)[:n].float().numpy(),
            np.asarray(getattr(jb.tokens, name)[:n], np.float32))
    np.testing.assert_allclose(tb.bm25.impact.numpy(),
                               np.asarray(jb.bm25.impact), atol=1e-6)


@pytest.fixture(scope="module")
def bundles(zh_chunks, en_chunks):
    """{(store, lang): (JAX bundle, JAX config, port config)} over the
    first 150 chunks of each corpus; the port bundles are carried per
    test."""
    out = {}
    for store in STORES:
        for lang, chunks in (("zh", zh_chunks), ("en", en_chunks)):
            jcfg, cfg = small_configs(store)
            jb = JaxBundle.build_from_chunks(chunks[:150],
                                             jcfg.with_lang(lang), lang)
            out[store, lang] = (jb, jcfg, cfg)
    return out


@pytest.mark.parametrize("lang", ["zh", "en"])
@pytest.mark.parametrize("store", list(STORES))
def test_store_bundles_serve_as_jax(bundles, store, lang):
    """A JAX Q8 / N4 bundle carried to the port (trap: the int8 codes and
    the nbit4 store go over as they are, never quantized again): equal
    stores; ``FusedQueryEngine`` top-10 rows equal to JAX's and the packed
    components within 1e-4; ``HybridRetriever``'s channel lists (dense,
    BM25, late) equal to JAX's."""
    jb, jcfg, cfg = bundles[store, lang]
    if store == "q8":
        assert np.asarray(jb.dense.emb).dtype == np.int8
    tb = carry_stores(jb, cfg)
    assert_same_stores(tb, jb)
    queries = sample_queries(jb.chunks, 16, seed=1)
    jeng = JaxEngine(jb, jcfg.with_lang(lang))
    teng = FusedQueryEngine(tb, cfg.with_lang(lang))
    ws, wr, wc = jeng.search_batch(queries, 10)
    gs, gr, gc = teng.search_batch(queries, 10)
    assert assert_same_ranking(ws, wr, gs, gr) <= 1
    same = wr == gr
    for name in wc:
        np.testing.assert_allclose(gc[name][same], wc[name][same], atol=1e-4)
    jhr = JaxHybrid(jb, jcfg.with_lang(lang))
    thr = HybridRetriever(tb, cfg.with_lang(lang))
    for q in queries[:4]:
        want = jhr._channels_topk_all(q, 40)
        got = thr._channels_topk_all(q, 40)
        for name in ("dense", "bm25", "colbert"):
            np.testing.assert_array_equal(got[name][1], want[name][1])
            np.testing.assert_allclose(got[name][0], want[name][0],
                                       atol=1e-5)


@pytest.mark.parametrize("store", list(STORES))
def test_store_bundle_append_and_files_match_jax(zh_chunks, tmp_path,
                                                 store):
    """One ``add_chunks`` append (50 new zh chunks: Q8 quantizes them, N4
    encodes them with the codebook trained at the first add) leaves the
    carried port bundle's stores equal to the JAX bundle's; each package
    then loads the other's saved bundle with the same stores."""
    jcfg, cfg = small_configs(store)
    jb = JaxBundle.build_from_chunks(zh_chunks[:150], jcfg.with_lang("zh"),
                                     "zh")
    tb = carry_stores(jb, cfg)
    more = zh_chunks[150:200]
    assert jb.add_chunks(more) == 50
    assert tb.add_chunks([LawChunk.from_json(c.model_dump_json(
        exclude_none=True)) for c in more]) == 50
    assert_same_stores(tb, jb, encoded_apart=True)
    tb.save(tmp_path / "port")
    jb.save(tmp_path / "jax")
    for d in ("jax", "port"):   # each package loads either's files alike
        assert_same_stores(
            IndexBundle.load(tmp_path / d, cfg.with_lang("zh"), "zh",
                             device="cpu"),
            JaxBundle.load(tmp_path / d, jcfg.with_lang("zh"), "zh"))


def test_nbit4_recall_within_two_points_of_bf16(zh_chunks):
    """The port's own bundles (built by ``build_from_chunks`` on the CPU):
    N4's fused Recall@10 stays within 0.02 of the bf16 store's, the bound
    of ``tests/test_token_nbit4.py:126-150``."""
    chunks = [LawChunk.from_json(c.model_dump_json(exclude_none=True))
              for c in zh_chunks[:150]]
    r, queries = {}, None
    for name in ("bf16", "nbit4"):
        cfg = AppConfig()
        cfg.engine.capacity_round = 256
        cfg.engine.late_doc_maxlen = 64
        if name == "nbit4":
            cfg.engine.token_dtype = "nbit4"
        b = IndexBundle.build_from_chunks(chunks, cfg.with_lang("zh"), "zh",
                                          device="cpu")
        if queries is None:
            queries, gold = make_queries(b, 60)
        rows = [x[:10].tolist() for x in FusedQueryEngine(
            b, cfg.with_lang("zh")).search_batch(queries, 10)[1]]
        r[name], _ = recall_mrr(rows, gold, 10)
    assert r["nbit4"] >= r["bf16"] - 0.02, r


def test_bundle_load_keeps_a_float_token_payload_in_engine_dtype(
        en_chunks, tmp_path):
    """As JAX's ``IndexBundle.load`` (``bundle.py:313-314``): a float16
    token payload loads in ``engine.dtype`` even when ``token_dtype`` asks
    for int8 (an int8 or nbit4 payload keeps its own form)."""
    jcfg, cfg = JaxConfig(), AppConfig()
    for c in (jcfg, cfg):
        c.engine.capacity_round = 256
        c.engine.late_doc_maxlen = 64
    chunks = [LawChunk.from_json(c.model_dump_json(exclude_none=True))
              for c in en_chunks[:40]]
    IndexBundle.build_from_chunks(chunks, cfg.with_lang("en"), "en",
                                  device="cpu").save(tmp_path)
    for c in (jcfg, cfg):
        c.engine.token_dtype = "int8"
    got = IndexBundle.load(tmp_path, cfg.with_lang("en"), "en", device="cpu")
    want = JaxBundle.load(tmp_path, jcfg.with_lang("en"), "en")
    assert got.tokens.dtype == torch.bfloat16
    assert str(want.tokens.dtype) == "bfloat16"
    np.testing.assert_array_equal(
        got.tokens.tok[:40].float().numpy(),
        np.asarray(want.tokens.tok[:40], np.float32))
