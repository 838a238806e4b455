"""Doc-sharded serving (``parallel/sharded_search.py``,
``IndexBundle.shard_views``, the sharded branches of ``HybridRetriever`` and
``BundleCache``), every case of ``tests/test_sharded_serving.py``, on the
CPU.

The JAX package builds and saves one index; the port loads that directory
(the carried index) and serves it unsharded and over a mesh that names
the CPU once per shard; JAX serves it over its virtual CPU devices. Held:

- the port's sharded channel lists against its unsharded ones: rows
  exactly, scores within 1e-5 (the same ops on the same rows);
- the port's sharded lists against JAX's sharded lists on the same index:
  rows equal but where JAX's scores tie within ``TIE``, scores within
  ``ATOL`` (the port draws the hash projection in numpy, ``models/prng.py``,
  to within 2.2e-5 of JAX's);
- padding: lists past the valid rows (``NEG_INF`` scores, including a
  shard with 0 valid rows) give JAX's row ids too, and never reach the
  first ``n`` entries that serving keeps;
- the nbit4 store as JAX's own test holds it: dense rows exact, late rows
  as sets, scores within 2e-2 (the sharded copy is bf16).
"""

import json

import jax
import numpy as np
import pytest
import torch

from chip_smoke import corpus_vocab, write_bert_checkpoint
from legalrag_tpu.api.server import create_app as jax_create_app
from legalrag_tpu.api.webcore import TestClient as JaxTestClient
from legalrag_tpu.config import AppConfig as JaxConfig
from legalrag_tpu.index.bundle import IndexBundle as JaxBundle
from legalrag_tpu.parallel.mesh import make_mesh as jax_make_mesh
from legalrag_tpu.retrieval.hybrid import HybridRetriever as JaxHybrid
from legalrag_tpu_torch.api.server import create_app
from legalrag_tpu_torch.api.webcore import TestClient
from legalrag_tpu_torch.config import AppConfig
from legalrag_tpu_torch.index.bundle import IndexBundle
from legalrag_tpu_torch.parallel import mesh as mesh_mod
from legalrag_tpu_torch.parallel.mesh import make_mesh
from legalrag_tpu_torch.retrieval.hybrid import HybridRetriever
from test_torch_hybrid import assert_same_hits
from test_torch_index import port_chunks
from test_torch_server import assert_same_json

ATOL = 1e-5     # scores, port against JAX
TIE = 1e-6      # JAX scores closer than this may come in either order
QUERIES = ["买卖合同的标的物风险", "抵押权的设立", "债务人不履行到期债务"]
CPU = torch.device("cpu")
PATHS = ("data_dir", "raw_dir", "processed_dir", "index_dir", "graph_dir",
         "eval_dir", "upload_dir")


def small(cfg, root, capacity_round=64):
    cfg.llm.provider = "disabled"
    cfg.llm.api_key = None
    cfg.engine.capacity_round = capacity_round
    cfg.engine.late_doc_maxlen = 32
    cfg.server.prewarm_buckets = 0
    for name in PATHS:
        setattr(cfg.paths, name, root / name)
    cfg.paths.ensure_tree()
    return cfg


def cpu_mesh(shards: int):
    return make_mesh([CPU] * shards, data=1, model=shards)


def jax_mesh(shards: int):
    return jax_make_mesh(jax.devices("cpu")[:shards], data=1, model=shards)


def saved_index(chunks, root, capacity_round=64, token_dtype=""):
    """JAX builds and saves ``chunks``; returns (JAX config, port config,
    the zh index directory)."""
    jcfg = small(JaxConfig(), root, capacity_round)
    cfg = small(AppConfig(), root, capacity_round)
    jcfg.engine.token_dtype = cfg.engine.token_dtype = token_dtype
    d = jcfg.with_lang("zh").paths.lang_index_dir
    JaxBundle.build_from_chunks(chunks, jcfg.with_lang("zh"), "zh").save(d)
    return jcfg, cfg, d


def served_three(jcfg, cfg, d, shards):
    """(port unsharded, port sharded, JAX sharded) retrievers over ``d``."""
    plain = IndexBundle.load(d, cfg.with_lang("zh"), "zh", device="cpu")
    sharded = IndexBundle.load(d, cfg.with_lang("zh"), "zh", device="cpu")
    sharded.enable_sharding(cpu_mesh(shards))
    jb = JaxBundle.load(d, jcfg.with_lang("zh"), "zh")
    jb.enable_sharding(jax_mesh(shards))
    return (HybridRetriever(plain, cfg.with_lang("zh")),
            HybridRetriever(sharded, cfg.with_lang("zh")),
            JaxHybrid(jb, jcfg.with_lang("zh")))


def assert_lists_equal(a, b, what, tol=1e-5):
    """Port against port: rows exactly, scores within ``tol``."""
    assert set(a) == set(b), what
    for name in ("dense", "bm25", "colbert"):
        if name in a:
            np.testing.assert_array_equal(a[name][1], b[name][1],
                                          err_msg=f"{what} {name} rows")
            np.testing.assert_allclose(a[name][0], b[name][0], rtol=0,
                                       atol=tol, err_msg=f"{what} {name}")
    np.testing.assert_allclose(a["qvec"], b["qvec"], rtol=0, atol=1e-6)


def assert_lists_match_jax(got, want, what, atol=ATOL, tie=TIE):
    """Port against JAX: rows equal but where JAX's scores tie within
    ``tie`` (then the rows hold the same set), scores within ``atol``."""
    assert set(got) == set(want), what
    for name in ("dense", "bm25", "colbert"):
        if name not in want:
            continue
        gs, gi = np.asarray(got[name][0]), np.asarray(got[name][1])
        ws, wi = np.asarray(want[name][0]), np.asarray(want[name][1])
        np.testing.assert_allclose(gs, ws, rtol=0, atol=atol,
                                   err_msg=f"{what} {name} scores")
        for q in range(wi.shape[0]):
            for p in np.nonzero(gi[q] != wi[q])[0]:
                near = np.abs(ws[q] - ws[q, p]) <= tie
                assert set(gi[q][near]) == set(wi[q][near]), (what, name, q, p)


@pytest.fixture(scope="module")
def carried(zh_chunks, tmp_path_factory):
    root = tmp_path_factory.mktemp("sharded_carried")
    jcfg, cfg, d = saved_index(zh_chunks[:100], root)
    return jcfg, cfg, d


def test_sharded_channel_lists_exact(carried):
    plain, shard, jshard = served_three(*carried, shards=4)
    for q in QUERIES:
        a = plain._channels_topk_all(q, 32)
        b = shard._channels_topk_all(q, 32)
        assert "colbert" in a
        assert_lists_equal(a, b, q)
        assert_lists_match_jax(b, jshard._channels_topk_all(q, 32), q)
    views = shard.bundle.shard_views()
    assert [t.shape[0] for t in views["emb"]] == [32] * 4
    assert [t.shape[1] for t in views["impact"]] == [32] * 4


def test_sharded_full_search_parity(carried):
    plain, shard, jshard = served_three(*carried, shards=4)
    for q in QUERIES:
        h1 = plain.search(q, top_k=10)
        h2 = shard.search(q, top_k=10)
        assert [h.chunk.id for h in h1] == [h.chunk.id for h in h2]
        np.testing.assert_allclose([h.score for h in h1],
                                   [h.score for h in h2], rtol=0, atol=1e-6)
        assert [h.score_breakdown.get("channels")
                or [h.score_breakdown.get("channel")] for h in h1] == \
               [h.score_breakdown.get("channels")
                or [h.score_breakdown.get("channel")] for h in h2]
        assert_same_hits(h2, jshard.search(q, top_k=10))


def test_sharded_views_refresh_on_ingest(carried, zh_chunks):
    """An append after ``enable_sharding`` moves the state's (generation,
    n): the views are rebuilt, the added docs are served, and the lists
    equal an unsharded bundle's after the same append and JAX's sharded
    bundle's after its own."""
    plain, shard, jshard = served_three(*carried, shards=4)
    extra = zh_chunks[100:110]
    before = shard.bundle.shard_views()
    n0 = shard.bundle.n_docs
    for r in (plain, shard):
        assert r.bundle.add_chunks(port_chunks(extra)) == len(extra)
    jshard.bundle.add_chunks(extra)
    assert shard.bundle.n_docs == n0 + len(extra)
    assert shard.bundle.shard_views() is not before
    q = extra[0].text[:40]
    b = shard._channels_topk_all(q, 16)
    assert any(r >= n0 for r in b["dense"][1][0].tolist())
    assert_lists_equal(plain._channels_topk_all(q, 16), b, "after ingest")
    assert_lists_match_jax(b, jshard._channels_topk_all(q, 16), "ingest")


def test_sharded_views_of_an_older_state_are_not_kept(carried, zh_chunks):
    """A call still holding the state from before an ingest gets that
    state's own views, and the newer state's views stay cached."""
    _, cfg, d = carried
    bundle = IndexBundle.load(d, cfg.with_lang("zh"), "zh", device="cpu")
    bundle.enable_sharding(cpu_mesh(4))
    old_state = bundle.state
    before = bundle.shard_views()
    bundle.add_chunks(port_chunks(zh_chunks[100:110]))
    after = bundle.shard_views()
    old = bundle.shard_views(old_state)
    assert old is not after and old is not before
    for name in ("emb", "impact", "tok", "mask"):
        for a, b in zip(old[name], before[name]):
            assert torch.equal(a, b), name
    assert bundle.shard_views() is after


def test_sharded_through_http_api(zh_chunks, tmp_path_factory, monkeypatch):
    """``/rag/retrieve`` with ``n_index_shards: -1`` (every visible device;
    here four entries of the CPU) answers as the one-device server and as
    JAX's 4-shard server, over one saved index."""
    root = tmp_path_factory.mktemp("sharded_http")
    jcfg, cfg, _ = saved_index(zh_chunks[:100], root)
    monkeypatch.setattr(mesh_mod, "local_devices",
                        lambda platform=None: [CPU] * 4)
    responses = {}
    for shards in (1, -1):
        cfg.engine.n_index_shards = shards
        app = create_app(cfg, build_async=False, device="cpu")
        assert app.state.error is None
        r = TestClient(app).post("/rag/retrieve", json_body={
            "question": QUERIES[0], "top_k": 8})
        assert r.status == 200
        responses[shards] = r.json()
        mesh = app.state.pipeline.retriever.cache.get("zh").mesh
        assert (mesh is None) == (shards == 1)
        if mesh is not None:
            assert mesh.shape == {"data": 1, "model": 4}
    jcfg.engine.n_index_shards = 4
    jr = JaxTestClient(jax_create_app(jcfg, build_async=False)).post(
        "/rag/retrieve", json_body={"question": QUERIES[0], "top_k": 8})
    h1, h4 = responses[1]["hits"], responses[-1]["hits"]
    assert [h["chunk"]["id"] for h in h1] == [h["chunk"]["id"] for h in h4]
    np.testing.assert_allclose([h["score"] for h in h1],
                               [h["score"] for h in h4], rtol=0, atol=1e-6)
    assert_same_json(h4, jr.json()["hits"])


@pytest.mark.parametrize("n_docs,shards,eff_k", [
    (37, 4, 16),    # n % shards != 0: capacity padding in play
    (5, 4, 32),     # near-single-doc shards, eff_k > n_docs, a shard of 0
    (100, 8, 64),   # eff_k > n_local
    (101, 4, 8),    # odd size, small k
    (60, 1, 16),    # one shard
    (60, 2, 32),
    (61, 3, 16),    # a shard count that splits no power of two
])
def test_sharded_geometry_matrix(zh_chunks, tmp_path_factory, n_docs, shards,
                                 eff_k):
    """Awkward geometry on one device: the real rows equal the unsharded
    lists'; every entry (the padding's NEG_INF rows too) equals JAX's
    sharded lists'."""
    root = tmp_path_factory.mktemp(f"geo{n_docs}x{shards}")
    jcfg, cfg, d = saved_index(zh_chunks[:n_docs], root, capacity_round=8)
    plain, shard, jshard = served_three(jcfg, cfg, d, shards)
    for q in QUERIES[:2]:
        a = plain._channels_topk_all(q, eff_k)
        b = shard._channels_topk_all(q, eff_k)
        w = jshard._channels_topk_all(q, eff_k)
        assert set(a) == set(b) == set(w)
        for name in ("dense", "bm25", "colbert"):
            sa, ia = np.asarray(a[name][0]), np.asarray(a[name][1])
            sb, ib = np.asarray(b[name][0]), np.asarray(b[name][1])
            real = sa > -1e29
            np.testing.assert_array_equal(real, sb > -1e29)
            np.testing.assert_array_equal(ia[real], ib[real])
            np.testing.assert_allclose(sa[real], sb[real], rtol=0, atol=1e-5)
            ws = np.asarray(w[name][0])
            np.testing.assert_array_equal(ws > -1e29, sb > -1e29)
            np.testing.assert_array_equal(ib[~real],
                                          np.asarray(w[name][1])[~real])
        assert_lists_match_jax(b, w, f"{q} x{shards}")
        assert (np.asarray(b["dense"][1]) < shard.bundle.dense.capacity).all()
    # the served lists (the first n entries) hold only real rows
    out = shard.search(QUERIES[0], top_k=10)
    assert len(out) == min(10, n_docs)


def test_sharded_bert_is_one_call_and_exact(en_chunks, tmp_path_factory):
    """A bert bundle sharded: the query forward and every shard's channels
    in one call (the two-call entry points poisoned), lists equal to the
    unsharded engine's and, within the bert backend's tolerance (1e-4; the
    packages encode apart), to JAX's sharded engine's over the port's
    save."""
    root = tmp_path_factory.mktemp("sharded_bert")
    chunks = en_chunks[:80]
    vocab = corpus_vocab(c.text for c in chunks)
    ckpt = write_bert_checkpoint(root / "ckpt", vocab, 0, layer_scale=8.0,
                                 vocab_size=len(vocab), hidden_size=32,
                                 num_hidden_layers=2, num_attention_heads=2,
                                 intermediate_size=64,
                                 max_position_embeddings=64)

    def configure(c):
        small(c, root)
        c.retrieval.embedding_backend = "bert"
        c.retrieval.embedding_model_en = str(ckpt)
        c.engine.late_dim = 16
        c.engine.max_query_tokens = 16
        return c

    cfg, jcfg = configure(AppConfig()), configure(JaxConfig())
    d = root / "index_dir" / "en"
    IndexBundle.build_from_chunks(port_chunks(chunks), cfg.with_lang("en"),
                                  "en", device="cpu").save(d)
    plain = HybridRetriever(IndexBundle.load(d, cfg.with_lang("en"), "en",
                                             device="cpu"), cfg)
    sb = IndexBundle.load(d, cfg.with_lang("en"), "en", device="cpu")
    sb.enable_sharding(cpu_mesh(4))
    shard = HybridRetriever(sb, cfg)

    def boom(*a, **k):  # pragma: no cover
        raise AssertionError("sharded+bert took the two-call path")

    sb.encoder.encode_query_bundle = boom
    sb.encoder.encode_queries = boom
    jb = JaxBundle.load(d, jcfg.with_lang("en"), "en")
    jb.enable_sharding(jax_mesh(4))
    jshard = JaxHybrid(jb, jcfg)
    q = "security interest attaches when value is given"
    a = plain._channels_topk_all(q, 16)
    b = shard._channels_topk_all(q, 16)
    assert list(shard._bert_sharded) == [(sb.mesh, 16, True)]
    assert_lists_equal(a, b, "bert")
    w = jshard._channels_topk_all(q, 16)
    np.testing.assert_allclose(b["qvec"], w["qvec"], rtol=0, atol=1e-5)
    assert_lists_match_jax(b, w, "bert vs JAX", atol=1e-4, tie=1e-4)
    h1, h2 = plain.search(q, top_k=8), shard.search(q, top_k=8)
    assert [h.chunk.id for h in h1] == [h.chunk.id for h in h2]
    np.testing.assert_allclose([h.score for h in h1],
                               [h.score for h in h2], rtol=0, atol=1e-6)


def test_sharded_nbit4_store(zh_chunks, tmp_path_factory):
    """The nbit4 store shards by per-slice host reconstruction into bf16
    (never the whole store at once) and agrees with the unsharded engine's
    in-kernel dequantization as JAX's own test holds it, and with JAX's
    sharded nbit4 engine."""
    root = tmp_path_factory.mktemp("sharded_n4")
    jcfg, cfg, d = saved_index(zh_chunks[:100], root, token_dtype="nbit4")
    plain, shard, jshard = served_three(jcfg, cfg, d, shards=4)
    rows_asked = []
    tokens = shard.bundle.tokens
    orig = tokens.dequantized_rows

    def spy(start, stop):
        rows_asked.append((start, stop))
        return orig(start, stop)

    tokens.dequantized_rows = spy
    views = shard.bundle.shard_views()
    assert rows_asked == [(0, 32), (32, 64), (64, 96), (96, 128)]
    assert views["tok"][0].dtype == torch.bfloat16
    assert views["q_dtype"] == torch.bfloat16
    for q in QUERIES:
        a = plain._channels_topk_all(q, 16)
        b = shard._channels_topk_all(q, 16)
        w = jshard._channels_topk_all(q, 16)
        for other in (a, w):
            ids_a = np.asarray(other["colbert"][1]).ravel().tolist()
            ids_b = np.asarray(b["colbert"][1]).ravel().tolist()
            assert len(set(ids_a) & set(ids_b)) >= 15
            np.testing.assert_allclose(
                np.sort(np.asarray(other["colbert"][0]).ravel()),
                np.sort(np.asarray(b["colbert"][0]).ravel()), atol=2e-2)
        np.testing.assert_array_equal(a["dense"][1], b["dense"][1])
        assert_lists_match_jax({k: b[k] for k in ("dense", "bm25", "qvec")},
                               {k: w[k] for k in ("dense", "bm25", "qvec")},
                               q)
