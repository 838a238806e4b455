"""Bert bundles, port against the JAX package, on the first 150 chunks of
each corpus with tiny random-init checkpoints (hidden 32, 2 layers, 64
positions; the layers' weights at 8x random init's scale, or every text
gets nearly the same CLS vector and min-max fusion scales float32's last
bits past the checks; a WordPiece vocabulary of each corpus's words;
written by ``chip_smoke.write_bert_checkpoint``) and a BERT-style
cross-encoder:

- a bert bundle built and saved by either package loads in the other
  (``embedding_backend: "bert"`` in the manifest, no ``encoder.npz``, the
  encoder from the config), with the stores the saver wrote;
- ``FusedQueryEngine.search_batch`` over one carried index: top-10 rows
  equal to JAX's but for JAX scores that tie within 1e-5
  (``assert_same_ranking``), components within 1e-4;
- ``HybridRetriever``'s batched channels: the query vector within 1e-5,
  rows equal but for JAX scores that tie within 1e-5, scores within
  1e-4; ``RerankerFactory`` picks the cross-encoder or MaxSim as JAX
  does and scores within 1e-4; ``search`` with the cross-encoder gives
  JAX's hits (scores within 1e-4);
- ``add_chunks`` on a bert bundle keeps its encoder and serves JAX's
  appended search; the build CLI builds bert bundles from the config.

Rows encoded apart by the two packages are compared within one bf16 step
plus 1e-6 (the stores round float32 embeddings that differ in the last
bits). Scores of a query each package encoded itself are compared within
1e-4: the score+select and MaxSim routes round the query to bf16, where a
last-bit difference can flip a component's rounding (2^-9 of it)."""

import json

import numpy as np
import pytest

from chip_smoke import corpus_vocab, write_bert_checkpoint
from legalrag_tpu.config import AppConfig as JaxConfig
from legalrag_tpu.index.bundle import IndexBundle as JaxBundle
from legalrag_tpu.retrieval.engine import FusedQueryEngine as JaxEngine
from legalrag_tpu.retrieval.hybrid import HybridRetriever as JaxHybrid
from legalrag_tpu.retrieval.rerankers import RerankerFactory as JaxFactory
from legalrag_tpu_torch.cli import build_index
from legalrag_tpu_torch.config import AppConfig
from legalrag_tpu_torch.corpus.loader import write_chunks_jsonl
from legalrag_tpu_torch.index.bundle import IndexBundle
from legalrag_tpu_torch.models.bert import TorchBertEncoder
from legalrag_tpu_torch.retrieval.engine import FusedQueryEngine
from legalrag_tpu_torch.retrieval.hybrid import HybridRetriever
from legalrag_tpu_torch.retrieval.rerankers import (
    CrossEncoderReranker,
    MaxSimReranker,
    RerankerFactory,
)
from test_torch_engine import (
    TIE,
    assert_same_ranking,
    compare,
    sample_queries,
)
from test_torch_index import bf16_ulp, port_chunks

TINY = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
            intermediate_size=64, max_position_embeddings=64)
N_CHUNKS = 150


def assert_close_hits(got, want):
    """Hit lists of the same chunks in the same order, but for JAX scores
    that tie within ``TIE``; scores and the rerank fields within 1e-4."""
    assert len(got) == len(want)
    by_id = {h.chunk.id: h for h in want}
    for p, (g, w) in enumerate(zip(got, want)):
        ref = by_id[g.chunk.id]
        if ref is not w:
            assert abs(ref.score - w.score) < TIE, p
        assert abs(g.score - ref.score) <= 1e-4
        for key in ("rerank_raw", "rerank_norm", "fused"):
            if key in (ref.score_breakdown or {}):
                assert abs(g.score_breakdown[key]
                           - ref.score_breakdown[key]) <= 1e-4, key


def configure(c, ckpts, reranker):
    c.retrieval.embedding_backend = "bert"
    c.retrieval.embedding_model_zh = str(ckpts["zh"])
    c.retrieval.embedding_model_en = str(ckpts["en"])
    c.retrieval.reranker_model = str(reranker)
    c.engine.capacity_round = 256
    c.engine.late_dim = 16
    c.engine.late_doc_maxlen = 32
    c.engine.max_query_tokens = 16
    return c


@pytest.fixture(scope="module")
def setup(tmp_path_factory, zh_chunks, en_chunks):
    """Checkpoints, both configs, and each language's bundle built by JAX
    and by the port (on the CPU), saved under ``jax/<lang>`` and
    ``port/<lang>``."""
    root = tmp_path_factory.mktemp("bert_backend")
    chunks = {"zh": zh_chunks[:N_CHUNKS], "en": en_chunks[:N_CHUNKS]}
    ckpts = {}
    for seed, (lang, cs) in enumerate(chunks.items()):
        vocab = corpus_vocab(c.text for c in cs)
        ckpts[lang] = write_bert_checkpoint(
            root / f"ckpt_{lang}", vocab, seed, layer_scale=8.0,
            vocab_size=len(vocab), **TINY)
    vocab = corpus_vocab(c.text for cs in chunks.values() for c in cs)
    ce = write_bert_checkpoint(root / "ce", vocab, 9, head=True,
                               layer_scale=8.0, vocab_size=len(vocab), **TINY)
    cfg = configure(AppConfig(), ckpts, ce)
    jcfg = configure(JaxConfig(), ckpts, ce)
    built = {}
    for lang, cs in chunks.items():
        jb = JaxBundle.build_from_chunks(cs, jcfg.with_lang(lang), lang)
        tb = IndexBundle.build_from_chunks(port_chunks(cs), cfg.with_lang(lang),
                                           lang, device="cpu")
        jb.save(root / "jax" / lang)
        tb.save(root / "port" / lang)
        built[lang] = (jb, tb)
    return {"root": root, "chunks": chunks, "cfg": cfg, "jcfg": jcfg,
            "ce": ce, "built": built}


def assert_same_stores(tb, jb, encoded_apart=False):
    n = jb.dense.n
    assert tb.dense.n == n and tb.tokens.n == jb.tokens.n == n
    pairs = [(tb.dense.emb[:n].float().numpy(), np.asarray(jb.dense.emb[:n],
                                                          np.float32)),
             (tb.tokens.tok[:n].float().numpy(),
              np.asarray(jb.tokens.tok[:n], np.float32))]
    for got, want in pairs:
        if encoded_apart:
            # float32 encodings apart differ in the last bits: one bf16
            # step, or 1e-6 near zero, where the step is finer
            assert (np.abs(got - want) <= bf16_ulp(want) + 1e-6).all()
        else:
            np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tb.tokens.mask[:n].numpy(),
                                  np.asarray(jb.tokens.mask[:n]))
    np.testing.assert_allclose(tb.bm25.impact.numpy(),
                               np.asarray(jb.bm25.impact), atol=1e-6)


@pytest.mark.parametrize("lang", ["zh", "en"])
def test_bert_bundles_cross_load(setup, lang):
    """Either package's saved bert bundle loads in the other with the same
    stores; the port's build (the encoder's dims over the config's 768)
    gives JAX's stores within a bf16 step."""
    root, cfg, jcfg = setup["root"], setup["cfg"], setup["jcfg"]
    jb, tb = setup["built"][lang]
    assert tb.dense.dim == 32 and tb.tokens.token_dim == 16
    assert isinstance(tb.encoder, TorchBertEncoder)
    assert_same_stores(tb, jb, encoded_apart=True)
    for d in ("jax", "port"):
        manifest = json.loads((root / d / lang / "manifest.json").read_text())
        assert manifest["embedding_backend"] == "bert"
        assert manifest["dim"] == 32 and manifest["token_dim"] == 16
        assert not (root / d / lang / "encoder.npz").exists()
        loaded = IndexBundle.load(root / d / lang, cfg.with_lang(lang), lang,
                                  device="cpu")
        assert isinstance(loaded.encoder, TorchBertEncoder)
        assert loaded.encoder.instruction == getattr(
            cfg.retrieval, f"query_instruction_{lang}")
        assert_same_stores(loaded, JaxBundle.load(root / d / lang,
                                                  jcfg.with_lang(lang), lang))
        assert [c.id for c in loaded.chunks] == [c.id for c in jb.chunks]


@pytest.mark.parametrize("lang", ["zh", "en"])
def test_engine_top10_matches_jax(setup, lang):
    """``search_batch`` over the JAX-built bundle loaded by both packages:
    the port encodes the queries itself (prepare: the tokenized ids on the
    device; execute: the encoder, then the fused query)."""
    root, cfg, jcfg = setup["root"], setup["cfg"], setup["jcfg"]
    d = root / "jax" / lang
    jeng = JaxEngine(JaxBundle.load(d, jcfg.with_lang(lang), lang),
                     jcfg.with_lang(lang))
    teng = FusedQueryEngine(IndexBundle.load(d, cfg.with_lang(lang), lang,
                                             device="cpu"), cfg.with_lang(lang))
    queries = sample_queries(setup["built"][lang][0].chunks, 13) + ["", "法"]
    assert compare(jeng, teng, queries) <= 2
    (inputs, _qtf), _st, b, _k = teng.prepare(queries[:3])
    ids_q, mask_q, ids_t, mask_t = inputs
    assert b == 3 and ids_q.shape == (4, 64) and ids_t.shape == (4, 16)


def test_hybrid_channels_and_reranker_match_jax(setup):
    """The batched channels call (both query views from one encoder
    call), the per-channel APIs, the reranker JAX's factory picks, and
    ``search`` with the cross-encoder reranking the top 30."""
    root, cfg, jcfg = setup["root"], setup["cfg"], setup["jcfg"]
    lang = "zh"
    d = root / "jax" / lang
    jb = JaxBundle.load(d, jcfg.with_lang(lang), lang)
    tb = IndexBundle.load(d, cfg.with_lang(lang), lang, device="cpu")
    jhr = JaxHybrid(jb, jcfg.with_lang(lang))
    thr = HybridRetriever(tb, cfg.with_lang(lang))
    queries = sample_queries(jb.chunks, 4, seed=2)
    for q in queries:
        want = jhr._channels_topk_all(q, 40)
        got = thr._channels_topk_all(q, 40)
        np.testing.assert_allclose(got["qvec"], want["qvec"], atol=1e-5)
        for name in ("dense", "bm25", "colbert"):
            # rows equal but at JAX ties (scores in rank order within 1e-4)
            assert assert_same_ranking(want[name][0], want[name][1],
                                       got[name][0], got[name][1]) <= 2
    for api in ("search_dense", "search_colbert"):
        assert_close_hits(getattr(thr, api)(queries[0], 10),
                          getattr(jhr, api)(queries[0], 10))

    tr = RerankerFactory.create(cfg.with_lang(lang), tb)
    jr = JaxFactory.create(jcfg.with_lang(lang), jb)
    assert isinstance(tr, CrossEncoderReranker) and jr.name == tr.name
    assert RerankerFactory.create(cfg.with_lang(lang), tb) is tr
    docs = [c.text for c in jb.chunks[:5]]
    np.testing.assert_allclose(tr.score(queries[0], docs),
                               jr.score(queries[0], docs), atol=1e-4)
    for q in queries[:2]:
        got, want = thr.search(q, top_k=10), jhr.search(q, top_k=10)
        assert_close_hits(got, want)
        assert all(h.score_breakdown["reranker"] == "cross_encoder"
                   for h in got)

    # no vocab.txt (an XLM-R-style tokenizer): both fall back to MaxSim
    (root / "no_vocab").mkdir()
    for f in ("config.json", "model.safetensors"):
        (root / "no_vocab" / f).write_bytes((setup["ce"] / f).read_bytes())
    tcfg, jcfg2 = cfg.with_lang(lang), jcfg.with_lang(lang)
    tcfg.retrieval.reranker_model = str(root / "no_vocab")
    jcfg2.retrieval.reranker_model = str(root / "no_vocab")
    assert isinstance(RerankerFactory.create(tcfg, tb), MaxSimReranker)
    assert JaxFactory.create(jcfg2, jb).name == "maxsim"
    tcfg.retrieval.embedding_backend = "hash"
    tcfg.retrieval.reranker_model = str(setup["ce"])
    assert isinstance(RerankerFactory.create(tcfg, tb), MaxSimReranker)


def test_append_keeps_the_encoder_and_matches_jax(setup, en_chunks):
    """``add_chunks`` of 50 en chunks on the carried bert bundle: the
    encoder is kept (a bert encoder has no corpus statistics), the stores
    grow to JAX's, and the appended search is JAX's."""
    root, cfg, jcfg = setup["root"], setup["cfg"], setup["jcfg"]
    lang = "en"
    jb = JaxBundle.load(root / "jax" / lang, jcfg.with_lang(lang), lang)
    tb = IndexBundle.load(root / "jax" / lang, cfg.with_lang(lang), lang,
                          device="cpu")
    enc = tb.encoder
    more = en_chunks[N_CHUNKS:N_CHUNKS + 50]
    assert jb.add_chunks(more) == 50
    assert tb.add_chunks(port_chunks(more)) == 50
    assert tb.encoder is enc and tb.generation == jb.generation
    assert_same_stores(tb, jb, encoded_apart=True)
    queries = sample_queries(jb.chunks[N_CHUNKS:], 8, seed=4)
    assert compare(JaxEngine(jb, jcfg.with_lang(lang)),
                   FusedQueryEngine(tb, cfg.with_lang(lang)), queries) <= 2


def test_build_cli_builds_bert_bundles(setup, tmp_path):
    """``cli.build_index`` reads the bert fields of the JSON config that
    ``scripts/build_index.py`` reads; the JAX package loads the result."""
    cfg, jcfg = setup["cfg"], setup["jcfg"]
    processed = tmp_path / "processed"
    processed.mkdir()
    write_chunks_jsonl(port_chunks(setup["chunks"]["en"][:40]),
                       processed / "law_en.jsonl")
    conf = {"paths": {name: str(tmp_path / name) for name in (
                "data_dir", "raw_dir", "index_dir", "graph_dir", "eval_dir",
                "upload_dir")} | {"processed_dir": str(processed)},
            "retrieval": {k: getattr(cfg.retrieval, k) for k in (
                "embedding_backend", "embedding_model_zh",
                "embedding_model_en", "reranker_model")},
            "engine": {k: getattr(cfg.engine, k) for k in (
                "capacity_round", "late_dim", "late_doc_maxlen",
                "max_query_tokens")}}
    (tmp_path / "cfg.json").write_text(json.dumps(conf))
    build_index.main(["--config", str(tmp_path / "cfg.json"), "--device",
                      "cpu"])
    out = tmp_path / "index_dir" / "en"
    assert json.loads((out / "manifest.json").read_text())[
        "embedding_backend"] == "bert"
    jl = JaxBundle.load(out, jcfg.with_lang("en"), "en")
    tl = IndexBundle.load(out, cfg.with_lang("en"), "en", device="cpu")
    assert jl.n_docs == tl.n_docs == 40 and jl.dense.dim == 32
    assert_same_stores(tl, jl)
