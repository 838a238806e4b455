"""The port's large-corpus mode vs the JAX package on the same numpy inputs:
CSR postings, the sparse BM25 kernel's plain version against the Pallas
kernel (interpret mode), the BM25 top list against ``bm25_sparse_topk_auto``,
the two-pass selections, candidate MaxSim, the int8 token store, and the
whole CSR branch of ``fused_hybrid_topk``."""

import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legalrag_tpu.config import AppConfig as JaxConfig
from legalrag_tpu.index.bm25_index import BM25Index as JaxBM25Index
from legalrag_tpu.index.bundle import IndexBundle as JaxBundle
from legalrag_tpu.index.token_index import TokenIndex as JaxTokenIndex
from legalrag_tpu.ops import bm25_sparse as jbs
from legalrag_tpu.ops import fused_query as jfq
from legalrag_tpu.ops import topk as jtopk
from legalrag_tpu.ops.maxsim import maxsim_candidates as jax_maxsim_candidates
from legalrag_tpu.tokenize import tokenize
from legalrag_tpu_torch import convert, scale
from legalrag_tpu_torch.config import AppConfig
from legalrag_tpu_torch.index.token_index import TokenIndex
from legalrag_tpu_torch.ops import bm25_sparse as tbs
from legalrag_tpu_torch.ops import fused_query as tfq
from legalrag_tpu_torch.ops import topk as ttopk
from legalrag_tpu_torch.ops.maxsim import maxsim_candidates
from legalrag_tpu_torch.schemas import LawChunk

DOCS = [
    "the seller must deliver conforming goods to the buyer",
    "a security interest attaches when value is given by the secured party",
    "the buyer in ordinary course takes free of the security interest",
    "rent is payable under the lease and the lessee must pay the lessor",
    "negotiable instruments are payable to bearer or to order",
] * 3
TIE = 1e-5  # scores closer than this may swap order (f32 sums in another order)
t = torch.from_numpy
# one compiled program, as inside the JAX fused query (eager, its merge
# network compiles op by op)
jax_topk_auto = jax.jit(jbs.bm25_sparse_topk_auto,
                        static_argnames=("k", "max_postings"))


def _random_corpus(seed, v, n, lo=2, hi=15):
    rng = np.random.default_rng(seed)
    ids, tfs = [], []
    for _ in range(n):
        m = rng.integers(lo, hi)
        ids.append(rng.choice(v, m, replace=False).astype(np.int64))
        tfs.append(rng.integers(1, 5, m).astype(np.float64))
    return ids, tfs


def _docs_index():
    idx = JaxBM25Index("en")
    idx.build_from_texts(DOCS)
    return idx


def _query_slots(index, queries, maxlen=8):
    ids = np.zeros((len(queries), maxlen), np.int32)
    counts = np.zeros((len(queries), maxlen), np.int32)
    for qi, q in enumerate(queries):
        uniq = {}
        for tok in tokenize(q, "en"):
            if tok in index.vocab:
                uniq[index.vocab[tok]] = uniq.get(index.vocab[tok], 0) + 1
        for j, (tid, c) in enumerate(list(uniq.items())[:maxlen]):
            ids[qi, j], counts[qi, j] = tid, c
    return ids, counts


def assert_rows_except_ties(want_s, want_i, got_s, got_i, tol=TIE):
    """Equal scores (atol ``tol``, a scalar or one per row) and ids, except
    ids swapped inside a group of scores closer than ``tol``. Slots scoring
    NEG_INF carry no id."""
    want_s, got_s = np.asarray(want_s, np.float32), np.asarray(got_s)
    want_i, got_i = np.asarray(want_i), np.asarray(got_i)
    tol = np.broadcast_to(np.asarray(tol, np.float64), want_s.shape[:1])
    for q in range(want_i.shape[0]):
        np.testing.assert_allclose(got_s[q], want_s[q], atol=tol[q], rtol=0)
        valid = want_s[q] > -1e29
        assert (got_s[q] > -1e29).tolist() == valid.tolist()
        for p in np.nonzero((want_i[q] != got_i[q]) & valid)[0]:
            # the row at p sits elsewhere in the wanted list within a tie of
            # p, or past its end with a score tied to position p
            where = np.nonzero(want_i[q][valid] == got_i[q, p])[0]
            ref = want_s[q, where[0]] if len(where) else got_s[q, p]
            assert abs(ref - want_s[q, p]) < tol[q], (q, p, want_i[q],
                                                      got_i[q])


# ------------------------------------------------------------ (a) postings

@pytest.mark.parametrize("case", ["docs_chunk8", "random_chunk512",
                                  "negative_idf"])
def test_build_postings_equals_jax(case):
    if case == "docs_chunk8":
        idx = _docs_index()
        args = (idx.doc_term_ids, idx.doc_term_freqs, len(idx.vocab),
                idx.k1, idx.b, idx.epsilon)
        kw = {"chunk": 8}
    elif case == "random_chunk512":
        args = (*_random_corpus(0, 300, 400), 300)
        kw = {}
    else:  # most terms in every doc: epsilon-floored negative idf
        rng = np.random.default_rng(3)
        args = ([np.arange(7, dtype=np.int64) for _ in range(30)],
                [rng.integers(1, 6, 7).astype(np.float64) for _ in range(30)],
                8)
        kw = {}
    want = jbs.build_postings(*args, **kw)
    got = tbs.build_postings(*args, **kw)
    for w, g in zip(want, got):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


# ------------------------------------------- (b) the kernel's plain version

@pytest.mark.parametrize("case", ["docs_queries", "all_padding",
                                  "dup_terms_and_counts"])
def test_bm25_sparse_scores_plain_matches_pallas(case):
    if case == "dup_terms_and_counts":
        args = (*_random_corpus(1, 60, 90), 60)
        offsets, post_docs, post_w = jbs.build_postings(*args, chunk=8)
        rng = np.random.default_rng(2)
        ids = rng.integers(0, 60, (3, 6)).astype(np.int32)
        ids[0, 1] = ids[0, 0]                 # one term in two slots
        counts = rng.integers(0, 3, (3, 6)).astype(np.int32)
        n_docs = 90
    else:
        idx = _docs_index()
        offsets, post_docs, post_w = jbs.build_postings(
            idx.doc_term_ids, idx.doc_term_freqs, len(idx.vocab), idx.k1,
            idx.b, idx.epsilon, chunk=8)
        if case == "docs_queries":
            ids, counts = _query_slots(idx, ["security interest of the buyer",
                                             "lease rent", "unknownword only"])
        else:
            ids = np.zeros((1, 4), np.int32)
            counts = np.zeros((1, 4), np.int32)
        n_docs = idx.n
    n_pad = -(-n_docs // 128) * 128
    want = np.asarray(jbs.bm25_sparse_scores(
        jnp.asarray(ids), jnp.asarray(counts), jnp.asarray(offsets),
        jnp.asarray(post_docs), jnp.asarray(post_w), n_pad, chunk=8,
        interpret=True))
    got, touched = tbs.bm25_sparse_scores_plain(
        t(ids), t(counts), t(offsets), t(post_docs), t(post_w), n_pad)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    via_wrapper = tbs.bm25_sparse_scores(t(ids), t(counts), t(offsets),
                                         t(post_docs), t(post_w), n_pad,
                                         chunk=8)
    assert torch.equal(via_wrapper, got)
    if case == "all_padding":
        assert (got == 0).all() and (touched == 0).all()
    else:  # touched: the docs of every counted posting
        assert touched.sum() > 0
        assert ((got != 0) <= (touched == 1)).all()


def test_bm25_sparse_scores_rejects_a_chunk_the_postings_were_not_built_with():
    idx = _docs_index()
    arrays = jbs.build_postings(idx.doc_term_ids, idx.doc_term_freqs,
                                len(idx.vocab), chunk=8)
    ids = np.zeros((1, 4), np.int32)
    with pytest.raises(ValueError, match="not a multiple of"):
        jbs.bm25_sparse_scores(jnp.asarray(ids), jnp.asarray(ids),
                               *(jnp.asarray(a) for a in arrays), 128,
                               chunk=48, interpret=True)
    with pytest.raises(ValueError, match="not a multiple of"):
        tbs.bm25_sparse_scores(t(ids), t(ids), *(t(a) for a in arrays), 128,
                               chunk=48)


# -------------------------------------------------- (c) the BM25 top list

def _topk_case(case):
    """(term_ids, term_counts, postings, n_docs, k, max_postings)."""
    rng = np.random.default_rng({"merge": 0, "sorted": 1, "truncated": 2,
                                 "idf_zero": 3}[case])
    if case == "idf_zero":
        # term 0 is in exactly half of the docs: idf = ln(5.5) - ln(5.5) = 0
        n = 10
        doc_ids = [np.array([0, 1 + d % 3], np.int64) if d % 2 == 0
                   else np.array([1 + d % 3, 4], np.int64) for d in range(n)]
        doc_tfs = [np.array([1.0, 2.0]) for _ in range(n)]
        postings = jbs.build_postings(doc_ids, doc_tfs, 5)
        ids = np.array([[0, 0, 0, 0], [0, 2, 0, 0]], np.int32)
        counts = np.array([[1, 0, 0, 0], [1, 1, 0, 0]], np.int32)
        return ids, counts, postings, n, 8, 4 * 16
    v, n = 200, 500
    doc_ids, doc_tfs = _random_corpus(int(rng.integers(100)), v, n, 3, 20)
    if case == "truncated":  # term 7 in every doc, far past its budget
        doc_ids = [np.union1d(d, [7]) for d in doc_ids]
        doc_tfs = [np.ones(len(d)) for d in doc_ids]
    postings = jbs.build_postings(doc_ids, doc_tfs, v)
    n_slots, max_postings = {"merge": (8, 8 * 512), "sorted": (6, 6 * 50),
                             "truncated": (4, 4 * 64)}[case]
    ids = rng.integers(0, v, (5, n_slots)).astype(np.int32)
    counts = rng.integers(1, 3, (5, n_slots)).astype(np.int32)
    counts[0, n_slots // 2:] = 0             # padded slots
    counts[4] = 0                            # a query with no counted slot
    ids[1, 1] = ids[1, 0]                    # one term in two slots
    if case == "truncated":
        ids[:, 0] = 7
        counts[:, 0] = 1
    return ids, counts, postings, n, 32, max_postings


@pytest.mark.parametrize("case", ["merge", "sorted", "truncated", "idf_zero"])
def test_bm25_sparse_topk_matches_topk_auto(case):
    ids, counts, postings, n, k, max_postings = _topk_case(case)
    per_term = max_postings // ids.shape[1]
    assert (per_term & (per_term - 1) == 0) == (case in ("merge", "truncated",
                                                         "idf_zero"))
    ws, wi = (np.asarray(x) for x in jax_topk_auto(
        jnp.asarray(ids), jnp.asarray(counts),
        *(jnp.asarray(a) for a in postings), k=k, max_postings=max_postings))
    gs, gi = tbs.bm25_sparse_topk(t(ids), t(counts), *(t(a) for a in postings),
                                  k, max_postings=max_postings, n_docs=n)
    assert gs.shape == (ids.shape[0], k) and gi.dtype == torch.int64
    # JAX's totals are differences of a float32 running sum (cumsum) over
    # the query's gathered postings: exact to a few ulps of that running
    # sum, not of the score. Tolerance: 1e-5 plus 4 ulps of the row total.
    running = tbs.bm25_sparse_scores_plain(
        t(ids), t(counts), *(t(a) for a in postings), n,
        per_term)[0].abs().sum(1).numpy()
    tol = TIE + 4 * np.spacing(running.astype(np.float32))
    assert_rows_except_ties(ws, wi, gs.numpy(), gi.numpy(), tol)
    if case in ("merge", "sorted"):  # a query with no counted slot
        assert not (gs[4] > -1e29).any()
    if case == "truncated":
        # the budget binds: without it the lists differ
        full = jax_topk_auto(
            jnp.asarray(ids), jnp.asarray(counts),
            *(jnp.asarray(a) for a in postings), k=k,
            max_postings=ids.shape[1] * 1024)
        assert not np.array_equal(np.asarray(full[1]), wi)
    if case == "idf_zero":
        # df = N/2: every doc of term 0 is a candidate with score exactly 0
        np.testing.assert_array_equal(gi[0, :5].numpy(), [0, 2, 4, 6, 8])
        assert (gs[0, :5] == 0).all() and (gs[0, 5:] == -1e30).all()


@pytest.mark.parametrize("case", ["signed_zeros", "wide_ties", "bfloat16",
                                  "batched_3d"])
def test_stable_topk_orders_as_lax_top_k(case):
    """(score desc, index asc), -0.0 below +0.0, the dtype kept: the order
    of ``lax.top_k``, for every shape the port selects from."""
    rng = np.random.default_rng(0)
    if case == "signed_zeros":
        s = np.array([[0.0, 3.0, -0.0, 3.0, -1e30, 0.0, 1.0, 3.0, -2.5, -1e30],
                      [-1.0, -1.0, -3.0, 2.0, 2.0, -0.0, 0.0, 7.0, -1e30,
                       2.0]], np.float32)
        ks = (1, 4, 10)
    elif case == "batched_3d":   # tile-local lists: [B, tiles, tile]
        s = np.round(rng.standard_normal((2, 3, 50)), 1).astype(np.float32)
        ks = (7, 50)
    else:
        s = np.round(rng.standard_normal((3, 4000)), 1).astype(np.float32)
        ks = (1, 300)
    dtype = torch.bfloat16 if case == "bfloat16" else torch.float32
    ts = t(s).to(dtype)
    js = jnp.asarray(ts.float().numpy(),
                     jnp.bfloat16 if case == "bfloat16" else jnp.float32)
    for k in ks:
        ws, wi = jax.lax.top_k(js, k)
        gs, gi = ttopk.stable_topk(ts, k)
        assert gs.dtype == dtype and gi.dtype == torch.int64
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        assert (gs.float().numpy().tobytes()
                == np.asarray(ws.astype(jnp.float32)).tobytes())
    # k past the row: the whole row
    assert ttopk.stable_topk(ts, s.shape[-1] + 5)[1].shape == s.shape


# --------------------------------------------- (d) two-pass selections

def _tie_map(seed, b, n, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return np.round(rng.standard_normal((b, n)) * 4).astype(dtype)  # many ties


@pytest.mark.parametrize("n,k", [(5000, 64), (2000, 10), (50, 64), (3000, 3000)])
def test_topk_2pass_matches_jax(n, k):
    s = _tie_map(n, 3, n)
    ws, wi = jtopk.topk_2pass(jnp.asarray(s), k)
    gs, gi = ttopk.topk_2pass(t(s), k)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))


@pytest.mark.parametrize("n,valid_n,k,dtype", [
    (5000, 3333, 64, "float32"),     # straddling block, recursion
    (5000, 3072, 16, "float32"),     # valid_n on a block boundary
    (5000, 3333, 64, "bfloat16"),
    (700, 600, 16, "float32"),       # n < 2 * block
    (1200, 1100, 1200, "float32"),   # k >= n
])
def test_topk_2pass_masked_matches_jax(n, valid_n, k, dtype):
    s = _tie_map(n + k, 4, n)
    js = jnp.asarray(s, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    ts = t(s).to(torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    ws, wi = jtopk.topk_2pass_masked(js, valid_n, k)
    gs, gi = ttopk.topk_2pass_masked(ts, valid_n, k)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gs.float().numpy(),
                                  np.asarray(ws.astype(jnp.float32)))
    assert gs.dtype == ts.dtype


def test_topk_large_and_dense_topk_2pass_match_jax(monkeypatch):
    rng = np.random.default_rng(5)
    emb = rng.standard_normal((3000, 64)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    emb = np.array(jnp.asarray(emb, jnp.bfloat16).astype(jnp.float32))
    q = rng.standard_normal((4, 64)).astype(np.float32)
    ws, wi = jtopk.dense_topk_2pass(jnp.asarray(emb, jnp.bfloat16),
                                    jnp.asarray(q), jnp.int32(2900), 40)
    gs, gi = ttopk.dense_topk_2pass(t(emb).to(torch.bfloat16), t(q), 2900, 40)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), atol=1e-6)
    s = _tie_map(9, 2, 1500)
    monkeypatch.setattr(jtopk, "TWO_PASS_MIN_N", 1024)
    monkeypatch.setattr(ttopk, "TWO_PASS_MIN_N", 1024)
    for k in (30, 1500):
        ws, wi = jtopk.topk_large(jnp.asarray(s), k)
        gs, gi = ttopk.topk_large(t(s), k)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))


# ------------------------------------------------ (e) candidate MaxSim

@pytest.mark.parametrize("store", ["bfloat16", "int8"])
def test_maxsim_candidates_matches_jax(store):
    rng = np.random.default_rng(7)
    n, l_doc, dt, b, lq, c = 40, 12, 16, 4, 6, 10
    tok = rng.standard_normal((n, l_doc, dt)).astype(np.float32)
    tok /= np.linalg.norm(tok, axis=-1, keepdims=True)
    mask = rng.random((n, l_doc)) > 0.3
    mask[3] = False                                   # empty doc
    q_tok = rng.standard_normal((b, lq, dt)).astype(np.float32)
    q_tok /= np.linalg.norm(q_tok, axis=-1, keepdims=True)
    q_mask = rng.random((b, lq)) > 0.2
    q_mask[:, 0] = True
    cand = rng.integers(0, n, (b, c)).astype(np.int32)
    cand[0, :3] = [3, 5, 5]                           # empty doc, duplicate
    if store == "int8":
        jidx = JaxTokenIndex(dt, l_doc, dtype="int8", capacity_round=8)
        jidx.add(tok, mask)
        j_tok, t_tok = jidx.tok, t(np.array(jidx.tok))
        jq, tq = jnp.asarray(q_tok), t(q_tok)          # float32 queries
    else:
        j_tok = jnp.asarray(tok, jnp.bfloat16)
        t_tok = t(tok).to(torch.bfloat16)
        jq = jnp.asarray(q_tok, jnp.bfloat16)
        tq = t(q_tok).to(torch.bfloat16)
    jmask = jnp.pad(jnp.asarray(mask), ((0, j_tok.shape[0] - n), (0, 0)))
    want = np.asarray(jax_maxsim_candidates(j_tok, jmask, jq,
                                            jnp.asarray(q_mask),
                                            jnp.asarray(cand)))
    got = maxsim_candidates(t_tok, t(np.array(jmask)), tq, t(q_mask),
                            t(cand).long())
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    assert got[0, 0] == 0


# --------------------------------------------------- (g) int8 token store

def test_int8_token_store_round_trips_in_the_jax_format(tmp_path):
    rng = np.random.default_rng(8)
    tok = rng.standard_normal((5, 6, 16)).astype(np.float32)
    tok /= np.linalg.norm(tok, axis=-1, keepdims=True)
    mask = rng.random((5, 6)) > 0.3
    jidx = JaxTokenIndex(16, 6, dtype="int8", capacity_round=8)
    jidx.add(tok, mask)
    tidx = TokenIndex(16, 6, dtype="int8", capacity_round=8, device="cpu")
    tidx.add(tok, mask)
    assert tidx.tok.dtype == torch.int8 and tidx.query_dtype == torch.float32
    np.testing.assert_array_equal(tidx.tok.numpy(), np.asarray(jidx.tok))
    # JAX -> port: int8 payload loads as int8, whatever dtype is asked for
    jidx.save(tmp_path / "jax.npz")
    back = TokenIndex.load(tmp_path / "jax.npz", dtype="bfloat16",
                           capacity_round=8, device="cpu")
    assert back.tok.dtype == torch.int8 and back.n == 5
    np.testing.assert_array_equal(back.tok.numpy(), np.asarray(jidx.tok))
    np.testing.assert_array_equal(back.mask.numpy(), np.asarray(jidx.mask))
    # port -> JAX
    tidx.save(tmp_path / "port.npz")
    jback = JaxTokenIndex.load(tmp_path / "port.npz", capacity_round=8)
    assert jback.dtype == jnp.int8 and jback.n == 5
    np.testing.assert_array_equal(np.asarray(jback.tok), tidx.tok.numpy())
    z = np.load(tmp_path / "port.npz")
    assert z["tok"].dtype == np.int8 and bool(z["quantized"])


# --------------------------------- (f) the whole CSR branch vs JAX

@pytest.fixture(scope="module")
def large_setup(en_chunks):
    """The tests/test_fused_large.py setup, carried to the port."""
    jcfg = JaxConfig()
    jcfg.engine.capacity_round = 256
    jcfg.engine.late_doc_maxlen = 64
    jb = JaxBundle.build_from_chunks(en_chunks[:200], jcfg, "en")
    cfg = AppConfig()
    cfg.engine.capacity_round = 256
    cfg.engine.late_doc_maxlen = 64
    with tempfile.TemporaryDirectory() as d:
        jb.bm25.save(d + "/bm25.npz")
        z = dict(np.load(d + "/bm25.npz"))
    arrays = {
        "encoder": jb.encoder.state(), "proj": np.asarray(jb.encoder._projection()),
        "emb": np.asarray(jb.dense.emb, np.float32), "n": jb.dense.n,
        "impact": np.asarray(jb.bm25.impact),
        "tok": np.asarray(jb.tokens.tok, np.float32),
        "mask": np.asarray(jb.tokens.mask),
        "flat_ids": z["flat_ids"], "flat_tfs": z["flat_tfs"],
        "offsets": z["offsets"], "bm25_params": z["params"]}
    chunks = [LawChunk.from_json(c.model_dump_json(exclude_none=True))
              for c in jb.chunks]
    tb = convert.bundle_from_arrays(arrays, chunks, dict(jb.bm25.vocab), cfg,
                                    "cpu")
    postings = jbs.build_postings(
        jb.bm25.doc_term_ids, jb.bm25.doc_term_freqs, len(jb.bm25.vocab),
        jb.bm25.k1, jb.bm25.b, jb.bm25.epsilon)
    queries = ["buyer in ordinary course of business",
               "negotiable instrument payable to bearer",
               "security interest attaches when value is given",
               "warranty of merchantability goods"]
    enc = jb.encoder
    ids, mask = jb.bm25.query_term_ids(queries, 32)
    qt, qm = enc.encode_tokens(queries, 32)
    qvec = enc.encode_queries(queries)
    return jb, tb, postings, (qvec, ids, mask, qt, qm)


def _run_both(large_setup, params, int8_tokens=False):
    jb, tb, postings, (qvec, ids, mask, qt, qm) = large_setup
    jp = jfq.FusedParams(**params)
    tp = tfq.FusedParams(**params)
    j_tok, t_tok = jb.tokens.tok, tb.tokens.tok
    jq = jnp.asarray(qt, jb.tokens.dtype)
    tq = t(np.array(jq.astype(jnp.float32))).to(tb.tokens.query_dtype)
    if int8_tokens:
        quant = JaxTokenIndex(128, 64, dtype="int8")._quantize(
            np.asarray(jb.tokens.tok, np.float32))
        j_tok, t_tok = jnp.asarray(quant), t(quant)
        jq, tq = jnp.asarray(qt, jnp.float32), t(np.asarray(qt, np.float32))
    want = jfq.fused_hybrid_topk(
        jb.dense.emb, tuple(jnp.asarray(a) for a in postings), j_tok,
        jb.tokens.mask, jnp.asarray(qvec),
        (jnp.asarray(ids), jnp.asarray(mask)), jq, jnp.asarray(qm),
        jnp.int32(jb.dense.n), jp)
    got = tfq.fused_hybrid_topk(
        tb.dense.emb, convert.postings_from_arrays(*postings, device="cpu"),
        t_tok, tb.tokens.mask, t(qvec), (t(ids), t(mask)), tq, t(qm),
        tb.dense.n, tp)
    return ({k: np.asarray(v) for k, v in want.items()},
            {k: v.numpy() for k, v in got.items()})


BASE = dict(eff_k=32, final_k=10, rrf_k=60.0, alpha=0.5, w_dense=0.6,
            w_bm25=0.4, w_late=0.35)


def assert_packed_close(got, want):
    """Packed components within 1e-5, except BM25 (index 2) within 1e-4:
    JAX's CSR BM25 totals are differences of a float32 running sum over the
    query's postings (~1e2 here), a few ulps of which reach 6e-5."""
    assert got.shape == want.shape
    rest = [i for i in range(want.shape[-1]) if i != 2]
    np.testing.assert_allclose(got[..., rest], want[..., rest], atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(got[..., 2], want[..., 2], atol=1e-4, rtol=0)


@pytest.mark.parametrize("case", ["late_all", "late_32", "late_8", "int8_tokens"])
def test_csr_branch_matches_jax(large_setup, case):
    n = large_setup[1].dense.capacity
    late = {"late_all": n, "late_32": 32, "late_8": 8, "int8_tokens": 32}[case]
    params = dict(BASE, late_candidates=late, max_postings=32 * 256)
    want, got = _run_both(large_setup, params, case == "int8_tokens")
    np.testing.assert_array_equal(got["rows"], want["rows"])
    assert got["packed"].shape == (4, 10, 6)
    assert_packed_close(got["packed"], want["packed"])


def test_csr_branch_two_pass_route_matches_jax(large_setup, monkeypatch):
    """The block-max route, forced at test scale in both packages."""
    monkeypatch.setattr(jtopk, "TWO_PASS_MIN_N", 64)
    monkeypatch.setattr(ttopk, "TWO_PASS_MIN_N", 64)
    jax.clear_caches()
    try:
        params = dict(BASE, eff_k=16, late_candidates=32)
        want, got = _run_both(large_setup, params)
        np.testing.assert_array_equal(got["rows"], want["rows"])
        assert_packed_close(got["packed"], want["packed"])
    finally:
        monkeypatch.undo()
        jax.clear_caches()


def test_csr_branch_bf16_map_holds_to_the_jax_bar(large_setup):
    """With the bf16 map the frameworks may round the map differently: the
    JAX test's bar (>= 9/10 of the top-10 shared, the same top-1, dense
    components of shared hits within 1e-5) holds against JAX's bf16 run
    and against the port's own f32 run."""
    params = dict(BASE, late_candidates=32, max_postings=32 * 256)
    want, got = _run_both(large_setup, dict(params, dense_map_bf16=True))
    _, got_f32 = _run_both(large_setup, params)
    for ref in (want, got_f32):
        for r in range(4):
            shared = np.intersect1d(ref["rows"][r], got["rows"][r])
            assert len(shared) >= 9 and ref["rows"][r][0] == got["rows"][r][0]
            for doc in shared.tolist():
                i = list(ref["rows"][r]).index(doc)
                j = list(got["rows"][r]).index(doc)
                np.testing.assert_allclose(got["packed"][r, j, 1],
                                           ref["packed"][r, i, 1], atol=1e-5)


def test_map_mode_late_candidates_matches_jax(large_setup):
    jb, tb, _, (qvec, ids, mask, qt, qm) = large_setup
    params = dict(BASE, late_candidates=48)
    jq = jnp.asarray(qt, jb.tokens.dtype)
    want = jfq.fused_hybrid_topk(
        jb.dense.emb, jb.bm25.impact, jb.tokens.tok, jb.tokens.mask,
        jnp.asarray(qvec), (jnp.asarray(ids), jnp.asarray(mask)), jq,
        jnp.asarray(qm), jnp.int32(jb.dense.n), jfq.FusedParams(**params))
    got = tfq.fused_hybrid_topk(
        tb.dense.emb, tb.bm25.impact, tb.tokens.tok, tb.tokens.mask, t(qvec),
        (t(ids), t(mask)), t(np.array(jq.astype(jnp.float32))).to(
            torch.bfloat16), t(qm), tb.dense.n, tfq.FusedParams(**params))
    np.testing.assert_array_equal(got["rows"].numpy(), np.asarray(want["rows"]))
    np.testing.assert_allclose(got["packed"].numpy(), np.asarray(want["packed"]),
                               atol=1e-4, rtol=0)


def test_convert_carries_int8_tokens_and_checks_postings(large_setup):
    jb, tb = large_setup[0], large_setup[1]
    quant = JaxTokenIndex(128, 64, dtype="int8")._quantize(
        np.asarray(jb.tokens.tok, np.float32))
    cfg = AppConfig()
    cfg.engine.capacity_round = 256
    cfg.engine.late_doc_maxlen = 64
    arrays = {"encoder": jb.encoder.state(),
              "proj": np.asarray(jb.encoder._projection()),
              "emb": np.asarray(jb.dense.emb, np.float32), "n": jb.dense.n,
              "impact": tb.bm25.impact.numpy(),
              "flat_ids": np.concatenate(tb.bm25.doc_term_ids),
              "flat_tfs": np.concatenate(tb.bm25.doc_term_freqs),
              "offsets": np.cumsum([0] + [len(a) for a in tb.bm25.doc_term_ids]),
              "bm25_params": [tb.bm25.k1, tb.bm25.b, tb.bm25.epsilon],
              "tok": quant, "mask": np.asarray(jb.tokens.mask)}
    b = convert.bundle_from_arrays(arrays, tb.chunks, tb.bm25.vocab, cfg, "cpu")
    assert b.tokens.tok.dtype == torch.int8
    np.testing.assert_array_equal(b.tokens.tok[:jb.dense.n].numpy(),
                                  quant[:jb.dense.n])
    with pytest.raises(ValueError, match="CSR"):
        convert.postings_from_arrays(np.array([0, 5, 3]), np.zeros(8),
                                     np.zeros(8), device="cpu")


# ------------------------------------------------- the scale point, small

def test_scale_synthesis_keeps_the_postings_invariant_and_matches_jax():
    idx = scale.synthesize_index(n_docs=3000, vocab=400, dim=64, doc_len=8,
                                 token_dim=32, seed=0, device="cpu")
    offsets, post_docs, post_w = (x.numpy() for x in idx.postings)
    assert offsets[0] == 0 and (np.diff(offsets) >= 0).all()
    sizes = np.diff(offsets)
    assert sizes.max() <= scale.POSTINGS_CAP and sizes[0] > 250
    nnz = offsets[-1]
    assert len(post_docs) % 512 == 0 and len(post_docs) >= nnz + 512
    assert (post_docs[nnz:] == 0).all() and (post_w[nnz:] == 0).all()
    for tid in range(400):
        d = post_docs[offsets[tid]:offsets[tid + 1]]
        assert (np.diff(d) > 0).all()                # unique, ascending
    assert (post_w[:nnz] >= 0).all()
    assert idx.doc_tok.dtype == torch.int8
    assert idx.doc_tok.abs().max() <= 127
    np.testing.assert_allclose(idx.emb.float().norm(dim=1).numpy(), 1.0,
                               atol=1e-2)
    qs = scale.synthesize_queries(idx, 400, batch=6, seed=1)
    params = scale.scale_params(candidates=128)
    got = scale.run_hybrid(idx, qs, params)
    want = jfq.fused_hybrid_topk(
        jnp.asarray(idx.emb.float().numpy(), jnp.bfloat16),
        tuple(jnp.asarray(x.numpy()) for x in idx.postings),
        jnp.asarray(idx.doc_tok.numpy()), jnp.asarray(idx.doc_mask.numpy()),
        jnp.asarray(qs.qvec.numpy()),
        (jnp.asarray(qs.term_ids.numpy()), jnp.asarray(qs.term_counts.numpy())),
        jnp.asarray(qs.q_tok.numpy()), jnp.asarray(qs.q_mask.numpy()),
        jnp.int32(idx.n), jfq.FusedParams(**vars(params)))
    np.testing.assert_array_equal(got["rows"].numpy(), np.asarray(want["rows"]))
    assert_packed_close(got["packed"].numpy(), np.asarray(want["packed"]))
