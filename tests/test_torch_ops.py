"""Port ops vs the JAX ops on the same numpy inputs: the plain versions of the
two kernels against the Pallas kernels they replace (interpret mode), and the
per-channel components, stable top-k and BM25 pieces against JAX."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legalrag_tpu.ops import fused_query as jfq
from legalrag_tpu.ops.bm25 import bm25_scores_matmul as jax_bm25
from legalrag_tpu.ops.maxsim import maxsim_full as jax_maxsim_full
from legalrag_tpu.ops.maxsim_pallas import maxsim_scores_pallas
from legalrag_tpu.ops.maxsim_pallas2 import maxsim_scores_pallas2
from legalrag_tpu.ops.topk import dense_topk_pallas, dense_topk_xla
from legalrag_tpu_torch.ops import fused_query as tfq
from legalrag_tpu_torch.ops.bm25 import bm25_scores_matmul, query_term_counts
from legalrag_tpu_torch.ops.maxsim import maxsim_full, maxsim_full_plain
from legalrag_tpu_torch.ops.topk import (
    bucket_k,
    dense_scores,
    dense_topk,
    dense_topk_fused_plain,
    stable_topk,
)


def _unit(rng, *shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-9)


def _bf16(x):
    """bf16-rounded values, as float32 (exact in both packages)."""
    return np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


# ----------------------------------------------------------------- kernel 1

@pytest.mark.parametrize("case", ["dup_rows", "valid_lt_n", "k_gt_tile"])
def test_dense_topk_plain_matches_pallas(case):
    """ids exact, scores within 1e-5, against the Pallas score+select kernel
    in interpret mode (bf16 store, q cast to the store dtype)."""
    rng = np.random.default_rng({"dup_rows": 0, "valid_lt_n": 1,
                                 "k_gt_tile": 2}[case])
    n, d, b = 256, 64, 4
    emb = _unit(rng, n, d)
    q = _unit(rng, b, d)
    valid_n, k, tile = n, 16, 64
    if case == "dup_rows":
        emb[40:48] = emb[3]        # exact ties: the lowest row wins
        emb[200] = emb[3]
        q[0] = emb[3]
    elif case == "valid_lt_n":
        valid_n = 150
    else:
        k, tile = 48, 32           # k > tile: kp = tile rows per tile
    emb_j = jnp.asarray(emb, jnp.bfloat16)
    s_j, i_j = dense_topk_pallas(emb_j, jnp.asarray(q), jnp.int32(valid_n), k,
                                 tile_n=tile, interpret=True)
    emb_t = torch.from_numpy(emb).to(torch.bfloat16)
    s_t, i_t = dense_topk_fused_plain(emb_t, torch.from_numpy(q), valid_n, k)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), atol=1e-5)
    if case == "dup_rows":
        assert list(i_t[0, :10].numpy()) == [3, 40, 41, 42, 43, 44, 45, 46,
                                             47, 200]


def test_dense_topk_plain_equals_full_map_topk_past_valid_rows():
    """k > valid_n: the masked rows fill the tail in row order, as
    lax.top_k of the masked map gives them (the Pallas kernel can repeat a
    row there; the port's selection never does)."""
    rng = np.random.default_rng(3)
    emb, q = _unit(rng, 128, 32), _unit(rng, 3, 32)
    s_j, i_j = dense_topk_xla(jnp.asarray(emb), jnp.asarray(q), jnp.int32(5),
                              12)
    s_t, i_t = dense_topk_fused_plain(torch.from_numpy(emb),
                                      torch.from_numpy(q), 5, 12)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), atol=1e-5)
    assert (s_t[:, 5:] == -1e30).all()


@pytest.mark.parametrize("n,tile", [(300, 128), (130, 128), (64, 16)])
def test_dense_topk_plain_ragged_tiles(n, tile):
    """N not a multiple of the tile: rows that do not exist never surface."""
    rng = np.random.default_rng(n)
    emb, q = _unit(rng, n, 16), _unit(rng, 2, 16)
    s, i = dense_topk_fused_plain(torch.from_numpy(emb), torch.from_numpy(q),
                                  n, n, tile=tile)
    full = dense_scores(torch.from_numpy(emb), torch.from_numpy(q))
    s_ref, i_ref = stable_topk(full, n)
    np.testing.assert_array_equal(i.numpy(), i_ref.numpy())
    np.testing.assert_array_equal(s.numpy(), s_ref.numpy())


def test_dense_scores_casts_q_to_store_dtype():
    rng = np.random.default_rng(4)
    emb, q = _unit(rng, 50, 32), _unit(rng, 3, 32)
    want = np.asarray(jnp.dot(jnp.asarray(q).astype(jnp.bfloat16),
                              jnp.asarray(emb, jnp.bfloat16).T,
                              preferred_element_type=jnp.float32))
    got = dense_scores(torch.from_numpy(emb).to(torch.bfloat16),
                       torch.from_numpy(q))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


# ----------------------------------------------------------------- kernel 2

def _maxsim_inputs(seed, n=32, l=12, dt=16, b=4, lq=6):
    rng = np.random.default_rng(seed)
    doc_tok = _unit(rng, n, l, dt)
    doc_mask = rng.random((n, l)) > 0.3
    doc_mask[3] = False                        # empty doc
    doc_mask[5] = [j % 3 == 1 for j in range(l)]   # valid tokens not a prefix
    q_tok = _unit(rng, b, lq, dt)
    q_mask = rng.random((b, lq)) > 0.2
    q_mask[:, 0] = True
    return doc_tok, doc_mask, q_tok, q_mask


@pytest.mark.parametrize("pallas", ["maxsim_scores_pallas",
                                    "maxsim_scores_pallas2"])
def test_maxsim_plain_matches_pallas(pallas):
    fn = {"maxsim_scores_pallas": maxsim_scores_pallas,
          "maxsim_scores_pallas2": maxsim_scores_pallas2}[pallas]
    doc_tok, doc_mask, q_tok, q_mask = _maxsim_inputs(0)
    want = np.asarray(fn(jnp.asarray(doc_tok), jnp.asarray(doc_mask),
                         jnp.asarray(q_tok), jnp.asarray(q_mask), tile_t=8,
                         interpret=True))
    got = maxsim_full_plain(*(torch.from_numpy(x) for x in
                              (doc_tok, doc_mask, q_tok, q_mask)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert (got[:, 3] == 0).all()


def test_maxsim_plain_matches_xla_bf16_and_chunking():
    """bf16 operands (the main path's dtype) and a doc chunk smaller than N."""
    doc_tok, doc_mask, q_tok, q_mask = _maxsim_inputs(1, n=40, dt=32)
    doc_b, q_b = _bf16(doc_tok), _bf16(q_tok)
    want = np.asarray(jax_maxsim_full(
        jnp.asarray(doc_b, jnp.bfloat16), jnp.asarray(doc_mask),
        jnp.asarray(q_b, jnp.bfloat16), jnp.asarray(q_mask), tile_n=8))
    args = (torch.tensor(doc_b).to(torch.bfloat16),
            torch.from_numpy(doc_mask),
            torch.tensor(q_b).to(torch.bfloat16),
            torch.from_numpy(q_mask))
    got = maxsim_full(*args)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    chunked = maxsim_full_plain(*args, budget_bytes=4 * 4 * 6 * 12 * 3)
    np.testing.assert_allclose(chunked.numpy(), got.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_maxsim_negative_similarities_preserved():
    doc_tok = -np.ones((8, 2, 4), np.float32) / 2.0
    doc_mask = np.ones((8, 2), bool)
    q_tok = np.ones((1, 1, 4), np.float32) / 2.0
    q_mask = np.ones((1, 1), bool)
    want = np.asarray(maxsim_scores_pallas(
        jnp.asarray(doc_tok), jnp.asarray(doc_mask), jnp.asarray(q_tok),
        jnp.asarray(q_mask), tile_t=8, interpret=True))
    got = maxsim_full_plain(*(torch.from_numpy(x) for x in
                              (doc_tok, doc_mask, q_tok, q_mask)))
    assert (got < 0).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------ channel components

def _bm25_like_map(seed, b=3, n=200, valid_n=180):
    rng = np.random.default_rng(seed)
    s = np.zeros((b, n), np.float32)        # most docs score exactly 0
    for r in range(b):
        hits = rng.choice(valid_n, 12, replace=False)
        s[r, hits] = rng.random(12).astype(np.float32) * 5
        s[r, hits[:3]] = s[r, hits[3]]      # ties among positives too
    s[1] = 0.0                               # a row with no match at all
    s[:, valid_n:] = -1e30
    return s


@pytest.mark.parametrize("eff_k", [8, 32, 64])
def test_channel_components_match_jax_on_zero_ties(eff_k):
    """BM25 leaves most docs at exactly 0; those zeros fill eff_k and become
    candidates in index order, as lax.top_k orders them."""
    s = _bm25_like_map(eff_k)
    want = jfq._channel_components(jnp.asarray(s), eff_k, 0.4, 60.0)
    got = tfq.channel_components(torch.from_numpy(s), eff_k, 0.4, 60.0)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_stable_topk_matches_lax_top_k_ties():
    s = np.array([[0, 3, 0, 3, -1e30, 0, 1, 3]], np.float32)
    ws, wi = jax.lax.top_k(jnp.asarray(s), 6)
    gs, gi = stable_topk(torch.from_numpy(s), 6)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))


# ------------------------------------------------------------------- BM25

def test_query_term_counts_add_duplicates_and_bm25_matmul():
    rng = np.random.default_rng(5)
    v, n = 24, 40
    impact = (rng.random((v, n)) * (rng.random((v, n)) > 0.7)).astype(np.float32)
    ids = np.array([[3, 3, 7, 0, 0], [1, 2, 2, 2, 0]], np.int32)
    mask = np.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 0]], bool)
    want_q = np.zeros((2, v), np.float32)
    np.add.at(want_q, (np.arange(2)[:, None].repeat(5, 1)[mask], ids[mask]), 1.0)
    got_q = query_term_counts(torch.from_numpy(ids), torch.from_numpy(mask), v)
    np.testing.assert_array_equal(got_q.numpy(), want_q)
    want = np.asarray(jax_bm25(jnp.asarray(impact), jnp.asarray(want_q)))
    got = bm25_scores_matmul(torch.from_numpy(impact), got_q)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_bucket_k_matches():
    from legalrag_tpu.ops.topk import bucket_k as jax_bucket_k

    for k, n in [(1, 100), (40, 2048), (64, 50), (600, 10000), (9, 0)]:
        assert bucket_k(k, n) == jax_bucket_k(k, n)


# ------------------------------------------------------ fused, map mode

def test_fused_hybrid_topk_matches_jax_on_synthetic_inputs():
    """The whole map-mode program on one synthetic input (qvec and qtf in
    their pair forms), f32 stores so the dense map is exact in both."""
    rng = np.random.default_rng(6)
    n, d, v, l_doc, dt, b, lq, d0 = 256, 32, 40, 10, 16, 4, 5, 64
    emb = _unit(rng, n, d)
    impact = (rng.random((v, 192)) * (rng.random((v, 192)) > 0.8)
              ).astype(np.float32)          # impact pads N differently
    doc_tok = _unit(rng, n, l_doc, dt)
    doc_mask = rng.random((n, l_doc)) > 0.4
    sketch = rng.standard_normal((b, d0)).astype(np.float32)
    proj = rng.standard_normal((d0, d)).astype(np.float32)
    term_ids = rng.integers(0, v, (b, 6)).astype(np.int32)
    term_mask = rng.random((b, 6)) > 0.3
    q_tok = _unit(rng, b, lq, dt)
    q_mask = rng.random((b, lq)) > 0.3
    valid_n = 180
    jp = jfq.FusedParams(eff_k=32, final_k=16, rrf_k=60.0, alpha=0.5,
                         w_dense=0.6, w_bm25=0.4, w_late=0.35)
    want = jfq.fused_hybrid_topk(
        jnp.asarray(emb), jnp.asarray(impact), jnp.asarray(doc_tok),
        jnp.asarray(doc_mask), (jnp.asarray(sketch), jnp.asarray(proj)),
        (jnp.asarray(term_ids), jnp.asarray(term_mask)), jnp.asarray(q_tok),
        jnp.asarray(q_mask), jnp.int32(valid_n), jp)
    tp = tfq.FusedParams(eff_k=32, final_k=16, rrf_k=60.0, alpha=0.5,
                         w_dense=0.6, w_bm25=0.4, w_late=0.35)
    t = torch.from_numpy
    got = tfq.fused_hybrid_topk(
        t(emb), t(impact), t(doc_tok), t(doc_mask), (t(sketch), t(proj)),
        (t(term_ids), t(term_mask)), t(q_tok), t(q_mask), valid_n, tp)
    np.testing.assert_array_equal(got["rows"].numpy(), np.asarray(want["rows"]))
    np.testing.assert_allclose(got["packed"].numpy(),
                               np.asarray(want["packed"]), atol=1e-4)
    assert tfq.PACKED_NAMES == jfq.PACKED_NAMES


def test_fused_hybrid_topk_unported_modes_raise():
    """What the port does not run yet raises NotImplementedError: the
    full-corpus MaxSim over an int8 token store (the kernel has no
    in-kernel dequant) and the int8 dense store."""
    from legalrag_tpu_torch.index.dense_index import store_dtype

    p = tfq.FusedParams(eff_k=8, final_k=8, rrf_k=60.0, alpha=0.5,
                        w_dense=0.6, w_bm25=0.4, w_late=0.35)
    emb = torch.zeros(16, 8)
    with pytest.raises(NotImplementedError):
        tfq.fused_hybrid_topk(emb, torch.zeros(4, 16),
                              torch.zeros(16, 2, 8, dtype=torch.int8),
                              torch.ones(16, 2, dtype=torch.bool),
                              torch.zeros(1, 8), torch.zeros(1, 4),
                              torch.zeros(1, 2, 8),
                              torch.ones(1, 2, dtype=torch.bool), 16, p)
    with pytest.raises(NotImplementedError):
        store_dtype("int8")
