"""The quantized stores of the port against the JAX package: the unit-int8
dense scorer and store, the int8 and nbit4 token stores and MaxSim over
them, and the scale point's store options (the bundles, engines and
retrievers over them: ``tests/test_torch_stores_bundle.py``). The same numpy inputs (from a seed) go through
the JAX function, as the JAX tests run it on the CPU (these stores are XLA
programs there, no Pallas), and through its counterpart in the port on the
CPU (the MaxSim kernel's plain version).

Tolerances: the int8 scorer's quantized queries and int32 sums are equal
bit for bit, and so are its scores against JAX's eager ``dense_scores``
(the same IEEE operations in the same order); inside JAX's jitted
programs XLA may fold the divisions by 127 into products, so scores there
agree within 1e-6 (one float32 ulp at 1) and rows exactly; MaxSim maps within 1e-5 (float32 sums of up to 64 products in
another order); nbit4 codes, packed nibbles and codebooks byte-equal;
dequantized tokens within 1e-6; fused scores within 1e-4, rows equal but
for JAX scores that tie within 1e-5 (``assert_same_ranking``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legalrag_tpu.index.dense_index import DenseIndex as JaxDense
from legalrag_tpu.index.token_index import Residual4TokenIndex as JaxR4
from legalrag_tpu.index.token_index import TokenIndex as JaxTokens
from legalrag_tpu.ops import fused_query as jfq
from legalrag_tpu.ops import maxsim as jm
from legalrag_tpu.ops import topk as jt
from legalrag_tpu_torch import scale
from legalrag_tpu_torch.index.dense_index import DenseIndex
from legalrag_tpu_torch.index.token_index import (
    Residual4TokenIndex,
    TokenIndex,
)
from legalrag_tpu_torch.ops import fused_query as tfq
from legalrag_tpu_torch.ops import maxsim as tm
from legalrag_tpu_torch.ops import topk as tt


def unit(rng, *shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def clustered_tokens(n, l_doc, dt, seed=0):
    """Cluster-structured unit tokens and a mask with an empty doc (2) and
    a doc whose valid tokens are not a prefix (3), as the JAX nbit4 tests
    make them."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((32, dt))
    x = centers[rng.integers(0, 32, n * l_doc)] + 0.3 * rng.standard_normal(
        (n * l_doc, dt))
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    mask = rng.random((n, l_doc)) < 0.9
    mask[:, 0] = True
    mask[2] = False
    mask[3] = np.arange(l_doc) % 3 == 1
    return x.reshape(n, l_doc, dt).astype(np.float32), mask


def t(a):
    return torch.from_numpy(np.asarray(a))


# ----------------------------------------------------------- int8 dense

@pytest.mark.parametrize("b", [1, 5, 64])
def test_int8_dense_scores_acc_and_scores_equal_jax(b):
    """The quantized queries, the int32 accumulator and the scores of the
    int8 scorer equal JAX's bit for bit (``legalrag_tpu/ops/topk.py:
    84-92``), at batch sizes below and above ``torch._int_mm``'s 16 rows;
    an all-zero query and halves that round to even included."""
    rng = np.random.default_rng(b)
    e8 = np.rint(np.clip(unit(rng, 512, 96), -1, 1) * 127).astype(np.int8)
    q = rng.standard_normal((b, 96)).astype(np.float32)
    if b > 1:
        q[1] = 0.0
        q[0, :5] = [127.0, 0.5, 1.5, 2.5, -0.5]   # qs = 1: 0, 2, 2, -0
        q[0, 5:] = 0.25
    # JAX's quantization and accumulator, as its dense_scores computes them
    qf = jnp.asarray(q)
    qs = jnp.maximum(jnp.max(jnp.abs(qf), axis=-1, keepdims=True),
                     1e-8) / 127.0
    qq = jnp.round(qf / qs).astype(jnp.int8)
    acc = jax.lax.dot_general(qq, jnp.asarray(e8), (((1,), (1,)), ((), ())),
                              preferred_element_type=jnp.int32)
    tqq, tqs = tt.quantize_queries(t(q))
    np.testing.assert_array_equal(tqq.numpy(), np.asarray(qq))
    np.testing.assert_array_equal(tqs.numpy(), np.asarray(qs))
    tacc = tt.int8_dot(tqq, t(e8))
    assert tacc.dtype == torch.int32
    np.testing.assert_array_equal(tacc.numpy(), np.asarray(acc))
    np.testing.assert_array_equal(
        tt.dense_scores(t(e8), t(q)).numpy(),
        np.asarray(jt.dense_scores(jnp.asarray(e8), qf)))
    if b > 1:
        assert tqq[0, :5].tolist() == [127, 0, 2, 2, 0]


@pytest.mark.parametrize("route", ["one_pass", "two_pass"])
def test_int8_dense_topk_matches_jax(route, monkeypatch):
    """``dense_topk`` over an int8 store: the masked quantized map and
    ``stable_topk`` below ``TWO_PASS_MIN_N`` rows (never the score+select
    kernel), the block-max two-pass route from there (patched to 512 in
    both packages); rows equal to JAX's ``dense_topk``."""
    if route == "two_pass":
        monkeypatch.setattr(jt, "TWO_PASS_MIN_N", 512)
        monkeypatch.setattr(tt, "TWO_PASS_MIN_N", 512)
    rng = np.random.default_rng(3)
    e8 = np.rint(unit(rng, 1024, 64) * 127).astype(np.int8)
    e8[700] = e8[100]                        # an exact tie across blocks
    q = rng.standard_normal((6, 64)).astype(np.float32)
    q[0] = e8[100] / 127.0
    ws, wi = jt.dense_topk(jnp.asarray(e8), jnp.asarray(q), 1000, 40)
    gs, gi = tt.dense_topk(t(e8), t(q), 1000, 40)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=0, atol=1e-6)
    gs2, gi2 = tt.score_select_topk(t(e8), t(q), 1000, 40)
    assert torch.equal(gi2, tt.stable_topk(tt.mask_cols(
        tt.dense_scores(t(e8), t(q)), 1000), 40)[1])


def test_dense_index_int8_methods_and_files_match_jax(tmp_path):
    """``DenseIndex(dtype="int8")``: add (in two parts, across a capacity
    step), topk, score_rows (a division by 127, as JAX's), save and load,
    with each package loading the other's file."""
    rng = np.random.default_rng(4)
    vec = unit(rng, 300, 64)
    vec[0, 0] = 1.5                          # clipped to 1 before scaling
    jd = JaxDense(64, "int8", capacity_round=128)
    td = DenseIndex(64, "int8", capacity_round=128, device="cpu")
    for part in (vec[:200], vec[200:]):
        jd.add(part)
        td.add(part)
    assert td.emb.dtype == torch.int8 and td.capacity == jd.capacity == 384
    np.testing.assert_array_equal(td.emb.numpy(), np.asarray(jd.emb))
    q = unit(rng, 5, 64)
    ws, wi = jd.topk(q, 10)
    gs, gi = td.topk(q, 10)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(gs, ws, atol=1e-6)
    rows = np.array([3, 250, 17, 299])
    np.testing.assert_allclose(td.score_rows(q[0], rows),
                               jd.score_rows(q[0], rows), atol=1e-6)
    td.save(tmp_path / "port.npz")
    jd.save(tmp_path / "jax.npz")
    assert np.array_equal(np.load(tmp_path / "port.npz")["emb"],
                          np.load(tmp_path / "jax.npz")["emb"])
    from_port = JaxDense.load(tmp_path / "port.npz", "int8", 128)
    from_jax = DenseIndex.load(tmp_path / "jax.npz", "int8", 128,
                               device="cpu")
    np.testing.assert_array_equal(np.asarray(from_port.emb), td.emb.numpy())
    np.testing.assert_array_equal(from_jax.emb.numpy(), np.asarray(jd.emb))


def test_int8_dense_store_never_casts_the_query():
    """Trap: ``q.to(torch.int8)`` truncates a unit query to zeros. The map
    mode's packed dense component at the final rows is JAX's quantized
    map value, not a dot with a zero query; the bf16 map and its exact
    rescore refuse an int8 store (JAX never writes that map for int8), and
    ``dense_topk_2pass(map_bf16=True)`` ignores the bf16 map there."""
    rng = np.random.default_rng(5)
    n, d, v, l_doc, dt, b, lq = 256, 32, 64, 8, 16, 4, 5
    e8 = np.rint(unit(rng, n, d) * 127).astype(np.int8)
    impact = np.abs(rng.standard_normal((v, n))).astype(np.float32)
    impact[:, 200:] = 0
    tok8 = np.clip(np.round(unit(rng, n, l_doc, dt) * 127), -127,
                   127).astype(np.int8)
    dmask = rng.random((n, l_doc)) < 0.8
    qvec = unit(rng, b, d)
    qtf = (rng.random((b, v)) < 0.1).astype(np.float32)
    q_tok = unit(rng, b, lq, dt)
    q_mask = rng.random((b, lq)) < 0.8
    q_mask[:, 0] = True
    jp = jfq.FusedParams(eff_k=32, final_k=16, rrf_k=60.0, alpha=0.5,
                         w_dense=0.6, w_bm25=0.4, w_late=0.35)
    want = jfq.fused_hybrid_topk(
        jnp.asarray(e8), jnp.asarray(impact), jnp.asarray(tok8),
        jnp.asarray(dmask), jnp.asarray(qvec), jnp.asarray(qtf),
        jnp.asarray(q_tok), jnp.asarray(q_mask), jnp.int32(200), jp)
    tp = tfq.FusedParams(eff_k=32, final_k=16, rrf_k=60.0, alpha=0.5,
                         w_dense=0.6, w_bm25=0.4, w_late=0.35)
    got = tfq.fused_hybrid_topk(t(e8), t(impact), t(tok8), t(dmask), t(qvec),
                                t(qtf), t(q_tok), t(q_mask), 200, tp)
    np.testing.assert_array_equal(got["rows"].numpy(),
                                  np.asarray(want["rows"]))
    np.testing.assert_allclose(got["packed"].numpy(),
                               np.asarray(want["packed"]), atol=1e-5)
    dense_at = tt.dense_scores(t(e8), t(qvec)).gather(1, got["rows"])
    assert torch.equal(got["packed"][..., 1], dense_at)  # not a zero query
    assert dense_at.abs().max() > 0.2
    with pytest.raises(TypeError):
        tt.rescore_exact(t(e8), t(qvec), torch.zeros(b, 4),
                         torch.zeros(b, 4, dtype=torch.int64))
    with pytest.raises(TypeError):
        tt.dense_scores_bf16(t(e8), t(qvec))
    a = tt.dense_topk_2pass(t(e8), t(qvec), 200, 10, block=64, map_bf16=True)
    c = tt.dense_topk_2pass(t(e8), t(qvec), 200, 10, block=64)
    assert torch.equal(a[0], c[0]) and torch.equal(a[1], c[1])


# ------------------------------------------------------------- MaxSim

def token_stores(store, seed=6):
    """A JAX and a port token index (int8 or nbit4) holding the same
    tokens: 90 docs of 12 tokens of dim 32, capacity 96."""
    tok, mask = clustered_tokens(90, 12, 32, seed)
    if store == "int8":
        j = JaxTokens(32, 12, "int8", capacity_round=32)
        p = TokenIndex(32, 12, "int8", capacity_round=32, device="cpu")
    else:
        j = JaxR4(32, 12, capacity_round=32)
        p = Residual4TokenIndex(32, 12, capacity_round=32, device="cpu")
    j.add(tok, mask)
    p.add(tok, mask)
    return j, p


@pytest.mark.parametrize("store", ["int8", "nbit4"])
def test_maxsim_functions_match_jax(store):
    """``maxsim_full`` (the kernel's plain version on the CPU),
    ``maxsim_candidates`` and ``maxsim_topk`` over an int8 and an nbit4
    store against JAX's, atol 1e-5; an empty doc scores 0; the index
    methods (``score_candidates``, ``topk``) agree too."""
    j, p = token_stores(store)
    rng = np.random.default_rng(7)
    q = unit(rng, 3, 6, 32)
    qm = rng.random((3, 6)) < 0.7
    qm[:, 0] = True
    want = np.asarray(jm.maxsim_full(j.tok, j.mask, jnp.asarray(q),
                                     jnp.asarray(qm), tile_n=32))
    got = tm.maxsim_full(p.tok, p.mask, t(q), t(qm)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert (got[:, 2] == 0).all()
    cand = rng.integers(0, 90, (3, 8))
    np.testing.assert_allclose(
        tm.maxsim_candidates(p.tok, p.mask, t(q), t(qm), t(cand)).numpy(),
        np.asarray(jm.maxsim_candidates(j.tok, j.mask, jnp.asarray(q),
                                        jnp.asarray(qm),
                                        jnp.asarray(cand, jnp.int32))),
        atol=1e-5)
    ws, wi = jm.maxsim_topk(j.tok, j.mask, jnp.asarray(q), jnp.asarray(qm),
                            85, 10, tile_n=32)
    gs, gi = tm.maxsim_topk(p.tok, p.mask, t(q), t(qm), 85, 10)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), atol=1e-5)
    np.testing.assert_allclose(p.score_candidates(q, qm, cand),
                               j.score_candidates(q, qm, cand), atol=1e-5)
    ws, wi = j.topk(q, qm, 7)
    gs, gi = p.topk(q, qm, 7)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(gs, ws, atol=1e-5)


def test_nbit4_dequant_is_the_host_reconstruction():
    """The plain dequant of a ``Residual4Store`` (what the kernel's staging
    computes: the product by scales / 7, then the sum, each rounded) equals
    the numpy reconstruction of JAX's ``dequantized_rows`` bit for bit;
    dim 2k comes from the high nibble."""
    j, p = token_stores("nbit4", seed=8)
    got = tm.dequant(p.tok).numpy()
    np.testing.assert_array_equal(got, p.dequantized()[0])
    np.testing.assert_allclose(got, j.dequantized()[0], atol=1e-6)
    packed = torch.tensor([[0x0F, 0x80]], dtype=torch.uint8)
    assert tm.unpack_nibbles(packed).tolist() == [[-8.0, 7.0, 0.0, -8.0]]


# ------------------------------------------------------- nbit4 store

def test_residual4_index_matches_jax_byte_for_byte(tmp_path):
    """``Residual4TokenIndex``: the k-means codebook (centroids, scales),
    ``codes_c`` and ``packed`` byte-equal to JAX's from the same tokens, an
    append encoded with the first add's codebook, ``dequantized_rows``
    within 1e-6, ``nbytes``, and save / load both ways (``TokenIndex.load``
    dispatches the payload)."""
    tok, mask = clustered_tokens(300, 16, 32, seed=9)
    j = JaxR4(32, 16, capacity_round=128)
    p = Residual4TokenIndex(32, 16, capacity_round=128, device="cpu")
    for part in (slice(0, 200), slice(200, 300)):
        j.add(tok[part], mask[part])
        p.add(tok[part], mask[part])
    np.testing.assert_array_equal(p.centroids, j.centroids)
    np.testing.assert_array_equal(p.scales, j.scales)
    for name in ("codes_c", "packed", "mask"):
        np.testing.assert_array_equal(getattr(p, name).numpy(),
                                      np.asarray(getattr(j, name)))
    assert (p.n, p.capacity, p.nbytes) == (j.n, j.capacity, j.nbytes)
    np.testing.assert_allclose(p.dequantized_rows(50, 250)[0],
                               j.dequantized_rows(50, 250)[0], atol=1e-6)
    p.save(tmp_path / "port.npz")
    j.save(tmp_path / "jax.npz")
    from_port = JaxTokens.load(tmp_path / "port.npz", capacity_round=128)
    from_jax = TokenIndex.load(tmp_path / "jax.npz", capacity_round=128,
                               device="cpu")
    assert isinstance(from_port, JaxR4)
    assert isinstance(from_jax, Residual4TokenIndex)
    for name in ("codes_c", "packed", "mask"):
        np.testing.assert_array_equal(np.asarray(getattr(from_port, name)),
                                      getattr(p, name).numpy())
        np.testing.assert_array_equal(getattr(from_jax, name).numpy(),
                                      np.asarray(getattr(j, name)))
    np.testing.assert_array_equal(from_jax.centroids, j.centroids)


@pytest.mark.parametrize("case", ["few_tokens", "subsampled"])
def test_residual4_training_branches_match_jax(case, monkeypatch):
    """The codebook's two edge branches, byte-equal to JAX's: fewer valid
    tokens than K centroids (the last one repeated to K) and more than
    ``TRAIN_SAMPLE`` (a seeded sample; patched to 500 in both classes)."""
    if case == "few_tokens":
        tok, mask = clustered_tokens(6, 8, 32, seed=10)
    else:
        monkeypatch.setattr(JaxR4, "TRAIN_SAMPLE", 500)
        monkeypatch.setattr(Residual4TokenIndex, "TRAIN_SAMPLE", 500)
        tok, mask = clustered_tokens(80, 16, 32, seed=11)
    j = JaxR4(32, tok.shape[1], capacity_round=8)
    p = Residual4TokenIndex(32, tok.shape[1], capacity_round=8, device="cpu")
    j.add(tok, mask)
    p.add(tok, mask)
    np.testing.assert_array_equal(p.centroids, j.centroids)
    np.testing.assert_array_equal(p.scales, j.scales)
    np.testing.assert_array_equal(p.packed.numpy(), np.asarray(j.packed))
    np.testing.assert_array_equal(p.codes_c.numpy(), np.asarray(j.codes_c))


def test_scale_point_runs_each_store_on_the_cpu(capsys):
    """``scale.py`` with the int8 dense store and the nbit4 token store at
    a tiny size on the CPU: the JSON line names the stores, the late
    recall is measured, and the nbit4 store is the one
    ``Residual4TokenIndex`` makes."""
    assert scale.main(["--device", "cpu", "--n-docs", "2048", "--vocab",
                       "1024", "--dim", "64", "--doc-len", "8",
                       "--token-dim", "32", "--iters", "1",
                       "--dense-dtype", "int8", "--token-dtype", "nbit4",
                       "--recall-queries", "64"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    import json

    res = json.loads(line)
    assert (res["dense_dtype"], res["token_dtype"]) == ("int8", "nbit4")
    assert 0.5 <= res["late_recall@10"] <= 1.0
    idx = scale.synthesize_index(512, 256, 64, 8, 32, device="cpu",
                                 token_dtype="nbit4", gold_rows=4)
    assert isinstance(idx.doc_tok, tm.Residual4Store)
    assert idx.emb.dtype == torch.bfloat16 and idx.gold[1].shape == (4, 8, 32)
    cpu = idx.to("cpu")
    assert torch.equal(cpu.doc_tok.packed, idx.doc_tok.packed)
