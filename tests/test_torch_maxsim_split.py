"""The arithmetic of MaxSim's int8 route on the tensor cores
(``legalrag_tpu_torch/csrc/maxsim.cu``, ``maxsim_tc_kernel<int8, DT>``),
emulated here on the CPU and held against the JAX package's
``maxsim_full`` (XLA: ``x * (1/127)`` widened, float32 einsum) over the same
int8 store, with inputs made from a numpy seed.

The kernel scales each float32 query by the power of two ``2**e`` that
brings the largest magnitude among its valid tokens' elements into
``[2**14, 2**15)``, and splits each scaled element into two fp16 parts, both rounded
to nearest even: ``hi = fp16(x 2**e)``, ``lo = fp16(x 2**e - hi)``. Each
product ``lo * code`` and ``hi * code`` is exact in float32 (11 + 8
significant bits), the two go into one float32 sum, each row maximum over a
doc's valid tokens is scaled by ``2**-e / 127``, masked query slots add 0,
an empty doc scores 0, and one lane sums a query's best matches in float64
and rounds once. The emulation below does the same with torch's fp16 casts
(round to nearest even, subnormals kept) and float32 sums in another
order.

Tolerances: ``hi + lo`` is ``x 2**e`` within ``2**-22 * |x 2**e|`` per
element where ``lo`` is a normal fp16 value (fp16 keeps 11 significant bits,
so each rounding leaves at most ``2**-11`` of what it rounds), and within
fp16's subnormal spacing ``2**-24`` (``2**-38`` of the query's largest
element) below; the emulated map is JAX's within atol 1e-5 on dense unit
tokens and on the hash encoder's sparse ones (one to a few entries of
+-1/sqrt(k)), whose residues repeat with one sign over a query's tokens:
there a split into two bf16 parts (8 significant bits, the kernel before
it took fp16) leaves ``2**-16`` of each element and, on an H100, put the
Civil Code store's map 6.1e-5 off the plain version. Summing the best
matches in float32 in token order would itself leave up to ~1e-5 at these
scores (near 30); JAX's own float32 sum is ~5e-6 off the exact one."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legalrag_tpu.ops import maxsim as jm
from legalrag_tpu_torch.index.token_index import (
    Residual4TokenIndex,
    quantize_int8,
)
from legalrag_tpu_torch.ops import maxsim as tm

SPLIT_SLOTS = 32  # query slots a split instance holds: longer queries take its long path


def unit(rng, *shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def query_exponent(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The kernel's exponent e of each query (int32 [..., 1, 1]) from x
    [..., Lq, dt] and its token mask [..., Lq]: 14 - floor(log2 m) for the
    largest magnitude m of its valid tokens' elements, at most 126 (m zero
    or subnormal)."""
    m = torch.where(mask[..., None], x.abs(), 0.0).amax(dim=(-2, -1),
                                                         keepdim=True)
    return torch.clamp(141 - (m.view(torch.int32) >> 23), max=126)


def split_f16(x: torch.Tensor, mask: torch.Tensor):
    """The kernel's split of float32 queries x [..., Lq, dt] with token
    mask [..., Lq]: (hi, lo, back) with hi and lo float32 values that fp16
    holds exactly, hi + lo ~ x * 2**e, and back = 2**-e per query."""
    e = query_exponent(x, mask).float()
    y = x * torch.pow(2.0, e)
    hi = y.half().float()
    lo = (y - hi).half().float()
    return hi, lo, torch.pow(2.0, -e)


def split_rows(x: torch.Tensor):
    """``split_f16`` of rows [n, dt], each row a one-token query."""
    hi, lo, back = split_f16(x[:, None, :], torch.ones(x.shape[0], 1,
                                                       dtype=torch.bool))
    return hi[:, 0], lo[:, 0], back[:, 0]


def sum_tokens(best: torch.Tensor) -> torch.Tensor:
    """[B, N, Lq] best matches (0 where masked) -> [B, N] float32, summed in
    float64 and rounded once, as the split instances sum them."""
    return best.double().sum(dim=-1).float()


def split_maxsim(codes: torch.Tensor, dmask: torch.Tensor, q: torch.Tensor,
                 qmask: torch.Tensor) -> torch.Tensor:
    """[B, N] MaxSim as the int8 instance computes it: exact lo and hi
    products summed in float32, the row max scaled by 2**-e / 127 (e the
    query's exponent), each query's best matches summed in float64."""
    hi, lo, back = split_f16(q, qmask)
    c = codes.float()
    dots = (torch.einsum("bqd,nld->bnql", lo, c)
            + torch.einsum("bqd,nld->bnql", hi, c))
    dots = dots.masked_fill(~dmask[None, :, None, :], float("-inf"))
    scale = back[:, None, :, 0] * np.float32(1.0 / 127.0)    # [B, 1, 1]
    best = dots.amax(dim=-1) * scale                         # [B, N, Lq]
    best = torch.where(dmask.any(dim=1)[None, :, None], best, 0.0)
    best = torch.where(qmask[:, None, :], best, 0.0)
    return sum_tokens(best)


def int8_inputs(dt: int, long_query: bool, seed: int):
    """An int8 store of 64 docs x 20 tokens (doc 2 empty, doc 3's valid
    tokens not a prefix, doc 4 with one token) and 5 float32 unit queries
    of Lq 40 with masks that are not a prefix; with ``long_query`` query 1
    has every slot valid (more than the instance's 32) and query 4 has 33."""
    rng = np.random.default_rng(seed)
    n, l_doc, b, lq = 64, 20, 5, 40
    codes = quantize_int8(unit(rng, n, l_doc, dt))
    dmask = rng.random((n, l_doc)) < 0.7
    dmask[:, 0] = True
    dmask[2] = False
    dmask[3] = np.arange(l_doc) % 3 == 1
    dmask[4] = np.arange(l_doc) == 11
    q = unit(rng, b, lq, dt)
    qmask = rng.random((b, lq)) < 0.5
    qmask[:, 0] = True
    qmask[0, 1::2] = False
    qmask[2] = False                      # a query with no valid token
    if long_query:
        qmask[1] = True
        qmask[4] = np.arange(lq) < 33
    else:
        qmask[:, SPLIT_SLOTS:] = False
    return codes, dmask, q, qmask


@pytest.mark.parametrize("dt", [32, 64, 128])
def test_split_parts_reconstruct_the_query(dt):
    """hi and lo are fp16 values (a second cast changes nothing), the
    scaled row's largest element lies in [2**14, 2**15], ``hi + lo`` is
    ``x 2**e`` within ``2**-22 * |x 2**e|`` per element (or fp16's
    subnormal spacing, for elements 2**17 below the row's largest), and
    the products of either part with an int8 code are exact in float32."""
    rng = np.random.default_rng(dt)
    q = torch.from_numpy(np.concatenate([
        unit(rng, 64, dt), 100.0 * unit(rng, 4, dt),
        1e-3 * unit(rng, 4, dt)]))
    hi, lo, back = split_rows(q)
    for part in (hi, lo):
        assert torch.equal(part.half().float(), part)
    y = q / back
    top = y.abs().amax(dim=-1)
    assert bool(((top >= 2.0 ** 14) & (top <= 2.0 ** 15)).all())
    assert bool(((y - (hi + lo)).abs()
                 <= torch.maximum(2.0 ** -22 * y.abs(),
                                  torch.full_like(y, 2.0 ** -25))).all())
    codes = torch.arange(-127, 128, dtype=torch.float32)
    for part in (hi, lo):
        prod = part.reshape(-1, 1) * codes
        assert torch.equal(prod.double(),
                           part.double().reshape(-1, 1) * codes.double())


@pytest.mark.parametrize("log2_mag", [None, -140, -100, -30, 30, 100])
def test_split_scale_keeps_rows_of_any_magnitude_in_fp16_range(log2_mag):
    """The row scale's range edges: rows of unit tokens times 2**k (k = -140
    is below float32's smallest normal, so e stops at 126; None is a row of
    zeros) scale to finite fp16 parts, the largest scaled element at most
    2**15 (fp16's largest finite value is 65504), and ``(hi + lo) * 2**-e``
    is the row within 2**-22 of each element or 2**-38 of the row's
    largest; 2**e and 2**-e are normal floats."""
    rng = np.random.default_rng(7)
    q = torch.from_numpy(unit(rng, 16, 128))
    q = q * 0.0 if log2_mag is None else q * 2.0 ** log2_mag
    e = query_exponent(q[:, None, :], torch.ones(16, 1, dtype=torch.bool))
    assert bool(((e >= -126) & (e <= 126)).all())
    hi, lo, back = split_rows(q)
    assert bool(torch.isfinite(hi).all() and torch.isfinite(lo).all())
    assert bool((hi.abs().amax(dim=-1) <= 2.0 ** 15).all())
    assert bool((back > 0).all() and torch.isfinite(1 / back).all())
    top = q.abs().amax(dim=-1, keepdim=True)
    err = ((hi + lo).double() * back.double() - q.double()).abs()
    assert bool((err <= 2.0 ** -22 * q.double().abs()
                 + 2.0 ** -38 * top.double()).all())
    if log2_mag is None:
        assert bool((hi == 0).all() and (lo == 0).all())


@pytest.mark.parametrize("long_query", [False, True],
                         ids=["short_queries", "long_query"])
@pytest.mark.parametrize("dt", [32, 64, 128])
def test_split_maxsim_matches_jax_on_an_int8_store(dt, long_query):
    """The emulated int8 instance against JAX's ``maxsim_full`` and the
    port's plain version over the same int8 store, atol 1e-5, at every
    token_dim the kernel takes, with and without queries longer than its
    32 slots; the empty doc and the query with no valid token score 0."""
    codes, dmask, q, qmask = int8_inputs(dt, long_query, seed=dt + long_query)
    want = np.asarray(jm.maxsim_full(jnp.asarray(codes), jnp.asarray(dmask),
                                     jnp.asarray(q), jnp.asarray(qmask),
                                     tile_n=codes.shape[0]))
    got = split_maxsim(torch.from_numpy(codes), torch.from_numpy(dmask),
                       torch.from_numpy(q), torch.from_numpy(qmask)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    plain = tm.maxsim_full(torch.from_numpy(codes), torch.from_numpy(dmask),
                           torch.from_numpy(q), torch.from_numpy(qmask))
    np.testing.assert_allclose(got, plain.numpy(), rtol=0, atol=1e-5)
    assert (got[:, 2] == 0).all() and (got[2] == 0).all()
    assert (qmask.sum(axis=1) > SPLIT_SLOTS).any() == long_query


def sparse_tokens(rng, n: int, dt: int) -> np.ndarray:
    """n unit tokens of k in {1, 2, 3} entries +-1/sqrt(k), as the hash
    encoder makes them (``models/hash_encoder.py:_token_vec``)."""
    out = np.zeros((n, dt), np.float32)
    for row, k in zip(out, rng.integers(1, 4, n)):
        row[rng.choice(dt, k, replace=False)] = rng.choice([-1.0, 1.0], k)
    return out / np.linalg.norm(out, axis=1, keepdims=True)


def sparse_inputs(dt: int):
    """An int8 store of the hash encoder's sparse tokens (48 docs x 24,
    doc 5 empty) and 6 queries of Lq 48 made of two docs' own tokens
    (self-retrieval), normalized."""
    rng = np.random.default_rng(100 + dt)
    n, l_doc, b = 48, 24, 6
    vocab = sparse_tokens(rng, 200, dt)
    codes = quantize_int8(vocab[rng.integers(0, 200, (n, l_doc))])
    dmask = rng.random((n, l_doc)) < 0.9
    dmask[5] = False
    q = np.stack([np.concatenate([codes[i], codes[i + 1]]) / 127.0
                  for i in range(b)]).astype(np.float32)       # Lq 48
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    qmask = rng.random(q.shape[:2]) < 0.9
    return codes, dmask, q, qmask


@pytest.mark.parametrize("dt", [32, 64, 128])
def test_split_residue_stays_within_its_bound_on_sparse_tokens(dt):
    """Queries made of a doc's own sparse tokens (self-retrieval): the
    emulated int8 instance is the exact map within the split's bound, sum
    over valid query tokens of 2**-22 * max_j sum_c |q_c| |code_jc| / 127
    plus float32 rounding, and JAX's map within atol 1e-5 (which the
    bf16 split missed on these tokens); JAX's map is the exact one within
    float32 rounding."""
    codes, dmask, q, qmask = sparse_inputs(dt)
    n = codes.shape[0]
    got = split_maxsim(torch.from_numpy(codes), torch.from_numpy(dmask),
                       torch.from_numpy(q), torch.from_numpy(qmask)).double()
    want = np.asarray(jm.maxsim_full(jnp.asarray(codes), jnp.asarray(dmask),
                                     jnp.asarray(q), jnp.asarray(qmask),
                                     tile_n=n), np.float64)
    c64, q64 = torch.from_numpy(codes).double(), torch.from_numpy(q).double()
    dm, qm = torch.from_numpy(dmask), torch.from_numpy(qmask)
    dots = torch.einsum("bqd,nld->bnql", q64, c64) / 127.0
    exact = dots.masked_fill(~dm[None, :, None, :], float("-inf")).amax(-1)
    exact = torch.where(dm.any(1)[None, :, None], exact, 0.0)
    exact = torch.where(qm[:, None, :], exact, 0.0).sum(-1)
    mag = torch.einsum("bqd,nld->bnql", q64.abs(), c64.abs()) / 127.0
    mag = mag.masked_fill(~dm[None, :, None, :], 0.0).amax(-1)
    bound = (torch.where(qm[:, None, :], mag, 0.0).sum(-1) * 2.0 ** -22
             + 1e-6 * (1.0 + exact.abs()))
    assert bool(((got - exact).abs() <= bound).all())
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(want, exact.numpy(), rtol=1e-6, atol=1e-6)
    assert (got[:, 5] == 0).all()


# ------------------------------------------------------------------ nbit4
#
# The nbit4 instance (``maxsim_tc_kernel<nbit4, DT>``) splits each dot
# with a decoded token ``centroids[c] + (n - 8) * step`` (``step = scales /
# 7``) into a centroid term and a residual term:
#
#     q . d = T[q, c] + sum_k (q_k step_k) (n_k - 8),   T = q . centroids^T.
#
# T [256, B * Lq] is computed per call by ``maxsim_centroid_table_kernel``
# (float32 FMAs in k order). The residual term runs as the int8 instance's
# products: x = q * step (rounded once), scaled per query and split into
# fp16 parts, times the nibble factors n - 8 (exact in fp16: the producer
# warps build each as the fp16 bits of 1024 + n less 1032); each element of
# a doc's token columns is then T + 2**-e * acc, rounded once, before the
# row maximum. JAX instead rounds each decoded value (its product and its
# sum) and takes float32 dots.


def nbit4_store(rng, n: int, l_doc: int, dt: int, dmask: np.ndarray):
    """The port's ``Residual4TokenIndex`` store (trained and encoded on the
    CPU) of n docs of unit tokens."""
    idx = Residual4TokenIndex(dt, l_doc, capacity_round=n, device="cpu")
    idx.add(unit(rng, n, l_doc, dt), dmask)
    return idx.tok


def jax_store(store):
    return jm.Residual4Store(*(jnp.asarray(t.numpy()) for t in (
        store.codes_c, store.packed, store.centroids, store.scales)))


def nbit4_maxsim(store, dmask: torch.Tensor, q: torch.Tensor,
                 qmask: torch.Tensor) -> torch.Tensor:
    """[B, N] MaxSim as the nbit4 instance computes it."""
    x = q * store.step                                   # [B, Lq, dt]
    hi, lo, back = split_f16(x, qmask)
    nib = tm.unpack_nibbles(store.packed)                # [N, L, dt], n - 8
    acc = (torch.einsum("bqd,nld->bnql", lo, nib)
           + torch.einsum("bqd,nld->bnql", hi, nib))     # [B, N, Lq, L]
    table = torch.einsum("bqd,cd->bqc", q, store.centroids)  # [B, Lq, 256]
    cent = table[:, :, store.codes_c.long()]             # [B, Lq, N, L]
    val = cent.permute(0, 2, 1, 3) + acc * back[:, :, :, None]
    val = val.masked_fill(~dmask[None, :, None, :], float("-inf"))
    best = val.amax(dim=-1)                              # [B, N, Lq]
    best = torch.where(dmask.any(dim=1)[None, :, None], best, 0.0)
    best = torch.where(qmask[:, None, :], best, 0.0)
    return sum_tokens(best)


def nbit4_inputs(dt: int, long_query: bool, seed: int):
    """An nbit4 store of 64 docs x 20 tokens built by the port's
    ``Residual4TokenIndex`` (doc 2 empty, doc 3's valid tokens not a
    prefix, doc 4 with one token, masked tokens with arbitrary centroid
    ids) and 5 float32 unit queries as ``int8_inputs`` makes them."""
    rng = np.random.default_rng(seed)
    n, l_doc, b, lq = 64, 20, 5, 40
    dmask = rng.random((n, l_doc)) < 0.7
    dmask[:, 0] = True
    dmask[2] = False
    dmask[3] = np.arange(l_doc) % 3 == 1
    dmask[4] = np.arange(l_doc) == 11
    store = nbit4_store(rng, n, l_doc, dt, dmask)
    codes = store.codes_c.clone()
    pad = torch.from_numpy(~dmask)
    codes[pad] = torch.from_numpy(
        rng.integers(0, 256, int(pad.sum()))).to(torch.uint8)
    store = store._replace(codes_c=codes)
    _, _, q, qmask = int8_inputs(dt, long_query, seed)
    return store, dmask, q, qmask


def check_nbit4(store, dmask, q, qmask, atol=1e-5):
    """The emulated nbit4 instance against JAX's ``maxsim_full`` and the
    port's plain version on the same store; returns the emulated map."""
    want = np.asarray(jm.maxsim_full(jax_store(store), jnp.asarray(dmask),
                                     jnp.asarray(q), jnp.asarray(qmask),
                                     tile_n=dmask.shape[0]))
    dm, qt, qm = (torch.from_numpy(a) for a in (dmask, q, qmask))
    got = nbit4_maxsim(store, dm, qt, qm).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    plain = tm.maxsim_full(store, dm, qt, qm).numpy()
    np.testing.assert_allclose(got, plain, rtol=0, atol=atol)
    return got


def test_nbit4_nibble_factors_are_exact_in_fp16():
    """Every packed byte widens to the nibble factors n - 8 of its two
    dims (high nibble first) through the fp16 bits of 1024 + n less 1032,
    exactly; and the product of either fp16 part of a split element with
    any factor is exact in float32."""
    byte = torch.arange(256, dtype=torch.int32)
    for nib, dim in ((byte >> 4, 0), (byte & 0xF, 1)):
        h = (0x6400 | nib).to(torch.int16).view(torch.float16)
        got = (h - torch.tensor(1032.0, dtype=torch.float16)).float()
        assert torch.equal(got, nib.float() - 8)
        want = tm.unpack_nibbles(byte.to(torch.uint8)[:, None])[:, dim]
        assert torch.equal(got, want)
    rng = np.random.default_rng(3)
    hi, lo, _ = split_rows(torch.from_numpy(unit(rng, 32, 128)))
    f = torch.arange(-8, 8, dtype=torch.float64)
    for part in (hi, lo):
        prod = part.reshape(-1, 1) * f.float()
        assert torch.equal(prod.double(), part.double().reshape(-1, 1) * f)


@pytest.mark.parametrize("long_query", [False, True],
                         ids=["short_queries", "long_query"])
@pytest.mark.parametrize("dt", [32, 64, 128])
def test_nbit4_split_matches_jax_on_a_residual4_store(dt, long_query):
    """The emulated nbit4 instance against JAX's ``maxsim_full`` and the
    port's plain version over a store from ``Residual4TokenIndex``, atol
    1e-5, at every token_dim, with and without queries longer than the
    instance's 32 slots; masked tokens' centroid ids change nothing; the
    empty doc and the query with no valid token score 0."""
    store, dmask, q, qmask = nbit4_inputs(dt, long_query, seed=30 + dt)
    got = check_nbit4(store, dmask, q, qmask)
    assert (got[:, 2] == 0).all() and (got[2] == 0).all()
    zeroed = store._replace(codes_c=torch.where(
        torch.from_numpy(dmask), store.codes_c, torch.zeros_like(store.codes_c)))
    again = nbit4_maxsim(zeroed, *(torch.from_numpy(a)
                                   for a in (dmask, q, qmask))).numpy()
    assert np.array_equal(got, again)
    assert (qmask.sum(axis=1) > SPLIT_SLOTS).any() == long_query


@pytest.mark.parametrize("dt", [32, 64, 128])
def test_nbit4_zero_scale_dims_match_jax(dt):
    """Dimensions whose residual scale is 0 (their step 0, so the nibbles
    add nothing there) and the hash encoder's sparse queries, whose
    elements q * step are zero off one to three dims: the emulated instance
    is JAX's map within atol 1e-5."""
    store, dmask, _q, qmask = nbit4_inputs(dt, True, seed=60 + dt)
    dead = torch.arange(dt) % 5 == 2
    store = store._replace(scales=torch.where(dead, 0.0, store.scales),
                           step=torch.where(dead, 0.0, store.step))
    rng = np.random.default_rng(dt)
    vocab = sparse_tokens(rng, 100, dt)
    q = vocab[rng.integers(0, 100, qmask.shape)]
    check_nbit4(store, dmask, q, qmask)


@pytest.mark.parametrize("log2_mag", [-100, -30, 30, 60])
def test_nbit4_scale_range_edges_match_jax(log2_mag):
    """Queries of unit tokens times 2**k: the per-query scale keeps the
    fp16 parts finite and normal where it matters, so the emulated map over
    2**k is JAX's over 2**k within 1e-5 (both scale exactly by powers of
    two); one query mixes a unit token with tokens 2**-30 smaller."""
    store, dmask, q, qmask = nbit4_inputs(64, True, seed=90)
    q = q.copy()
    q[3, 1:] *= 2.0 ** -30
    qmask[3, :4] = True
    s = 2.0 ** log2_mag
    want = np.asarray(jm.maxsim_full(jax_store(store), jnp.asarray(dmask),
                                     jnp.asarray(q * s), jnp.asarray(qmask),
                                     tile_n=dmask.shape[0]), np.float64)
    got = nbit4_maxsim(store, *(torch.from_numpy(a) for a in (
        dmask, (q * s).astype(np.float32), qmask))).double().numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got / s, want / s, rtol=0, atol=1e-5)
