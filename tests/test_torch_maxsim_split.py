"""The arithmetic of MaxSim's int8 route on the tensor cores
(``legalrag_tpu_torch/csrc/maxsim.cu``, ``maxsim_bf16_kernel<int8, DT>``),
emulated here on the CPU and held against the JAX package's
``maxsim_full`` (XLA: ``x * (1/127)`` widened, float32 einsum) over the same
int8 store, with inputs made from a numpy seed.

The kernel splits each float32 query element into two bf16 parts, both
rounded to nearest even: ``hi = bf16(q)``, ``lo = bf16(q - hi)``. Each
product ``lo * code`` and ``hi * code`` is exact in float32 (8 + 8
significant bits), the two go into one float32 sum, each row maximum over a
doc's valid tokens is scaled by ``1/127``, masked query slots add 0, an
empty doc scores 0, and one lane sums a query's best matches in token
order. The emulation below does the same with torch's bf16 casts (round to
nearest even) and float32 sums in another order.

Tolerances: ``hi + lo`` is ``q`` within ``2**-16 * |q|`` per element (bf16
keeps 8 significant bits, so each rounding leaves at most ``2**-8`` of
what it rounds); the emulated map is JAX's within atol 1e-5 (the split's
residue, at most ``2**-16`` of a unit dot, and float32 sums in another
order) and so is the port's plain version on the CPU, which the kernel is
held to on the card. The hash encoder's tokens are sparse (one to a few
entries of +-1/sqrt(k)), so their residues repeat and add up over a
query's tokens instead of cancelling: there the emulated map is held to
the split's own bound, which exceeds 1e-5 (on an H100 the Civil Code
store's map is 6.1e-5 off the plain version)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legalrag_tpu.ops import maxsim as jm
from legalrag_tpu_torch.index.token_index import quantize_int8
from legalrag_tpu_torch.ops import maxsim as tm

SPLIT_SLOTS = 32  # query slots the int8 instance holds: longer queries take its long path


def unit(rng, *shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def split_bf16(q: torch.Tensor):
    """The kernel's split of float32 queries: (hi, lo) as float32 values
    that bf16 holds exactly."""
    hi = q.to(torch.bfloat16).float()
    lo = (q - hi).to(torch.bfloat16).float()
    return hi, lo


def split_maxsim(codes: torch.Tensor, dmask: torch.Tensor, q: torch.Tensor,
                 qmask: torch.Tensor) -> torch.Tensor:
    """[B, N] MaxSim as the int8 instance computes it: exact lo and hi
    products summed in float32, the row max scaled by 1/127, each query's
    best matches summed in token order."""
    hi, lo = split_bf16(q)
    c = codes.float()
    dots = (torch.einsum("bqd,nld->bnql", lo, c)
            + torch.einsum("bqd,nld->bnql", hi, c))
    dots = dots.masked_fill(~dmask[None, :, None, :], float("-inf"))
    best = dots.amax(dim=-1) * np.float32(1.0 / 127.0)       # [B, N, Lq]
    best = torch.where(dmask.any(dim=1)[None, :, None], best, 0.0)
    best = torch.where(qmask[:, None, :], best, 0.0)
    total = torch.zeros(best.shape[:2], dtype=torch.float32)
    for i in range(best.shape[2]):                           # token order
        total = total + best[:, :, i]
    return total


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
    """hi and lo are bf16 values (a second cast changes nothing) and
    ``hi + lo`` is ``q`` within ``2**-16 * |q|`` per element; the products
    of either part with an int8 code are exact in float32."""
    rng = np.random.default_rng(dt)
    q = torch.from_numpy(np.concatenate([
        unit(rng, 64, dt), 100.0 * unit(rng, 4, dt),
        1e-3 * unit(rng, 4, dt)]))
    hi, lo = split_bf16(q)
    for part in (hi, lo):
        assert torch.equal(part.to(torch.bfloat16).float(), part)
    assert bool(((q - (hi + lo)).abs() <= 2.0 ** -16 * q.abs()).all())
    codes = torch.arange(-127, 128, dtype=torch.float32)
    for part in (hi, lo):
        prod = part.reshape(-1, 1) * codes
        assert torch.equal(prod.double(),
                           part.double().reshape(-1, 1) * codes.double())


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


@pytest.mark.parametrize("dt", [32, 64, 128])
def test_split_residue_stays_within_its_bound_on_sparse_tokens(dt):
    """Queries made of a doc's own sparse tokens (self-retrieval): the
    emulated int8 instance is the exact map within the split's bound,
    sum over valid query tokens of 2**-16 * max_j sum_c |q_c| |code_jc| /
    127 (each part's rounding leaves 2**-8 of what it rounds) plus float32
    rounding, and JAX's map is the exact one within float32 rounding."""
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
    bound = (torch.where(qm[:, None, :], mag, 0.0).sum(-1) * 2.0 ** -16
             + 1e-6 * (1.0 + exact.abs()))
    assert bool(((got - exact).abs() <= bound).all())
    np.testing.assert_allclose(want, exact.numpy(), rtol=1e-6, atol=1e-6)
    assert (got[:, 5] == 0).all()
