"""The paged engine's host tree and its pools, held to the JAX package's
(``legalrag_tpu/models/paged_decoder.py``) exactly, on the CPU.

- ``_RadixIndex``: a seeded random sequence of admissions (match, incref,
  reservation, alloc with eviction, publish) and releases (decref, frees,
  the reservation's rest), the whole state compared after every step: the
  tree with its block ids and refcounts, the free list in order, the LRU
  of refcount-0 nodes in order, reserved, available, and the reused and
  evicted counts.
- ``_gather_pools`` / ``_scatter_pools``: random pools in bfloat16,
  float32 and the int8 cache's 4-tuple, tables with shared blocks and
  sentinel entries, windows clamped onto a block that two slots share:
  the gathered views and the written pools bit for bit JAX's.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legalrag_tpu.models import paged_decoder as jpd
from legalrag_tpu_torch.models import paged_decoder as tpd


def snapshot(r) -> dict:
    def tree(n):
        return {k: (c.block_id, c.refs, tree(c))
                for k, c in sorted(n.children.items())}

    def keys(n):
        out = []
        while n.parent is not None:
            out.append(n.key)
            n = n.parent
        return tuple(reversed(out))

    return {"tree": tree(r.root), "free": list(r.free),
            "lru": [keys(n) for n in r.zeroref], "reserved": r.reserved,
            "available": r.available(), "evictable": r.evictable,
            "reused": r.reused_blocks, "evicted": r.evicted_blocks}


class Stream:
    """One admitted stream as the engine books it, in one tree."""

    def __init__(self, path, private, reserve):
        self.path, self.private, self.reserve = path, private, reserve


def admit(r, ids, bs, extra):
    """The engine's admission against tree ``r``: None when it does not
    fit, else the stream with its prompt's blocks allocated and its new
    full blocks published."""
    path = r.match(ids)
    r.incref(path)
    need = -(-(len(ids) + extra) // bs) - len(path)
    if r.available() < need:
        r.decref(path)
        return None
    r.reserved += need
    r.reused_blocks += len(path)
    st = Stream(path, [], need)
    for _ in range(-(-(len(ids) - len(path) * bs) // bs)):
        grow(r, st)
    parent = path[-1] if path else r.root
    pub = list(st.private)
    for j in range(len(path), len(ids) // bs):
        bid = pub.pop(0)
        node = r.publish(parent, tuple(ids[j * bs:(j + 1) * bs]), bid)
        if node is None:
            break
        st.private.remove(bid)
        st.path.append(node)
        parent = node
    return st


def grow(r, st):
    st.private.append(r.alloc())
    r.reserved -= 1
    st.reserve -= 1


def release(r, st):
    r.decref(st.path)
    r.free.extend(st.private)
    r.reserved -= st.reserve


@pytest.mark.parametrize("seed,bs,n_blocks", [(0, 4, 12), (1, 4, 20),
                                              (2, 8, 9), (3, 2, 16)])
def test_radix_index_matches_jax_step_by_step(seed, bs, n_blocks):
    rng = np.random.default_rng(seed)
    trees = (tpd._RadixIndex(n_blocks, bs), jpd._RadixIndex(n_blocks, bs))
    # a few chunk templates, so prompts share prefixes and diverge
    chunks = [list(rng.integers(1, 5, bs)) for _ in range(4)]
    live = []                                 # (port stream, JAX stream)
    counts = {"admitted": 0, "waited": 0, "released": 0}
    for _ in range(300):
        op = rng.random()
        if op < 0.5 or not live:
            ids = sum((chunks[i] for i in rng.integers(0, 4,
                                                       rng.integers(0, 4))),
                      []) + list(rng.integers(1, 5, rng.integers(1, bs + 1)))
            extra = int(rng.integers(0, 2 * bs))
            got = [admit(r, ids, bs, extra) for r in trees]
            assert (got[0] is None) == (got[1] is None)
            if got[0] is None:
                counts["waited"] += 1
            else:
                counts["admitted"] += 1
                live.append(tuple(got))
        elif op < 0.7:
            pair = live[int(rng.integers(len(live)))]
            if pair[0].reserve:
                for r, st in zip(trees, pair):
                    grow(r, st)
        else:
            pair = live.pop(int(rng.integers(len(live))))
            for r, st in zip(trees, pair):
                release(r, st)
            counts["released"] += 1
        assert snapshot(trees[0]) == snapshot(trees[1])
        for port_st, jax_st in live:
            assert ([n.block_id for n in port_st.path], port_st.private,
                    port_st.reserve) == ([n.block_id for n in jax_st.path],
                                         jax_st.private, jax_st.reserve)
    assert trees[0].reused_blocks > 0 and trees[0].evicted_blocks > 0
    assert min(counts.values()) > 0, counts


def test_radix_exhaustion_raises_like_jax():
    for mod in (tpd, jpd):
        r = mod._RadixIndex(2, 4)
        r.alloc()
        r.alloc()
        with pytest.raises(RuntimeError, match="exhausted"):
            r.alloc()


NB, BS, MAXB, W = 12, 4, 6, 4
# slots 0 and 1 share blocks 0-2; their windows, clamped to MAXB - W = 2,
# both start on the shared block 2; slot 2 is short, slot 3 empty
TABLES = np.array([[0, 1, 2, 3, 4, NB], [0, 1, 2, 5, NB, NB],
                   [6, 7, NB, NB, NB, NB], [NB] * MAXB], np.int32)
WRITE_FROM = [17, 13, 5, 0]        # each slot's first written row
BLK_LO = np.array([min(p // BS, MAXB - W) for p in WRITE_FROM], np.int32)


def random_pools(rng, kind: str):
    """One layer's pools as numpy arrays (bf16 values exact in float32)."""
    shape = (NB, BS, 2, 8)
    if kind == "kv_quant":
        return (rng.integers(-127, 128, shape).astype(np.int8),
                rng.integers(-127, 128, shape).astype(np.int8),
                rng.random(shape[:3] + (1,)).astype(np.float32),
                rng.random(shape[:3] + (1,)).astype(np.float32))
    vals = [rng.standard_normal(shape).astype(np.float32) for _ in range(2)]
    if kind == "bfloat16":
        vals = [torch.from_numpy(v).bfloat16().float().numpy() for v in vals]
    return tuple(vals)


def to_jax(a, kind):
    return jnp.asarray(a, jnp.bfloat16 if kind == "bfloat16"
                       and a.dtype == np.float32 else a.dtype)


def to_port(a, kind, scratch=False):
    t = torch.from_numpy(np.ascontiguousarray(a))
    if kind == "bfloat16" and t.dtype == torch.float32:
        t = t.bfloat16()
    if scratch:   # the port's pools hold the scratch block at NB
        t = torch.cat([t, torch.full_like(t[:1], 7)])
    return t


def to_numpy(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


@pytest.mark.parametrize("kind", ["bfloat16", "float32", "kv_quant"])
def test_gather_and_scatter_pools_match_jax(kind):
    rng = np.random.default_rng(5)
    layers = [random_pools(rng, kind) for _ in range(2)]
    jax_pools = [tuple(to_jax(a, kind) for a in layer) for layer in layers]
    port_pools = [tuple(to_port(a, kind, scratch=True) for a in layer)
                  for layer in layers]
    jself = SimpleNamespace(block_size=BS)
    pself = SimpleNamespace(block_size=BS, n_blocks=NB, maxb=MAXB)
    tables = torch.from_numpy(TABLES.astype(np.int64))
    jviews = jpd.PagedDecoderLM._gather_pools(jself, jax_pools,
                                              jnp.asarray(TABLES))
    pviews = tpd.TorchPagedDecoderLM._gather_pools(pself, port_pools, tables)
    for jl, pl in zip(jviews, pviews):
        for j, p in zip(jl, pl):
            assert p.shape == (4, MAXB * BS) + j.shape[2:]
            np.testing.assert_array_equal(to_numpy(p),
                                          np.asarray(j, np.float32)
                                          if kind == "bfloat16"
                                          else np.asarray(j))
    # the launch's writes: every slot's rows from its first written one
    new = []
    for layer in jviews:
        out = []
        for a in layer:
            a = np.array(a.astype(jnp.float32) if kind == "bfloat16" else a)
            for s, p in enumerate(WRITE_FROM):
                fresh = random_pools(rng, kind)[0][:1, :1, :, :a.shape[-1]]
                a[s, p:] = np.broadcast_to(fresh[0, 0],
                                           a[s, p:].shape).astype(a.dtype)
            out.append(a)
        new.append(tuple(out))
    jgot = jpd.PagedDecoderLM._scatter_pools(
        jself, jax_pools, [tuple(to_jax(a, kind) for a in l) for l in new],
        jnp.asarray(TABLES), jnp.asarray(BLK_LO), W)
    tpd.TorchPagedDecoderLM._scatter_pools(
        pself, port_pools, [tuple(to_port(a, kind) for a in l) for l in new],
        tables, torch.from_numpy(BLK_LO.astype(np.int64)), W)
    changed = 0
    for jl, pl, old in zip(jgot, port_pools, layers):
        for j, p, o in zip(jl, pl, old):
            want = np.asarray(j, np.float32) if kind == "bfloat16" \
                else np.asarray(j)
            np.testing.assert_array_equal(to_numpy(p[:NB]), want)
            changed += int((want != o).any(axis=(1, 2, 3)).sum())
            # the shared block: both windows wrote its own bytes back
            np.testing.assert_array_equal(want[2], o[2])
    # blocks 4 (slot 0), 5 (slot 1) and 7 (slot 2) of each tensor
    assert changed == 3 * len(layers[0]) * len(layers)
