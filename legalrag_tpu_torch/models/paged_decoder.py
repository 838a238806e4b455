"""A paged KV pool with radix-tree prefix reuse under continuous batching
(port of ``legalrag_tpu/models/paged_decoder.py``).

The continuous-batching engine (``models/batched_decoder.py``) gives every
slot a private ``max_len`` stripe of KV rows. This engine keeps one block
pool instead and shares prompt prefixes across requests by reference:

- **Block pool.** Per layer one ``[NB, BS, Hkv, D]`` k / v pool in the
  model's dtype (under ``kv_quant`` the int8 k / v and their float32 scales
  ``[NB, BS, Hkv, 1]``, the int8 cache's layout). A stream's cache is a
  block table ``[MAXB]`` of pool indices: position ``p`` lives at
  ``pool[table[p // BS], p % BS]``. Each launch gathers every slot's table
  into a contiguous ``[S, MAXB * BS]`` view, runs the batched engine's
  decode or speculation launch over it unchanged, and scatters back only
  the block window each slot could have written.
- **Radix tree.** Full blocks of prompt tokens are published to a
  host-side tree keyed by BS-token chunks. Admission walks it and attaches
  every matched block to the new stream's table by reference (no prefill,
  no copy); finished streams leave their published blocks cached at
  refcount 0, evicted least recently used first.
- **Reservation admission.** A stream is admitted only when ``free +
  evictable - reserved`` blocks cover its worst case (prompt, budget and
  ``spec_k`` rows of headroom), so a launch never runs out of blocks: the
  host tops each table up ahead of every launch from its reservation.
  Streams that do not fit wait, first in, first out.

The table entry ``NB`` means "no block". JAX gathers it clipped to block
``NB - 1`` and drops its writes. The gather here clamps it the same way
(those rows lie past the slot's filled rows, where the causal mask zeroes
them; they are finite, being some stream's KV). The pools hold one block
more, a scratch block at index ``NB`` that no gather reads: a sentinel
entry's write-back lands there, so no index is out of range on the card
and no launch reads anything back to the host. ``paged_stats`` counts the
``NB`` blocks the tree manages.

Per launch the gathered view is as large as the batched engine's slot
cache, so the card holds the pool and one view at a time: JAX's design.
Greedy streams are token-identical to JAX's ``PagedDecoderLM`` and to the
port's batched and single-stream engines; a sampled stream draws from its
own generator, as in the batched engine.
"""

from __future__ import annotations

from collections import OrderedDict, deque
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from legalrag_tpu_torch.models.batched_decoder import (
    Cache,
    TorchBatchedDecoderLM,
    _Stream,
)
from legalrag_tpu_torch.models.constrain import JsonConstraint
from legalrag_tpu_torch.models.decoder import DecoderModel, pad_bucket
from legalrag_tpu_torch.utils.device import DeviceLike
from legalrag_tpu_torch.utils.metrics import METRICS


class _Node:
    """Radix-tree node: one published full block of prompt KV."""

    __slots__ = ("key", "block_id", "refs", "children", "parent")

    def __init__(self, key: Tuple[int, ...], block_id: int, parent):
        self.key = key
        self.block_id = block_id
        self.refs = 0
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.parent = parent


class _RadixIndex:
    """Host-side radix tree over BS-token chunks, the pool's free list, and
    an LRU of refcount-0 nodes.

    Invariant: a node with refs > 0 never has a refs == 0 ancestor
    (matching increfs the whole root-to-node path), so every refcount-0
    node's subtree is entirely refcount-0 and is evicted as a unit.
    """

    def __init__(self, n_blocks: int, block_size: int):
        self.bs = block_size
        self.root = _Node((), -1, None)
        self.free: deque = deque(range(n_blocks))
        # refcount-0 nodes, least recently released first
        self.zeroref: "OrderedDict[_Node, None]" = OrderedDict()
        self.reserved = 0          # blocks promised to admitted streams
        self.reused_blocks = 0     # lifetime counts (paged_stats)
        self.evicted_blocks = 0

    def match(self, ids: List[int]) -> List[_Node]:
        """The longest published-block chain covering a strict prefix of
        ``ids``: at least one token is left to forward, whose logits seed
        the first token."""
        limit = (len(ids) - 1) // self.bs
        path: List[_Node] = []
        node = self.root
        bs = self.bs
        for j in range(limit):
            child = node.children.get(tuple(ids[j * bs:(j + 1) * bs]))
            if child is None:
                break
            path.append(child)
            node = child
        return path

    def incref(self, nodes: List[_Node]) -> None:
        for n in nodes:
            if n.refs == 0:
                self.zeroref.pop(n, None)
            n.refs += 1

    def decref(self, nodes: List[_Node]) -> None:
        for n in nodes:
            n.refs -= 1
            if n.refs == 0:
                self.zeroref[n] = None       # the newest, evicted last

    @property
    def evictable(self) -> int:
        return len(self.zeroref)

    def available(self) -> int:
        return len(self.free) + self.evictable - self.reserved

    def alloc(self) -> int:
        """One block from the free list, evicting the least recently used
        refcount-0 subtree when it is empty. Callers draw against a
        reservation, so running out here is a fault, not load."""
        if not self.free:
            self._evict_one()
        return self.free.popleft()

    def _evict_one(self) -> None:
        if not self.zeroref:
            raise RuntimeError("paged KV pool exhausted despite "
                               "reservation accounting")
        node, _ = self.zeroref.popitem(last=False)
        stack = [node]
        while stack:
            n = stack.pop()
            for c in n.children.values():
                self.zeroref.pop(c, None)
                stack.append(c)
            self.free.append(n.block_id)
            self.evicted_blocks += 1
        if node.parent is not None:
            node.parent.children.pop(node.key, None)

    def publish(self, parent: _Node, key: Tuple[int, ...],
                block_id: int) -> Optional[_Node]:
        """Insert a freshly prefilled full prompt block under ``parent``.
        Where a concurrent stream already published the same chunk, theirs
        stays (ours remains private, freed at the stream's end): None."""
        if key in parent.children:
            return None
        node = _Node(key, block_id, parent)
        node.refs = 1
        parent.children[key] = node
        return node


class _PagedStream(_Stream):
    """A stream's host bookkeeping with its blocks."""

    __slots__ = ("path", "private", "reserve", "n_blocks", "limit")

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.path: List[_Node] = []      # radix nodes this stream refs
        self.private: List[int] = []     # block ids owned outright
        self.reserve = 0                 # blocks still drawable
        self.n_blocks = 0                # table entries filled so far
        self.limit = 0                   # last allowed position + 1


class TorchPagedDecoderLM(TorchBatchedDecoderLM):
    """Continuous batching over a paged KV pool with radix prefix reuse
    (module docstring): ``TorchBatchedDecoderLM``'s ``generate_stream``
    contract and launches, run over a view gathered from the pool."""

    ENGINE = "paged"
    _new_stream = _PagedStream

    def __init__(self, model: DecoderModel, tokenizer=None,
                 device: DeviceLike = None, max_len: int = 4096,
                 n_slots: int = 4, decode_chunk: int = 8,
                 block_size: int = 64, pool_blocks: int = 0,
                 prefill_chunk: int = 1024, kv_quant: bool = False,
                 json_constraint: Optional[JsonConstraint] = None,
                 spec_k: int = 0, spec_steps: int = 4, ngram_draft=None,
                 draft: Optional[DecoderModel] = None):
        if max_len % block_size:
            raise ValueError(f"max_len {max_len} must be a multiple of "
                             f"block_size {block_size}")
        self.block_size = block_size
        self.maxb = max_len // block_size
        # the default pool: every slot a full context, and one slot's worth
        # of retained (refcount-0) blocks
        self.n_blocks = pool_blocks or (n_slots + 1) * self.maxb
        if self.n_blocks < self.maxb:
            raise ValueError("pool smaller than one full-context stream")
        if spec_k and max_len - spec_k < block_size:
            raise ValueError(f"spec_k {spec_k} leaves no stream budget "
                             f"in max_len {max_len}")
        self.radix = _RadixIndex(self.n_blocks, block_size)
        # host-authoritative block tables; NB: no block
        self._tables = np.full((n_slots, self.maxb), self.n_blocks, np.int64)
        super().__init__(model, tokenizer, device=device, max_len=max_len,
                         n_slots=n_slots, decode_chunk=decode_chunk,
                         spec_k=spec_k, spec_steps=spec_steps,
                         kv_quant=kv_quant, prefill_chunk=prefill_chunk,
                         json_constraint=json_constraint,
                         ngram_draft=ngram_draft if spec_k else None,
                         draft=draft)
        self.prefill_chunk = max(prefill_chunk, block_size)

    # -------------------------------------------------------------- pools
    def _empty_cache(self) -> None:
        """The pools, ``NB + 1`` blocks a layer (the last the scratch block
        that sentinel writes land in); no slot cache between launches."""
        self._pools = [tuple(a.view(self.n_blocks + 1, self.block_size,
                                    *a.shape[2:]) for a in layer)
                       for layer in self._zeros_cache(
                           self.cfg, 1, (self.n_blocks + 1) * self.block_size,
                           self.kv_quant, self.model.dtype)]
        return None

    @property
    def cache_bytes(self) -> int:
        """Bytes of the pools, the scratch block included."""
        return sum(a.numel() * a.element_size()
                   for layer in self._pools for a in layer)

    @property
    def view_bytes(self) -> int:
        """Bytes of one launch's gathered view, ``[S, MAXB * BS]`` a layer."""
        return (self.cache_bytes // (self.n_blocks + 1)
                * self.n_slots * self.maxb)

    def _gather_pools(self, pools: Cache, tables: torch.Tensor) -> Cache:
        """Block pools -> per-slot contiguous caches ``[S, MAXB * BS, ...]``.
        A sentinel entry gathers block ``NB - 1``, as JAX's clipped gather
        does: rows past the slot's filled ones, which the mask zeroes."""
        s = tables.shape[0]
        flat = tables.clamp_max(self.n_blocks - 1).reshape(-1)
        return [tuple(p.index_select(0, flat).view(s, -1, *p.shape[2:])
                      for p in entry)
                for entry in pools]

    def _scatter_pools(self, pools: Cache, caches: Cache,
                       tables: torch.Tensor, blk_lo: torch.Tensor,
                       w: int) -> None:
        """Write blocks ``blk_lo[s] .. blk_lo[s] + w - 1`` of each slot's
        contiguous cache back into the pools, in place. ``w`` is sized for
        the launch's worst-case write span and the host clamps ``blk_lo``
        to ``[0, MAXB - w]``, so the window is in bounds; its blocks below
        the first written row get their own gathered bytes back. A sentinel
        entry's block goes to the scratch block ``NB``.

        Two entries of one write can name the same block only as the
        scratch block, which nothing reads, or as a published prompt block
        that two slots share: a slot writes at positions past its prompt,
        so a shared block enters a window only at the clamp, and then each
        slot writes back the bytes it gathered from that block, the same
        bytes, whichever write lands."""
        s, bs = tables.shape[0], self.block_size
        win = blk_lo[:, None] + torch.arange(w, device=tables.device)[None]
        idx = tables.gather(1, win).reshape(-1)                 # [S * w]
        sidx = torch.arange(s, device=tables.device)[:, None]
        for entry, centry in zip(pools, caches):
            for p, c in zip(entry, centry):
                upd = c.view(s, self.maxb, bs, *c.shape[2:])[sidx, win]
                p.index_copy_(0, idx, upd.reshape(s * w, bs, *c.shape[2:]))

    def _window(self, span: int) -> int:
        """The write-back window's blocks for ``span`` written rows."""
        return min(self.maxb, (span - 1) // self.block_size + 2)

    def _prefill_piece(self, table_row: torch.Tensor, lo: int, w: int,
                       ids: List[int], p_len: int,
                       true_len: int) -> torch.Tensor:
        """Forward one right-padded ``[1, C]`` prompt chunk at absolute
        offset ``p_len`` over the slot's gathered view, then write the
        block window from ``lo`` back; the float32 logits [1, V] of its
        last real token."""
        caches = self._gather_pools(self._pools, table_row)
        hidden = self.model(self._ids(ids), self._positions(p_len, len(ids)),
                            kv_cache=caches, cache_len=p_len,
                            return_hidden=True)
        self._scatter_pools(self._pools, caches, table_row,
                            torch.tensor([lo], device=self.device), w)
        return self.model.logits(hidden[:, true_len - 1])

    # ------------------------------------------------------------- blocks
    def _alloc_into(self, st: _PagedStream, slot: int) -> int:
        """One block from the stream's reservation into its table."""
        bid = self.radix.alloc()
        self.radix.reserved -= 1
        st.reserve -= 1
        st.private.append(bid)
        self._tables[slot, st.n_blocks] = bid
        st.n_blocks += 1
        return bid

    def _release(self, st: _PagedStream, slot: int) -> None:
        """Return a finished stream's blocks: decref its shared path nodes
        (they stay cached, evictable at refcount 0), free its private ones,
        release what is left of its reservation."""
        self.radix.decref(st.path)
        st.path = []
        self.radix.free.extend(st.private)
        st.private = []
        self.radix.reserved -= st.reserve
        st.reserve = 0
        self._tables[slot, :] = self.n_blocks

    def _top_up_tables(self) -> None:
        """Before a launch every active slot's table covers the launch's
        worst-case write positions, drawn from its reservation. A plain
        launch writes one row a step up to pos + decode_chunk. A speculative
        one writes k + 1 verify rows a round from pos, pos advancing at most
        k + 1 a round, so up to pos + spec_steps * (k + 1), capped at
        limit + spec_k. The device position is len(prompt) + produced (less
        one with speculation: the pending token's row is written by the
        next verify), so nothing is read from the card."""
        k = self.spec_k
        for i, st in enumerate(self._slots):
            if st is None:
                continue
            if k:
                pos = len(st.prompt_ids) + max(st.produced - 1, 0)
                horizon = min(pos + self.spec_steps * (k + 1),
                              st.limit + k, self.max_len)
            else:
                pos = len(st.prompt_ids) + st.produced
                horizon = min(pos + self.decode_chunk, st.limit,
                              self.max_len)
            while st.n_blocks * self.block_size < horizon:
                self._alloc_into(st, i)

    def _blk_lo(self) -> np.ndarray:
        """Each slot's first write-back block for the next launch (the
        position as in ``_top_up_tables``), clamped so the window stays in
        bounds. Empty slots stay 0: their sentinel table writes to the
        scratch block."""
        k = self.spec_k
        span = self.spec_steps * (k + 1) if k else self.decode_chunk
        w = self._window(span)
        lo = np.zeros(self.n_slots, np.int64)
        for i, st in enumerate(self._slots):
            if st is None:
                continue
            pos = len(st.prompt_ids) + (max(st.produced - 1, 0) if k
                                        else st.produced)
            lo[i] = min(max(pos // self.block_size, 0), self.maxb - w)
        return lo

    # ---------------------------------------------------------- admission
    def _try_admit(self, st: _PagedStream, slot: int) -> bool:
        """Admit ``st`` into ``slot`` if its worst-case blocks fit free +
        evictable - reserved: through limit + spec_k, since every verify
        writes k rows past the last accepted position. False leaves it
        pending (blocks free up as other streams finish)."""
        ids = st.prompt_ids
        bs = self.block_size
        st.limit = min(len(ids) + st.max_new, self.max_len - self.spec_k)
        path = self.radix.match(ids)
        self.radix.incref(path)
        need = -(-(st.limit + self.spec_k) // bs) - len(path)
        if self.radix.available() < need:
            self.radix.decref(path)
            return False
        self.radix.reserved += need
        st.reserve = need
        st.path = path
        for j, node in enumerate(path):
            self._tables[slot, j] = node.block_id
        st.n_blocks = len(path)
        self.radix.reused_blocks += len(path)
        METRICS.inc("legalrag_paged_reused_tokens", len(path) * bs,
                    engine="paged")
        self._admit_stream(st, slot)
        return True

    def _prefill_slot(self, st: _PagedStream, slot: int) -> torch.Tensor:
        """The prompt past its matched blocks, into fresh blocks chunk by
        chunk, each padded to a bucket that keeps its rows inside the view;
        then its new full blocks published. The last prompt token's logits
        [1, V]."""
        ids, bs = st.prompt_ids, self.block_size
        n_matched = len(st.path)
        m = n_matched * bs
        sfx = ids[m:]
        for _ in range(-(-len(sfx) // bs)):
            self._alloc_into(st, slot)
        table_row = torch.from_numpy(self._tables[slot:slot + 1]).to(
            self.device)
        c = self.prefill_chunk
        last = None
        for off in range(0, len(sfx), c):
            piece = list(sfx[off:off + c])
            n = len(piece)
            cb = c if n == c else pad_bucket(n, lo=self._PAD_BUCKET_MIN,
                                             hi=self.max_len - (m + off))
            w = self._window(cb)
            lo = min(max((m + off) // bs, 0), self.maxb - w)
            last = self._prefill_piece(table_row, lo, w,
                                       piece + [0] * (cb - n), m + off, n)
        METRICS.inc("legalrag_paged_prefill_tokens", len(sfx),
                    engine="paged")
        # the prompt's freshly filled full blocks to the tree; a partial
        # tail block stays private
        parent = st.path[-1] if st.path else self.radix.root
        pub_ids = deque(st.private)
        for j in range(n_matched, len(ids) // bs):
            bid = pub_ids.popleft()
            node = self.radix.publish(parent, tuple(ids[j * bs:(j + 1) * bs]),
                                      bid)
            if node is None:
                break           # published by another stream: stays private
            st.private.remove(bid)
            st.path.append(node)
            parent = node
        return last

    def _admit_pending(self, pending) -> None:
        """First in, first out: admission stops at the first stream that
        does not fit, so a large request is not starved by later small
        ones; a failed admission gives back its blocks and fails only its
        stream."""
        for i in range(self.n_slots):
            if not pending:
                break
            if self._slots[i] is None:
                st = pending[0]
                try:
                    if not self._try_admit(st, i):
                        break
                except BaseException as e:
                    pending.popleft()
                    self._release(st, i)
                    self._admission_failed(st, i, e)
                    continue
                pending.popleft()

    # ------------------------------------------------------------ launches
    def _through_view(self, span: int, launch, *args) -> torch.Tensor:
        """Top the tables up, run ``launch`` over the slots' gathered view,
        then write each slot's window of ``span`` rows back to the pools."""
        self._top_up_tables()
        s = self.n_slots
        host = torch.from_numpy(np.concatenate(
            [self._tables.reshape(-1), self._blk_lo()])).to(self.device)
        tables, lo = host[:-s].view(s, self.maxb), host[-s:]
        self._cache = self._gather_pools(self._pools, tables)
        try:
            out = launch(*args)
            self._scatter_pools(self._pools, self._cache, tables, lo,
                                self._window(span))
        finally:
            self._cache = None
        return out

    def _decode_launch(self, ctrl) -> torch.Tensor:
        return self._through_view(self.decode_chunk, super()._decode_launch,
                                  ctrl)

    def _spec_launch(self, ctrl, firsts) -> torch.Tensor:
        return self._through_view(self.spec_steps * (self.spec_k + 1),
                                  super()._spec_launch, ctrl, firsts)

    def _tick(self, pending) -> bool:
        if not super()._tick(pending):
            return False
        r = self.radix
        METRICS.set_gauge("legalrag_paged_free_blocks", len(r.free))
        METRICS.set_gauge("legalrag_paged_cached_blocks", r.evictable)
        METRICS.set_gauge("legalrag_paged_reserved_blocks", r.reserved)
        METRICS.set_gauge("legalrag_paged_pending_streams",
                          len(self._pending))
        return True

    def _finish(self, slot: int) -> None:
        st = self._slots[slot]
        if st is not None:
            self._release(st, slot)
        super()._finish(slot)

    # ------------------------------------------------------------------ API
    def paged_stats(self) -> Dict[str, int]:
        """The pool and the tree: block reuse is the point."""
        r = self.radix
        return {"n_blocks": self.n_blocks, "block_size": self.block_size,
                "free_blocks": len(r.free), "cached_blocks": r.evictable,
                "reserved_blocks": r.reserved,
                "reused_blocks": r.reused_blocks,
                "evicted_blocks": r.evicted_blocks}
