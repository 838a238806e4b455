"""Doc-sharded search over a ``(data, model)`` mesh (port of
``legalrag_tpu/parallel/sharded_search.py``).

Corpus rows (and the impact matrix's doc columns) split over the ``model``
axis, query batches over ``data``. Each shard computes its own top-k
lists with the port's ops, as the unsharded serving path computes them:

- dense: ``ops.topk.dense_topk`` over the shard's rows with the shard's
  valid count ``clamp(valid_n - offset, 0, n_local)``: on a CUDA tensor the
  score+select kernel (``csrc/score_select.cu``); the Q8 store keeps its
  ``int8_dot`` route;
- BM25: the shard's impact columns, one float32 matmul, masked, then
  ``topk_large``;
- late: ``ops.maxsim.maxsim_full`` on the shard's tokens (on a CUDA tensor
  the MaxSim kernel, ``csrc/maxsim.cu``), masked, then ``topk_large``.

Every shard's work is launched before the first copy, so that shards on
different cards overlap. Then each shard's ``[B, kk]`` lists (rows made
global by the shard's offset) are copied to the lead device, concatenated
in shard order and merged by ``stable_topk``: JAX's ``all_gather`` +
``lax.top_k``, whose ties fall to the lowest position, i.e. the lower shard
and then the shard's own order. The global top-k of the union of per-shard
top-k lists is exact. (JAX's ``_gather_topk`` is ``_local_topk`` then
``_merge`` here, split so that the copies wait for every shard's launch.)

Corpus arguments take a full tensor (split here), a list of per-model-shard
tensors on ``mesh.devices[0][j]`` (``IndexBundle.shard_views``) or a grid of
per-cell tensors (``parallel.mesh.as_cells``); query arguments a full tensor
or a grid.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import torch

from legalrag_tpu_torch.models.hash_encoder import project_norm
from legalrag_tpu_torch.ops.bm25 import bm25_scores_matmul, query_term_counts
from legalrag_tpu_torch.ops.fused_query import fuse_candidate_lists
from legalrag_tpu_torch.ops.maxsim import maxsim_full
from legalrag_tpu_torch.ops.topk import (
    dense_topk,
    mask_cols,
    stable_topk,
    topk_large,
)
from legalrag_tpu_torch.parallel.mesh import Cells, Mesh, as_cells, place

TopK = Tuple[torch.Tensor, torch.Tensor]


def _model_shards(mesh: Mesh, x, dim: int = 0) -> List[torch.Tensor]:
    """``x`` as one tensor per model shard, on ``mesh.devices[0][j]``."""
    return as_cells(Mesh(mesh.devices[:1]), x, model_dim=dim)[0]


def _shard_valid(valid_n: int, offset: int, n_local: int) -> int:
    return max(0, min(int(valid_n) - offset, n_local))


def _local_topk(scores: torch.Tensor, kk: int, offset: int,
                valid_n: int) -> TopK:
    """A shard's [B, n_local] map -> its masked top-kk, rows made global."""
    n_local = scores.shape[1]
    s, i = topk_large(mask_cols(scores, _shard_valid(valid_n, offset,
                                                     n_local)), kk)
    return s, i + offset


def _local_dense(emb_l: torch.Tensor, q: torch.Tensor, kk: int, offset: int,
                 valid_n: int) -> TopK:
    """A shard's dense top-kk (kernel 1 on a CUDA tensor), rows global."""
    s, i = dense_topk(emb_l, q, _shard_valid(valid_n, offset,
                                             emb_l.shape[0]), kk)
    return s, i + offset


def _merge(lists: Sequence[TopK], eff_k: int, lead: torch.device) -> TopK:
    """Copy each shard's list to ``lead``, concatenate in shard order and
    take the top-eff_k (``lax.top_k``'s order)."""
    s_all = torch.cat([s.to(lead) for s, _ in lists], dim=1)
    i_all = torch.cat([i.to(lead) for _, i in lists], dim=1)
    top_s, pos = stable_topk(s_all, min(eff_k, s_all.shape[1]))
    return top_s, torch.gather(i_all, 1, pos)


def _maxsim_local(doc_tok_l: torch.Tensor, doc_mask_l: torch.Tensor,
                  q_tok: torch.Tensor, q_mask: torch.Tensor) -> torch.Tensor:
    """A shard's full MaxSim map (the kernel tiles by itself; JAX's
    tile-budget rule has no counterpart)."""
    return maxsim_full(doc_tok_l, doc_mask_l, q_tok, q_mask)


def make_sharded_dense_topk(mesh: Mesh, k: int) -> Callable:
    """(emb [N, d] split over model, q [B, d] split over data, valid_n) ->
    (scores [B, k], global row ids [B, k]) on the lead device."""

    def run(emb, q, valid_n: int) -> TopK:
        emb_c = as_cells(mesh, emb, model_dim=0)
        q_c = as_cells(mesh, q, data_dim=0)
        n_local = emb_c[0][0].shape[0]
        kk = min(k, n_local)
        lists = [[_local_dense(e, qq, kk, j * n_local, valid_n)
                  for j, (e, qq) in enumerate(zip(er, qr))]
                 for er, qr in zip(emb_c, q_c)]
        out = [_merge(row, k, mesh.devices[i, 0])
               for i, row in enumerate(lists)]
        return (torch.cat([s.to(mesh.lead) for s, _ in out]),
                torch.cat([r.to(mesh.lead) for _, r in out]))

    return run


def make_sharded_hybrid_step(mesh: Mesh, k: int, eff_k: int,
                             rrf_k: float = 60.0, alpha: float = 0.5,
                             w_dense: float = 0.6, w_bm25: float = 0.4,
                             w_late: float = 0.35,
                             has_late: bool = False) -> Callable:
    """The batched fused step over a sharded corpus (dense + BM25 +
    optional MaxSim): per data row, every channel's global top-eff_k list,
    then ``fuse_candidate_lists`` (the large-corpus mode's fusion) over the
    gathered lists. ``impact`` is [N, V] (doc rows). Returns (fused scores
    [B, k'], rows [B, k']) on the lead device, k' = min(k, candidates).
    Signature as JAX's: with ``has_late`` (emb, impact, doc_tok, doc_mask,
    qvec, qtf, q_tok, q_mask, valid_n), else (emb, impact, qvec, qtf,
    valid_n)."""

    def step(emb, impact, doc_tok, doc_mask, qvec, qtf, q_tok, q_mask,
             valid_n: int) -> TopK:
        emb_c = as_cells(mesh, emb, model_dim=0)
        imp_c = as_cells(mesh, impact, model_dim=0)
        q_c = as_cells(mesh, qvec, data_dim=0)
        t_c = as_cells(mesh, qtf, data_dim=0)
        if has_late:
            tok_c = as_cells(mesh, doc_tok, model_dim=0)
            dm_c = as_cells(mesh, doc_mask, model_dim=0)
            qt_c = as_cells(mesh, q_tok, data_dim=0)
            qm_c = as_cells(mesh, q_mask, data_dim=0)
        n_local = emb_c[0][0].shape[0]
        kk = min(eff_k, n_local)
        per_row = []
        for i, row in enumerate(emb_c):   # every shard's work first
            lists = [[], [], []]
            for j, e in enumerate(row):
                off = j * n_local
                lists[0].append(_local_dense(e, q_c[i][j], kk, off, valid_n))
                lists[1].append(_local_topk(
                    bm25_scores_matmul(imp_c[i][j].T, t_c[i][j]), kk, off,
                    valid_n))
                if has_late:
                    lists[2].append(_local_topk(_maxsim_local(
                        tok_c[i][j], dm_c[i][j], qt_c[i][j], qm_c[i][j]),
                        kk, off, valid_n))
            per_row.append(lists)
        out = []
        for i, lists in enumerate(per_row):
            dev = mesh.devices[i, 0]
            weights = (w_dense, w_bm25, w_late)[:3 if has_late else 2]
            per = [(w, *_merge(ls, eff_k, dev))
                   for w, ls in zip(weights, lists)]
            n_cand = sum(s.shape[1] for _, s, _ in per)
            r = fuse_candidate_lists(per, rrf_k, alpha, min(k, n_cand))
            out.append((r["top_s"], r["rows"]))
        return (torch.cat([s.to(mesh.lead) for s, _ in out]),
                torch.cat([r.to(mesh.lead) for _, r in out]))

    if has_late:
        return step

    def without_late(emb, impact, qvec, qtf, valid_n: int) -> TopK:
        return step(emb, impact, None, None, qvec, qtf, None, None, valid_n)

    return without_late


def _channels_shardmap(mesh: Mesh, eff_k: int, has_late: bool) -> Callable:
    """The per-channel step shared by the plain and encoder-fused sharded
    serving calls: (corpus shards, replicated query views) -> the dense,
    BM25 (and late) global top-eff_k lists on the lead device. Queries are
    replicated: the first data row computes them."""

    def step(emb, impact, doc_tok, doc_mask, qvec, term_ids, term_mask,
             q_tok, q_mask, valid_n: int) -> Tuple[TopK, ...]:
        emb_s = _model_shards(mesh, emb, 0)
        imp_s = _model_shards(mesh, impact, 1)
        n_local = emb_s[0].shape[0]
        kk = min(eff_k, n_local)
        v = imp_s[0].shape[0]
        devs = [e.device for e in emb_s]
        if has_late:
            tok_s = _model_shards(mesh, doc_tok, 0)
            dm_s = _model_shards(mesh, doc_mask, 0)
        lists: Tuple[List[TopK], ...] = ([], [], [])
        qtf = {}   # the [B, V] term counts, once per distinct device
        for j, dev in enumerate(devs):   # every shard's work first
            off = j * n_local
            if dev not in qtf:
                qtf[dev] = query_term_counts(term_ids.to(dev),
                                             term_mask.to(dev), v)
            lists[0].append(_local_dense(emb_s[j], qvec.to(dev), kk, off,
                                         valid_n))
            lists[1].append(_local_topk(bm25_scores_matmul(imp_s[j],
                                                           qtf[dev]),
                                        kk, off, valid_n))
            if has_late:
                lists[2].append(_local_topk(_maxsim_local(
                    tok_s[j], dm_s[j], q_tok.to(dev), q_mask.to(dev)),
                    kk, off, valid_n))
        return tuple(_merge(ls, eff_k, mesh.lead)
                     for ls in lists[:3 if has_late else 2])

    return step


def make_sharded_channels_step(mesh: Mesh, eff_k: int,
                               has_late: bool) -> Callable:
    """Doc-sharded counterpart of ``ops.fused_query.fused_channels_topk``:
    every channel's GLOBAL top-eff_k list, equal to the one-device lists,
    so the host pipeline downstream (fusion, min-score, graph, rerank,
    dedup) is untouched. ``run(emb, impact, doc_tok, doc_mask, qvec,
    (term_ids, term_mask), q_tok, q_mask, valid_n)`` -> (dense, bm25[,
    late]), each (scores, rows)."""
    step = _channels_shardmap(mesh, eff_k, has_late)

    def run(emb, impact, doc_tok, doc_mask, qvec, qtf_pair, q_tok, q_mask,
            valid_n: int) -> Tuple[TopK, ...]:
        return step(emb, impact, doc_tok, doc_mask, qvec, qtf_pair[0],
                    qtf_pair[1], q_tok, q_mask, valid_n)

    return run


def make_sharded_bert_channels_step(mesh: Mesh, eff_k: int, has_late: bool,
                                    encoder, q_dtype: torch.dtype) -> Callable:
    """Encoder-fused sharded serving call: the bert query forward
    (``encoder.query_views``) and every shard's channels from one call.
    ``run(inputs, emb, impact, doc_tok, doc_mask, term_ids, term_mask,
    valid_n)`` -> (dense, bm25[, late], qvec), ``inputs`` from
    ``encoder.query_inputs(texts, maxlen, has_late)``. (JAX's takes the
    encoder's params and config at call time; the port's encoder holds
    them.)"""
    step = _channels_shardmap(mesh, eff_k, has_late)

    def run(inputs, emb, impact, doc_tok, doc_mask, term_ids, term_mask,
            valid_n: int):
        qvec, q_tok, q_mask = encoder.query_views(inputs)
        if has_late:
            q_tok = q_tok.to(q_dtype)
        return (*step(emb, impact, doc_tok, doc_mask, qvec, term_ids,
                      term_mask, q_tok, q_mask, valid_n), qvec)

    return run


def sharded_channels_topk(mesh: Mesh, eff_k: int, emb, impact, doc_tok,
                          doc_mask, qvec, qtf_pair, q_tok, q_mask,
                          valid_n: int) -> Dict[str, object]:
    """Dict-shaped facade matching ``fused_channels_topk``'s output:
    ``{"qvec": [B, d], "dense": (s, i), "bm25": (s, i)[, "colbert": (s,
    i)]}``. ``qvec`` may be ready embeddings or the hash backend's
    (sketch, projection) pair, projected and L2-normalized on the lead
    device."""
    if isinstance(qvec, (tuple, list)):
        qvec = project_norm(qvec[0].to(mesh.lead), qvec[1].to(mesh.lead))
    has_late = doc_tok is not None
    res = make_sharded_channels_step(mesh, eff_k, has_late)(
        emb, impact, doc_tok, doc_mask, qvec, qtf_pair, q_tok, q_mask,
        valid_n)
    out = {"qvec": qvec, "dense": res[0], "bm25": res[1]}
    if has_late:
        out["colbert"] = res[2]
    return out


def shard_corpus_arrays(mesh: Mesh, emb: torch.Tensor, impact: torch.Tensor
                        ) -> Tuple[Cells, Cells]:
    """The corpus arrays as per-cell grids with their serving placement
    (``impact`` given as [N, V] doc rows): both split by rows over
    ``model``."""
    return place(mesh, emb, model_dim=0), place(mesh, impact, model_dim=0)
