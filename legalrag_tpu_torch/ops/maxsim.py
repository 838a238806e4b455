"""Late-interaction MaxSim (port of ``legalrag_tpu/ops/maxsim.py:25-142``).

    score(q, d) = sum over valid query tokens i of max over valid doc tokens j of q_i . d_j

An empty doc (no valid token) contributes 0 and negative best-matches stay
negative, as in the JAX ``maxsim_full`` and its Pallas kernels.

Token stores: bf16 and f32 tensors [N, L, dt]; int8 tensors holding
``round(v * 127)`` of unit vectors, widened as ``x * (1 / 127)``; and the
nbit4 ``Residual4Store`` (a centroid id and 4-bit residual codes a token),
reconstructed as ``centroids[codes_c] + codes * (scales / 7)``. Queries are
bf16 over a bf16 store and float32 over the others.

``maxsim_full`` is the full-corpus [B, N] map of the late channel. On a CUDA
tensor it launches the hand-written kernel ``csrc/maxsim.cu`` (which
replaces the Pallas ``maxsim_scores_pallas`` / ``maxsim_scores_pallas2``),
its products on the tensor cores for bf16, int8 and nbit4 stores: bf16 in
one launch; int8 in one launch, the codes widened to fp16 as the kernel
stages them and each float32 query, scaled by a power of two, split into
two fp16 parts, two products each; nbit4 as a centroid term, read from a
[256, B * Lq] table of ``q . centroids`` that a first launch computes,
plus a residual term ``(q * step) . (nibble - 8)`` on the tensor cores as
int8's. A float32 store takes two launches on the CUDA cores through a
[N, B * Lq] scratch. (JAX leaves the quantized stores to XLA's
``maxsim_full``.) On a CPU tensor it runs the plain version
``maxsim_full_plain``.

``maxsim_topk`` is the late channel's masked top-k over that map
(``legalrag_tpu/ops/maxsim.py:135-142``): columns >= ``valid_n`` NEG_INF,
then ``topk_large``.

``maxsim_candidates`` scores per-query candidate lists [B, C] (the
large-corpus mode's late channel): a batched gather and einsum, as XLA
computes it in JAX, over every store.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import torch

from legalrag_tpu_torch import kernels
from legalrag_tpu_torch.ops.topk import INT8_SCALE, mask_cols, topk_large

# the kernel's doc-store type ids (csrc/common.cuh lrt::DType)
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_NBIT4 = 3
_TENSOR_CORE_IDS = (1, 2, _NBIT4)  # bf16, int8 and nbit4: the tensor-core kernel
_ROUTES = ("float32", "bf16", "int8", "nbit4")  # by type id (kernels.ROUTES)
_KERNEL_DT = (32, 64, 128)
NBIT4_CENTROIDS = 256


class Residual4Store(NamedTuple):
    """The nbit4 token store on the device (``legalrag_tpu/ops/maxsim.py:
    28-40``): token ~ ``centroids[codes_c] + unpack4(packed) * step``.
    ``packed`` holds two residual codes a byte, dim 2k in the high nibble
    and 2k + 1 in the low one, each biased by +8. ``step`` is ``scales /
    7``, divided once on the host in float32 (as numpy and XLA divide)."""

    codes_c: torch.Tensor    # [N, L] uint8 centroid ids
    packed: torch.Tensor     # [N, L, dt // 2] uint8 residual nibbles
    centroids: torch.Tensor  # [256, dt] float32
    scales: torch.Tensor     # [dt] float32 per-dim residual scale
    step: torch.Tensor       # [dt] float32, scales / 7


TokenStore = Union[torch.Tensor, Residual4Store]


def n_docs(store: TokenStore) -> int:
    return store.codes_c.shape[0] if isinstance(store, Residual4Store) \
        else store.shape[0]


def doc_len(store: TokenStore) -> int:
    return store.codes_c.shape[1] if isinstance(store, Residual4Store) \
        else store.shape[1]


def token_dim(store: TokenStore) -> int:
    return store.centroids.shape[1] if isinstance(store, Residual4Store) \
        else store.shape[2]


def gather_docs(store: TokenStore, rows: torch.Tensor) -> TokenStore:
    """The store's rows ``rows`` (any index shape), in the store's form."""
    if isinstance(store, Residual4Store):
        return store._replace(codes_c=store.codes_c[rows],
                              packed=store.packed[rows])
    return store[rows]


def slice_docs(store: TokenStore, start: int, stop: int) -> TokenStore:
    if isinstance(store, Residual4Store):
        return store._replace(codes_c=store.codes_c[start:stop],
                              packed=store.packed[start:stop])
    return store[start:stop]


def unpack_nibbles(packed: torch.Tensor) -> torch.Tensor:
    """[..., dt // 2] uint8 -> [..., dt] float32 residual codes in [-8, 7]
    (dim 2k from the high nibble)."""
    hi = (packed >> 4).to(torch.int32) - 8
    lo = (packed & 0xF).to(torch.int32) - 8
    return torch.stack([hi, lo], dim=-1).reshape(
        packed.shape[:-1] + (2 * packed.shape[-1],)).float()


def dequant(x: TokenStore) -> torch.Tensor:
    """Token tile -> float32 for the product: bf16 and f32 widen exactly,
    int8 rescales by 1/127, nbit4 adds its residuals (two roundings: the
    product, then the sum) to its centroids."""
    if isinstance(x, Residual4Store):
        return (x.centroids[x.codes_c.long()]
                + unpack_nibbles(x.packed) * x.step)
    if x.dtype == torch.int8:
        return x.float() * (1.0 / INT8_SCALE)
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise NotImplementedError(f"token store dtype {x.dtype} is not "
                                  "ported (bf16/f32/int8/nbit4)")
    return x.float()


def maxsim_candidates(doc_tok: torch.Tensor, doc_mask: torch.Tensor,
                      q_tok: torch.Tensor, q_mask: torch.Tensor,
                      cand: torch.Tensor) -> torch.Tensor:
    """MaxSim of per-query candidate lists: doc_tok [N, L, dt], doc_mask
    [N, L] bool, q_tok [B, Lq, dt], q_mask [B, Lq] bool, cand [B, C] row
    ids -> [B, C] float32."""
    docs = dequant(gather_docs(doc_tok, cand))        # [B, C, L, dt]
    sim = torch.einsum("bqd,bcld->bcql", dequant(q_tok), docs)
    sim = sim.masked_fill(~doc_mask[cand][:, :, None, :], float("-inf"))
    best = sim.amax(dim=-1)                            # [B, C, Lq]
    best = torch.where(q_mask[:, None, :], best, 0.0)
    best = torch.where(torch.isfinite(best), best, 0.0)  # empty docs
    return best.sum(dim=-1)


def maxsim_full_plain(doc_tok: TokenStore, doc_mask: torch.Tensor,
                      q_tok: torch.Tensor, q_mask: torch.Tensor,
                      budget_bytes: int = 256 << 20) -> torch.Tensor:
    """Plain PyTorch MaxSim map: doc-chunked float32 einsum of the widened
    (dequantized) operands. doc_tok [N, L, dt] or a ``Residual4Store``,
    doc_mask [N, L] bool, q_tok [B, Lq, dt], q_mask [B, Lq] bool -> [B, N]
    float32."""
    n, l_doc = n_docs(doc_tok), doc_len(doc_tok)
    b, lq, _ = q_tok.shape
    qf = dequant(q_tok)
    chunk = max(1, min(n, budget_bytes // max(4 * b * lq * l_doc, 1)))
    out = torch.empty((b, n), dtype=torch.float32, device=doc_mask.device)
    for s in range(0, n, chunk):
        d = dequant(slice_docs(doc_tok, s, s + chunk))
        sim = torch.einsum("bqd,cld->bcql", qf, d)
        sim = sim.masked_fill(~doc_mask[s:s + chunk][None, :, None, :],
                              float("-inf"))
        best = sim.amax(dim=-1)                              # [B, C, Lq]
        best = torch.where(torch.isfinite(best), best, 0.0)  # empty docs
        best = torch.where(q_mask[:, None, :], best, 0.0)
        out[:, s:s + chunk] = best.sum(dim=-1)
    return out


def maxsim_full(doc_tok: TokenStore, doc_mask: torch.Tensor,
                q_tok: torch.Tensor, q_mask: torch.Tensor) -> torch.Tensor:
    """Exact full-corpus MaxSim -> [B, N] float32: the kernel on a CUDA
    tensor, ``maxsim_full_plain`` on a CPU tensor."""
    if doc_mask.device.type == "cpu":
        return maxsim_full_plain(doc_tok, doc_mask, q_tok, q_mask)
    return _maxsim_kernel(doc_tok, doc_mask, q_tok, q_mask)


def maxsim_topk(doc_tok: TokenStore, doc_mask: torch.Tensor,
                q_tok: torch.Tensor, q_mask: torch.Tensor, valid_n: int,
                k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k rows of the full MaxSim map, rows >= ``valid_n`` scored
    NEG_INF: ([B, k] float32, [B, k] int64)."""
    scores = mask_cols(maxsim_full(doc_tok, doc_mask, q_tok, q_mask), valid_n)
    return topk_large(scores, min(k, scores.shape[1]))


def _maxsim_kernel(doc_tok: TokenStore, doc_mask: torch.Tensor,
                   q_tok: torch.Tensor, q_mask: torch.Tensor) -> torch.Tensor:
    dev = doc_mask.device
    nbit4 = isinstance(doc_tok, Residual4Store)
    store = list(doc_tok) if nbit4 else [doc_tok]
    if dev.type != "cuda" or any(t.device != dev
                                 for t in (*store, q_tok, q_mask)):
        raise ValueError("maxsim needs every tensor on one CUDA device")
    dtype_id = kernel_type_id(doc_tok)
    want_q = torch.bfloat16 if dtype_id == 1 else torch.float32
    if q_tok.dtype != want_q:
        raise TypeError(f"maxsim over a {'nbit4' if nbit4 else doc_tok.dtype}"
                        f" store takes {want_q} queries, got {q_tok.dtype}")
    if doc_mask.dtype != torch.bool or q_mask.dtype != torch.bool:
        raise TypeError("maxsim masks must be bool")
    n, l_doc, dt = n_docs(doc_tok), doc_len(doc_tok), token_dim(doc_tok)
    b, lq, qdt = q_tok.shape
    shapes_ok = (qdt == dt and doc_mask.shape == (n, l_doc)
                 and q_mask.shape == (b, lq))
    if nbit4:
        shapes_ok = shapes_ok and (
            doc_tok.packed.shape == (n, l_doc, dt // 2)
            and doc_tok.centroids.shape == (NBIT4_CENTROIDS, dt)
            and doc_tok.step.shape == (dt,))
    else:
        shapes_ok = shapes_ok and doc_tok.ndim == 3
    if not shapes_ok:
        raise ValueError(f"shapes doc {[tuple(t.shape) for t in store]} mask "
                         f"{tuple(doc_mask.shape)} q {tuple(q_tok.shape)} "
                         f"qmask {tuple(q_mask.shape)}")
    if dt not in _KERNEL_DT:
        raise ValueError(f"maxsim kernel takes token_dim in {_KERNEL_DT}, got {dt}")
    if not all(t.is_contiguous() for t in (*store, doc_mask, q_tok, q_mask)):
        raise ValueError("maxsim needs contiguous tensors")
    if any(t.data_ptr() % 16 for t in (*store, q_tok)):
        raise ValueError("maxsim needs 16-byte aligned token tensors")
    out = torch.empty((b, n), dtype=torch.float32, device=dev)
    if b == 0 or n == 0:
        return out
    lib = kernels.lib()
    if lib.maxsim_smem_bytes(dtype_id, l_doc, dt) < 0:
        raise ValueError(f"doc_maxlen {l_doc} x token_dim {dt} does not fit "
                         f"the kernel's shared-memory staging")
    grid, scratch = launch_plan(dtype_id, n, b, lq, dev)
    # the store's tensors: the tokens (nbit4: packed), then nbit4's codes_c,
    # centroids and step (NULL otherwise)
    tok, codes, cents, step = ((doc_tok.packed, doc_tok.codes_c,
                                doc_tok.centroids, doc_tok.step) if nbit4
                               else (doc_tok, None, None, None))
    kernels.launch("maxsim", tok.data_ptr(), doc_mask.data_ptr(),
                   q_tok.data_ptr(), q_mask.data_ptr(),
                   *(None if t is None else t.data_ptr()
                     for t in (codes, cents, step)),
                   dtype_id, b, lq, n, l_doc, dt, grid,
                   None if scratch is None else scratch.data_ptr(),
                   out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
                   route=_ROUTES[dtype_id])
    return out


def kernel_type_id(doc_tok: TokenStore) -> int:
    """The C entry ``maxsim``'s type id of a token store (raises for a
    store it does not take)."""
    if isinstance(doc_tok, Residual4Store):
        if (doc_tok.codes_c.dtype != torch.uint8
                or doc_tok.packed.dtype != torch.uint8
                or any(t.dtype != torch.float32 for t in doc_tok[2:])):
            raise TypeError("an nbit4 store is uint8 codes_c and packed, "
                            "float32 centroids, scales and step")
        return _NBIT4
    if doc_tok.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"maxsim takes bf16/f32/int8/nbit4 stores, got "
                        f"{doc_tok.dtype}")
    return _KERNEL_DTYPES[doc_tok.dtype]


def launch_plan(dtype_id: int, n: int, b: int, lq: int,
                dev: torch.device) -> Tuple[int, Optional[torch.Tensor]]:
    """The C entry ``maxsim``'s grid and scratch for a store of kernel type
    ``dtype_id`` (N docs) and a batch of B queries of Lq tokens."""
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    if dtype_id in _TENSOR_CORE_IDS:
        # about one block per SM; the kernel splits the blocks among its
        # query groups and doc slices. nbit4: the centroid table first.
        grid = max(n_sm, -(-b // kernels.lib().maxsim_queries_per_block()))
        scratch = (torch.empty((NBIT4_CENTROIDS, b * lq), dtype=torch.float32,
                               device=dev) if dtype_id == _NBIT4 else None)
    else:
        grid = max(1, min(n, 2 * n_sm))
        scratch = torch.empty((n, b * lq), dtype=torch.float32, device=dev)
    return grid, scratch
