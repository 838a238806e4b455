"""legalrag_tpu_torch — the PyTorch/CUDA port of legalrag_tpu.

The batched hybrid query path (hash encoder, bf16/f32 dense, BM25 impact
and token stores, map-mode and large-corpus fused hybrid top-k,
``FusedQueryEngine``), the single-query serving path (``ByLangRetriever``,
``HybridRetriever``, law graph, rerank, micro-batcher) and the HTTP server
with its RAG pipeline (``api/``, ``pipeline/``, ``routing/``, ``llm/``) on
torch tensors, with CUDA C++ kernels written by hand for Hopper
(``csrc/``): the fused dense score+select, full-corpus MaxSim and the CSR
BM25 scatter.

The package imports torch, numpy and scipy, never jax and never a module of
``legalrag_tpu``: the JAX package is the reference this port is tested
against (``tests/test_torch_*.py``).
"""

__version__ = "0.1.0"
