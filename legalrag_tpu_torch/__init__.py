"""legalrag_tpu_torch — the PyTorch/CUDA port of legalrag_tpu.

The batched hybrid query path (hash encoder, bf16/f32 dense, BM25 impact
and token stores, map-mode fused hybrid top-k, ``FusedQueryEngine``) on
torch tensors, with two CUDA C++ kernels written by hand for Hopper
(``csrc/``): the fused dense score+select and full-corpus MaxSim.

The package imports torch, numpy and scipy, never jax and never a module of
``legalrag_tpu``: the JAX package is the reference this port is tested
against (``tests/test_torch_*.py``).
"""

__version__ = "0.1.0"
