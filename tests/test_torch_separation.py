"""The PyTorch port stands alone: it imports neither jax nor any module of
the JAX package, and it never falls back to the CPU silently."""

import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent

PORT_MODULES = sorted(
    ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
    for p in (REPO / "legalrag_tpu_torch").rglob("*.py"))


def test_port_and_chip_smoke_import_no_jax_and_no_jax_package():
    code = textwrap.dedent(f"""
        import sys
        sys.modules["jax"] = None  # any import of jax now fails
        sys.path.insert(0, {str(REPO)!r})
        import importlib
        for name in {PORT_MODULES!r} + ["chip_smoke"]:
            importlib.import_module(name)
        bad = sorted(k for k in sys.modules
                     if k == "legalrag_tpu" or k.startswith("legalrag_tpu."))
        assert not bad, bad
        assert "legalrag_tpu_torch.retrieval.engine" in sys.modules
        print("ok", len({PORT_MODULES!r}))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=str(REPO))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.startswith("ok")


def test_module_list_covers_the_slice():
    for name in ("legalrag_tpu_torch.ops.topk", "legalrag_tpu_torch.ops.maxsim",
                 "legalrag_tpu_torch.ops.fused_query",
                 "legalrag_tpu_torch.ops.bm25_sparse",
                 "legalrag_tpu_torch.index.bundle",
                 "legalrag_tpu_torch.kernels", "legalrag_tpu_torch.convert",
                 "legalrag_tpu_torch.scale"):
        assert name in PORT_MODULES


def test_default_device_raises_without_cuda(monkeypatch):
    from legalrag_tpu_torch.config import AppConfig
    from legalrag_tpu_torch.index.bundle import IndexBundle
    from legalrag_tpu_torch.utils.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        IndexBundle("en", AppConfig())
    assert resolve_device("cpu") == torch.device("cpu")
    assert IndexBundle("en", AppConfig(), device="cpu").device.type == "cpu"


def test_tf32_is_off():
    import legalrag_tpu_torch.utils.device  # noqa: F401

    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_cpu_tensor_takes_plain_version_and_never_builds_kernels(monkeypatch):
    """A CPU tensor runs the plain version; the kernel library is never
    built or loaded for it."""
    from legalrag_tpu_torch import kernels
    from legalrag_tpu_torch.ops.bm25_sparse import bm25_sparse_scores
    from legalrag_tpu_torch.ops.maxsim import maxsim_full
    from legalrag_tpu_torch.ops.topk import dense_topk

    def boom(*a, **k):
        raise AssertionError("kernel path taken for a CPU tensor")

    monkeypatch.setattr(kernels, "lib", boom)
    before = kernels.launch_counts()
    g = torch.Generator().manual_seed(0)
    emb = torch.randn(64, 16, generator=g).to(torch.bfloat16)
    s, i = dense_topk(emb, torch.randn(2, 16, generator=g), 60, 8)
    assert s.shape == (2, 8) and i.dtype == torch.int64
    out = maxsim_full(torch.randn(5, 3, 8, generator=g),
                      torch.ones(5, 3, dtype=torch.bool),
                      torch.randn(2, 4, 8, generator=g),
                      torch.ones(2, 4, dtype=torch.bool))
    assert out.shape == (2, 5)
    offsets = torch.tensor([0, 2, 3], dtype=torch.int32)
    bm = bm25_sparse_scores(torch.tensor([[0, 1]], dtype=torch.int32),
                            torch.tensor([[1, 2]], dtype=torch.int32),
                            offsets, torch.tensor([1, 3, 0, 0],
                                                  dtype=torch.int32),
                            torch.tensor([0.5, 0.25, 2.0, 0.0]), 4, chunk=4)
    assert bm.tolist() == [[4.0, 0.5, 0.0, 0.25]]
    assert kernels.launch_counts() == before
