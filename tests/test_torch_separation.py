"""The PyTorch port stands alone: it imports neither jax nor any module of
the JAX package, and it never falls back to the CPU silently."""

import json
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
        for name in {PORT_MODULES!r} + ["chip_smoke", "maxsim_routes"]:
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
                 "legalrag_tpu_torch.scale",
                 "legalrag_tpu_torch.retrieval.hybrid",
                 "legalrag_tpu_torch.retrieval.by_lang",
                 "legalrag_tpu_torch.retrieval.batcher",
                 "legalrag_tpu_torch.retrieval.channels",
                 "legalrag_tpu_torch.retrieval.fusion",
                 "legalrag_tpu_torch.retrieval.rerankers",
                 "legalrag_tpu_torch.graph.builder",
                 "legalrag_tpu_torch.graph.store",
                 "legalrag_tpu_torch.utils.tracing",
                 "legalrag_tpu_torch.config", "legalrag_tpu_torch.schemas",
                 "legalrag_tpu_torch.utils.metrics",
                 "legalrag_tpu_torch.llm.context",
                 "legalrag_tpu_torch.llm.client",
                 "legalrag_tpu_torch.llm.gateway",
                 "legalrag_tpu_torch.prompts",
                 "legalrag_tpu_torch.routing.issue_extractor",
                 "legalrag_tpu_torch.routing.router",
                 "legalrag_tpu_torch.pipeline.citations",
                 "legalrag_tpu_torch.pipeline.rag_pipeline",
                 "legalrag_tpu_torch.api.webcore",
                 "legalrag_tpu_torch.api.answer_scanner",
                 "legalrag_tpu_torch.api.server",
                 "legalrag_tpu_torch.api.retrieval_api",
                 "legalrag_tpu_torch.api.index_api",
                 "legalrag_tpu_torch.index.registry",
                 "legalrag_tpu_torch.corpus.loader",
                 "legalrag_tpu_torch.cli.preprocess_law",
                 "legalrag_tpu_torch.cli.build_index",
                 "legalrag_tpu_torch.cli.build_graph",
                 "legalrag_tpu_torch.cli.index_admin",
                 "legalrag_tpu_torch.ingest.minipdf",
                 "legalrag_tpu_torch.ingest.pdf_parser",
                 "legalrag_tpu_torch.ingest.ingestor",
                 "legalrag_tpu_torch.ingest.task_queue",
                 "legalrag_tpu_torch.ingest.orchestrator",
                 "legalrag_tpu_torch.ingest.service",
                 "legalrag_tpu_torch.models.decoder",
                 "legalrag_tpu_torch.models.constrain",
                 "legalrag_tpu_torch.models.ngram_draft",
                 "legalrag_tpu_torch.models.spec_decode",
                 "legalrag_tpu_torch.models.batched_decoder",
                 "legalrag_tpu_torch.models.paged_decoder",
                 "legalrag_tpu_torch.cli.build_draft_table",
                 "legalrag_tpu_torch.tokenize.bpe",
                 "legalrag_tpu_torch.parallel",
                 "legalrag_tpu_torch.parallel.mesh",
                 "legalrag_tpu_torch.parallel.sharded_search",
                 "legalrag_tpu_torch.parallel.training",
                 "legalrag_tpu_torch.parallel.decoder_tp",
                 "legalrag_tpu_torch.parallel.decoder_dp",
                 "legalrag_tpu_torch.evals.synthetic",
                 "legalrag_tpu_torch.cli.train_encoder"):
        assert name in PORT_MODULES


def test_decoder_and_bpe_import_no_tokenizer_or_checkpoint_package():
    """The decoder engine, its tokenizer, the client that serves them and
    ``chip_smoke.py`` import none of ``transformers``, ``tokenizers``,
    ``safetensors`` or ``regex`` (nor JAX), and render a chat template
    without them."""
    code = textwrap.dedent(f"""
        import sys
        for name in ("jax", "transformers", "tokenizers", "safetensors",
                     "regex"):
            sys.modules[name] = None  # any import of them now fails
        sys.path.insert(0, {str(REPO)!r})
        from legalrag_tpu_torch.llm import client
        from legalrag_tpu_torch.models import (batched_decoder, decoder,
                                               paged_decoder, spec_decode)
        from legalrag_tpu_torch.cli import build_draft_table
        from legalrag_tpu_torch.tokenize import bpe
        import chip_smoke
        tok = bpe.BPETokenizer({{
            "model": {{"type": "BPE", "vocab": {{c: i for i, c in enumerate(
                bpe.bytes_to_unicode().values())}}, "merges": []}},
            "normalizer": {{"type": "NFC"}},
            "pre_tokenizer": {{"type": "Sequence", "pretokenizers": [
                {{"type": "Split", "pattern": {{"Regex": bpe.QWEN2_PATTERN}},
                 "behavior": "Isolated", "invert": False}},
                {{"type": "ByteLevel", "add_prefix_space": False,
                 "use_regex": False}}]}},
            "decoder": {{"type": "ByteLevel"}}, "added_tokens": []}},
            {{"chat_template": "{{{{ messages[0]['content'] }}}}"}})
        ids = tok("合同 ok")["input_ids"]
        assert tok.decode(ids) == "合同 ok", ids
        assert tok.apply_chat_template([{{"role": "user", "content": "x"}}]) == "x"
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=str(REPO))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.startswith("ok")


def test_prompts_are_the_ports_own_copies():
    """The port reads its prompt registries from its own files, which hold
    what the JAX package's files hold."""
    import json

    for lang in ("zh", "en"):
        mine = REPO / "legalrag_tpu_torch" / "prompts" / f"prompt_{lang}.json"
        theirs = REPO / "legalrag_tpu" / "prompts" / f"prompt_{lang}.json"
        assert json.loads(mine.read_text(encoding="utf-8")) == \
            json.loads(theirs.read_text(encoding="utf-8"))


def test_default_device_raises_without_cuda(monkeypatch):
    from legalrag_tpu_torch.config import AppConfig
    from legalrag_tpu_torch.index.bundle import IndexBundle
    from legalrag_tpu_torch.utils.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        IndexBundle("en", AppConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    assert IndexBundle("en", AppConfig(), device="cpu").device.type == "cpu"


def test_server_and_pipeline_raise_without_cuda_unless_told(monkeypatch, tmp_path):
    """create_app, the retrieval service and RagPipeline serve on cuda by
    default: without CUDA they raise at once instead of serving from the
    CPU; with device="cpu" the app builds (here over an empty index
    directory, so its warmup finds no index)."""
    from legalrag_tpu_torch.api import retrieval_api
    from legalrag_tpu_torch.api.server import create_app
    from legalrag_tpu_torch.config import AppConfig
    from legalrag_tpu_torch.pipeline.rag_pipeline import RagPipeline

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = AppConfig()
    cfg.paths.index_dir = tmp_path / "index"
    cfg.server.prewarm_buckets = 0
    for make in (lambda: create_app(cfg, build_async=False),
                 lambda: create_app(cfg, build_async=False, device="cuda"),
                 lambda: retrieval_api.create_app(cfg),
                 lambda: RagPipeline(cfg)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    app = create_app(cfg, build_async=False, device="cpu")
    assert app.state.device.type == "cpu" and app.state.warmup_done


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


def test_ingest_and_build_raise_without_cuda_unless_told(monkeypatch, tmp_path):
    """The ingest service grows the bundles of its cache on the cache's
    device (``cuda`` by default, which raises without CUDA), and the index
    build CLI builds on ``cuda`` unless given ``--device cpu``."""
    from legalrag_tpu_torch.cli import build_index
    from legalrag_tpu_torch.config import AppConfig
    from legalrag_tpu_torch.ingest.service import IngestService
    from legalrag_tpu_torch.retrieval.by_lang import BundleCache

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = AppConfig()
    cfg.paths.processed_dir = tmp_path / "processed"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        IngestService(cfg, BundleCache(cfg))
    assert IngestService(cfg, BundleCache(cfg, device="cpu")).queue.join(1)
    cfg_file = tmp_path / "cfg.json"
    cfg_file.write_text(json.dumps({"paths": {
        name: str(tmp_path / name) for name in (
            "data_dir", "raw_dir", "processed_dir", "index_dir", "graph_dir",
            "eval_dir", "upload_dir")}}))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_index.main(["--config", str(cfg_file)])
    build_index.main(["--config", str(cfg_file), "--device", "cpu"])
    assert not any((tmp_path / "index_dir").iterdir())  # no chunks: no bundle
