"""The port's offline build CLIs (``legalrag_tpu_torch/cli``), the index
registry and its HTTP face (``api/index_api.py``) vs the JAX scripts and
service on the CPU.

Both packages run their own CLIs in-process over their own copy of one raw
tree (the trimmed statute of ``tests/test_cli_e2e.py``): preprocess, then a
versioned index build with activation (the port's with ``--device cpu``),
then the law graph. The processed JSONL, the graph and ``ACTIVE`` must be
byte-equal; the bundle's ``chunks.jsonl`` byte-equal, its manifest equal
but for ``created_unix``, its BM25, token and encoder arrays equal, and its
dense rows within one bf16 step (the port draws the default projection in
numpy; it differs from JAX's by erfinv's residue, and the float32 sums run
in another order, so a row element may round to the neighbouring bf16
value). ``index_admin``'s output and the index service's JSON must be the
same, with each root's path in its place."""

import io
import json
import sys
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch

from legalrag_tpu.api.index_api import create_app as jax_index_app
from legalrag_tpu.api.webcore import TestClient as JaxTestClient
from legalrag_tpu.config import AppConfig as JaxConfig
from legalrag_tpu.index.registry import IndexRegistry as JaxRegistry
from legalrag_tpu_torch.api.index_api import create_app as index_app
from legalrag_tpu_torch.api.webcore import TestClient
from legalrag_tpu_torch.cli import build_graph, build_index, index_admin, preprocess_law
from legalrag_tpu_torch.config import AppConfig
from legalrag_tpu_torch.index.registry import IndexRegistry
from scripts import build_graph as jax_build_graph
from scripts import build_index as jax_build_index
from scripts import index_admin as jax_index_admin
from scripts import preprocess_law as jax_preprocess_law
from test_torch_index import bf16_ulp

PATHS = ("data_dir", "raw_dir", "processed_dir", "index_dir", "graph_dir",
         "eval_dir", "upload_dir")


def write_root(root: Path, statute: str) -> Path:
    """A raw tree and the JSON config that points every path into it."""
    raw = root / "data" / "raw"
    raw.mkdir(parents=True)
    (raw / "mini_law.txt").write_text(statute, encoding="utf-8")
    paths = {"root": str(root), "data_dir": str(root / "data")}
    for name in PATHS[1:]:
        paths[name] = str(root / "data" / name.removesuffix("_dir"))
    cfg = root / "config.json"
    cfg.write_text(json.dumps({"paths": paths}), encoding="utf-8")
    return cfg


def run_jax(module, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [module.__name__] + argv)
    out = io.StringIO()
    with redirect_stdout(out):
        module.main()
    return out.getvalue()


def run_port(main, argv):
    out = io.StringIO()
    with redirect_stdout(out):
        main(argv)
    return out.getvalue()


@pytest.fixture(scope="module")
def built(tmp_path_factory, zh_text):
    """(JAX config path, port config path) after preprocess, build_index
    --index-version v1 --activate and build_graph in each package."""
    lines = zh_text.splitlines()
    start = next(i for i, l in enumerate(lines) if l.startswith("第一条"))
    end = next(i for i, l in enumerate(lines) if l.startswith("第八十一条"))
    statute = "中华人民共和国民法典\n" + "\n".join(lines[start:end])
    mp = pytest.MonkeyPatch()
    try:
        jroot = tmp_path_factory.mktemp("cli_jax")
        proot = tmp_path_factory.mktemp("cli_port")
        jcfg, pcfg = write_root(jroot, statute), write_root(proot, statute)
        jc = JaxConfig.load(jcfg)
        run_jax(jax_preprocess_law, ["--raw-dir", str(jc.paths.raw_dir),
                                     "--out-dir", str(jc.paths.processed_dir)],
                mp)
        run_jax(jax_build_index, ["--config", str(jcfg), "--index-version",
                                  "v1", "--activate"], mp)
        run_jax(jax_build_graph, ["--config", str(jcfg)], mp)
        run_port(preprocess_law.main, ["--config", str(pcfg)])
        run_port(build_index.main, ["--config", str(pcfg), "--index-version",
                                    "v1", "--activate", "--device", "cpu"])
        run_port(build_graph.main, ["--config", str(pcfg)])
    finally:
        mp.undo()
    return jcfg, pcfg


def data(cfg_path) -> Path:
    return Path(json.loads(cfg_path.read_text())["paths"]["data_dir"])


def test_processed_corpus_and_graph_byte_equal(built):
    jcfg, pcfg = built
    for rel in ("processed/law_zh.jsonl", "graph/law_graph_zh.jsonl"):
        got, want = (data(pcfg) / rel).read_bytes(), (data(jcfg) / rel).read_bytes()
        assert got == want, rel
    assert len((data(pcfg) / "processed/law_zh.jsonl").read_text(
        encoding="utf-8").splitlines()) == 80


def test_versioned_bundle_and_active_pointer_match_jax(built):
    jcfg, pcfg = built
    jroot, proot = data(jcfg) / "index" / "zh", data(pcfg) / "index" / "zh"
    assert (proot / "ACTIVE").read_bytes() == (jroot / "ACTIVE").read_bytes() \
        == b"v1"
    assert sorted(p.name for p in proot.iterdir()) == \
        sorted(p.name for p in jroot.iterdir()) == ["ACTIVE", "versions"]
    jd, pd = jroot / "versions" / "v1", proot / "versions" / "v1"
    assert sorted(p.name for p in pd.iterdir()) == \
        sorted(p.name for p in jd.iterdir())
    assert (pd / "chunks.jsonl").read_bytes() == (jd / "chunks.jsonl").read_bytes()
    got = json.loads((pd / "manifest.json").read_text())
    want = json.loads((jd / "manifest.json").read_text())
    assert list(got) == list(want)
    got.pop("created_unix"), want.pop("created_unix")
    assert got == want and got["n_docs"] == 80 and got["generation"] == 1
    for name in ("bm25.npz", "tokens.npz", "encoder.npz"):
        g, w = np.load(pd / name), np.load(jd / name)
        assert sorted(g.files) == sorted(w.files), name
        for k in w.files:
            np.testing.assert_array_equal(g[k], w[k], err_msg=f"{name}:{k}")
    g, w = np.load(pd / "dense.npz"), np.load(jd / "dense.npz")
    assert (int(g["n"]), int(g["dim"])) == (int(w["n"]), int(w["dim"])) == (80, 768)
    ge, we = g["emb"].astype(np.float32), w["emb"].astype(np.float32)
    ulp = bf16_ulp(np.maximum(np.abs(ge), np.abs(we)))
    assert (np.abs(ge - we) <= np.maximum(ulp, 1e-6)).all()
    assert (ge == we).mean() > 0.99
    # the config resolves the active version through the registry, as JAX's
    pc, jc = AppConfig.load(pcfg), JaxConfig.load(jcfg)
    assert pc.with_lang("zh").paths.lang_index_dir == pd
    assert jc.with_lang("zh").paths.lang_index_dir == jd


def test_build_index_variants_match_jax(built, monkeypatch):
    """``--lang`` and ``--no-colbert`` into the unversioned root, beside
    the active version; a language with no chunks builds nothing."""
    jcfg, pcfg = built
    run_jax(jax_build_index, ["--config", str(jcfg), "--lang", "zh",
                              "--no-colbert"], monkeypatch)
    run_port(build_index.main, ["--config", str(pcfg), "--lang", "zh",
                                "--no-colbert", "--device", "cpu"])
    run_port(build_index.main, ["--config", str(pcfg), "--lang", "en",
                                "--device", "cpu"])   # no en chunks: nothing
    jroot, proot = data(jcfg) / "index" / "zh", data(pcfg) / "index" / "zh"
    assert sorted(p.name for p in proot.iterdir()) == \
        sorted(p.name for p in jroot.iterdir())
    assert not (proot / "tokens.npz").exists()
    assert (proot / "chunks.jsonl").read_bytes() == \
        (jroot / "chunks.jsonl").read_bytes()
    assert not (data(pcfg) / "index" / "en").exists()
    assert (proot / "ACTIVE").read_text() == "v1"


def test_build_index_needs_a_card_unless_told(built, monkeypatch):
    _jcfg, pcfg = built
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_index.main(["--config", str(pcfg)])
    with pytest.raises(SystemExit):
        build_index.main(["--config", str(pcfg), "--device", "tpu"])


@pytest.mark.parametrize("argv", [["list", "--lang", "zh"],
                                  ["active", "--lang", "zh"],
                                  ["list", "--lang", "en"],
                                  ["active", "--lang", "en"],
                                  ["activate", "v1", "--lang", "zh"]],
                         ids=["list", "active", "list_empty", "active_unversioned",
                              "activate"])
def test_index_admin_output_matches_jax(built, argv, monkeypatch):
    jcfg, pcfg = built

    class JaxLoad:   # the JAX script reads the default config: give it ours
        @staticmethod
        def load(path=None, **kw):
            return JaxConfig.load(jcfg)

    monkeypatch.setattr(jax_index_admin, "AppConfig", JaxLoad)
    want = run_jax(jax_index_admin, argv, monkeypatch)
    got = run_port(index_admin.main, argv + ["--config", str(pcfg)])
    assert got == want.replace(str(data(jcfg)), str(data(pcfg)))


def test_index_admin_activate_errors_match_jax(built, monkeypatch):
    jcfg, pcfg = built

    class JaxLoad:
        @staticmethod
        def load(path=None, **kw):
            return JaxConfig.load(jcfg)

    monkeypatch.setattr(jax_index_admin, "AppConfig", JaxLoad)
    for argv, exc in ((["activate", "--lang", "zh"], SystemExit),
                      (["activate", "v9", "--lang", "zh"], FileNotFoundError)):
        with pytest.raises(exc) as want:
            run_jax(jax_index_admin, argv, monkeypatch)
        with pytest.raises(exc) as got:
            run_port(index_admin.main, argv + ["--config", str(pcfg)])
        assert str(got.value) == str(want.value).replace(str(data(jcfg)),
                                                         str(data(pcfg)))


def test_index_api_matches_jax(built):
    jcfg, pcfg = built
    jc = JaxTestClient(jax_index_app(JaxConfig.load(jcfg)))
    pc = TestClient(index_app(AppConfig.load(pcfg)))
    calls = [("get", "/index/active"), ("get", "/index/active?lang=en"),
             ("get", "/index/list"), ("get", "/index/list?lang=en"),
             ("post", "/index/activate/v1"), ("post", "/index/activate/v9"),
             ("post", "/index/activate/v1?lang=en"), ("get", "/index/nope")]
    statuses = []
    for method, path in calls:
        got, want = getattr(pc, method)(path), getattr(jc, method)(path)
        body = json.loads(want.text.replace(str(data(jcfg)), str(data(pcfg))))
        assert (got.status, got.json()) == (want.status, body), path
        statuses.append(got.status)
    assert statuses == [200, 200, 200, 200, 200, 404, 404, 404]
    assert pc.get("/index/list").json() == {"versions": ["v1"]}


def test_registry_matches_jax(tmp_path):
    for reg_cls, root in ((IndexRegistry, tmp_path / "p"),
                          (JaxRegistry, tmp_path / "j")):
        reg = reg_cls(root)
        assert reg.active_version() is None and reg.list_versions() == []
        assert reg.active_index_dir() == root
        (root / "versions" / "b").mkdir(parents=True)
        (root / "versions" / "a").mkdir()
        (root / "versions" / "not_a_dir").write_text("x")
        assert reg.list_versions() == ["a", "b"]
        assert reg.activate("b") == root / "versions" / "b"
        assert reg.active_version() == "b"
        assert reg.active_index_dir() == root / "versions" / "b"
        (root / "ACTIVE").write_text("gone\n")  # a pointer to nothing
        assert reg.active_index_dir() == root
        (root / "ACTIVE").write_text("  \n")
        assert reg.active_version() is None
        with pytest.raises(FileNotFoundError):
            reg.activate("c")
        assert not (root / "ACTIVE.tmp").exists()


def test_pdf_config_loads_as_jax(tmp_path):
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps({"pdf": {"chunk_chars": 300, "enable_ocr": True,
                                        "statute_gap_ratio_max": 0.25}}))
    got, want = AppConfig.load(path, mkdirs=False), JaxConfig.load(path, mkdirs=False)
    for mine, theirs in ((got.pdf, want.pdf), (AppConfig().pdf, JaxConfig().pdf)):
        theirs = theirs.model_dump()
        # the one field the JAX package declares and reads nowhere
        assert set(theirs) - set(vars(mine)) == {"ingest_rebuild_colbert"}
        assert vars(mine) == {k: theirs[k] for k in vars(mine)}
    assert got.pdf.chunk_chars == 300 and got.pdf.enable_ocr


def test_profile_session_writes_a_trace_when_asked(tmp_path, monkeypatch):
    from legalrag_tpu_torch.utils.tracing import profile_session, trace_span

    monkeypatch.delenv("LEGALRAG_TRACE_DIR", raising=False)
    with profile_session():
        torch.ones(4).sum()
    assert not list(tmp_path.iterdir())
    monkeypatch.setenv("LEGALRAG_TRACE_DIR", str(tmp_path / "env"))
    with profile_session():
        with trace_span("retrieval.channels"):
            torch.ones(4).sum()
    with pytest.raises(ValueError):
        with profile_session(str(tmp_path / "arg")):
            raise ValueError("the region failed")
    for d in ("env", "arg"):
        (trace,) = (tmp_path / d).iterdir()
        assert trace.suffix == ".json"
    events = json.loads(next((tmp_path / "env").iterdir()).read_text())
    assert any(e.get("name") == "retrieval.channels"
               for e in events["traceEvents"])
