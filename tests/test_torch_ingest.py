"""Port PDF ingestion (``legalrag_tpu_torch/ingest``), the bundle cache's
``put`` and the live append vs the JAX package on the CPU.

The same bytes, texts and saved bundles go through both packages: the PDF
writer's bytes and the extracted text must be equal, the chunks byte-equal
as JSONL, and one upload through each package's ``IngestService`` over its
own copy of the same saved bundles must leave equal statuses, files and
stores (float stores within 1e-6; the stores are float32 here, so the
dense rows differ only by the projection's float32 sums and the port's
numpy draw of the default projection). The forced interleaving test holds
a request served in the middle of an append to the state from before it.
"""

import json
import shutil
import sys
import threading
import time

import numpy as np
import pytest

from legalrag_tpu.config import AppConfig as JaxConfig
from legalrag_tpu.corpus import write_chunks_jsonl as jax_write_chunks
from legalrag_tpu.graph import GraphBuilder as JaxGraphBuilder
from legalrag_tpu.index.bundle import IndexBundle as JaxBundle
from legalrag_tpu.ingest import minipdf as jax_minipdf
from legalrag_tpu.ingest import pdf_parser as jax_pdf_parser
from legalrag_tpu.ingest.ingestor import PDFIngestor as JaxIngestor
from legalrag_tpu.ingest.ingestor import compute_doc_id as jax_doc_id
from legalrag_tpu.ingest.service import IngestService as JaxIngestService
from legalrag_tpu.ingest.task_queue import TaskQueue as JaxTaskQueue
from legalrag_tpu.retrieval.by_lang import BundleCache as JaxBundleCache
from legalrag_tpu.retrieval.hybrid import HybridRetriever as JaxHybrid
from legalrag_tpu_torch.config import AppConfig
from legalrag_tpu_torch.index.bm25_index import BM25Index
from legalrag_tpu_torch.index.bundle import IndexBundle
from legalrag_tpu_torch.index.registry import IndexRegistry
from legalrag_tpu_torch.ingest import minipdf, pdf_parser
from legalrag_tpu_torch.ingest.ingestor import PDFIngestor, compute_doc_id
from legalrag_tpu_torch.ingest.service import IngestService
from legalrag_tpu_torch.ingest.task_queue import TaskQueue
from legalrag_tpu_torch.retrieval.by_lang import BundleCache
from legalrag_tpu_torch.retrieval.engine import FusedQueryEngine
from legalrag_tpu_torch.retrieval.hybrid import HybridRetriever
from legalrag_tpu_torch.tokenize import tokenize
from test_pdf_parser import (  # noqa: F401  (fixtures)
    BODY1,
    BODY2,
    BODY3,
    FakePage,
    FakePDF,
    _page_lines,
    fake_ocr,
    fake_pdfplumber,
)
from test_torch_engine import carry
from test_torch_hybrid import assert_same_hits, small_configs
from test_torch_index import port_chunks

ATOL = 1e-6
PATHS = ("data_dir", "raw_dir", "processed_dir", "index_dir", "graph_dir",
         "eval_dir", "upload_dir")

ZH_PAGES = ["中华人民共和国测试法\n第一章 一般规定\n第一条　为了测试，制定本法。\n"
            "第二条　本法适用于（测试）活动；任何人不得违反。",
            "第三条　括号 (nested (deep)) 与反斜杠 \\ 均应保留。\n第四条　完。"]
EN_PAGES = ["SECTION 2-306. Output, Requirements and Exclusive Dealings.\n"
            "(1) A term which measures the quantity by the output of the seller.",
            "SECTION 2-307. Delivery in Single Lot.\nparen (nested (deep)) "
            "and \\ slash; all goods must be tendered in a single delivery."]
GENERIC_EN = ("Widget Registration Guide\n\n"
              + " ".join(f"Widget rule {i}: every purple gadget must be "
                         f"registered within {i + 10} days of its purchase."
                         for i in range(40))
              + "\n\nRegistry office\n\nThe widget registry answers "
                "questions about purple gadgets on weekdays.")


def zh_slice(zh_text: str, first: str, stop: str) -> str:
    """The Civil Code's raw lines from the article line that starts with
    ``first`` up to the one that starts with ``stop`` (chapter lines
    included), under a title line."""
    lines = zh_text.splitlines()
    a = next(i for i, l in enumerate(lines) if l.startswith(first))
    b = next(i for i, l in enumerate(lines) if l.startswith(stop))
    return "测试民法\n" + "\n".join(lines[a:b])


# ------------------------------------------------------------ the writer

@pytest.mark.parametrize("pages", [ZH_PAGES, EN_PAGES], ids=["zh", "en"])
@pytest.mark.parametrize("compress", [True, False], ids=["flate", "plain"])
def test_build_pdf_bytes_equal_jax(pages, compress):
    got = minipdf.build_pdf(pages, compress=compress)
    assert got == jax_minipdf.build_pdf(pages, compress=compress)
    assert got.startswith(b"%PDF-1.4")


# -------------------------------------------------------- the extraction

def pdf_inputs():
    yield "zh_flate", jax_minipdf.build_pdf(ZH_PAGES)
    yield "zh_plain", jax_minipdf.build_pdf(ZH_PAGES, compress=False)
    yield "en_flate", jax_minipdf.build_pdf(EN_PAGES)
    yield "empty_page", jax_minipdf.build_pdf([""])
    yield "not_a_pdf", b"not a pdf at all"
    yield "no_objects", b"%PDF-1.4\nno objects here"
    # hex strings, TJ arrays with kerns, Td / Tm / ' operators, one font
    stream = (b"BT /F1 11 Tf 56 780 Td [(Hel) -50 (lo) -300 (World)] TJ "
              b"0 -14 Td <48657820> Tj (quote) ' 1 0 0 1 56 700 Tm "
              b"(moved) Tj ET")
    yield "operators", (
        b"%PDF-1.4\n1 0 obj\n<< /Type /Catalog /Pages 2 0 R >>\nendobj\n"
        b"2 0 obj\n<< /Type /Pages /Count 1 /Kids [3 0 R] >>\nendobj\n"
        b"3 0 obj\n<< /Type /Page /Parent 2 0 R /Resources << /Font << "
        b"/F1 5 0 R >> >> /Contents 4 0 R >>\nendobj\n"
        + b"4 0 obj\n<< /Length %d >>\nstream\n" % len(stream) + stream
        + b"\nendstream\nendobj\n"
        b"5 0 obj\n<< /Type /Font /Subtype /Type1 /BaseFont /Helvetica >>\n"
        b"endobj\n")


@pytest.mark.parametrize("data", [d for _n, d in pdf_inputs()],
                         ids=[n for n, _d in pdf_inputs()])
def test_extract_pdf_text_equal_jax(data):
    got = minipdf.extract_pdf_text(data)
    assert got == jax_minipdf.extract_pdf_text(data)


CMAPS = [
    b"2 beginbfchar\n<0001> <4E2D>\n<0002> <0041>\nendbfchar\n",
    (b"1 begincodespacerange\n<0000> <FFFF>\nendcodespacerange\n"
     b"1 beginbfrange\n<0005> <0007> <4E00>\nendbfrange\n"
     b"1 beginbfrange\n<0010> <0011> [<4F60> <597D>]\nendbfrange\n"),
    b"1 beginbfrange\n<00FE> <0101> <D83DDE00>\nendbfrange\n",
    b"nothing to map",
]


@pytest.mark.parametrize("cmap", CMAPS, ids=["bfchar", "bfrange_both",
                                             "surrogate_range", "empty"])
def test_parse_tounicode_equal_jax(cmap):
    assert minipdf._parse_tounicode(cmap) == jax_minipdf._parse_tounicode(cmap)


TRIM = ["  ＡＢＣ　全角 第一条 ",
        "目录\n第一章 总则\n第一条 目录行\n正文开始\n第一条 为了保护。\n第二条 完。",
        "目 录\n总则\n",
        "no toc here\n第一条 x",
        ""]


@pytest.mark.parametrize("text", TRIM, ids=["nfkc", "toc", "toc_no_article",
                                            "no_toc", "empty"])
def test_trim_law_body_equal_jax(text):
    assert pdf_parser.trim_law_body(text) == jax_pdf_parser.trim_law_body(text)


@pytest.mark.parametrize("name,data", [("zh.pdf", jax_minipdf.build_pdf(ZH_PAGES)),
                                       ("en.PDF", jax_minipdf.build_pdf(EN_PAGES)),
                                       ("notes.txt", "第一条 文本\r\n".encode()),
                                       ("bad.md", b"\xff\xfe bytes")],
                         ids=["zh_pdf", "en_pdf", "txt", "md_undecodable"])
def test_extraction_ladder_without_pdfplumber_equal_jax(name, data, tmp_path,
                                                        monkeypatch):
    """The minipdf rung for PDFs (pdfplumber masked in ``sys.modules`` for
    both packages), UTF-8 decoding for text payloads."""
    monkeypatch.setitem(sys.modules, "pdfplumber", None)
    path = tmp_path / name
    path.write_bytes(data)
    got = pdf_parser.extract_text(path)
    assert got == jax_pdf_parser.extract_text(path) and got


def test_extraction_ladder_raises_as_jax_when_nothing_decodes(tmp_path,
                                                              monkeypatch):
    monkeypatch.setitem(sys.modules, "pdfplumber", None)
    path = tmp_path / "scan.pdf"
    path.write_bytes(b"%PDF-1.4\n1 0 obj\n<< /Type /Catalog >>\nendobj\n")
    with pytest.raises(RuntimeError) as got:
        pdf_parser.extract_text(path)
    with pytest.raises(RuntimeError) as want:
        jax_pdf_parser.extract_text(path)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("ocr", [True, False], ids=["ocr", "no_ocr"])
def test_pdfplumber_rung_equal_jax(fake_pdfplumber, fake_ocr, ocr, tmp_path):
    """The pdfplumber rung through the JAX tests' fake module: the layout
    text (headers, footers and page numbers dropped) or the raw text, with
    OCR for an empty page when enabled."""
    fake_pdfplumber._pdf = FakePDF([
        FakePage(_page_lines(BODY1, 1), 1),
        FakePage([], 2, text=""),
        FakePage(_page_lines(BODY2, 3), 3),
        FakePage(_page_lines(BODY3, 4), 4, broken_words=True)])
    path = tmp_path / "law.pdf"
    path.write_bytes(b"%PDF-1.4")
    got = pdf_parser.extract_text(path, enable_ocr=ocr)
    assert got == jax_pdf_parser.extract_text(path, enable_ocr=ocr)


# ------------------------------------------------------------- chunking

@pytest.mark.parametrize("name,text", [("a.pdf", "第一条 x"), ("b.txt", ""),
                                       ("合同.pdf", "中文 text\n" * 50)])
def test_compute_doc_id_equal_jax(name, text):
    assert compute_doc_id(name, text) == jax_doc_id(name, text)


def gate_cases(zh_text):
    statute = zh_slice(zh_text, "第六十一条", "第九十一条")
    few = zh_slice(zh_text, "第六十一条", "第六十六条")
    gaps = "测试法\n" + "\n".join(
        f"第{n}条 第{n}条的规定内容，用于测试条文编号的间隔。"
        for n in ("一", "十", "二十", "三十", "四十", "五十", "六十", "七十",
                  "八十", "九十", "一百", "一百一十", "一百二十", "一百三十",
                  "一百四十", "一百五十", "一百六十", "一百七十", "一百八十",
                  "一百九十", "二百", "二百一十"))
    preamble = "前言。" * 8000 + "\n" + statute
    return [("statute", statute, {}), ("few_records", few, {}),
            ("gaps", gaps, {}), ("low_coverage", preamble, {}),
            ("long_records", few, {"min_statute_records": 2}),
            ("generic_en", GENERIC_EN, {}),
            ("generic_overlap0", GENERIC_EN, {"chunk_overlap": 0}),
            ("ucc", None, {})]


def gate_case_ids():
    return ["statute", "few_records", "gaps", "low_coverage", "long_records",
            "generic_en", "generic_overlap0", "ucc"]


@pytest.mark.parametrize("case", range(8), ids=gate_case_ids())
def test_to_chunks_and_gate_equal_jax(case, zh_text, ucc_texts):
    name, text, pdf = gate_cases(zh_text)[case]
    if text is None:
        text = ucc_texts["ucc_8.txt"] + "\n" + ucc_texts["ucc_9.txt"]
    jcfg, cfg = JaxConfig(), AppConfig()
    for k, v in pdf.items():
        setattr(jcfg.pdf, k, v)
        setattr(cfg.pdf, k, v)
    text = pdf_parser.trim_law_body(text)
    doc_id = compute_doc_id(f"{name}.txt", text)
    got = PDFIngestor(cfg)._to_chunks(text, f"{name}.txt", doc_id)
    want = JaxIngestor(jcfg)._to_chunks(text, f"{name}.txt", doc_id)
    assert [c.to_json() for c in got] == \
        [c.model_dump_json(exclude_none=True) for c in want]
    statute = name in ("statute", "ucc")
    assert all((c.id.split(":")[1] == c.article_id) == statute for c in got)
    if not statute:   # generic labels are unique
        labels = [c.article_no for c in got]
        assert len(set(labels)) == len(labels)


def test_task_queue_survives_a_failing_task():
    ran = []

    def boom():
        raise ValueError("task failed on purpose")

    for q in (TaskQueue("t"), JaxTaskQueue("t")):
        ran.clear()
        q.enqueue(boom)
        q.enqueue(ran.append, 1)
        q.enqueue(lambda: time.sleep(0.05))
        q.enqueue(ran.append, 2)
        assert q.join(timeout=10)
        assert ran == [1, 2] and q._worker.is_alive()
    slow = TaskQueue("slow")
    slow.enqueue(time.sleep, 0.5)
    assert slow.join(timeout=0.05) is False
    assert slow.join(timeout=10)


# ------------------------------------------------- one upload, both packages

def config_pair(root_j, root_p, colbert: bool = True):
    jcfg, cfg = JaxConfig(), AppConfig()
    for c, root in ((jcfg, root_j), (cfg, root_p)):
        c.engine.capacity_round = 64
        c.engine.late_doc_maxlen = 64
        c.engine.dtype = "float32"
        c.retrieval.enable_colbert = colbert
        for name in PATHS:
            setattr(c.paths, name, root / name)
        c._apply_lang_paths(c.lang)
    return jcfg, cfg


@pytest.fixture(scope="module")
def base_root(tmp_path_factory, zh_chunks, en_chunks):
    """Bundles (zh: 60 articles, en: 60 sections) saved by the JAX package,
    with their processed corpora and law graphs: what the CLIs leave."""
    root = tmp_path_factory.mktemp("ingest_base")
    jcfg, _ = config_pair(root, root)
    jcfg.paths.ensure_tree()
    for lang, chunks in (("zh", zh_chunks[:60]), ("en", en_chunks[:60])):
        lc = jcfg.with_lang(lang)
        jax_write_chunks(chunks, lc.paths.corpus_file)
        JaxBundle.build_from_chunks(chunks, lc, lang).save(lc.paths.lang_index_dir)
        JaxGraphBuilder().build_to_file(chunks, lc.paths.graph_file)
    return root


def uploads(zh_text):
    """Articles 61-90 as a two-page PDF (the statute route), and a generic
    English text."""
    lines = zh_slice(zh_text, "第六十一条", "第九十一条").split("\n")
    pages = ["\n".join(lines[:20]), "\n".join(lines[20:])]
    return {"statute_pdf": ("测试民法.pdf", minipdf.build_pdf(pages)),
            "generic_txt": ("widgets.txt", GENERIC_EN.encode())}


def ingest_both(base_root, tmp_path, filename, content, colbert=True):
    """Each package's IngestService over its own copy of ``base_root``,
    one upload, the queue drained: (JAX side, port side, doc ids)."""
    root_j, root_p = tmp_path / "jax", tmp_path / "port"
    shutil.copytree(base_root, root_j)
    shutil.copytree(base_root, root_p)
    jcfg, cfg = config_pair(root_j, root_p, colbert)
    jcache = JaxBundleCache(jcfg)
    cache = BundleCache(cfg, device="cpu")
    jsvc, svc = JaxIngestService(jcfg, jcache), IngestService(cfg, cache)
    jid, jn = jsvc.ingest_upload_and_schedule(filename, content)
    pid, pn = svc.ingest_upload_and_schedule(filename, content)
    assert (pid, pn) == (jid, jn)
    assert jsvc.queue.join(timeout=120) and svc.queue.join(timeout=120)
    return (jcfg, jcache, jsvc), (cfg, cache, svc), pid


def assert_same_stores(jb, tb):
    n = tb.n_docs
    assert (tb.n_docs, tb.generation) == (jb.n_docs, jb.generation)
    assert tb.dense.capacity == jb.dense.capacity
    np.testing.assert_allclose(tb.dense.emb[:n].numpy(),
                               np.asarray(jb.dense.emb, np.float32)[:n],
                               rtol=0, atol=ATOL)
    assert tb.bm25.vocab == jb.bm25.vocab
    np.testing.assert_allclose(tb.bm25.impact.numpy(),
                               np.asarray(jb.bm25.impact), rtol=0, atol=ATOL)
    if jb.tokens.n:
        assert tb.tokens.n == jb.tokens.n
        np.testing.assert_allclose(tb.tokens.tok[:n].numpy(),
                                   np.asarray(jb.tokens.tok, np.float32)[:n],
                                   rtol=0, atol=ATOL)
        np.testing.assert_array_equal(tb.tokens.mask[:n].numpy(),
                                      np.asarray(jb.tokens.mask)[:n])
    np.testing.assert_array_equal(tb.encoder.df, jb.encoder.df)
    assert tb.encoder.n_docs == jb.encoder.n_docs
    assert [c.to_json() for c in tb.chunks] == \
        [c.model_dump_json(exclude_none=True) for c in jb.chunks]


def manifest_of(d):
    m = json.loads((d / "manifest.json").read_text(encoding="utf-8"))
    m.pop("created_unix")
    return m


@pytest.mark.parametrize("kind,colbert", [("statute_pdf", True),
                                          ("generic_txt", True),
                                          ("statute_pdf", False)],
                         ids=["statute_pdf", "generic_txt", "statute_no_colbert"])
def test_ingest_service_upload_matches_jax(base_root, tmp_path, zh_text,
                                           monkeypatch, kind, colbert):
    monkeypatch.setitem(sys.modules, "pdfplumber", None)
    filename, content = uploads(zh_text)[kind]
    (jcfg, jcache, jsvc), (cfg, cache, svc), doc_id = ingest_both(
        base_root, tmp_path, filename, content, colbert)
    status = svc.get_status(doc_id)
    assert status == jsvc.get_status(doc_id)
    assert status == {"faiss": "added", "bm25": "added",
                      "colbert": "added" if colbert else "disabled",
                      "graph": "added"}
    lang = "zh" if kind == "statute_pdf" else "en"
    jdir = jcache.index_dir(lang)
    pdir = cache.index_dir(lang)
    assert manifest_of(pdir) == manifest_of(jdir)
    for name in ("chunks.jsonl",):
        assert (pdir / name).read_bytes() == (jdir / name).read_bytes()
    out = f"ingested_{doc_id}.jsonl"
    assert (cfg.paths.processed_dir / out).read_bytes() == \
        (jcfg.paths.processed_dir / out).read_bytes()
    assert (cfg.paths.upload_dir / filename).read_bytes() == content
    for g in ("zh", "en"):
        gf = f"law_graph_{g}.jsonl"
        assert (cfg.paths.graph_dir / gf).read_bytes() == \
            (jcfg.paths.graph_dir / gf).read_bytes()
    tb, jb = cache.get(lang), jcache.get(lang)
    assert_same_stores(jb, tb)
    assert tb.n_docs > 60
    if kind == "statute_pdf":
        assert tb.dense.capacity == 128  # grew across the 64-row boundary
        assert {c.id for c in tb.chunks[60:]} == \
            {f"{doc_id}:{n}" for n in range(61, 91)}


def test_ingest_job_failure_status_matches_jax(base_root, tmp_path, zh_text,
                                               monkeypatch):
    """A job that raises leaves ``error: <message>`` on its keys, as in
    JAX; the graph job still runs."""
    def no_space(self, index_dir):
        raise OSError("no space left on device")

    monkeypatch.setattr(IndexBundle, "save", no_space)
    monkeypatch.setattr(JaxBundle, "save", no_space)
    filename, content = uploads(zh_text)["generic_txt"]
    (_jcfg, _jc, jsvc), (_cfg, _c, svc), doc_id = ingest_both(
        base_root, tmp_path, filename, content)
    status = svc.get_status(doc_id)
    assert status == jsvc.get_status(doc_id)
    assert status == {"faiss": "error: no space left on device",
                      "bm25": "error: no space left on device",
                      "colbert": "error: no space left on device",
                      "graph": "added"}
    assert svc.get_status("unknown") == jsvc.get_status("unknown") == {}


def test_ingest_rejects_text_free_uploads_as_jax(base_root, tmp_path,
                                                 monkeypatch):
    monkeypatch.setitem(sys.modules, "pdfplumber", None)
    root_j, root_p = tmp_path / "jax", tmp_path / "port"
    jcfg, cfg = config_pair(root_j, root_p)
    jsvc = JaxIngestService(jcfg, JaxBundleCache(jcfg))
    svc = IngestService(cfg, BundleCache(cfg, device="cpu"))
    for name, data, exc in (("blank.txt", b"  \n\t ", ValueError),
                            ("scan.pdf", minipdf.build_pdf([""]), RuntimeError)):
        with pytest.raises(exc) as got:
            svc.ingest_upload_and_schedule(name, data)
        with pytest.raises(exc) as want:
            jsvc.ingest_upload_and_schedule(name, data)
        assert str(got.value) == str(want.value)


# ------------------------------------------------- a request mid-append

def test_request_in_the_middle_of_an_append_reads_the_state_before_it(
        en_chunks, monkeypatch):
    """The ingest worker is stopped inside the BM25 rebuild of an append
    (after the dense and token appends and the vocabulary refill, before
    the impact matrix is replaced) and requests are served then: they must
    give the lists from before the append, never an error; after it, the
    lists equal JAX's after the same append."""
    jcfg, cfg = small_configs()
    base, new = en_chunks[:120], en_chunks[300:340]
    jb = JaxBundle.build_from_chunks(base, jcfg, "en")
    tb = carry(jb, cfg)
    jhr, hr = JaxHybrid(jb, jcfg), HybridRetriever(tb, cfg)
    engine = FusedQueryEngine(tb, cfg)
    # a question made of a new section's own words, some not in the old
    # vocabulary
    q = new[0].text[:120]
    assert sum(t not in tb.bm25.vocab for t in tokenize(q, "en", query=True)) > 3
    before = hr.search(q)
    before_batch = engine.search_hits([q, "security interest"], 10)
    assert_same_hits(before, jhr.search(q))

    reached, release = threading.Event(), threading.Event()
    materialize = BM25Index._materialize

    def paused(self):
        if threading.current_thread().name == "appender":
            reached.set()
            assert release.wait(60)
        materialize(self)

    monkeypatch.setattr(BM25Index, "_materialize", paused)
    added = []
    t = threading.Thread(
        target=lambda: added.append(tb.add_chunks(port_chunks(new))),
        name="appender")
    t.start()
    try:
        assert reached.wait(60)
        during = hr.search(q)
        during_batch = engine.search_hits([q, "security interest"], 10)
        mid = (tb.n_docs, tb.generation)
    finally:
        release.set()
        t.join(60)
    assert not t.is_alive() and added == [40]
    assert mid == (120, jb.generation)
    assert [(h.chunk.id, h.score) for h in during] == \
        [(h.chunk.id, h.score) for h in before]
    assert [[(h.chunk.id, h.score) for h in hs] for hs in during_batch] == \
        [[(h.chunk.id, h.score) for h in hs] for hs in before_batch]

    jb.add_chunks(new)
    after = hr.search(q)
    assert_same_hits(after, jhr.search(q))
    assert after[0].chunk.id in {c.id for c in new}
    assert tb.n_docs == jb.n_docs == 160 and tb.generation == jb.generation


def test_bundle_fields_are_read_only(en_chunks):
    """A bundle publishes whole states only (build, load, append): none of
    its fields can be set on its own, so no store can be swapped in beside
    a state it does not match."""
    _jcfg, cfg = small_configs()
    tb = IndexBundle.build_from_chunks(port_chunks(en_chunks[:20]), cfg, "en",
                                       device="cpu")
    st = tb.state
    for name in ("encoder", "dense", "bm25", "tokens", "chunks", "id2row",
                 "generation"):
        with pytest.raises(AttributeError):
            setattr(tb, name, getattr(tb, name))
        assert getattr(tb, name) is getattr(st, name)
    assert tb.state is st and st.generation == 1


def test_appends_under_concurrent_reads_publish_whole_states(en_chunks):
    """Stress: 6 reader threads (more than this test's appends need) serve
    channels calls and read states while a writer appends 10 batches, with
    the interpreter switching threads every 10 us. Every state a reader
    takes has its stores, chunks and id map of one size, and every row a
    channels call returns lies inside the state it read."""
    _jcfg, cfg = small_configs()
    cfg.engine.capacity_round = 16     # a capacity crossing every few appends
    chunks = port_chunks(en_chunks[:90])
    tb = IndexBundle.build_from_chunks(chunks[:40], cfg, "en", device="cpu")
    hr = HybridRetriever(tb, cfg)
    questions = [c.text[:80] for c in chunks[40:90:7]]
    errors, seen, done = [], [], threading.Event()

    def reader(k):
        i = 0
        while not done.is_set():
            try:
                st = tb.state
                n = len(st.chunks)
                assert st.dense.n == st.tokens.n == st.bm25.n == n
                assert len(st.id2row) == n
                assert st.dense.capacity >= n and st.tokens.capacity >= n
                out = hr._channels_topk_batch([questions[(i + k) % len(
                    questions)]], 20)
                top = max(int(out[ch][1].max()) for ch in
                          ("dense", "bm25", "colbert"))
                assert top < tb.n_docs
                seen.append(n)
            except Exception as e:  # reported below, with the thread's stop
                errors.append(repr(e))
                return
            i += 1

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=reader, args=(k,)) for k in range(6)]
        for t in threads:
            t.start()
        for lo in range(40, 90, 5):
            assert tb.add_chunks(chunks[lo:lo + 5]) == 5
    finally:
        done.set()
        for t in threads:
            t.join(60)
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[:3]
    assert tb.n_docs == 90 and tb.generation == 11
    assert tb.dense.capacity == tb.tokens.capacity == 96
    assert len(set(seen)) > 2   # the readers saw several generations


# ------------------------------------------------- activation and the cache

@pytest.mark.parametrize("package", ["port", "jax"])
def test_activating_a_version_without_a_higher_generation_is_not_picked_up(
        package, en_chunks, tmp_path):
    """``BundleCache.get`` reloads only when the active directory's
    generation is above the one in memory: activating a version saved at
    the same generation leaves the old bundle serving (the JAX behaviour,
    kept); one saved at a higher generation is picked up."""
    if package == "port":
        cfg, Bundle = small_configs()[1], IndexBundle
        cache_of = lambda c: BundleCache(c, device="cpu", check_interval=0.0)
        build = lambda ch, c: Bundle.build_from_chunks(ch, c, "en", device="cpu")
    else:
        cfg, Bundle = small_configs()[0], JaxBundle
        cache_of = lambda c: JaxBundleCache(c, check_interval=0.0)
        build = lambda ch, c: Bundle.build_from_chunks(ch, c, "en")
    cfg.paths.index_dir = tmp_path / "index"
    reg = IndexRegistry(tmp_path / "index" / "en")
    chunks = en_chunks if package == "jax" else port_chunks(en_chunks[:80])
    build(chunks[:50], cfg).save(reg.versions_root() / "v1")
    build(chunks[:70], cfg).save(reg.versions_root() / "v2")
    grown = build(chunks[:70], cfg)
    grown.add_chunks(chunks[70:80])
    grown.save(reg.versions_root() / "v3")
    reg.activate("v1")
    cache = cache_of(cfg)
    assert cache.get("en").n_docs == 50
    reg.activate("v2")                      # generation 1, as v1's
    assert cache.index_dir("en") == reg.versions_root() / "v2"
    assert cache.get("en").n_docs == 50
    reg.activate("v3")                      # generation 2
    assert cache.get("en").n_docs == 80
    live = cache.get("en")
    cache.put("en", live)
    assert cache.get("en") is live


def test_put_installs_the_grown_bundle_for_the_retriever(en_chunks, tmp_path):
    from legalrag_tpu_torch.retrieval.by_lang import ByLangRetriever

    cfg = small_configs()[1]
    cfg.paths.index_dir = tmp_path / "index"
    cfg.paths.graph_dir = tmp_path / "graph"
    lc = cfg.with_lang("en")
    chunks = port_chunks(en_chunks[:60])
    IndexBundle.build_from_chunks(chunks[:50], lc, "en",
                                  device="cpu").save(lc.paths.lang_index_dir)
    cache = BundleCache(cfg, device="cpu", check_interval=3600.0)
    by_lang = ByLangRetriever(cfg, cache=cache)
    hr = by_lang.retriever("en")
    grown = IndexBundle.load(lc.paths.lang_index_dir, lc, "en", device="cpu")
    grown.add_chunks(chunks[50:60])
    cache.put("en", grown)
    assert cache.get("en") is grown
    assert by_lang.retriever("en").bundle is grown is not hr.bundle
