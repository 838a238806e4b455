"""The port's ``CaseRetriever`` (``retrieval/case_retriever.py``), its
``CaseEntry`` / ``CaseRetrievalHit`` and ``cli/build_case_index.py``
against the JAX package's on the CPU.

The records are ``tests/test_agent_cases.py``'s three, two without a court
or a date (the filters' missing-value rules), and 512 seeded records from
the zh statutes (``chip_smoke.make_cases``). Both packages add them in two
calls (the incremental IDF and BM25's ``add_texts``): the same IDF state,
vocabulary, postings and impact matrix, dense rows within a bf16 ulp (the
float32 projections round apart). On one index carried to both packages
(the port loads JAX's save) they answer 32 queries with no filter and
with each filter: equal case-id lists, fused scores within ATOL, rows
whose JAX scores tie within TIE may swap (a bf16 ulp moves a dense score
~1e-5, and min-max over the channel's top eff amplifies it, so the
independently built stores are held by their state, as every carried
bundle is). Each package loads the other's save, with ``cases.jsonl``
byte-equal. The port's hash encoder serves with the JAX encoder's
projection (``use_projection``); the default one, drawn in numpy, differs
from JAX's by erfinv's approximation.
"""

import json
import logging

import numpy as np
import pytest

from chip_smoke import case_filter, case_queries, make_cases
from legalrag_tpu.config import AppConfig as JaxConfig
from legalrag_tpu.retrieval.case_retriever import CaseRetriever as JaxCases
from legalrag_tpu.schemas import CaseEntry as JaxCase
from legalrag_tpu.schemas import CaseRetrievalHit as JaxCaseHit
from legalrag_tpu_torch.cli import build_case_index
from legalrag_tpu_torch.config import AppConfig
from legalrag_tpu_torch.retrieval.case_retriever import CaseRetriever
from legalrag_tpu_torch.schemas import CaseEntry, CaseRetrievalHit, dump

ATOL = 1e-5   # fused scores and every number of the breakdown
TIE = 1e-6    # JAX scores closer than this may come in either order
N_SEEDED = 512
N_QUERIES = 32
FIRST = 300   # the first add_cases call; the rest the second

FIXTURE = [
    dict(case_id="c1", title="买卖合同纠纷案", court="北京一中院",
         date="2022-03-01", cause="买卖合同纠纷",
         text="出卖人迟延交付货物，买受人主张解除合同并要求赔偿损失。"),
    dict(case_id="c2", title="离婚后财产分割案", court="上海二中院",
         date="2023-06-10", cause="离婚纠纷",
         text="离婚后一方隐藏夫妻共同财产，另一方请求重新分割。"),
    dict(case_id="c3", title="借款合同纠纷案", court="北京一中院",
         date="2021-01-15", cause="借款合同纠纷",
         text="借款人未按期还款，贷款人请求支付本金和利息违约金。"),
    dict(case_id="c4", title="租赁合同纠纷案", cause="房屋租赁合同纠纷",
         text="承租人拖欠租金，出租人请求解除租赁合同并腾退房屋。",
         cited_articles=["722"], meta={"source": "调解书", "pages": 3}),
    dict(case_id="c5", title="赠与合同纠纷案", court="北京一中院",
         text="赠与人在赠与财产的权利转移之前撤销赠与。"),
]


def configs():
    jcfg, cfg = JaxConfig(), AppConfig()
    for c in (jcfg, cfg):
        c.engine.capacity_round = 64
    return jcfg, cfg


@pytest.fixture(scope="module")
def records(zh_chunks):
    """(JAX records, port records): the fixture's and the seeded ones."""
    rng = np.random.default_rng(5)
    seeded = [dump(c, exclude_none=True)
              for c in make_cases(zh_chunks, N_SEEDED, rng)]
    rows = FIXTURE + seeded
    return [JaxCase(**r) for r in rows], [CaseEntry(**r) for r in rows]


@pytest.fixture(scope="module")
def queries(zh_chunks):
    return (case_queries(zh_chunks, N_QUERIES, np.random.default_rng(9))
            + ["离婚后发现对方隐藏财产怎么办", "合同纠纷"])


def with_jax_projection(retriever, jax_retriever):
    retriever.encoder.use_projection(
        np.asarray(jax_retriever.encoder._projection()))
    return retriever


@pytest.fixture(scope="module")
def built(records):
    """(JAX retriever, port retriever), each fed in the same two calls."""
    (jrecs, trecs), (jcfg, cfg) = records, configs()
    jr = JaxCases(jcfg, "zh")
    tr = with_jax_projection(CaseRetriever(cfg, "zh", device="cpu"), jr)
    for a, b in ((0, FIRST), (FIRST, len(trecs))):
        assert jr.add_cases(jrecs[a:b]) == tr.add_cases(trecs[a:b]) == b - a
    return jr, tr


def jax_queries(retriever, jax_retriever):
    """The port's retriever with JAX's query vectors: one query component
    whose float32 sums round to the other side of a bf16 midpoint moves a
    dense score ~1e-5, past ATOL once min-max normalized."""
    retriever.encoder.encode_queries = lambda texts: np.asarray(
        jax_retriever.encoder.encode_queries(texts), np.float32)
    return retriever


@pytest.fixture(scope="module")
def pair(built, tmp_path_factory):
    """(JAX retriever, the port's load of its save, with JAX's query
    vectors)."""
    jr, _ = built
    d = tmp_path_factory.mktemp("jax_cases")
    jr.save(d)
    return jr, jax_queries(CaseRetriever.load(d, configs()[1], "zh",
                                              device="cpu"), jr)


def assert_same_hits(got, want):
    """Equal case ids and ranks up to swaps of JAX scores within TIE; each
    hit's case, score and breakdown held to the JAX hit of that case."""
    assert [h.rank for h in got] == [h.rank for h in want]
    want_ids = [h.case.case_id for h in want]
    assert len(got) == len(want), ([h.case.case_id for h in got], want_ids)
    by_id = {h.case.case_id: h for h in want}
    for p, (g, w) in enumerate(zip(got, want)):
        if g.case.case_id != w.case.case_id:
            assert g.case.case_id in by_id, (p, g.case.case_id, want_ids)
            assert abs(by_id[g.case.case_id].score - w.score) < TIE, p
        ref = by_id[g.case.case_id]
        assert g.case.to_json() == ref.case.model_dump_json(exclude_none=True)
        assert abs(g.score - ref.score) <= ATOL
        assert_close_tree(g.score_breakdown, ref.score_breakdown)


def assert_close_tree(got, want, path="bd"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (path, got)
        for k in want:
            assert_close_tree(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), (path, got, want)
        for i, (g, w) in enumerate(zip(got, want)):
            assert_close_tree(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        assert abs(float(got) - want) <= ATOL, (path, got, want)
    else:
        assert got == want, (path, got, want)


def test_case_json_matches_pydantic(records):
    jrecs, trecs = records
    for j, t in zip(jrecs, trecs):
        line = j.model_dump_json(exclude_none=True)
        assert t.to_json() == line
        assert CaseEntry.from_json(line) == t
        assert dump(t, exclude_none=True) == j.model_dump(exclude_none=True)
    hit = CaseRetrievalHit(case=trecs[3], score=0.5, rank=1)
    want = JaxCaseHit(case=jrecs[3], score=0.5, rank=1)
    assert json.dumps(dump(hit, exclude_none=True), ensure_ascii=False,
                      separators=(",", ":")) == \
        want.model_dump_json(exclude_none=True)


def test_two_adds_keep_the_jax_state(built):
    jr, tr = built
    assert tr.encoder.n_docs == jr.encoder.n_docs == len(tr.cases)
    np.testing.assert_array_equal(tr.encoder.df, np.asarray(jr.encoder.df))
    assert tr.bm25.vocab == jr.bm25.vocab
    assert tr.bm25.n == jr.bm25.n == len(tr.cases)
    for a, b in zip(tr.bm25.doc_term_ids, jr.bm25.doc_term_ids):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(tr.bm25.impact.numpy(),
                               np.asarray(jr.bm25.impact), rtol=1e-6,
                               atol=1e-6)
    assert tr.dense.n == jr.dense.n and tr.dense.capacity == jr.dense.capacity
    got = tr.dense.emb.float().numpy()
    want = np.asarray(jr.dense.emb, np.float32)
    # a bf16 ulp (absolute below 1e-6, where the float32 sums cancel)
    assert (np.abs(got - want) <= np.abs(want) * 2.0 ** -7 + 1e-6).all()
    assert (got != want).mean() < 1e-3
    assert tr.id2row == jr.id2row
    assert tr.add_cases([tr.cases[0], tr.cases[7]]) == \
        jr.add_cases([jr.cases[0], jr.cases[7]]) == 0


@pytest.mark.parametrize("name", ["none", "court", "cause", "date",
                                  "date_from", "date_to", "all"])
def test_searches_match_jax(pair, queries, name):
    jr, tr = pair
    for i, q in enumerate(queries):
        kw = (case_filter(name, i) if name in ("none", "court", "cause",
                                               "date")
              else {"date_from": "2021-06-01"} if name == "date_from"
              else {"date_to": "2019-12-31"} if name == "date_to"
              else {"court": "北京一中院", "cause": "合同",
                    "date_from": "2021-01-01", "date_to": "2022-12-31"})
        top_k = (3, 10)[i % 2]
        want = jr.search(q, top_k=top_k, **kw)
        got = tr.search(q, top_k=top_k, **kw)
        assert_same_hits(got, want)
        if name == "none":
            assert len(got) == top_k


def test_narrow_filter_gives_the_same_short_list(pair, queries):
    """Each channel takes its top eff before the filter: a court that few
    cases name returns fewer than top_k hits, or none, in both packages,
    although more matching cases exist."""
    jr, tr = pair
    short = 0
    for q in queries:
        for court in ("北京一中院", "上海二中院", "最高人民法院"):
            want = jr.search(q, top_k=10, court=court)
            got = tr.search(q, top_k=10, court=court)
            assert_same_hits(got, want)
            matching = sum(c.court == court for c in tr.cases)
            short += len(got) < min(10, matching)
    assert short > 0
    assert tr.search("合同", top_k=3, court="不存在法院") == \
        jr.search("合同", top_k=3, court="不存在法院") == []


def test_saves_load_across_packages(built, queries, tmp_path):
    jr, tr = built
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jr.save(jdir)
    tr.save(tdir)
    assert (jdir / "cases.jsonl").read_bytes() == \
        (tdir / "cases.jsonl").read_bytes()
    assert {p.name for p in jdir.iterdir()} == {p.name for p in tdir.iterdir()}
    for name in ("case_bm25.npz", "case_encoder.npz", "case_dense.npz"):
        a, b = np.load(jdir / name), np.load(tdir / name)
        assert set(a.files) == set(b.files)
        for k in a.files:
            if name == "case_dense.npz" and k == "emb":
                # the bf16 rows saved as float16: within a bf16 ulp
                want = a[k].astype(np.float32)
                assert (np.abs(want - b[k]) <= np.abs(want) * 2.0 ** -7
                        + 1e-6).all()
            else:
                np.testing.assert_array_equal(a[k], b[k])
    jcfg, cfg = configs()
    from_jax = with_jax_projection(
        CaseRetriever.load(jdir, cfg, "zh", device="cpu"), jr)
    from_port = JaxCases.load(tdir, jcfg, "zh")
    assert [c.to_json() for c in from_jax.cases] == \
        [c.to_json() for c in tr.cases]
    for q in queries[:8]:
        for kw in ({}, {"cause": "合同"}):
            assert_same_hits(from_jax.search(q, 10, **kw),
                             jr.search(q, 10, **kw))
            assert_same_hits(tr.search(q, 10, **kw),
                             from_port.search(q, 10, **kw))
    assert from_jax.add_cases([tr.cases[2]]) == 0
    assert from_jax.encoder.n_docs == jr.encoder.n_docs
    np.testing.assert_array_equal(from_jax.encoder.df,
                                  np.asarray(jr.encoder.df))


class Lines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def test_build_case_index_cli(records, queries, tmp_path):
    jrecs, trecs = records
    cases = tmp_path / "cases.jsonl"
    cases.write_text("".join(r.model_dump_json(exclude_none=True) + "\n"
                             for r in jrecs[:120]), encoding="utf-8")
    conf = {"paths": {name: str(tmp_path / name.removesuffix("_dir"))
                      for name in ("data_dir", "raw_dir", "processed_dir",
                                   "index_dir", "graph_dir", "eval_dir",
                                   "upload_dir")},
            "engine": {"capacity_round": 64}}
    (tmp_path / "cfg.json").write_text(json.dumps(conf), encoding="utf-8")
    build_case_index.main(["--config", str(tmp_path / "cfg.json"),
                           "--cases", str(cases), "--device", "cpu"])
    out = tmp_path / "index" / "zh"
    assert (out / "cases.jsonl").read_bytes() == cases.read_bytes()
    jcfg, _ = configs()
    want = JaxCases.from_jsonl(cases, jcfg, "zh")
    got = JaxCases.load(out, jcfg, "zh")
    for q in queries[:6]:
        assert [h.case.case_id for h in got.search(q, 5)] == \
            [h.case.case_id for h in want.search(q, 5)]
    # the default path, raw_dir/cases_<lang>.jsonl: absent, logged
    log, lines = logging.getLogger("torch.cli.build_case_index"), Lines()
    log.addHandler(lines)
    try:
        build_case_index.main(["--config", str(tmp_path / "cfg.json"),
                               "--lang", "en", "--device", "cpu"])
    finally:
        log.removeHandler(lines)
    assert lines.lines == [
        f"no case corpus at {tmp_path / 'raw' / 'cases_en.jsonl'}"]
    assert not (tmp_path / "index" / "en").exists()
