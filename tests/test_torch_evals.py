"""The port's evals (``legalrag_tpu_torch/evals``, ``cli/evaluate_retrieval``,
``cli/evaluate_generation``, ``cli/mine_semantic_pairs``) against the JAX
package's on the CPU:

- the retrieval metrics exactly equal on seeded rankings;
- ``evals.generation``'s functions exactly equal on the same hits and
  answers;
- ``mine_pairs`` on the zh and en statutes row for row, each package over
  its own law graph; ``corrupt_pairs``, ``split_by_gold`` and
  ``build_stops`` for the same seeds;
- ``run_system`` for all six systems over the first 20 ``law_qa.jsonl``
  rows of each language, on one index of each language's first chunks
  carried to both packages: equal ranked article ids, rows may swap only
  where JAX's fused scores tie;
- the schema check with JAX's random decoder weights carried in through
  ``convert.decoder_params_from_jax``: equal streams and equal rates
  (greedy in both: sampling draws from each package's own generator).
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from legalrag_tpu.config import AppConfig as JaxConfig
from legalrag_tpu.evals import generation as jax_gen
from legalrag_tpu.evals import metrics as jax_metrics
from legalrag_tpu.evals import semantic_pairs as jax_pairs
from legalrag_tpu.graph import GraphBuilder as JaxGraphBuilder
from legalrag_tpu.graph import LawGraphStore as JaxGraphStore
from legalrag_tpu.index.bundle import IndexBundle as JaxBundle
from legalrag_tpu.llm.client import DEGRADED_ANSWER as JAX_DEGRADED
from legalrag_tpu.retrieval.engine import FusedQueryEngine as JaxEngine
from legalrag_tpu.retrieval.hybrid import HybridRetriever as JaxHybrid
from legalrag_tpu.schemas import IssueType as JaxIssueType
from legalrag_tpu.schemas import RetrievalHit as JaxHit
from legalrag_tpu.schemas import RoutingDecision as JaxDecision
from legalrag_tpu.schemas import RoutingMode as JaxMode
from legalrag_tpu.schemas import TaskType as JaxTaskType
from legalrag_tpu_torch.cli import evaluate_generation as gen_cli
from legalrag_tpu_torch.cli import evaluate_retrieval as ret_cli
from legalrag_tpu_torch.cli import mine_semantic_pairs as mine_cli
from legalrag_tpu_torch.config import AppConfig
from legalrag_tpu_torch.convert import decoder_params_from_jax
from legalrag_tpu_torch.evals import generation, metrics, semantic_pairs
from legalrag_tpu_torch.graph import GraphBuilder, LawGraphStore
from legalrag_tpu_torch.llm.client import DEGRADED_ANSWER
from legalrag_tpu_torch.retrieval.engine import FusedQueryEngine
from legalrag_tpu_torch.retrieval.hybrid import HybridRetriever
from legalrag_tpu_torch.schemas import LawChunk, RetrievalHit
from test_torch_engine import carry

REPO = Path(__file__).resolve().parent.parent
EVAL_ROWS = 20          # law_qa.jsonl rows per language through run_system
TIE = 1e-6              # JAX fused scores closer than this may swap
SCHEMA_ITEMS = 2         # seeded prompts of the sampled schema check
SCHEMA_JAX_ITEMS = 1     # of the greedy one against JAX's
INDEX_DOCS = {"zh": 640, "en": 320}   # the carried index's first chunks


def port_chunks(chunks):
    return [LawChunk.from_json(c.model_dump_json(exclude_none=True))
            for c in chunks]


# ------------------------------------------------------------- metrics

def seeded_rankings(n, seed):
    """(ranked ids, gold, k) triples: lists of 0-25 ids drawn with repeats
    from 12, the gold among them or not, k from 0 to 30."""
    rng = np.random.default_rng(seed)
    ids = [f"a{i}" for i in range(12)]
    return [([ids[j] for j in rng.integers(0, 12, int(rng.integers(0, 26)))],
             ids[int(rng.integers(12))], int(rng.integers(0, 31)))
            for _ in range(n)]


def test_metrics_equal_jax_on_seeded_rankings():
    for ranked, gold, k in seeded_rankings(2000, 0):
        assert metrics.evaluate_one(ranked, gold) == \
            jax_metrics.evaluate_one(ranked, gold)
        for name in ("hit_at_k", "recall_at_k", "mrr_at_k", "ndcg_at_k"):
            assert getattr(metrics, name)(ranked, gold, k) == \
                getattr(jax_metrics, name)(ranked, gold, k)


def test_aggregate_equals_jax():
    rng = np.random.default_rng(1)
    for n in (0, 1, 2, 7, 40):
        per = [metrics.evaluate_one(r, g)
               for r, g, _k in seeded_rankings(n, int(rng.integers(1 << 30)))]
        assert metrics.aggregate(per) == jax_metrics.aggregate(per)


# ---------------------------------------------------------- generation

def hits_of(chunks, rows):
    """(JAX hits, port hits) of the same chunks, ranked in ``rows``' order."""
    jh = [JaxHit(chunk=chunks[r], score=1.0 - 0.01 * i, rank=i + 1)
          for i, r in enumerate(rows)]
    th = [RetrievalHit(chunk=LawChunk.from_json(
        chunks[r].model_dump_json(exclude_none=True)),
        score=1.0 - 0.01 * i, rank=i + 1) for i, r in enumerate(rows)]
    return jh, th


def answers(lang, jh, chunks, rng):
    """Answers to score: the extractive one, the degraded one, quotes of
    retrieved and unretrieved provisions with their refs, and noise."""
    out = [jax_gen.extractive_answer("q", jh, lang), JAX_DEGRADED[lang], "",
           "结论：依据第1079条与第99条，可以离婚。"]
    for _ in range(6):
        c = chunks[int(rng.integers(len(chunks)))]
        ref = (f"第{c.article_id}条" if lang == "zh"
               else f"§ {c.article_id}")
        sep = "。" if lang == "zh" else ". "
        out.append(f"{ref}{sep}{c.text[:120]}{sep}{jh[0].chunk.text[:60]}")
    return out


@pytest.mark.parametrize("lang", ["zh", "en"])
def test_generation_functions_equal_jax_on_the_same_hits(lang, zh_chunks,
                                                         en_chunks):
    chunks = zh_chunks if lang == "zh" else en_chunks
    rng = np.random.default_rng(11)
    assert DEGRADED_ANSWER == JAX_DEGRADED
    items_j, items_t = [], []
    for _ in range(6):
        rows = rng.choice(len(chunks), size=int(rng.integers(0, 6)),
                          replace=False).tolist()
        jh, th = hits_of(chunks, rows)
        q = chunks[int(rng.integers(len(chunks)))].text[:30]
        assert generation.extractive_answer(q, th, lang) == \
            jax_gen.extractive_answer(q, jh, lang)
        gold = (str(chunks[rows[0]].article_id) if rows and rng.random() < 0.7
                else None)
        for ans in answers(lang, jh or hits_of(chunks, [0])[0], chunks, rng):
            assert generation.split_sentences(ans, lang) == \
                jax_gen.split_sentences(ans, lang)
            for tau in (0.3, 0.5):
                assert generation.faithfulness(ans, th, lang, tau) == \
                    jax_gen.faithfulness(ans, jh, lang, tau)
            assert generation.schema_validity(ans, ("a",)) == \
                jax_gen.schema_validity(ans, ("a",))
            got = generation.evaluate_answer(
                q, ans, th, gold, lang, judge=lambda q_, a, p: len(p) / 10)
            want = jax_gen.evaluate_answer(
                q, ans, jh, gold, lang, judge=lambda q_, a, p: len(p) / 10)
            assert got == want
            items_t.append(got)
            items_j.append(want)
    assert generation.aggregate_generation(items_t) == \
        jax_gen.aggregate_generation(items_j)
    for doc in ('{"conclusion": "x", "article": "1"}', '{"conclusion": 1}',
                "[1]", "{", '{"a": null}'):
        assert generation.schema_validity(doc, ("conclusion", "article")) == \
            jax_gen.schema_validity(doc, ("conclusion", "article"))


# ------------------------------------------------------- semantic pairs

def jax_adj(chunks):
    return {n["article_id"]: [
        (e["article_id"], e["relation"], e["conf"], e.get("evidence"))
        for e in n["neighbors"]] for n in JaxGraphBuilder().build_nodes(chunks)}


def port_adj(chunks, tmp_path):
    path = tmp_path / "graph.jsonl"
    GraphBuilder().build_to_file(chunks, path)
    store = LawGraphStore(path)
    store.load()
    return store.adj


@pytest.mark.parametrize("lang", ["zh", "en"])
def test_mined_and_corrupted_pairs_match_jax(lang, zh_chunks, en_chunks,
                                             tmp_path):
    jchunks = zh_chunks if lang == "zh" else en_chunks
    chunks = port_chunks(jchunks)
    stops = semantic_pairs.build_stops(chunks, lang)
    jstops = jax_pairs.build_stops(jchunks, lang)
    assert stops == jstops and stops
    assert semantic_pairs.build_stops(chunks, lang, 0.05) == \
        jax_pairs.build_stops(jchunks, lang, 0.05)
    rows = semantic_pairs.mine_pairs(chunks, port_adj(chunks, tmp_path), lang,
                                     stops=stops)
    want = jax_pairs.mine_pairs(jchunks, jax_adj(jchunks), lang, stops=jstops)
    assert rows == want and len(rows) >= 10
    for seed in (3, 8):
        syn = semantic_pairs.corrupt_pairs(chunks, lang, n=300, seed=seed,
                                           max_overlap=0.45, stops=stops)
        assert syn == jax_pairs.corrupt_pairs(jchunks, lang, n=300,
                                              seed=seed, max_overlap=0.45,
                                              stops=jstops)
        for holdout in (0.0, 0.4):
            assert semantic_pairs.split_by_gold(rows + syn, holdout, seed) == \
                jax_pairs.split_by_gold(want + syn, holdout, seed)
    for c in chunks[:40]:
        for s in semantic_pairs._sentences(c.text):
            assert semantic_pairs.strip_refs(s) == jax_pairs.strip_refs(s)
            assert semantic_pairs.apply_synonyms(s, lang) == \
                jax_pairs.apply_synonyms(s, lang)
            assert semantic_pairs.token_overlap(s, c.text, lang, stops) == \
                jax_pairs.token_overlap(s, c.text, lang, jstops)


def test_mine_cli_writes_the_splits(zh_chunks, en_chunks, tmp_path):
    """The CLI over a processed directory and graphs: files whose rows
    are JAX's mined and corrupted rows split by JAX's ``split_by_gold``."""
    processed, graph_dir = tmp_path / "processed", tmp_path / "graph"
    processed.mkdir()
    jchunks = {"zh": zh_chunks[:400], "en": en_chunks[:200]}
    with (processed / "law.jsonl").open("w", encoding="utf-8") as f:
        for cs in jchunks.values():
            for c in cs:
                f.write(c.model_dump_json(exclude_none=True) + "\n")
    cfg = {"paths": {name: str(tmp_path / name.removesuffix("_dir"))
                     for name in ("data_dir", "raw_dir", "index_dir",
                                  "upload_dir", "eval_dir")}
           | {"processed_dir": str(processed), "graph_dir": str(graph_dir)}}
    (tmp_path / "cfg.json").write_text(json.dumps(cfg), encoding="utf-8")
    port_cfg = AppConfig.load(tmp_path / "cfg.json")
    for lang, cs in jchunks.items():
        GraphBuilder().build_to_file(port_chunks(cs),
                                     port_cfg.with_lang(lang).paths.graph_file)
    mine_cli.main(["--config", str(tmp_path / "cfg.json"), "--seed", "5"])
    for lang, cs in jchunks.items():
        stops = jax_pairs.build_stops(cs, lang)
        rows = jax_pairs.mine_pairs(cs, jax_adj(cs), lang, stops=stops)
        syn = jax_pairs.corrupt_pairs(cs, lang, n=10 ** 9, seed=5,
                                      max_overlap=0.45, per_article=3,
                                      stops=stops)
        seen = {r["query"] for r in rows}
        rows += [r for r in syn if r["query"] not in seen]
        train, held = jax_pairs.split_by_gold(rows, 0.4, 5)
        for name, subset in (("", rows), ("_train", train), ("_held", held)):
            got = (tmp_path / "eval" / f"semantic_{lang}{name}.jsonl"
                   ).read_text(encoding="utf-8").splitlines()
            assert [json.loads(x) for x in got] == subset


# --------------------------------------------------------- run_system

def small_configs():
    jcfg, cfg = JaxConfig(), AppConfig()
    for c in (jcfg, cfg):
        c.engine.capacity_round = 256
        c.engine.late_doc_maxlen = 64
    return jcfg, cfg


@pytest.fixture(scope="module")
def eval_rows():
    rows = ret_cli.load_eval_set(REPO / "data" / "eval" / "law_qa.jsonl")
    return {lang: rs[:EVAL_ROWS]
            for lang, rs in ret_cli.by_language(rows).items()}


@pytest.fixture(scope="module", params=["zh", "en"])
def retrievers(request, zh_chunks, en_chunks, tmp_path_factory):
    """(lang, JAX (hybrid, engine), port (hybrid, engine)) over one carried
    bundle of the first ``INDEX_DOCS`` chunks and one law-graph file, the
    small config."""
    lang = request.param
    chunks = (zh_chunks if lang == "zh" else en_chunks)[:INDEX_DOCS[lang]]
    jcfg, cfg = small_configs()
    jb = JaxBundle.build_from_chunks(chunks, jcfg, lang)
    gpath = tmp_path_factory.mktemp("graph") / "g.jsonl"
    JaxGraphBuilder().build_to_file(chunks, gpath)
    tb = carry(jb, cfg)
    return (lang,
            (JaxHybrid(jb, jcfg, graph_store=JaxGraphStore(gpath)),
             JaxEngine(jb, jcfg)),
            (HybridRetriever(tb, cfg, graph_store=LawGraphStore(gpath)),
             FusedQueryEngine(tb, cfg)))


def jax_fused_scores(system, q, jh, je, k):
    """JAX's scores of ``run_system``'s list, for the tie test."""
    if system == "fused":
        return [h.score for h in je.search_hits([q], k)[0]]
    if system in ("fused+graph", "hybrid"):
        rerank = jh.cfg.retrieval.enable_rerank
        jh.cfg.retrieval.enable_rerank = system == "hybrid" and rerank
        try:
            d = JaxDecision(task_type=JaxTaskType.JUDGE_STYLE,
                            issue_type=JaxIssueType.OTHER,
                            mode=JaxMode.GRAPH_AUGMENTED)
            return [h.score for h in jh.search(q, top_k=k, decision=d)]
        finally:
            jh.cfg.retrieval.enable_rerank = rerank
    return [h.score for h in getattr(jh, f"search_{system}")(q, k)]


def test_run_system_matches_jax_for_every_system(retrievers, eval_rows):
    from scripts import evaluate_retrieval as jax_cli

    assert ret_cli.SYSTEMS == jax_cli.SYSTEMS
    lang, (jh, je), (th, te) = retrievers
    swaps = 0
    for row in eval_rows[lang]:
        for system in ret_cli.SYSTEMS:
            want = jax_cli.run_system(system, row["query"], jh, je, 20)
            got = ret_cli.run_system(system, row["query"], th, te, 20)
            assert len(got) == len(want) and want, (system, row["query"])
            if got != want:
                scores = jax_fused_scores(system, row["query"], jh, je, 20)
                for p in np.nonzero(np.array(got) != np.array(want))[0]:
                    where = want.index(got[p]) if got[p] in want else p
                    assert abs(scores[where] - scores[p]) < TIE, \
                        (system, row["query"], p, got, want)
                    swaps += 1
    assert th.cfg.retrieval.enable_rerank == jh.cfg.retrieval.enable_rerank
    assert swaps <= len(eval_rows[lang])


def test_evaluate_prints_jax_table(retrievers, eval_rows, capsys):
    """``evaluate`` and ``table`` on the port give the JAX script's printed
    lines for the same rows (one language at a time)."""
    from scripts import evaluate_retrieval as jax_cli
    from legalrag_tpu.evals import aggregate, evaluate_one

    lang, (jh, je), (th, te) = retrievers
    rows = {lang: eval_rows[lang][:8]}
    results, by_lang = ret_cli.evaluate(rows, ret_cli.SYSTEMS, 20,
                                        lambda _l: (th, te))
    want = {s: [evaluate_one(jax_cli.run_system(s, r["query"], jh, je, 20),
                             str(r["article_id"])) for r in rows[lang]]
            for s in ret_cli.SYSTEMS}
    assert {s: aggregate(v) for s, v in want.items()} == \
        {s: metrics.aggregate(results[s]) for s in ret_cli.SYSTEMS}
    assert dict(results) == {s: by_lang[(s, lang)] for s in ret_cli.SYSTEMS}
    lines = ret_cli.table(results, by_lang, ret_cli.SYSTEMS, [lang])
    assert lines[0] == f"{'system':<13}" + "".join(
        f"{m:>10}" for m in ("R@5", "R@10", "MRR@10", "nDCG@10", "Hit@3",
                             "Hit@10"))
    assert len(lines) == 1 + len(ret_cli.SYSTEMS)


# ---------------------------------------------------------- schema check

def test_random_state_has_jax_layout():
    """``random_decoder_state`` holds ``decoder_params_from_jax`` of JAX's
    random tree's keys, shapes and dtypes, at JAX's scales."""
    import jax

    from legalrag_tpu.models.decoder import DecoderConfig as JaxDC
    from scripts.bench_decode import device_random_params

    for conf, port_conf in ((JaxDC(**vars_of(gen_cli.answer_config(2))),
                             gen_cli.answer_config(2)),
                            (JaxDC(**vars_of(gen_cli.schema_config())),
                             gen_cli.schema_config())):
        want = decoder_params_from_jax(jax.tree.map(
            np.asarray, device_random_params(conf, jax.numpy.float32)))
        got = gen_cli.random_decoder_state(port_conf, 0, "cpu")
        assert {k: (tuple(v.shape), v.dtype) for k, v in got.items()} == \
            {k: (tuple(v.shape), v.dtype) for k, v in want.items()}
        for k, v in got.items():
            w = want[k]
            if k.endswith("norm.weight") or k.endswith(".bias"):
                assert torch.equal(v, w), k
            else:
                assert abs(v.std().item() / w.std().item() - 1) < 0.15, k


def vars_of(cfg):
    keys = ("num_hidden_layers", "hidden_size", "intermediate_size",
            "num_attention_heads", "num_key_value_heads", "head_dim",
            "vocab_size", "max_position_embeddings")
    return {k: getattr(cfg, k) for k in keys}


def test_schema_check_matches_jax_on_carried_weights(monkeypatch):
    import jax
    import scripts.evaluate_generation as jax_cli
    from legalrag_tpu.models.decoder import DecoderConfig as JaxDC
    from legalrag_tpu.models.decoder import JaxDecoderLM
    from scripts.bench_decode import device_random_params

    jparams = device_random_params(JaxDC(**vars_of(gen_cli.schema_config())),
                                   jax.numpy.float32)
    carried = decoder_params_from_jax(jax.tree.map(np.asarray, jparams))
    want_streams = []
    plain = JaxDecoderLM.generate_stream

    def greedy(self, prompt, **kw):
        toks = list(plain(self, prompt, **(kw | {"temperature": 0.0})))
        want_streams.append(toks)
        return iter(toks)

    monkeypatch.setattr(JaxDecoderLM, "generate_stream", greedy)
    want = jax_cli.run_schema_check(SCHEMA_JAX_ITEMS)
    got, streams = gen_cli.schema_streams(
        gen_cli.schema_engine("cpu", carried), SCHEMA_JAX_ITEMS,
        temperature=0.0)
    assert [t for pair in streams for t in pair] == want_streams
    assert got == want
    assert got["constrained_valid_prefix_rate"] == 1.0


def test_schema_check_keeps_the_guarantee_when_sampled():
    got, streams = gen_cli.schema_streams(gen_cli.schema_engine("cpu"),
                                          SCHEMA_ITEMS)
    assert got["n"] == SCHEMA_ITEMS
    assert got["constrained_valid_prefix_rate"] == 1.0
    assert all(c != u for c, u in streams)


def test_local_answerer_goes_through_the_client():
    """The random answerer answers through ``LLMClient``'s ``local-jax``
    seam: text that is not the degraded answer, one stream and its tokens
    counted."""
    from legalrag_tpu_torch.utils.metrics import METRICS

    local, client = gen_cli.make_local_answerer(1, "cpu")
    key = ("legalrag_llm_streams", (("provider", "local-jax"),))
    before = METRICS._counters.get(key, 0)
    text = local("q", "合同的解除\n\nq")
    assert text and text not in DEGRADED_ANSWER.values()
    assert METRICS._counters[key] == before + 1
    assert client._local.max_len == 1024
    assert isinstance(client._local.tokenizer, gen_cli.ByteTok)
