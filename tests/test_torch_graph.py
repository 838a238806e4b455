"""Port law graph (``graph.builder``, ``graph.store``) vs the JAX one: the
same chunks give the same graph file, byte for byte, and the stores' walks,
neighbour lists and node lookups agree exactly."""

import pytest

from legalrag_tpu.graph import GraphBuilder as JaxBuilder
from legalrag_tpu.graph import LawGraphStore as JaxStore
from legalrag_tpu.schemas import LawChunk as JaxChunk
from legalrag_tpu_torch.graph import GraphBuilder, LawGraphStore
from legalrag_tpu_torch.schemas import LawChunk


def port_chunks(chunks):
    return [LawChunk.from_json(c.model_dump_json(exclude_none=True))
            for c in chunks]


def node_view(n):
    nbs = [(nb.article_id, nb.relation, nb.conf, nb.evidence)
           for nb in n.neighbors]
    return (n.article_id, n.article_no, n.law_name, n.title, n.chapter,
            n.section, nbs, n.meta, n.graph_depth, n.graph_parent, n.relations)


def synthetic(lang):
    zh = [(1, "第一条　本法所称动产抵押，是指以动产设定的抵押。"),
          (2, "第二条　依照第一条的规定，动产抵押应当登记。"),
          (3, "第三条　第一条至第二条的规定适用于本章。"),
          (4, "第四条　其他规定。")]
    en = [("1-101", '§ 1-101. "Security interest" means an interest in '
           'personal property.'),
          ("1-102", "§ 1-102. As provided in Section 1-101, a security "
           "interest attaches."),
          ("1-103", "§ 1-103. Sections 101 to 102 and § 1-101 apply.")]
    rows = zh if lang == "zh" else en
    kws = [dict(id=f"{lang}:t:{aid}", law_name="测试法" if lang == "zh"
                else "Test", article_no=f"第{aid}条" if lang == "zh"
                else f"§ {aid}", article_id=str(aid), text=text, lang=lang)
           for aid, text in rows]
    return [JaxChunk(**k) for k in kws]


@pytest.fixture(scope="module")
def graphs(zh_chunks, en_chunks, tmp_path_factory):
    """name -> (JAX store, port store, file bytes equal) over en[:150],
    zh[:200] and the synthetic zh / en cases."""
    d = tmp_path_factory.mktemp("graphs")
    sets = {"en150": en_chunks[:150], "zh200": zh_chunks[:200],
            "zh_synthetic": synthetic("zh"), "en_synthetic": synthetic("en")}
    out = {}
    for name, chunks in sets.items():
        jp, tp = d / f"{name}_jax.jsonl", d / f"{name}_port.jsonl"
        JaxBuilder().build_to_file(chunks, jp)
        GraphBuilder().build_to_file(port_chunks(chunks), tp)
        out[name] = (JaxStore(jp), LawGraphStore(tp),
                     jp.read_bytes() == tp.read_bytes())
    return out


@pytest.mark.parametrize("name", ["en150", "zh200", "zh_synthetic",
                                  "en_synthetic"])
def test_graph_file_bytes_equal(graphs, name):
    assert graphs[name][2]


def test_build_nodes_equal_on_the_whole_zh_code(zh_chunks):
    assert (GraphBuilder().build_nodes(port_chunks(zh_chunks))
            == JaxBuilder().build_nodes(zh_chunks))


@pytest.mark.parametrize("name", ["en150", "zh200", "zh_synthetic",
                                  "en_synthetic"])
def test_walk_neighbors_and_node_equal(graphs, name):
    js, ts, _ = graphs[name]
    js.load()
    ts.load()
    ids = sorted(js.nodes)
    assert ids == sorted(ts.nodes)
    seeds = [ids[:1], ids[:3], ids[len(ids) // 2: len(ids) // 2 + 2], [],
             ["no-such-article"], ids[-1:]]
    depth_sets = [None, {"default": 1}, {"prev": 1, "next": 1, "cite": 3,
                                         "default": 2}]
    for seed in seeds:
        for depths in depth_sets:
            for limit, min_conf, rels in ((800, 0.0, None), (5, 0.5, None),
                                          (50, 0.9, ["cite", "cited",
                                                     "defined_by"])):
                want = js.walk(seed, limit=limit, relation_max_depth=depths,
                               rel_types=rels, min_conf=min_conf)
                got = ts.walk(seed, limit=limit, relation_max_depth=depths,
                              rel_types=rels, min_conf=min_conf)
                assert [node_view(n) for n in got] == \
                    [node_view(n) for n in want]
    for aid in ids[:20] + ["no-such-article"]:
        for depth in (1, 2):
            assert [node_view(n) for n in ts.get_neighbors(aid, depth)] == \
                [node_view(n) for n in js.get_neighbors(aid, depth)]
        g, w = ts.get_node(aid), js.get_node(aid)
        assert (g is None and w is None) or node_view(g) == node_view(w)


def test_walk_leaves_stored_nodes_untouched(graphs):
    _, ts, _ = graphs["zh_synthetic"]
    before = node_view(ts.get_node("2"))
    assert ts.walk(["1"], limit=10)
    assert node_view(ts.get_node("2")) == before
    assert ts.get_node("2").graph_depth is None


def test_missing_graph_file_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        LawGraphStore(tmp_path / "none.jsonl").walk(["1"])
