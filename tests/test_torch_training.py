"""The port's encoder trainer (``parallel/training.py``,
``evals/synthetic.py``, ``cli/train_encoder.py``) against the JAX
package's on the CPU:

- ``init_projection``'s normal draw against JAX's at rtol 1e-5 (the erfinv
  residue of ``models/prng.py``), before the 1 / sqrt(d_out) scale;
- the port's step on grids of the CPU at (1,1), (1,4), (2,4) and (8,1)
  against JAX's step on its one-device mesh and on its (d, 1) mesh (d the
  data size), with ``l2sp`` 0 and 0.1 and ``w0 != w``: the new W and the
  loss within 1e-6;
- JAX's step at (1, m) for m > 1, which the port does not copy, pinned:
  ``lr * (m * grad_nll + grad_penalty)`` and one model shard's penalty in
  the loss;
- the step learns, as ``tests/test_parallel.py`` asks of JAX's;
- ``extractive_queries`` rows identical to JAX's;
- ``cli/train_encoder.py --device cpu`` against ``scripts/train_encoder.py``
  on a one-device mesh, over one small bundle and pair file: the recall
  before and after, every epoch's log line, the exit code and the saved
  projection and dense rows, each package loading the other's save.

The JAX steps run on the suite's 8 virtual CPU devices.
"""

import json
import logging
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import legalrag_tpu.parallel as jax_parallel
from legalrag_tpu.config import AppConfig as JaxConfig
from legalrag_tpu.index.bundle import IndexBundle as JaxBundle
from legalrag_tpu.parallel.mesh import DATA_AXIS as JD, MODEL_AXIS as JM
from legalrag_tpu.parallel.mesh import make_mesh as jax_make_mesh
from legalrag_tpu.parallel.training import (
    init_projection as jax_init_projection,
    make_contrastive_train_step as jax_step,
)
from legalrag_tpu_torch.cli import train_encoder
from legalrag_tpu_torch.config import AppConfig
from legalrag_tpu_torch.evals.synthetic import (
    extractive_queries,
    quality_ok,
    strip_citations,
)
from legalrag_tpu_torch.index.bundle import IndexBundle
from legalrag_tpu_torch.parallel.mesh import make_mesh
from legalrag_tpu_torch.parallel.training import (
    full_projection,
    init_projection,
    make_contrastive_train_step,
)
from legalrag_tpu_torch.schemas import LawChunk

ATOL = 1e-6            # the step's new W and loss against JAX's
LR, T = 0.5, 0.1
D_IN, D_OUT, B = 64, 32, 16
SHAPES = ((1, 1), (1, 4), (2, 4), (8, 1))
CPU = torch.device("cpu")


def cpu_mesh(data: int, model: int):
    return make_mesh([CPU] * (data * model), data=data, model=model)


def jax_mesh(data: int, model: int):
    return jax_make_mesh(jax.devices("cpu")[:data * model], data=data,
                         model=model)


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(0)
    q = rng.standard_normal((B, D_IN)).astype(np.float32)
    d = (0.6 * q + rng.standard_normal((B, D_IN))).astype(np.float32)
    w = (rng.standard_normal((D_IN, D_OUT)) / np.sqrt(D_OUT)).astype(np.float32)
    w0 = (w + 0.05 * rng.standard_normal(w.shape)).astype(np.float32)
    return q, d, w, w0


def run_jax(shape, l2sp, q, d, w, w0):
    mesh = jax_mesh(*shape)
    put = lambda x, spec: jax.device_put(x, NamedSharding(mesh, spec))
    args = [put(w, P(None, JM))]
    if l2sp:
        args.append(put(w0, P(None, JM)))
    args += [put(q, P(JD, None)), put(d, P(JD, None))]
    new_w, loss = jax_step(mesh, lr=LR, temperature=T, l2sp=l2sp)(*args)
    return np.asarray(new_w), float(loss)


@pytest.fixture(scope="module")
def jax_steps(batch):
    """JAX's steps, each built once: {(shape, l2sp): (W', loss)}."""
    return {(shape, l2sp): run_jax(shape, l2sp, *batch)
            for shape in ((1, 1), (2, 1), (8, 1), (1, 4), (2, 4))
            for l2sp in (0.0, 0.1)}


def run_port(shape, l2sp, q, d, w, w0):
    mesh = cpu_mesh(*shape)
    step = make_contrastive_train_step(mesh, lr=LR, temperature=T, l2sp=l2sp)
    args = [torch.from_numpy(w)] + ([torch.from_numpy(w0)] if l2sp else [])
    new_w, loss = step(*args, torch.from_numpy(q), torch.from_numpy(d))
    return full_projection(mesh, new_w).numpy(), float(loss)


def test_init_projection_matches_jax():
    d_in, d_out = 256, 32
    want = np.asarray(jax_init_projection(jax_mesh(1, 4), d_in, d_out, seed=3))
    mesh = cpu_mesh(2, 4)
    got = init_projection(mesh, d_in, d_out, seed=3)
    assert len(got) == 2 and all(c.shape == (d_in, d_out // 4)
                                 for row in got for c in row)
    scale = np.float32(np.sqrt(d_out))
    np.testing.assert_allclose(full_projection(mesh, got).numpy() * scale,
                               want * scale, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("l2sp", [0.0, 0.1])
@pytest.mark.parametrize("shape", SHAPES)
def test_step_matches_jax_one_device_and_data_axis(batch, jax_steps, shape,
                                                   l2sp):
    got_w, got_loss = run_port(shape, l2sp, *batch)
    for ref in ((1, 1), (shape[0], 1)):
        want_w, want_loss = jax_steps[(ref, l2sp)]
        np.testing.assert_allclose(got_w, want_w, rtol=0, atol=ATOL,
                                   err_msg=f"W' at {shape} vs JAX {ref}")
        assert abs(got_loss - want_loss) <= ATOL, (shape, ref, got_loss,
                                                   want_loss)


@pytest.mark.parametrize("data", [1, 2])
def test_jax_step_scales_the_update_by_the_model_axis(batch, jax_steps, data):
    """The divergence the port does not copy (ROADMAP C): JAX's step at
    (data, 4) subtracts ``lr * (4 * grad_nll + grad_penalty)`` and reports
    the nll plus model shard 0's penalty only."""
    q, d, w, w0 = batch
    m = 4
    w_nll, nll = jax_steps[((1, 1), 0.0)]
    grad_nll = (w - w_nll) / LR
    grad_pen = 0.1 * 2.0 * (w - w0) / 1e4
    got_w, got_loss = jax_steps[((data, m), 0.1)]
    np.testing.assert_allclose(got_w, w - LR * (m * grad_nll + grad_pen),
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(jax_steps[((data, m), 0.0)][0],
                               w - LR * m * grad_nll, rtol=0, atol=ATOL)
    shard0 = 0.1 * float(((w - w0)[:, :D_OUT // m] ** 2).sum()) / 1e4
    whole = 0.1 * float(((w - w0) ** 2).sum()) / 1e4
    assert abs(got_loss - (nll + shard0)) <= ATOL
    assert abs(got_loss - (nll + whole)) > 10 * ATOL
    # the port: JAX's one-device step at every mesh shape
    port_w, port_loss = run_port((data, m), 0.1, *batch)
    np.testing.assert_allclose(port_w, jax_steps[((1, 1), 0.1)][0], rtol=0,
                               atol=ATOL)
    assert abs(port_loss - (nll + whole)) <= ATOL


def test_step_learns():
    rng = np.random.default_rng(2)
    d_in, d_out, b = 32, 16, 16
    q = rng.standard_normal((b, d_in)).astype(np.float32)
    docs = (0.6 * q + 1.0 * rng.standard_normal((b, d_in))).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    docs /= np.linalg.norm(docs, axis=1, keepdims=True)
    mesh = cpu_mesh(2, 4)
    step = make_contrastive_train_step(mesh, lr=0.5, temperature=1.0)
    w = init_projection(mesh, d_in, d_out, seed=0)
    losses = []
    for _ in range(20):
        w, loss = step(w, torch.from_numpy(q), torch.from_numpy(docs))
        losses.append(float(loss))
    assert losses[0] > 0.5
    assert losses[-1] < losses[0] - 0.05
    assert np.isfinite(losses).all()


def port_chunks(chunks):
    return [LawChunk.from_json(c.model_dump_json(exclude_none=True))
            for c in chunks]


@pytest.mark.parametrize("hardness", [0.0, 0.5])
@pytest.mark.parametrize("lang", ["zh", "en"])
def test_extractive_queries_match_jax(zh_chunks, en_chunks, lang, hardness):
    from scripts.generate_synthetic_data import (
        extractive_queries as jax_extractive,
    )

    chunks = (zh_chunks[:300] if lang == "zh" else en_chunks[:150])
    want = jax_extractive(chunks, n=10 ** 9, seed=11, per_article=2,
                          hardness=hardness)
    got = extractive_queries(port_chunks(chunks), n=10 ** 9, seed=11,
                             per_article=2, hardness=hardness)
    assert len(want) > 50 and got == want
    short = jax_extractive(chunks, n=7, seed=5)
    assert extractive_queries(port_chunks(chunks), n=7, seed=5) == short


def test_strip_citations_and_quality_gates_match_jax():
    from scripts import generate_synthetic_data as jax_gen

    texts = ["依照本法第一百二十条的规定，当事人可以请求", "第十条 民事主体",
             "See Section 9-203(b) and §1-201 for the rule", "这是什么",
             "this rule applies to goods", "What is a security interest?",
             "短", "买卖合同的出卖人应当按照约定的期限交付标的物"]
    for t in texts:
        assert strip_citations(t) == jax_gen.strip_citations(t)
        for lang in ("zh", "en"):
            assert quality_ok(t, lang) == jax_gen.quality_ok(t, lang), (t, lang)


CLI_DOCS = 150
CLI_DIM = 64


def _configs(root):
    paths = {name: str(root / name) for name in (
        "data_dir", "raw_dir", "processed_dir", "index_dir", "graph_dir",
        "eval_dir", "upload_dir")}
    blob = {"paths": paths, "retrieval": {"embedding_dim": CLI_DIM},
            "engine": {"capacity_round": 64, "late_doc_maxlen": 32}}
    (root / "cfg.json").write_text(json.dumps(blob))
    return JaxConfig.load(root / "cfg.json"), root / "cfg.json"


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def test_train_encoder_cli_matches_jax_script(zh_chunks, tmp_path_factory,
                                              monkeypatch):
    """Both CLIs over copies of one JAX-built bundle (a seeded trained
    projection set first, so both start from the same W) and one pair file
    used for training and the gate: equal recall before / after and epoch
    lines, exit 0, the saved projections within float16's resolution, and
    each package serving the other's save."""
    from scripts import train_encoder as jax_cli

    chunks = zh_chunks[:CLI_DOCS]
    roots = {}
    for name in ("jax", "port"):
        root = tmp_path_factory.mktemp(f"train_{name}")
        jcfg, cfg_file = _configs(root)
        jb = JaxBundle.build_from_chunks(chunks, jcfg.with_lang("zh"), "zh")
        rng = np.random.default_rng(1)
        jb.encoder.set_projection((rng.standard_normal((16384, CLI_DIM))
                                   / 8).astype(np.float32))
        jb.save(jcfg.with_lang("zh").paths.lang_index_dir)
        roots[name] = (root, jcfg, cfg_file)
    rows = extractive_queries(port_chunks(chunks), 10 ** 9, seed=3,
                              per_article=2, hardness=0.5)
    pairs = roots["port"][0] / "pairs.jsonl"
    pairs.write_text("".join(json.dumps(r, ensure_ascii=False) + "\n"
                             for r in rows), encoding="utf-8")
    flags = ["--epochs", "2", "--lr", "0.5", "--pairs", str(pairs),
             "--eval-pairs", str(pairs), "--save"]

    # JAX's script on a one-device mesh, its config and argv handed in
    root, jcfg, _ = roots["jax"]
    one = jax.devices("cpu")[:1]
    monkeypatch.setattr(jax_parallel, "local_devices", lambda *a, **k: one)
    monkeypatch.setattr(JaxConfig, "load",
                        classmethod(lambda cls, *a, **k: jcfg))
    monkeypatch.setattr(sys, "argv", ["train_encoder"] + flags)
    lines = _Lines()
    logging.getLogger("train_encoder").addHandler(lines)
    try:
        jax_cli.main()
    finally:
        logging.getLogger("train_encoder").removeHandler(lines)
    want = [line for line in lines.lines if "Recall@10" in line]

    root, _, cfg_file = roots["port"]
    port_lines = _Lines()
    logging.getLogger("torch.cli.train_encoder").addHandler(port_lines)
    try:
        res = train_encoder.run(train_encoder.parse_args(
            ["--config", str(cfg_file), "--device", "cpu"] + flags))
    finally:
        logging.getLogger("torch.cli.train_encoder").removeHandler(port_lines)
    got = [line for line in port_lines.lines if "Recall@10" in line]
    assert res["exit"] == 0 and res["saved"] and res["shape"] == {
        "data": 1, "model": 1}
    assert len(res["losses"]) == 2 * (len(rows) // 64)
    assert res["after"] > res["before"]
    # recall lines equal; the epoch losses within 1e-3 of the log's %.4f
    assert [line.split("Recall@10")[1] for line in got] == \
        [line.split("Recall@10")[1] for line in want]

    dirs = {name: roots[name][1].with_lang("zh").paths.lang_index_dir
            for name in roots}
    projs = {name: np.load(dirs[name] / "encoder.npz")["proj"]
             for name in dirs}
    assert projs["port"].dtype == np.float16
    np.testing.assert_allclose(projs["port"].astype(np.float32),
                               projs["jax"].astype(np.float32), rtol=0,
                               atol=2e-3)
    for name in dirs:
        assert json.loads((dirs[name] / "manifest.json").read_text(
        ))["generation"] == 2

    # each package serves the other's save with the trained projection
    cfg = AppConfig.load(cfg_file)
    mine = IndexBundle.load(dirs["jax"], cfg.with_lang("zh"), "zh",
                            device="cpu")
    np.testing.assert_array_equal(
        mine.encoder.projection().numpy(),
        projs["jax"].astype(np.float32))
    theirs = JaxBundle.load(dirs["port"], roots["jax"][1].with_lang("zh"),
                            "zh")
    np.testing.assert_array_equal(np.asarray(theirs.encoder._projection()),
                                  projs["port"].astype(np.float32))
    q = [r["query"] for r in rows[:8]]
    np.testing.assert_allclose(mine.encoder.encode_queries(q),
                               np.asarray(JaxBundle.load(
                                   dirs["jax"], roots["jax"][1].with_lang(
                                       "zh"), "zh").encoder.encode_queries(q)),
                               rtol=0, atol=1e-5)
    port_saved = IndexBundle.load(dirs["port"], cfg.with_lang("zh"), "zh",
                                  device="cpu")
    np.testing.assert_allclose(
        port_saved.dense.emb[:CLI_DOCS].float().numpy(),
        np.asarray(theirs.dense.emb[:CLI_DOCS], np.float32), rtol=0,
        atol=1e-2)
