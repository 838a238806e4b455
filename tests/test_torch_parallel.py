"""The port's mesh and sharded search (``legalrag_tpu_torch/parallel``)
against the JAX package's (``tests/test_parallel.py``) on the CPU:

- mesh shapes and axis names as ``make_mesh`` lays them out, the
  placement helpers' cells, ``slice_major_order`` with stub devices in
  JAX's order, ``make_global_mesh`` on one slice;
- ``init_multihost``: a no-op without ``JAX_COORDINATOR_ADDRESS``, refused
  with it (and so is the serving mesh and the server's ``main``);
- ``make_sharded_dense_topk`` and ``make_sharded_hybrid_step`` (with and
  without the late channel) on the port's (2, 4) grid of the CPU against
  JAX's on its (2, 4) mesh of virtual devices: rows exactly, scores within
  1e-5 (float32 and bf16 stores; a shard with no valid row; ``k`` above
  the valid rows, whose ``NEG_INF`` padding rows must be JAX's too);
- ``engine.n_index_shards`` refused as JAX refuses it, and -1 serving over
  every visible device.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from legalrag_tpu.config import AppConfig as JaxConfig
from legalrag_tpu.parallel import mesh as jax_mesh_mod
from legalrag_tpu.parallel.mesh import DATA_AXIS as JD, MODEL_AXIS as JM
from legalrag_tpu.parallel.sharded_search import (
    make_sharded_dense_topk as jax_dense_topk,
    make_sharded_hybrid_step as jax_hybrid_step,
)
from legalrag_tpu_torch.config import AppConfig
from legalrag_tpu_torch.index.bundle import IndexBundle
from legalrag_tpu_torch.ops.topk import dense_topk
from legalrag_tpu_torch.parallel import mesh as mesh_mod
from legalrag_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    batch_sharded,
    make_global_mesh,
    make_mesh,
    replicated,
    row_sharded,
    slice_major_order,
)
from legalrag_tpu_torch.parallel.sharded_search import (
    make_sharded_dense_topk,
    make_sharded_hybrid_step,
    shard_corpus_arrays,
)
from legalrag_tpu_torch.retrieval.by_lang import BundleCache
from test_torch_index import port_chunks

CPU = torch.device("cpu")


def cpu_mesh(data: int, model: int):
    return make_mesh([CPU] * (data * model), data=data, model=model)


@pytest.fixture(scope="module")
def jmesh():
    devs = jax.devices("cpu")
    if len(devs) < 8:
        pytest.skip("needs 8 virtual cpu devices")
    return jax_mesh_mod.make_mesh(devs[:8], data=2, model=4)


def test_mesh_shapes():
    devs = [torch.device("cuda", i) for i in range(8)]
    m = make_mesh(devs, data=2, model=4)
    assert m.axis_names == (DATA_AXIS, MODEL_AXIS) == ("data", "model")
    assert m.devices.shape == (2, 4)
    assert m.shape == {"data": 2, "model": 4}
    assert [d.index for d in m.devices[1]] == [4, 5, 6, 7]
    assert make_mesh(devs).shape == {"data": 1, "model": 8}
    assert make_mesh(devs, model=2).shape == {"data": 4, "model": 2}
    assert make_mesh(devs, data=8).shape == {"data": 8, "model": 1}
    assert m.lead == torch.device("cuda", 0)
    assert m == make_mesh(devs, data=2, model=4) and m != make_mesh(devs)
    assert hash(m) == hash(make_mesh(devs, data=2, model=4))
    with pytest.raises(AssertionError, match="mesh 3x3"):
        make_mesh(devs, data=3, model=3)
    # a grid may name one device more than once
    assert cpu_mesh(2, 4).devices.shape == (2, 4)
    assert mesh_mod.local_devices("cpu") == [CPU]


def test_placement_helpers():
    m = cpu_mesh(2, 4)
    x = torch.arange(48.0).reshape(8, 6)
    rows = row_sharded(m, x)
    assert [[c[0, 0].item() for c in r] for r in rows] == \
        [[0.0, 12.0, 24.0, 36.0]] * 2
    bat = batch_sharded(m, x)
    assert [[c.shape for c in r] for r in bat] == [[(4, 6)] * 4] * 2
    assert bat[1][2][0, 0].item() == 24.0
    rep = replicated(m, x)
    assert all(torch.equal(c, x) for r in rep for c in r)
    emb, imp = shard_corpus_arrays(m, x, x.T.contiguous().T)
    assert emb[1][3].shape == (2, 6) and imp[0][0].shape == (2, 6)
    with pytest.raises(ValueError, match="does not split"):
        row_sharded(cpu_mesh(1, 3), x)


class _StubDev:
    def __init__(self, slice_index, process_index, id_):
        self.slice_index = slice_index
        self.process_index = process_index
        self.id = id_


def test_slice_major_order_policy():
    devs = [_StubDev(s, p, i) for i in (1, 0) for p in (1, 0) for s in (1, 0)]
    n_slices, order = slice_major_order(devs)
    want_n, want = jax_mesh_mod.slice_major_order(devs)
    assert n_slices == want_n == 2
    assert [id(d) for d in order] == [id(d) for d in want]
    assert [(d.slice_index, d.process_index, d.id) for d in order] == [
        (0, 0, 0), (0, 0, 1), (0, 1, 0), (0, 1, 1),
        (1, 0, 0), (1, 0, 1), (1, 1, 0), (1, 1, 1)]
    m = make_global_mesh(devs)
    assert m.shape == {"data": 2, "model": 4}


def test_make_global_mesh_single_slice():
    m = make_global_mesh([CPU] * 4)
    assert m.shape[DATA_AXIS] == 1 and m.shape[MODEL_AXIS] == 4
    cards = [torch.device("cuda", i) for i in (2, 0, 3, 1)]
    m = make_global_mesh(cards)
    assert m.shape == {"data": 1, "model": 4}
    assert [d.index for d in m.devices[0]] == [0, 1, 2, 3]
    jm = jax_mesh_mod.make_global_mesh(jax.devices("cpu"))
    assert jm.shape[JD] == make_global_mesh([CPU]).shape[DATA_AXIS]


def test_init_multihost_noop_without_env_refused_with_it(monkeypatch,
                                                         tmp_path):
    monkeypatch.delenv("JAX_COORDINATOR_ADDRESS", raising=False)
    assert mesh_mod.init_multihost() is False
    assert jax_mesh_mod.init_multihost() is False
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "localhost:1")
    with pytest.raises(RuntimeError, match="multi-host serving is not "
                                           "ported"):
        mesh_mod.init_multihost()
    cfg = AppConfig()
    cfg.engine.n_index_shards = 2
    with pytest.raises(RuntimeError, match="A6b"):
        BundleCache(cfg, device="cpu")._serving_mesh()
    from legalrag_tpu_torch.api import server

    monkeypatch.setattr("sys.argv", ["server", "--device", "cpu"])
    with pytest.raises(RuntimeError, match="JAX_COORDINATOR_ADDRESS"):
        server.main()


def test_engine_config_mesh_fields_match_jax():
    mine, theirs = AppConfig().engine, JaxConfig().engine
    for name in ("n_index_shards", "mesh_data_axis", "mesh_model_axis"):
        assert getattr(mine, name) == getattr(theirs, name)
    assert mine.mesh_data_axis == DATA_AXIS
    assert mine.mesh_model_axis == MODEL_AXIS


@pytest.mark.parametrize("name", ["mesh_data_axis", "mesh_model_axis"])
def test_mesh_axis_names_other_than_fixed_refused(tmp_path, name):
    """The mesh's axis names are fixed, so a config that names others is
    refused at load, not ignored; the default names load."""
    path = tmp_path / "cfg.json"
    base = {"paths": {"data_dir": str(tmp_path)}}
    path.write_text(json.dumps({**base, "engine": {name: "x"}}))
    with pytest.raises(ValueError, match=f"engine.{name}='x'"):
        AppConfig.load(path, mkdirs=False)
    path.write_text(json.dumps({**base, "engine": {
        "mesh_data_axis": DATA_AXIS, "mesh_model_axis": MODEL_AXIS}}))
    assert AppConfig.load(path, mkdirs=False).engine.mesh_model_axis == \
        MODEL_AXIS


def _jput(mesh, x, spec):
    return jax.device_put(x, NamedSharding(mesh, spec))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("valid_n,k", [(490, 10), (100, 10), (5, 10)])
def test_sharded_dense_topk_matches_jax(jmesh, dtype, valid_n, k):
    """(2, 4) grid against JAX's (2, 4) mesh; valid_n 100 leaves shards
    1-3 (128 rows each) with no valid row, valid_n 5 pads the lists with
    NEG_INF rows, which must be JAX's."""
    rng = np.random.default_rng(0)
    n, d, b = 512, 64, 8
    emb = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((b, d)).astype(np.float32)
    jemb = jnp.asarray(emb, dtype)
    s_want, i_want = jax_dense_topk(jmesh, k)(
        _jput(jmesh, jemb, P(JM, None)), _jput(jmesh, q, P(JD, None)),
        jnp.int32(valid_n))
    temb = torch.from_numpy(emb).to(getattr(torch, dtype))
    mesh = cpu_mesh(2, 4)
    s, i = make_sharded_dense_topk(mesh, k)(temb, torch.from_numpy(q),
                                           valid_n)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_want))
    np.testing.assert_allclose(s.numpy(), np.asarray(s_want), rtol=0,
                               atol=1e-5)
    # the same lists from the port's unsharded dense channel
    s1, i1 = dense_topk(temb, torch.from_numpy(q), valid_n, k)
    real = s1.numpy() > -1e29
    np.testing.assert_array_equal(i.numpy()[real], i1.numpy()[real])
    np.testing.assert_allclose(s.numpy(), s1.numpy(), rtol=0, atol=1e-5)
    # grids in, as the placement helpers make them
    s2, i2 = make_sharded_dense_topk(mesh, k)(
        row_sharded(mesh, temb), batch_sharded(mesh, torch.from_numpy(q)),
        valid_n)
    assert torch.equal(i2, i) and torch.equal(s2, s)


def _hybrid_inputs(seed=0, n=128, d=32, v=64, b=4, l_doc=8, lq=4, dt=16):
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((n, d)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    impact_rows = np.abs(rng.standard_normal((n, v))).astype(np.float32)
    impact_rows[:, 20:] = 0.0   # docs tie at 0 on most terms
    doc_tok = rng.standard_normal((n, l_doc, dt)).astype(np.float32)
    doc_mask = rng.random((n, l_doc)) < 0.8
    qvec = rng.standard_normal((b, d)).astype(np.float32)
    qtf = np.zeros((b, v), np.float32)
    qtf[:, 15:25] = 1.0
    q_tok = rng.standard_normal((b, lq, dt)).astype(np.float32)
    q_mask = np.ones((b, lq), bool)
    return emb, impact_rows, doc_tok, doc_mask, qvec, qtf, q_tok, q_mask


@pytest.mark.parametrize("has_late", [False, True])
def test_sharded_hybrid_step_matches_jax(jmesh, has_late):
    emb, imp, tok, dmask, qvec, qtf, qt, qm = _hybrid_inputs()
    valid_n = 120
    kw = dict(k=8, eff_k=16, has_late=has_late)
    jstep = jax_hybrid_step(jmesh, **kw)
    put = lambda x, spec: _jput(jmesh, x, spec)
    corpus = [put(emb, P(JM, None)), put(imp, P(JM, None))]
    queries = [put(qvec, P(JD, None)), put(qtf, P(JD, None))]
    t = torch.from_numpy
    step = make_sharded_hybrid_step(cpu_mesh(2, 4), **kw)
    if has_late:
        s_want, i_want = jstep(*corpus, put(tok, P(JM, None, None)),
                               put(dmask, P(JM, None)), *queries,
                               put(qt, P(JD, None, None)),
                               put(qm, P(JD, None)), jnp.int32(valid_n))
        s, i = step(t(emb), t(imp), t(tok), t(dmask), t(qvec), t(qtf), t(qt),
                    t(qm), valid_n)
    else:
        s_want, i_want = jstep(*corpus, *queries, jnp.int32(valid_n))
        s, i = step(t(emb), t(imp), t(qvec), t(qtf), valid_n)
    assert s.shape == (4, 8)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_want))
    np.testing.assert_allclose(s.numpy(), np.asarray(s_want), rtol=0,
                               atol=1e-5)
    assert (i.numpy() < valid_n).all()


def test_bad_n_index_shards_refused(monkeypatch):
    cfg = AppConfig()
    for bad in (0, -2):
        cfg.engine.n_index_shards = bad
        with pytest.raises(ValueError, match="n_index_shards"):
            BundleCache(cfg, device="cpu")._serving_mesh()
    cfg.engine.n_index_shards = 2   # one CPU device is visible
    with pytest.raises(RuntimeError, match="only 1 devices visible"):
        BundleCache(cfg, device="cpu")._serving_mesh()
    monkeypatch.setattr(mesh_mod, "local_devices",
                        lambda platform=None: [CPU] * 3)
    assert BundleCache(cfg, device="cpu")._serving_mesh().shape == {
        "data": 1, "model": 2}
    with pytest.raises(RuntimeError, match="only 3 devices visible"):
        cfg.engine.n_index_shards = 4
        BundleCache(cfg, device="cpu")._serving_mesh()


def test_n_index_shards_all_devices(zh_chunks, tmp_path_factory,
                                    monkeypatch):
    """-1 shards a loaded bundle and a put one over every visible device;
    1 leaves them unsharded."""
    root = tmp_path_factory.mktemp("allshards")
    cfg = AppConfig()
    cfg.engine.capacity_round = 64
    cfg.engine.late_doc_maxlen = 32
    for name in ("data_dir", "raw_dir", "processed_dir", "index_dir",
                 "graph_dir", "eval_dir", "upload_dir"):
        setattr(cfg.paths, name, root / name)
    cfg.paths.ensure_tree()
    bundle = IndexBundle.build_from_chunks(port_chunks(zh_chunks[:60]),
                                           cfg.with_lang("zh"), "zh",
                                           device="cpu")
    bundle.save(root / "index_dir" / "zh")
    assert BundleCache(cfg, device="cpu").get("zh").mesh is None
    cfg.engine.n_index_shards = -1
    assert BundleCache(cfg, device="cpu").get("zh").mesh.shape == {
        "data": 1, "model": 1}
    monkeypatch.setattr(mesh_mod, "local_devices",
                        lambda platform=None: [CPU] * 5)
    cache = BundleCache(cfg, device="cpu")
    assert cache.get("zh").mesh.shape[MODEL_AXIS] == 5
    cache.put("zh", bundle)
    assert bundle.mesh.shape[MODEL_AXIS] == 5
    views = bundle.shard_views()
    # capacity 64, impact columns 128 (rounded to 128): 130 rows in 5 shards
    assert [t.shape[0] for t in views["emb"]] == [26] * 5
    assert [t.shape[1] for t in views["impact"]] == [26] * 5
