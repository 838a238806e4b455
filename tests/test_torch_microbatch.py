"""Port micro-batcher (``retrieval.batcher``) vs the JAX one: concurrent
searches coalesce into fewer channels calls and give the serial hits; the
leader/follower protocol behaves as JAX's on the same fake executions
(errors to every waiter, the leader returns while a drainer works, no
duplicate solo runs); kernel launch counts hold under many threads."""

import sys
import threading
import time

import numpy as np
import pytest

from legalrag_tpu.config import AppConfig as JaxConfig
from legalrag_tpu.index.bundle import IndexBundle as JaxBundle
from legalrag_tpu.retrieval.batcher import MicroBatcher as JaxMicroBatcher
from legalrag_tpu.retrieval.batcher import _slice_result as jax_slice_result
from legalrag_tpu.retrieval.hybrid import HybridRetriever as JaxHybrid
from legalrag_tpu_torch import kernels
from legalrag_tpu_torch.config import AppConfig
from legalrag_tpu_torch.retrieval.batcher import MicroBatcher, _slice_result
from legalrag_tpu_torch.retrieval.hybrid import HybridRetriever
from test_torch_engine import carry

BATCHERS = {"port": MicroBatcher, "jax": JaxMicroBatcher}
JOIN_S = 30.0

QUESTIONS = [
    "buyer in ordinary course of business",
    "negotiable instrument payable to bearer",
    "security interest perfection filing",
    "letter of credit issuer obligations",
    "lease contract default remedies",
    "warranty of merchantability goods",
]


@pytest.fixture(scope="module")
def pair(en_chunks):
    """(JAX, port) retrievers over en[:120], a 20 ms batching window."""
    jcfg, cfg = JaxConfig(), AppConfig()
    for c in (jcfg, cfg):
        c.engine.capacity_round = 256
        c.engine.late_doc_maxlen = 64
        c.engine.microbatch_window_ms = 20.0  # force overlap
    jb = JaxBundle.build_from_chunks(en_chunks[:120], jcfg, "en")
    return JaxHybrid(jb, jcfg), HybridRetriever(carry(jb, cfg), cfg)


def run_threads(target, args_list):
    threads = [threading.Thread(target=target, args=a) for a in args_list]
    for t in threads:
        t.start()
    for t in threads:
        t.join(JOIN_S)
    assert not any(t.is_alive() for t in threads)


def test_concurrent_searches_match_serial_and_jax_and_coalesce(pair):
    jhr, thr = pair
    want = {q: jhr.search(q, top_k=5) for q in QUESTIONS}
    serial = {q: thr.search(q, top_k=5) for q in QUESTIONS}
    base = thr._batcher.executions
    results, errors = {}, []

    def worker(q):
        try:
            results[q] = thr.search(q, top_k=5)
        except Exception as e:  # surfaces in the main thread
            errors.append(e)

    run_threads(worker, [(q,) for q in QUESTIONS])
    assert not errors
    for q in QUESTIONS:
        ids = [h.chunk.id for h in results[q]]
        assert ids == [h.chunk.id for h in serial[q]]
        assert ids == [h.chunk.id for h in want[q]]
        np.testing.assert_allclose([h.score for h in results[q]],
                                   [h.score for h in want[q]], atol=1e-5)
    used = thr._batcher.executions - base
    assert used < len(QUESTIONS), f"{used} executions for {len(QUESTIONS)}"
    assert thr._batcher.coalesced > 0


def test_mixed_eff_k_slices_nest(pair):
    _, thr = pair
    solo = thr._channels_topk_batch(["security interest filing"], 8)
    out = {}

    def small():
        out["small"] = thr._batcher.run("security interest filing", 8)

    def big():
        out["big"] = thr._batcher.run("lease default remedies", 32)

    run_threads(lambda f: f(), [(small,), (big,)])
    for name in ("dense", "bm25", "colbert"):
        np.testing.assert_array_equal(out["small"][name][1], solo[name][1])
        assert out["small"][name][0].shape[1] == 8
        assert out["big"][name][0].shape[1] == 32


@pytest.mark.parametrize("impl", ["port", "jax"])
def test_error_reaches_every_waiter(impl):
    calls = []

    def boom(questions, eff_k):
        calls.append(len(questions))
        raise RuntimeError("device on fire")

    mb = BATCHERS[impl](boom, window_s=0.05, max_batch=8)
    errs = []

    def worker():
        try:
            mb.run("q", 4)
        except RuntimeError as e:
            errs.append(str(e))

    run_threads(worker, [()] * 3)
    assert errs == ["device on fire"] * 3
    assert sum(calls) == 3 and mb.executions == 0


def test_slice_result_equals_jax():
    assert _slice_result(None, 0, 4) is None is jax_slice_result(None, 0, 4)
    rng = np.random.default_rng(0)
    res = {"dense": (rng.random((3, 16), dtype=np.float32),
                     rng.integers(0, 99, (3, 16))),
           "qvec": rng.random((3, 8), dtype=np.float32)}
    for i, k in ((0, 16), (2, 5)):
        got, want = _slice_result(res, i, k), jax_slice_result(res, i, k)
        assert set(got) == set(want)
        np.testing.assert_array_equal(got["qvec"], want["qvec"])
        for a, b in zip(got["dense"], want["dense"]):
            np.testing.assert_array_equal(a, b)
            assert a.shape == (1, k)


def test_empty_index_returns_none(pair):
    jhr, thr = pair
    for hr in (jhr, thr):
        n = hr.bundle.dense.n
        hr.bundle.dense.n = 0  # an empty index
        try:
            assert hr._channels_topk_all("anything", 8) is None
        finally:
            hr.bundle.dense.n = n


@pytest.mark.parametrize("impl", ["port", "jax"])
def test_leader_returns_while_queue_still_draining(impl):
    """After its first batch the leader's request returns; later batches
    run on a daemon drainer."""
    calls = {"n": 0}
    block = threading.Event()

    def run(questions, eff_k):
        calls["n"] += 1
        if calls["n"] > 1:  # every batch after the leader's blocks
            block.wait(5.0)
        return {"x": (np.zeros((len(questions), eff_k), np.float32),
                      np.zeros((len(questions), eff_k), np.int32))}

    mb = BATCHERS[impl](run, window_s=0.1, max_batch=1)
    done = {}

    def worker(name):
        done[name] = mb.run(name, 4)

    leader = threading.Thread(target=worker, args=("leader",))
    leader.start()
    time.sleep(0.02)  # the leader is inside its batching window
    followers = [threading.Thread(target=worker, args=(f"f{i}",))
                 for i in range(2)]
    for t in followers:
        t.start()
    leader.join(3.0)
    alive = leader.is_alive()
    block.set()  # always unblock before asserting, or threads leak
    for t in followers:
        t.join(5.0)
    assert not alive, "leader starved behind follower batches"
    assert len(done) == 3 and all(v is not None for v in done.values())
    assert calls["n"] == 3 and mb.executions == 3


@pytest.mark.parametrize("impl", ["port", "jax"])
def test_slow_execution_does_not_trigger_duplicate_solo_runs(impl):
    """Slots already drained into an in-flight execution wait for it past
    the wait timeout instead of running alone."""
    calls = []
    release = threading.Event()

    def slow_run(questions, eff_k):
        calls.append(list(questions))
        release.wait(5.0)  # longer than the batcher timeout below
        return {"x": (np.zeros((len(questions), eff_k), np.float32),
                      np.zeros((len(questions), eff_k), np.int32))}

    mb = BATCHERS[impl](slow_run, window_s=0.05, max_batch=8,
                        wait_timeout_s=0.2)
    out = []
    threads = [threading.Thread(target=lambda q=q: out.append(mb.run(q, 4)))
               for q in ("q0", "q1", "q2", "q3")]
    for t in threads:
        t.start()
    time.sleep(1.0)  # all four slots claimed, execution in flight
    release.set()
    for t in threads:
        t.join(JOIN_S)
    assert len(out) == 4 and all(o is not None for o in out)
    assert len(calls) == 1 and sorted(calls[0]) == ["q0", "q1", "q2", "q3"]
    assert (mb.executions, mb.coalesced) == (1, 3)


def test_many_threads_get_their_own_rows():
    """32 threads on 8 cores with a short switch interval: every request
    gets its own question's slice, and the counters add up."""
    def run(questions, eff_k):
        ids = np.array([[int(q)] * eff_k for q in questions])
        return {"x": (ids.astype(np.float32), ids)}

    mb = MicroBatcher(run, window_s=0.001, max_batch=5)
    bad = []

    def worker(t):
        for i in range(40):
            q = t * 1000 + i
            got = mb.run(str(q), 3 + i % 4)
            if not (got["x"][1] == q).all() or got["x"][1].shape != (1, 3 + i % 4):
                bad.append(q)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        run_threads(worker, [(t,) for t in range(32)])
    finally:
        sys.setswitchinterval(old)
    assert not bad
    assert mb.executions + mb.coalesced == 32 * 40


def test_launch_counts_hold_under_threads(monkeypatch):
    """``kernels.launch`` counts every launch made from many threads (the
    serving path's request threads launch concurrently)."""
    class FakeLib:
        def __getattr__(self, name):
            return lambda *args: 0  # cudaSuccess

    monkeypatch.setattr(kernels, "lib", lambda: FakeLib())
    kernels.reset_launch_counts()

    def worker():
        for _ in range(2000):
            kernels.launch("score_select")
            kernels.launch("maxsim")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        run_threads(worker, [()] * 16)
    finally:
        sys.setswitchinterval(old)
    counts = kernels.launch_counts()
    kernels.reset_launch_counts()
    assert counts == {"score_select": 32000, "maxsim": 32000,
                      "bm25_sparse": 0}
    assert kernels.launch_counts() == dict.fromkeys(kernels.KERNELS, 0)


def test_launch_counts_by_route(monkeypatch):
    """A launch named with a route counts under the kernel and the route;
    an unknown route raises before the launch and counts nothing; MaxSim's
    wrapper names each store kind's route (``kernels.ROUTES``)."""
    import torch

    from legalrag_tpu_torch.ops import maxsim as ms

    class FakeLib:
        def __getattr__(self, name):
            return lambda *args: 0  # cudaSuccess

    monkeypatch.setattr(kernels, "lib", lambda: FakeLib())
    kernels.reset_launch_counts()
    for route in ("nbit4", "nbit4", "int8"):
        kernels.launch("maxsim", route=route)
    kernels.launch("score_select")
    with pytest.raises(ValueError):
        kernels.launch("maxsim", route="fp8")
    counts = kernels.launch_counts(routes=True)
    kernels.reset_launch_counts()
    assert counts == {"score_select": 1, "maxsim": 3, "bm25_sparse": 0,
                      "maxsim/float32": 0, "maxsim/bf16": 0,
                      "maxsim/int8": 1, "maxsim/nbit4": 2}
    assert kernels.launch_counts(routes=True) == dict.fromkeys(counts, 0)
    stores = {"float32": torch.zeros(2, 3, 32),
              "bf16": torch.zeros(2, 3, 32, dtype=torch.bfloat16),
              "int8": torch.zeros(2, 3, 32, dtype=torch.int8),
              "nbit4": ms.Residual4Store(
                  torch.zeros(2, 3, dtype=torch.uint8),
                  torch.zeros(2, 3, 16, dtype=torch.uint8),
                  torch.zeros(256, 32), torch.zeros(32), torch.zeros(32))}
    assert {r: ms._ROUTES[ms.kernel_type_id(s)] for r, s in stores.items()} \
        == {r: r for r in kernels.ROUTES["maxsim"]}
    with pytest.raises(TypeError):
        ms.kernel_type_id(torch.zeros(2, 3, 32, dtype=torch.float16))
