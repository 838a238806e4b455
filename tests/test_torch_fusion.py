"""Port ``retrieval.fusion.fuse`` vs the JAX one: the same channel lists
give the same candidates in the same order, with equal scores and
breakdowns (pure Python on the same inputs, so exactly), for all four
methods."""

import numpy as np
import pytest

from legalrag_tpu.retrieval.fusion import ChannelResult as JaxChannel
from legalrag_tpu.retrieval.fusion import fuse as jax_fuse
from legalrag_tpu_torch.retrieval.fusion import ChannelResult, fuse

METHODS = ["rrf", "wrrf", "weighted_sum", "rrf_norm_blend"]


def random_channels(seed: int):
    """Three channels of seeded lists over 40 rows: float32 scores as the
    device returns them, some rows in several channels, ties in scores."""
    rng = np.random.default_rng(seed)
    out = []
    for name, w in (("dense", 0.6), ("bm25", 0.4), ("colbert", 0.35)):
        k = int(rng.integers(5, 20))
        rows = rng.choice(40, size=k, replace=False).astype(np.int64)
        scores = np.sort(rng.choice([0.0, 1.5, *rng.random(6)], size=k)
                         ).astype(np.float32)[::-1]
        out.append((name, w, rows, scores))
    return out


CASES = {
    "two_channels": [("dense", 0.6, [10, 11, 12], [0.9, 0.8, 0.1]),
                     ("bm25", 0.4, [11, 13, 10], [12.0, 5.0, 4.0])],
    "duplicate_rows": [("dense", 0.6, [3, 3, 4, 5], [0.9, 0.7, 0.7, 0.2]),
                       ("bm25", 0.4, [5, 3, 5], [2.0, 1.0, 0.5])],
    "empty_channel": [("dense", 0.6, [1, 2], [0.5, 0.4]),
                      ("bm25", 0.4, [], []),
                      ("colbert", 0.35, [2, 7], [9.0, 9.0])],
    "single": [("dense", 1.0, [5], [2.0])],
    "all_equal": [("dense", 0.6, [1, 2, 3], [0.0, 0.0, 0.0])],
    "none": [],
    **{f"random{s}": random_channels(s) for s in range(4)},
}


def as_candidates(out):
    return [(c.row, c.score, c.breakdown) for c in out]


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_fuse_equals_jax(case, method):
    chans = CASES[case]
    got = fuse([ChannelResult(*c) for c in chans], method=method, rrf_k=60,
               alpha=0.5)
    want = jax_fuse([JaxChannel(*c) for c in chans], method=method,
                    rrf_k=60, alpha=0.5)
    assert as_candidates(got) == as_candidates(want)
    assert all(type(c.row) is int and type(c.score) is float for c in got)


def test_fuse_other_rrf_k_and_alpha():
    chans = CASES["random1"]
    for rrf_k, alpha in ((1, 0.0), (10, 1.0), (60, 0.25)):
        got = fuse([ChannelResult(*c) for c in chans], rrf_k=rrf_k,
                   alpha=alpha)
        want = jax_fuse([JaxChannel(*c) for c in chans], rrf_k=rrf_k,
                        alpha=alpha)
        assert as_candidates(got) == as_candidates(want)


def test_wrrf_math():
    out = {c.row: c for c in fuse([ChannelResult(*c)
                                   for c in CASES["two_channels"]],
                                  method="wrrf")}
    # row 11: dense rank 2, bm25 rank 1; row 13: bm25 rank 2 only
    assert out[11].score == pytest.approx(0.6 / 62 + 0.4 / 61)
    assert out[13].score == pytest.approx(0.4 / 62)
