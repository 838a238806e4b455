"""The port decoder's per-row forward (``legalrag_tpu_torch/models/decoder.py``
``DecoderModel.forward`` with a [B] ``cache_len``, ``shared_kv`` and
``kv_offset``: the continuous-batching engine's decode and verify steps and
its pinned shared prefix) against the JAX package's ``decoder_forward`` on
the CPU, float32, on the tiny Qwen2 checkpoint of
``tests/test_torch_decoder.py``.

The same random cache (dense, or the int8 cache's 4-tuple) goes through
both; the logits and the written cache must agree within ``ATOL``, the rows
no offset writes unchanged. A row's offset past the end of the cache is
dropped, as JAX's scatter drops it, and the cache stays as it was there."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legalrag_tpu.models import decoder as jd
from legalrag_tpu_torch.models import decoder as td
from test_torch_decoder import ATOL, VOCAB, load_both, write_ckpt

S = 32          # cache rows a batch row
P = 12          # the shared segment's positions


@pytest.fixture(scope="module")
def qwen(tmp_path_factory):
    return load_both(write_ckpt(tmp_path_factory.mktemp("batched_fwd")))


def random_cache(cfg, rng, b: int, rows: int, int8: bool):
    """Per layer a dense (k, v) [b, rows, Hkv, D] or an int8 (k_q, v_q,
    k_scale, v_scale) cache of random numpy values."""
    shape = (b, rows, cfg.num_key_value_heads, cfg.head_dim)
    out = []
    for _ in range(cfg.num_hidden_layers):
        if int8:
            out.append(tuple(
                [rng.integers(-127, 128, shape).astype(np.int8)
                 for _ in range(2)]
                + [rng.uniform(0.001, 0.02, shape[:3] + (1,)).astype(
                    np.float32) for _ in range(2)]))
        else:
            out.append(tuple(rng.standard_normal(shape).astype(np.float32)
                             for _ in range(2)))
    return out


# (offsets a row, rows written a call, shared): each row's write offset is
# absolute; a shared row's cache holds positions from P on
CASES = {
    "vector_decode": ([5, 17, 30], 1, None),
    "vector_verify": ([0, 9, 22], 5, None),
    # the third row's last 2 of 5 rows and the fourth row's one row fall
    # past the cache: dropped
    "vector_past_the_end": ([3, 14, 29, 32], 5, None),
    "shared_decode": ([P + 3, 7, P + 19], 1, [P, 0, P]),
    "shared_verify_past_the_end": ([P + 4, 25, P + 17], 4, [P, 0, P]),
    "shared_offset_forward": ([P + 6], 6, P),
}


@pytest.mark.parametrize("int8", [False, True], ids=["dense", "int8"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_per_row_forward_matches_decoder_forward(qwen, case, int8):
    (jparams, jcfg), state, cfg = qwen
    lens, t, offset = CASES[case]
    b = len(lens)
    rng = np.random.default_rng(sorted(CASES).index(case))
    rows = S - P if offset is not None else S
    cache = random_cache(cfg, rng, b, rows, int8)
    shared = (random_cache(cfg, rng, 1, P, int8) if offset is not None
              else None)
    ids = rng.integers(0, VOCAB, (b, t))
    lens_np = np.asarray(lens, np.int64)
    pos = lens_np[:, None] + np.arange(t)[None, :]
    # one row at an int offset (an admission chunk), else a [B] offset
    cache_len = lens_np if b > 1 else lens[0]

    def jnp_tree(c):
        return None if c is None else [tuple(jnp.asarray(a) for a in l)
                                       for l in c]

    jcl = (jnp.asarray(cache_len, jnp.int32) if not isinstance(cache_len, int)
           else jnp.int32(cache_len))
    joff = (None if offset is None else jnp.asarray(offset, jnp.int32))
    want, want_cache = jd.decoder_forward(
        jparams, jcfg, jnp.asarray(ids, jnp.int32),
        jnp.asarray(pos, jnp.int32), kv_cache=jnp_tree(cache),
        cache_len=jcl, shared_kv=jnp_tree(shared), kv_offset=joff)

    model = td.DecoderModel.from_state_dict(cfg, state)
    port_cache = [tuple(torch.from_numpy(a.copy()) for a in l) for l in cache]
    port_shared = (None if shared is None else
                   [tuple(torch.from_numpy(a) for a in l) for l in shared])
    tcl = (torch.from_numpy(cache_len) if not isinstance(cache_len, int)
           else cache_len)
    toff = (None if offset is None else
            torch.tensor(offset) if isinstance(offset, list) else offset)
    with torch.no_grad():
        got = model(torch.from_numpy(ids), torch.from_numpy(pos),
                    kv_cache=port_cache, cache_len=tcl,
                    shared_kv=port_shared, kv_offset=toff)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    row0 = lens_np - (0 if offset is None else np.asarray(offset))
    for layer, jlayer, before in zip(port_cache, want_cache, cache):
        for a, ja, a0 in zip(layer, jlayer, before):
            a, ja = a.numpy(), np.asarray(ja)
            if a.dtype == np.int8:
                np.testing.assert_array_equal(a, ja)
            else:
                np.testing.assert_allclose(a, ja, atol=ATOL, rtol=0)
            for r in range(b):
                written = set(range(row0[r], row0[r] + t)) & set(range(rows))
                untouched = [i for i in range(rows) if i not in written]
                np.testing.assert_array_equal(a[r, untouched],
                                              a0[r, untouched])
                if int(row0[r]) + t > rows:
                    assert len(written) < t      # something was dropped
