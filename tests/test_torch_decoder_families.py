"""The port's decoder engine on the dense families past Qwen2 (Qwen3,
Gemma, Gemma 2, Gemma 3, Mistral, Llama with llama3 RoPE) against JAX's
``JaxDecoderLM`` on the CPU, float32, each on a tiny checkpoint saved by
transformers (``tests/test_torch_decoder.py``'s ``write_ckpt``) with a
window of 12 below the 40-token prompt, so every stream runs past it
(the Gemma heads untied: with the embedding scaled by sqrt(hidden) a tiny
random model with a tied head predicts the token it reads, and the
greedy streams would be one repeated token):

- the KV-cache path (a prefill, then single-token steps across the
  window) within 1e-4 of the full forward;
- greedy streams token-identical to ``JaxDecoderLM``'s and to the port's
  plain stream, with the prompt prefilled in one shot, in chunks of 16
  (the second chunk's queries see keys of the first outside the band),
  after a prefix-cache hit, or decoded one token per host round trip."""

import numpy as np
import pytest
import torch

from legalrag_tpu.models import decoder as jd
from legalrag_tpu_torch.models import decoder as td
from test_torch_decoder import (ATOL, DONOR, GREEDY, MAX_LEN, MODES, PROMPT,
                                load_both, port_logits, stream, write_ckpt)

WINDOW = 12
FAMILIES = {
    "qwen3": dict(family="qwen3", head_dim=16),
    "gemma": dict(family="gemma", tie_word_embeddings=False),
    "gemma2": dict(family="gemma2", tie_word_embeddings=False,
                   query_pre_attn_scalar=16,
                   sliding_window=WINDOW, attn_logit_softcapping=50.0,
                   final_logit_softcapping=30.0),
    "gemma3": dict(family="gemma3", tie_word_embeddings=False,
                   num_hidden_layers=3,
                   query_pre_attn_scalar=16, sliding_window=WINDOW,
                   sliding_window_pattern=3, rope_theta=1e6,
                   rope_local_base_freq=1e4,
                   rope_scaling={"rope_type": "linear", "factor": 8.0}),
    "mistral": dict(family="mistral", head_dim=8, sliding_window=WINDOW),
    "llama3_rope": dict(family="llama", rope_scaling={
        "rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
        "high_freq_factor": 4.0, "original_max_position_embeddings": 16}),
}


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def family(request, tmp_path_factory):
    """(name, (JAX params, JAX config), port state, port config)."""
    d = write_ckpt(tmp_path_factory.mktemp(request.param), seed=21,
                   **FAMILIES[request.param])
    return (request.param, *load_both(d))


def test_kv_cache_path_matches_the_full_forward(family):
    """A 10-token prefill into a 48-row cache, then 20 single-token steps
    (past the window): each row's logits within 1e-4 of the full forward
    over the 30 tokens."""
    _name, _j, state, cfg = family
    model = td.DecoderModel.from_state_dict(cfg, state)
    ids = np.asarray(PROMPT[:30])[None]
    full = port_logits(model, ids)[0]
    cache = [tuple(torch.zeros(1, 48, cfg.num_key_value_heads, cfg.head_dim)
                   for _ in range(2)) for _ in range(cfg.num_hidden_layers)]
    with torch.no_grad():
        got = [model(torch.from_numpy(ids[:, :10]), torch.arange(10)[None],
                     kv_cache=cache, cache_len=0)[0]]
        for p in range(10, 30):
            got.append(model(torch.from_numpy(ids[:, p:p + 1]),
                             torch.tensor([[p]]), kv_cache=cache,
                             cache_len=p)[0])
    np.testing.assert_allclose(torch.cat(got).numpy(), full, atol=ATOL, rtol=0)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_greedy_stream_matches_jax_engine(family, mode):
    """32 greedy tokens after the 40-token prompt identical to
    ``JaxDecoderLM``'s in the same mode and to the port's plain stream."""
    name, (jparams, jcfg), state, cfg = family
    streams = []
    for make in (
            lambda **kw: td.TorchDecoderLM(
                td.DecoderModel.from_state_dict(cfg, state), device="cpu",
                max_len=MAX_LEN, **kw),
            lambda **kw: jd.JaxDecoderLM(jparams, jcfg, max_len=MAX_LEN,
                                         **kw)):
        engine = make(**MODES[mode])
        if mode == "prefix_hit":
            stream(engine, DONOR, n=4)
        streams.append(stream(engine))
        if mode == "prefix_hit":
            assert engine.prefix_stats["hits"] == 1
    got, want = streams
    assert got == want
    plain = td.TorchDecoderLM(td.DecoderModel.from_state_dict(cfg, state),
                              device="cpu", max_len=MAX_LEN)
    assert got == stream(plain)
    assert len(set(got)) > 4, (name, got)       # not one repeated token
    assert len(PROMPT) + GREEDY > 3 * WINDOW
