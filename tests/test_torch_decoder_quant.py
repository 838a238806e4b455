"""The port's quantized local generation (``weight_quant`` with
``weight_bits`` 8 / 4 and ``kv_quant``; ``legalrag_tpu_torch/models/
quant.py`` and ``decoder.py``) against the JAX package's on the CPU,
float32, on tiny checkpoints saved by transformers
(``tests/test_torch_decoder.py``'s ``write_ckpt``):

- ``decoder_forward`` on quantized params (JAX's ``quantize_weights`` tree
  carried by ``decoder_params_from_jax``, and the port's own
  quantization), and with the int8 KV cache (a prefill, then single-token
  steps, against JAX's 4-tuple cache path), within ``ATOL``;
- greedy streams token-identical to ``JaxDecoderLM(weight_quant,
  weight_bits 8 / 4, kv_quant)``, each alone and combined, in every mode
  (one shot, chunked prefill, decode_chunk 1, a prefix-cache hit), on a
  dense Qwen2 and on Qwen2-MoE / Mixtral;
- ``TorchDecoderLM.from_pretrained`` and ``LLMClient`` (``local-jax``)
  with the three knobs: loaded and answering as JAX's client does, chat,
  stream and ``/rag/answer`` SSE.

``ATOL`` (1e-4, the unquantized decoder's): every integer product is
exact and every rescale is JAX's elementwise arithmetic, so the port's
logits differ from JAX's only by the float32 ulps the unquantized
decoder has (norms, attention, activations; 4e-6 here), unless an ulp
moves an activation across a rounding midpoint of its int8 grid, which
at these widths no input here does."""

import jax
import numpy as np
import pytest
import torch

from legalrag_tpu.models import decoder as jd
from legalrag_tpu_torch.convert import decoder_params_from_jax
from legalrag_tpu_torch.models import decoder as td
from legalrag_tpu_torch.models import quant as tq
from test_torch_decoder import (ATOL, DONOR, MAX_LEN, MODES, PROMPT,
                                VOCAB, jax_logits, load_both, port_logits,
                                stream, write_ckpt)

# (weight bits or 0, kv_quant): each knob alone and combined
QUANT = {"w8": (8, False), "w4": (4, False), "kv8": (0, True),
         "w8_kv8": (8, True), "w4_kv8": (4, True)}


def carried(jparams, bits: int):
    """JAX's params quantized at ``bits`` (as they are at 0), and the
    port's state carried from them."""
    if bits:
        jparams = jd.quantize_weights(jparams, bits=bits)
    return jparams, decoder_params_from_jax(jax.tree.map(np.asarray, jparams))


def jax_quant_logits(jparams, jcfg, ids):
    return jax_logits(jd.unpack_weights4(jparams), jcfg, ids)


@pytest.fixture(scope="module")
def qwen(tmp_path_factory):
    """The tiny Qwen2 checkpoint (``test_torch_decoder``'s): (directory,
    (JAX params, config), port state, port config)."""
    d = write_ckpt(tmp_path_factory.mktemp("qwen2_q"))
    return (d, *load_both(d))


@pytest.mark.parametrize("bits", [8, 4])
def test_forward_logits_match_jax(qwen, bits):
    """Float32 logits of a batch of 2 x 24 ids on quantized weights: JAX's
    quantized tree carried across, and the port's own quantization of its
    state, both within ATOL of JAX's ``decoder_forward``; the quantized
    model is near (not equal to) the full-precision one."""
    _d, (jparams, jcfg), state, cfg = qwen
    jq, state_q = carried(jparams, bits)
    ids = np.random.default_rng(1).integers(0, VOCAB, (2, 24))
    want = jax_quant_logits(jq, jcfg, ids)
    for st in (state_q, tq.quantize_weights(state, bits)):
        got = port_logits(td.DecoderModel.from_state_dict(cfg, st), ids)
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    dense = jax_logits(jparams, jcfg, ids)
    off = np.abs(want - dense).max()
    assert 1e-3 < off < (0.2 if bits == 8 else 1.0) * np.abs(dense).max()


def cache_rows(model, cfg, ids, kv_quant: bool, rows: int = 32):
    """The port's logits of ``ids`` [1, 16] by a 10-token prefill into a
    ``rows``-row cache, then 6 single-token steps."""
    shape = (1, rows, cfg.num_key_value_heads, cfg.head_dim)
    cache = [(torch.zeros(shape, dtype=torch.int8),
              torch.zeros(shape, dtype=torch.int8),
              torch.zeros(shape[:3] + (1,)), torch.zeros(shape[:3] + (1,)))
             if kv_quant else (torch.zeros(shape), torch.zeros(shape))
             for _ in range(cfg.num_hidden_layers)]
    with torch.no_grad():
        out = [model(torch.from_numpy(ids[:, :10]), torch.arange(10)[None],
                     kv_cache=cache, cache_len=0)[0]]
        for p in range(10, 16):
            out.append(model(torch.from_numpy(ids[:, p:p + 1]),
                             torch.tensor([[p]]), kv_cache=cache,
                             cache_len=p)[0])
    return torch.cat(out).numpy(), cache


def jax_cache_rows(jparams, jcfg, ids, kv_quant: bool, rows: int = 32):
    engine = jd.JaxDecoderLM(jparams, jcfg, max_len=rows, kv_quant=kv_quant)
    params = jd.unpack_weights4(jparams)
    cache = engine._empty_cache(1)
    pos = np.arange(16, dtype=np.int32)[None]
    logits, cache = jd.decoder_forward(params, jcfg, ids[:, :10], pos[:, :10],
                                       kv_cache=cache, cache_len=0)
    out = [np.asarray(logits)[0]]
    for p in range(10, 16):
        logits, cache = jd.decoder_forward(params, jcfg, ids[:, p:p + 1],
                                           pos[:, p:p + 1], kv_cache=cache,
                                           cache_len=p)
        out.append(np.asarray(logits)[0])
    return np.concatenate(out), cache


@pytest.mark.parametrize("quant", sorted(QUANT))
def test_kv_cache_path_matches_jax(qwen, quant):
    """A prefill and 6 decode steps through the cache (JAX's 4-tuple
    cache under ``kv_quant``): logits within ATOL of JAX's on the same
    path; the int8 cache rows JAX's, their scales within 1e-6 (the k/v
    rows they quantize differ by float32 ulps)."""
    bits, kv_quant = QUANT[quant]
    _d, (jparams, jcfg), _s, cfg = qwen
    jq, state = carried(jparams, bits)
    ids = np.asarray(PROMPT[:16])[None]
    got, cache = cache_rows(td.DecoderModel.from_state_dict(cfg, state), cfg,
                            ids, kv_quant)
    want, jcache = jax_cache_rows(jq, jcfg, ids, kv_quant)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    if kv_quant:
        for layer, jlayer in zip(cache, jcache):
            assert len(layer) == len(jlayer) == 4
            for a, b in zip(layer[:2], jlayer[:2]):
                assert np.array_equal(a[:, :16].numpy(),
                                      np.asarray(b)[:, :16])
            for a, b in zip(layer[2:], jlayer[2:]):
                np.testing.assert_allclose(a[:, :16].numpy(),
                                           np.asarray(b)[:, :16], rtol=1e-6)
        # the cache is not the full-precision one's
        plain, _c = cache_rows(td.DecoderModel.from_state_dict(cfg, state),
                               cfg, ids, False)
        assert np.abs(plain - got).max() > 1e-5


def port_engine(cfg, state, **kw):
    return td.TorchDecoderLM(td.DecoderModel.from_state_dict(cfg, state),
                             device="cpu", max_len=MAX_LEN, **kw)


def check_streams(jq, jcfg, state, cfg, mode, kv_quant):
    """The port's and JAX's greedy streams in ``mode``: equal, equal to the
    port's plain stream, and not one repeated token."""
    streams = []
    for make in (lambda **kw: port_engine(cfg, state, **kw),
                 lambda **kw: jd.JaxDecoderLM(jq, jcfg, max_len=MAX_LEN,
                                              **kw)):
        engine = make(kv_quant=kv_quant, **MODES[mode])
        if mode == "prefix_hit":
            stream(engine, DONOR, n=4)
        streams.append(stream(engine))
        if mode == "prefix_hit":
            assert engine.prefix_stats["hits"] == 1
            assert engine.prefix_stats["saved_tokens"] == 24
    got, want = streams
    assert got == want
    assert got == stream(port_engine(cfg, state, kv_quant=kv_quant))
    assert len(set(got)) > 4, got
    return got


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("quant", sorted(QUANT))
def test_greedy_stream_matches_jax_engine(qwen, quant, mode):
    """32 greedy tokens of PROMPT identical to ``JaxDecoderLM``'s with the
    same weight bits and KV cache, in the same mode."""
    bits, kv_quant = QUANT[quant]
    _d, (jparams, jcfg), _s, cfg = qwen
    jq, state = carried(jparams, bits)
    check_streams(jq, jcfg, state, cfg, mode, kv_quant)
