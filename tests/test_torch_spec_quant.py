"""The port's speculative engine on quantized weights and cache
(``TorchSpecLookupDecoderLM`` with ``weight_quant`` 8 / 4 and ``kv_quant``)
vs the JAX package's ``SpecLookupDecoderLM`` and the port's plain engine
under the same knobs, on the CPU in float32 (JAX's quantized trees carried
across, ``tests/test_torch_decoder_quant.py``'s ``carried``). Greedy
streams must be token-identical to both."""

import pytest

from test_torch_decoder_quant import carried
from test_torch_spec_decode import (PROMPTS, jax_spec, plain, qwen,  # noqa: F401
                                    run, spec)
from test_torch_spec_draft import small  # noqa: F401


# (weight bits or 0, kv_quant, with a draft model)
QUANT = [(0, True, False), (8, False, True), (4, False, False),
         (4, True, True)]


@pytest.mark.parametrize("bits,kv_quant,drafted", QUANT)
def test_quantized_streams_match_plain_and_jax(qwen, small, bits, kv_quant,
                                               drafted):
    """int8 KV cache, int8 / int4 weights (JAX's quantized tree carried
    across; a draft model quantized as the target is): greedy streams
    with lookup, and in two cases with the draft model, equal the
    quantized plain engine's and JAX's."""
    (jparams, jcfg), _s, cfg = qwen
    jq, state_q = carried(jparams, bits)
    q = ((jq, jcfg), state_q, cfg)
    drafts = [None]
    if drafted:
        (djp, djc), _ds, dcfg = small
        djq, dstate_q = carried(djp, bits)
        drafts.append(((djq, djc), dstate_q, dcfg))
    ref = plain(q, decode_chunk=1, kv_quant=kv_quant)
    for draft, p in zip(drafts, PROMPTS):
        want = run(ref, p, 14)
        eng = spec(q, draft, spec_k=4, spec_steps=2, kv_quant=kv_quant)
        jeng = jax_spec(q, draft, spec_k=4, spec_steps=2, kv_quant=kv_quant)
        assert run(eng, p, 14) == want == run(jeng, p, 14), (draft, p)
