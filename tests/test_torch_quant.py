"""The port's decoder quantization (``legalrag_tpu_torch/models/quant.py``
and the quantized ``MoEBlock``) against the JAX package's
(``legalrag_tpu/models/decoder.py``) on the CPU, on inputs drawn by numpy
from a seed:

- every quantizer exact (ints and scales bit for bit): ``_quant_acts``
  with rows exactly at .5 steps and all-zero rows (the 1e-8 floor),
  ``_quant_channel``, ``_quant_stack``, ``_quant_group4`` and
  ``_quant_stack4`` (I divisible by 64, I = 96 whose groups are whole
  columns, an odd I raising in both), the nibble carrier both ways,
  ``quantize_kv`` / ``dequantize_kv``;
- ``quantize_weights(bits 8 / 4)`` of a checkpoint's state equal, leaf for
  leaf, to JAX's tree carried across by ``decoder_params_from_jax`` (a
  dense Qwen2 and a Qwen2-MoE with its shared expert);
- ``_qdot2`` / ``_qdot4``: the integer accumulators equal to int64 numpy
  products, the outputs within 1e-6 (relative to the output's range) of
  JAX's;
- ``_moe_block``'s int8 and int4 branches (Mixtral, Qwen2-MoE with its
  shared expert, a tied router choosing ``lax.top_k``'s experts) within
  1e-5 of JAX's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legalrag_tpu.models import decoder as jd
from legalrag_tpu_torch.convert import decoder_params_from_jax
from legalrag_tpu_torch.models import decoder as td
from legalrag_tpu_torch.models import quant as tq
from test_torch_decoder import load_both, write_ckpt
from test_torch_decoder_moe import BLOCK_ATOL, block_inputs

QDOT_RTOL = 1e-6


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def same(got: torch.Tensor, want) -> bool:
    want = np.asarray(want)
    return got.dtype == t(want).dtype and np.array_equal(got.numpy(), want)


def draw(seed: int, *shape, scale: float = 1.0) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


# ------------------------------------------------------------ quantizers

def acts_rows() -> np.ndarray:
    """Rows whose values divided by the row scale land exactly on .5
    steps (amax 127: the scale is 1.0), an all-zero row, a row of one
    value, and random rows."""
    half = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5],
                    np.float32)
    scaled = half * np.float32(0.25)           # the scale 0.25: still .5s
    return np.stack([half, scaled, np.zeros(8, np.float32),
                     np.full(8, -3.0, np.float32), *draw(1, 4, 8)])


@pytest.mark.parametrize("name", ["quant_acts", "quantize_kv"])
def test_activation_and_kv_quantizers_are_exact(name):
    x = acts_rows().reshape(2, 4, 8)
    jfn = jd._quant_acts if name == "quant_acts" else jd.quantize_kv
    (wq, ws), (gq, gs) = jfn(jnp.asarray(x)), getattr(tq, name)(t(x))
    assert same(gq, wq) and same(gs, ws)
    rows = gq.reshape(-1, 8).numpy()
    assert list(rows[0]) == [127, 0, 2, 2, 0, -2, -2, 126]   # half to even
    assert not rows[2].any() and gs.reshape(-1)[2] == np.float32(1e-8) \
        / np.float32(127)
    back = jd.dequantize_kv(wq, ws, jnp.float32)
    assert same(tq.dequantize_kv(gq, gs, torch.float32), back)


@pytest.mark.parametrize("shape", [(128, 24), (96, 40), (64, 1)])
def test_weight_quantizers_are_exact(shape):
    """Per channel int8 and grouped int4 (groups of 64; at I = 96 the
    whole column is one group); a zero column takes the 1e-8 floor."""
    w = draw(2, *shape)
    w[:, 0] = 0.0
    for jfn, tfn in ((jd._quant_channel, tq.quant_channel),
                     (lambda a: jd._quant_group4(a, 64), tq.quant_group4)):
        (wq, ws), (gq, gs) = jfn(jnp.asarray(w)), tfn(t(w))
        assert same(gq, wq) and same(gs, ws)
    assert tq.quant_group4(t(w))[1].shape[0] == (shape[0] // 64
                                                 if shape[0] % 64 == 0 else 1)


@pytest.mark.parametrize("shape", [(3, 128, 24), (2, 96, 16)])
def test_stack_quantizers_are_exact(shape):
    w = draw(3, *shape)
    for jfn, tfn in ((jd._quant_stack, tq.quant_stack),
                     (lambda a: jd._quant_stack4(a, 64), tq.quant_stack4)):
        (wq, ws), (gq, gs) = jfn(jnp.asarray(w)), tfn(t(w))
        assert same(gq, wq) and same(gs, ws)


def test_nibble_carrier_both_ways():
    q = np.random.default_rng(4).integers(-8, 8, (3, 10, 6)).astype(np.int32)
    packed = jd._pack_nibbles(jnp.asarray(q))
    got = tq.pack_nibbles(t(q))
    assert same(got, packed)
    assert np.array_equal(tq.unpack_nibbles(got).numpy(), q)
    assert np.array_equal(np.asarray(jd._unpack_nibbles4(packed)).astype(
        np.int32), q)


def test_odd_contraction_dim_raises_in_both():
    w = draw(5, 7, 4)
    with pytest.raises(ValueError, match="even contraction dim"):
        jd._quant_group4(jnp.asarray(w), 64)
    with pytest.raises(ValueError, match="even contraction dim"):
        tq.quant_group4(t(w))


# --------------------------------------------------------- whole states

@pytest.fixture(scope="module", params=["qwen2", "qwen2_moe"])
def checkpoint(request, tmp_path_factory):
    """((JAX params, config), port state, port config) of a dense Qwen2 or
    a Qwen2-MoE with its shared expert (96-wide FFNs: whole-column
    groups)."""
    over = {} if request.param == "qwen2" else dict(
        family="qwen2_moe", num_experts=4, moe_intermediate_size=96,
        shared_expert_intermediate_size=40)
    d = write_ckpt(tmp_path_factory.mktemp(request.param), seed=31,
                   hidden_size=64, intermediate_size=96, **over)
    return load_both(d)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_weights_matches_jax_leaf_for_leaf(checkpoint, bits):
    """The port's ``quantize_weights`` of its own state equals JAX's tree
    carried across by ``decoder_params_from_jax``: the same names, dtypes
    and bits, the tied head quantized beside the embedding."""
    (jparams, _jcfg), state, cfg = checkpoint
    want = decoder_params_from_jax(jax.tree.map(
        np.asarray, jd.quantize_weights(jparams, bits=bits)))
    got = tq.quantize_weights(state, bits)
    assert set(got) - set(want) == set()
    for k, v in got.items():
        assert v.dtype == want[k].dtype and torch.equal(v, want[k]), k
    for k in set(want) - set(got):     # JAX's zero biases of Mixtral only
        assert k.endswith("_proj.bias") and not want[k].any(), k
    suffix = "_q4p" if bits == 4 else "_q"
    assert f"lm_head.weight{suffix}" in got and "embed_tokens.weight" in got
    assert tq.state_bits(got) == bits
    model = td.DecoderModel.from_state_dict(cfg, got)
    assert isinstance(model.lm_head, tq.QLinear)
    plain = [n for n, m in model.named_modules() if type(m) is torch.nn.Linear]
    assert all(n.endswith("shared_expert_gate") for n in plain), plain


def test_other_bits_raise_in_both(checkpoint):
    (jparams, _jcfg), state, _cfg = checkpoint
    with pytest.raises(ValueError, match="weight_bits must be 8 or 4"):
        jd.quantize_weights(jparams, bits=3)
    with pytest.raises(ValueError, match="weight_bits must be 8 or 4"):
        tq.quantize_weights(state, 3)


# ------------------------------------------------------------- products

@pytest.mark.parametrize("shape", [(128, 48), (96, 40)])
def test_qdot_int8_exact_integers_and_rescale(shape):
    i, o = shape
    x, w = draw(6, 3, 5, i), draw(7, i, o)
    wq, ws = jd._quant_channel(jnp.asarray(w))
    xq, _xs = tq.quant_acts(t(x))
    acc = tq.int_mm(xq.reshape(-1, i), t(np.asarray(wq).T))
    exact = xq.reshape(-1, i).numpy().astype(np.int64) @ np.asarray(
        wq).astype(np.int64)
    assert acc.dtype == torch.int32 and np.array_equal(acc.numpy(), exact)
    want = np.asarray(jd._qdot2(jnp.asarray(x), wq, ws))
    got = tq.qdot8(t(x), t(np.asarray(wq).T), t(ws)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=QDOT_RTOL * np.abs(want).max())


@pytest.mark.parametrize("shape", [(128, 48), (96, 40)])
def test_qdot_int4_exact_group_integers_and_rescale(shape):
    """The group axis stays in the accumulator (exact integers in
    float32), equal to numpy's int64 sums group by group; then the float32
    rescale and group sum."""
    i, o = shape
    x, w = draw(8, 2, 7, i), draw(9, i, o)
    packed, scale = jd._quant_group4(jnp.asarray(w), 64)
    n_g = scale.shape[0]
    g = i // n_g
    op = tq.int4_operand(t(packed), g)
    xq, _xs = tq.quant_acts(t(x))
    a = xq.reshape(-1, n_g, g).transpose(0, 1)
    acc = tq.group_int_mm(a, op)
    wi = np.asarray(jd._unpack_nibbles4(packed)).astype(np.int64).reshape(
        n_g, g, o)
    exact = np.einsum("gmi,gio->gmo", a.numpy().astype(np.int64), wi)
    assert acc.dtype == torch.float32 and np.array_equal(
        acc.numpy().astype(np.int64), exact)
    want = np.asarray(jd._qdot2(jnp.asarray(x), jd._unpack_nibbles4(packed),
                                scale))
    got = tq.qdot4(t(x), op, t(scale)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=QDOT_RTOL * np.abs(want).max())


def test_qlinear_adds_its_bias_after_the_cast():
    """A bf16 projection: the product rounded to bf16, then the bias added
    in bf16 (JAX's ``_proj(y, node) + bias``)."""
    w, b = draw(10, 64, 16), draw(11, 16)
    x = torch.from_numpy(draw(12, 3, 64)).to(torch.bfloat16)
    lin = tq.QLinear(64, 16, True, 8)
    lin.load_state_dict({**tq.linear_leaves(t(w.T), 8),
                         "bias": t(b).to(torch.bfloat16)}, assign=True)
    wq, ws = jd._quant_channel(jnp.asarray(w))
    want = jd._qdot(jnp.asarray(x.float().numpy(), jnp.bfloat16),
                    {"kernel_q": wq, "kernel_scale": ws}
                    ) + jnp.asarray(b, jnp.bfloat16)
    got = lin(x)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.detach().float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


# ------------------------------------------------------------ the block

@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("case", ["mixtral", "qwen2_moe_shared", "gelu_tanh",
                                  "tied_router"])
def test_quantized_moe_block_matches_jax(case, bits):
    """``MoEBlock`` holding JAX's quantized stacks (carried by
    ``decoder_params_from_jax``) within 1e-5 of ``_moe_block``'s int8 or
    int4 branch, the shared expert quantized, a tied router choosing
    ``lax.top_k``'s experts."""
    moe, block, jcfg, y = block_inputs(case)
    h = y.shape[-1]
    tree = {"embed": np.zeros((8, h), np.float32),
            "final_norm": np.zeros(h, np.float32),
            "lm_head": np.zeros((h, 8), np.float32),
            "layers": [{"input_norm": 0, "post_norm": 0, "moe": moe,
                        **{x: {"kernel": np.zeros((h, h), np.float32),
                               "bias": np.zeros(h, np.float32)}
                           for x in "qkvo"}}]}
    qtree = jd.quantize_weights(jax.tree.map(jnp.asarray, tree), bits=bits)
    qmoe = qtree["layers"][0]["moe"]
    want = np.asarray(jd._moe_block(jnp.asarray(y), jd.unpack_weights4(qmoe),
                                    jcfg))
    state = decoder_params_from_jax(jax.tree.map(np.asarray, qtree))
    pre = "layers.0.mlp."
    qblock = td.MoEBlock(block.cfg, bits)
    qblock.load_state_dict({k[len(pre):]: v for k, v in state.items()
                            if k.startswith(pre)})
    with torch.no_grad():
        got = qblock(t(y)).numpy()
    np.testing.assert_allclose(got, want, atol=BLOCK_ATOL, rtol=0)
    assert np.abs(want).max() > 0.5
    if "shared" in moe:
        assert isinstance(qblock.shared_expert.down_proj, tq.QLinear)
    # the quantized block is near the full-precision one: int8 closer
    with torch.no_grad():
        dense = block(t(y)).numpy()
    assert np.abs(got - dense).max() < (0.1 if bits == 8 else 0.6) \
        * np.abs(dense).max()


def test_held_operands_compute_the_same(checkpoint):
    """``hold_unpacked`` keeps each int4 operand once made; the logits are
    the same bits."""
    _j, state, cfg = checkpoint
    model = td.DecoderModel.from_state_dict(cfg, tq.quantize_weights(state, 4))
    ids = torch.from_numpy(np.random.default_rng(13).integers(
        0, cfg.vocab_size, (1, 12)))
    pos = torch.arange(12)[None]
    with torch.no_grad():
        want = model(ids, pos)
        tq.hold_unpacked(model)
        first, again = model(ids, pos), model(ids, pos)
    assert torch.equal(first, want) and torch.equal(again, want)
    assert model.lm_head._held and "weight_q4p" in model.lm_head._held
