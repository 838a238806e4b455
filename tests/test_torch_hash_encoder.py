"""Port hash encoder vs the JAX one: the numpy threefry projection, sketches,
projected query/passage vectors and token vectors."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from legalrag_tpu.models.hash_encoder import HashEncoder as JaxEncoder
from legalrag_tpu_torch.convert import encoder_from_jax
from legalrag_tpu_torch.models.hash_encoder import HashEncoder
from legalrag_tpu_torch.models.prng import jax_normal, threefry2x32

TEXTS_EN = ["A security interest attaches to collateral when value has been given.",
            "§ 2-306. Output, Requirements and Exclusive Dealings.",
            "what does 2-306 cover", "", "the buyer in ordinary course of business"]
TEXTS_ZH = ["当事人订立合同，可以采取书面形式、口头形式或者其他形式。",
            "第一千二百六十条　本法自2021年1月1日起施行。", "侵权责任", ""]


def test_threefry_bits_are_jax_bits():
    bits = np.asarray(jax.random.bits(jax.random.PRNGKey(7), (4096,),
                                      jnp.uint32))
    idx = np.arange(4096, dtype=np.uint32)
    x0, x1 = threefry2x32(0, 7, np.zeros_like(idx), idx)
    np.testing.assert_array_equal(x0 ^ x1, bits)


@pytest.mark.parametrize("seed,shape", [(0, (37, 5)), (123456789, (3, 1000)),
                                        (2 ** 31 - 1, (64,))])
def test_jax_normal_small_shapes(seed, shape):
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape))
    np.testing.assert_allclose(jax_normal(seed, shape), want,
                               rtol=1e-5, atol=1e-6)


def test_default_projection_matches_jax_seed7():
    """The full 16384 x 768 draw of seed 7: raw normals at rtol 1e-5 /
    atol 1e-6 (erfinv residue <= 2.2e-5 abs, <= 5.8e-6 rel), the scaled
    projection at atol 1e-6."""
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(7), (16384, 768),
                                        dtype=jnp.float32))
    got = jax_normal(7, (16384, 768))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    jenc = JaxEncoder("en", device=jax.devices("cpu")[0])
    enc = HashEncoder("en", device="cpu")
    np.testing.assert_allclose(enc.projection().numpy(),
                               np.asarray(jenc._projection()), rtol=1e-5,
                               atol=1e-6)


@pytest.fixture(scope="module", params=["en", "zh"])
def pair(request):
    lang = request.param
    texts = TEXTS_EN if lang == "en" else TEXTS_ZH
    rng = np.random.default_rng(0)
    # small widths; the projection is carried over, as convert does
    jenc = JaxEncoder(lang, dim=64, sketch_dim=512, token_dim=32,
                      device=jax.devices("cpu")[0])
    jenc.fit_idf(texts)
    proj = (rng.standard_normal((512, 64)) / 8.0).astype(np.float32)
    jenc._proj = jnp.asarray(proj)
    enc = encoder_from_jax(jenc.state(), proj, "cpu")
    return lang, texts, jenc, enc


def test_fit_idf_matches(pair):
    lang, texts, jenc, _ = pair
    enc = HashEncoder(lang, dim=64, sketch_dim=512, token_dim=32, device="cpu")
    enc.fit_idf(texts)
    np.testing.assert_array_equal(enc.df, jenc.df)
    assert enc.n_docs == jenc.n_docs


@pytest.mark.parametrize("query", [False, True])
def test_sketches_bit_equal(pair, query):
    _, texts, jenc, enc = pair
    np.testing.assert_array_equal(enc._sketch(texts, query=query),
                                  jenc._sketch(texts, query=query))


def test_encode_queries_and_passages(pair):
    _, texts, jenc, enc = pair
    np.testing.assert_allclose(enc.encode_queries(texts),
                               jenc.encode_queries(texts), atol=1e-6)
    np.testing.assert_allclose(enc.encode_passages(texts),
                               jenc.encode_passages(texts), atol=1e-6)


@pytest.mark.parametrize("query", [False, True])
def test_encode_tokens_equal(pair, query):
    _, texts, jenc, enc = pair
    t1, m1 = jenc.encode_tokens(texts, 16, query=query)
    t2, m2 = enc.encode_tokens(texts, 16, query=query)
    np.testing.assert_array_equal(t2, t1)
    np.testing.assert_array_equal(m2, m1)


def test_state_roundtrip(pair):
    _, texts, jenc, enc = pair
    back = HashEncoder.from_state(enc.state(), device="cpu")
    np.testing.assert_array_equal(back.df, jenc.df)
    assert "proj" not in enc.state()  # the carried default is not saved
    trained = np.ones((512, 64), np.float32)
    enc2 = HashEncoder.from_state(dict(enc.state(), proj=trained), device="cpu")
    np.testing.assert_array_equal(enc2.projection().numpy(), trained)
