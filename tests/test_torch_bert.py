"""The port's BERT encoders against the JAX package's on tiny random-init
checkpoints (hidden 32, 2 layers, 2 heads, vocab 64, as
``tests/test_checkpoint_parity.py`` sizes them): the forward pass (BERT
and roberta positions, with padding), bit-identical random init, the query
views and the four bi-encoder methods (with and without a ColBERT
projection), the cross-encoder's three head types, the safetensors reader
and writer against the ``safetensors`` package, ``.bin`` checkpoints and
the offline HF cache layout.

Each checkpoint is written by the port's safetensors writer and read by
both packages: JAX through ``safetensors.numpy`` and
``transformers.AutoTokenizer``, the port through its own reader and
WordPiece tokenizer. Tolerances: hidden states and cross-encoder logits
within 1e-4, L2-normalized encoder outputs within 1e-5, random-init params
bit-equal, file contents equal."""

import json
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legalrag_tpu.models import bert as jbert
from legalrag_tpu_torch.convert import (
    bert_params_from_jax,
    cross_encoder_head_from_jax,
    linear_from_jax,
)
from legalrag_tpu_torch.models import bert, safetensors_io
from legalrag_tpu_torch.models.encoder import get_encoder
from legalrag_tpu_torch.tokenize.wordpiece import (
    TokenizerNotSupported,
    WordPieceTokenizer,
)

REPO = Path(__file__).resolve().parent.parent
VOCAB = (["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
         + "the contract buyer seller goods law article shall of a delivery "
           "payment what is risk loss under ucc sell ##s ##er café".split()
         + list("为这个法律问题生成表示以用于检索相关条文：合同当事人，。"))
TINY = dict(vocab_size=64, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=64,
            max_position_embeddings=48, type_vocab_size=2)
CONFIGS = {"bert": TINY,
           "roberta": dict(TINY, model_type="roberta", type_vocab_size=1,
                           max_position_embeddings=50)}
INSTRUCTION = "为这个法律问题生成表示："
TEXTS = ["what is risk of loss under the ucc",
         "the sellers shall tender delivery of goods",
         "payment of a contract", "",
         "当事人订立合同，为这个法律问题。",
         "Café law " + "contract " * 40]


def perturbed_state(kw, seed):
    """Port random-init trunk state with random biases and layer-norm
    weights (random init leaves them 0 and 1)."""
    cfg = bert.BertConfig(**kw)
    state = bert.random_init_bert_params(cfg, seed)
    rng = np.random.default_rng(seed + 100)
    for k, v in state.items():
        if k.endswith("bias") or "LayerNorm" in k:
            noise = rng.standard_normal(tuple(v.shape)).astype(np.float32)
            state[k] = v + torch.from_numpy(noise) * 0.1
    return cfg, state


def write_tokenizer(d: Path, do_lower_case: bool = True, vocab=VOCAB):
    from transformers import BertTokenizerFast

    d.mkdir(parents=True, exist_ok=True)
    (d / "vocab.txt").write_text("\n".join(vocab), encoding="utf-8")
    BertTokenizerFast(vocab_file=str(d / "vocab.txt"),
                      do_lower_case=do_lower_case).save_pretrained(d)


def write_checkpoint(d: Path, kind: str = "bert", seed: int = 0,
                     head: str = "", prefix: str = "") -> Path:
    """A checkpoint directory (``config.json``, ``model.safetensors`` by the
    port's writer, the tokenizer files) of the tiny config; ``head`` adds a
    cross-encoder head: "roberta" (classifier.dense + out_proj), "bert"
    (pooler.dense + classifier) or "bare" (classifier)."""
    kw = CONFIGS[kind]
    cfg, state = perturbed_state(kw, seed)
    if kind == "roberta":   # roberta checkpoints omit the one-row table
        del state[bert.TOKEN_TYPE]
    tensors = {prefix + k: v for k, v in state.items()}
    g = torch.Generator().manual_seed(seed)
    h = cfg.hidden_size
    if head == "roberta":
        tensors |= {"classifier.dense.weight": torch.randn(h, h, generator=g),
                    "classifier.dense.bias": torch.randn(h, generator=g),
                    "classifier.out_proj.weight": torch.randn(1, h, generator=g),
                    "classifier.out_proj.bias": torch.randn(1, generator=g)}
    elif head in ("bert", "bare"):
        if head == "bert":
            tensors |= {
                prefix + "pooler.dense.weight": torch.randn(h, h, generator=g),
                prefix + "pooler.dense.bias": torch.randn(h, generator=g)}
        tensors |= {"classifier.weight": torch.randn(1, h, generator=g),
                    "classifier.bias": torch.randn(1, generator=g)}
    d.mkdir(parents=True, exist_ok=True)
    safetensors_io.save_file(tensors, d / "model.safetensors")
    (d / "config.json").write_text(json.dumps(
        {"model_type": kw.get("model_type", "bert"), "pad_token_id": 0,
         "layer_norm_eps": 1e-12, **kw}), encoding="utf-8")
    write_tokenizer(d)
    return d


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return write_checkpoint(tmp_path_factory.mktemp("bert"), prefix="bert.")


def jax_tree(kw, seed):
    """A JAX param tree (numpy) with random biases and layer norms."""
    tree = jax.tree.map(np.asarray, jbert.random_init_bert_params(
        jbert.BertConfig(**kw), seed))
    rng = np.random.default_rng(seed + 7)

    def bump(path, a):
        name = jax.tree_util.keystr(path)
        if "bias" in name or "LayerNorm" in name:
            return a + rng.standard_normal(a.shape).astype(np.float32) * 0.1
        return a

    return jax.tree_util.tree_map_with_path(bump, tree)


# ------------------------------------------------------------ forward pass

@pytest.mark.parametrize("kind", list(CONFIGS))
def test_random_init_is_bit_identical(kind):
    kw = CONFIGS[kind]
    want = bert_params_from_jax(jax.tree.map(
        np.asarray, jbert.random_init_bert_params(jbert.BertConfig(**kw), 3)))
    got = bert.random_init_bert_params(bert.BertConfig(**kw), 3)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == torch.float32
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("kind", list(CONFIGS))
def test_forward_matches_jax(kind):
    """Hidden states [B, L, H] within 1e-4 on the same carried params, with
    a padding mask (and segment ids for BERT); the padded tail's ids do not
    reach the real positions."""
    kw = CONFIGS[kind]
    tree = jax_tree(kw, 1)
    model = bert.build_bert(bert.BertConfig(**kw), bert_params_from_jax(tree),
                            "cpu")
    rng = np.random.default_rng(0)
    ids = rng.integers(5, 64, size=(3, 12))
    mask = np.ones((3, 12), np.int64)
    mask[1, 7:] = 0
    mask[2, 3:] = 0
    ids[mask == 0] = 0
    types = np.zeros_like(ids)
    if kind == "bert":
        types[0, 6:] = 1
    want = np.asarray(jbert.bert_forward(
        tree, jbert.BertConfig(**kw), jnp.asarray(ids, jnp.int32),
        jnp.asarray(mask, jnp.int32), jnp.asarray(types, jnp.int32)))
    with torch.no_grad():
        got = model(torch.from_numpy(ids), torch.from_numpy(mask),
                    torch.from_numpy(types)).numpy()
    assert got.dtype == np.float32 and got.shape == (3, 12, 32)
    np.testing.assert_allclose(got, want, atol=1e-4)
    ids2 = ids.copy()
    ids2[mask == 0] = 9
    with torch.no_grad():
        got2 = model(torch.from_numpy(ids2), torch.from_numpy(mask),
                     torch.from_numpy(types)).numpy()
    if kind == "bert":   # roberta positions follow the pad ids themselves
        np.testing.assert_allclose(got2[mask == 1], got[mask == 1], atol=1e-5)


# ------------------------------------------------------------ encoders

@pytest.mark.parametrize("with_proj", [False, True])
def test_encoder_matches_jax(ckpt, with_proj):
    """The four encoder methods and the device query views within 1e-5
    after L2 norm; the masks equal. ``max_length`` is clamped to the
    usable positions (48) in both."""
    proj = None
    if with_proj:
        rng = np.random.default_rng(5)
        proj = {"kernel": rng.standard_normal((32, 16)).astype(np.float32),
                "bias": rng.standard_normal(16).astype(np.float32)}
    jenc = jbert.FlaxBertEncoder.from_pretrained(
        str(ckpt), instruction=INSTRUCTION, max_length=512, token_dim=16,
        token_proj=None if proj is None else jax.tree.map(jnp.asarray, proj))
    tenc = bert.TorchBertEncoder.from_pretrained(
        str(ckpt), instruction=INSTRUCTION, device="cpu", max_length=512,
        token_dim=16, token_proj=None if proj is None else linear_from_jax(proj))
    assert tenc.max_length == jenc.max_length == 48
    assert (tenc.dim, tenc.token_dim) == (jenc.dim, jenc.token_dim)
    for name in ("encode_passages", "encode_queries"):
        want, got = getattr(jenc, name)(TEXTS), getattr(tenc, name)(TEXTS)
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-5)
    assert not np.allclose(tenc.encode_queries(TEXTS),
                           tenc.encode_passages(TEXTS), atol=1e-3)
    wt, wm = jenc.encode_tokens(TEXTS, 24)
    gt, gm = tenc.encode_tokens(TEXTS, 24, query=True)
    np.testing.assert_array_equal(gm, wm)
    np.testing.assert_allclose(gt, wt, atol=1e-5)
    want = jenc.encode_query_bundle(TEXTS, 24)
    got = tenc.encode_query_bundle(TEXTS, 24)
    for w, g in zip(want, got):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=1e-5)
    qvec, q_tok, q_mask = tenc.query_views(tenc.query_inputs(TEXTS, 24, True))
    np.testing.assert_allclose(qvec.numpy(), want[0], atol=1e-5)
    np.testing.assert_allclose(q_tok.numpy(), want[1], atol=1e-5)
    assert q_mask.dtype == torch.bool and (q_mask.numpy() == want[2]).all()
    assert tenc.query_views(tenc.query_inputs(TEXTS, 24, False))[1:] == \
        (None, None)


def test_get_encoder_builds_the_configured_bert_encoder(ckpt, tmp_path):
    from legalrag_tpu.config import AppConfig as JaxConfig
    from legalrag_tpu.models.encoder import get_encoder as jax_get_encoder
    from legalrag_tpu_torch.config import AppConfig

    names = ("embedding_backend", "embedding_model_zh", "embedding_model_en",
             "query_instruction_zh", "query_instruction_en", "reranker_model")
    assert [getattr(AppConfig().retrieval, n) for n in names] == \
        [getattr(JaxConfig().retrieval, n) for n in names]
    en = write_checkpoint(tmp_path / "en", seed=4)
    cfg, jcfg = AppConfig(), JaxConfig()
    for c in (cfg, jcfg):
        c.retrieval.embedding_backend = "bert"
        c.retrieval.embedding_model_zh = str(ckpt)
        c.retrieval.embedding_model_en = str(en)
        c.engine.late_dim = 16
    for lang in ("zh", "en"):
        tenc = get_encoder(cfg, lang, "cpu")
        jenc = jax_get_encoder(jcfg, lang)
        assert isinstance(tenc, bert.TorchBertEncoder)
        assert tenc.instruction == jenc.instruction
        assert tenc.token_dim == 16 and tenc.device.type == "cpu"
        np.testing.assert_allclose(tenc.encode_queries(TEXTS[:3]),
                                   jenc.encode_queries(TEXTS[:3]), atol=1e-5)


@pytest.mark.parametrize("head", ["roberta", "bert", "bare"])
def test_cross_encoder_matches_jax(tmp_path, head):
    """``score_pairs`` logits within 1e-4 of ``FlaxBertCrossEncoder``'s, the
    head found by name in each package; pairs truncated longest-first. The
    roberta checkpoint has no segment table (one zero row; pair segment ids
    zeroed) and roberta positions."""
    kind = "roberta" if head == "roberta" else "bert"
    d = write_checkpoint(tmp_path, kind=kind, seed=2, head=head,
                         prefix="roberta." if kind == "roberta" else "bert.")
    jce = jbert.FlaxBertCrossEncoder.from_pretrained(str(d))
    tce = bert.TorchBertCrossEncoder.from_pretrained(str(d), device="cpu")
    assert (tce.dense is None) == (jce.head.get("dense") is None) == \
        (head == "bare")
    assert tce.model.type_rows == (1 if kind == "roberta" else 2)
    pairs = [(TEXTS[0], t) for t in TEXTS] + [(TEXTS[5], TEXTS[1])]
    for max_length in (32, 512):
        want = jce.score_pairs(pairs, max_length=max_length)
        got = tce.score_pairs(pairs, max_length=max_length)
        assert len(got) == len(pairs)
        np.testing.assert_allclose(got, want, atol=1e-4)


def test_cross_encoder_head_from_jax_drives_the_same_logits(tmp_path):
    d = write_checkpoint(tmp_path, seed=6, head="bert", prefix="bert.")
    jce = jbert.FlaxBertCrossEncoder.from_pretrained(str(d))
    head = cross_encoder_head_from_jax(jax.tree.map(np.asarray, jce.head))
    trunk = bert_params_from_jax(jax.tree.map(np.asarray, jce.params))
    tce = bert.TorchBertCrossEncoder(
        bert.build_bert(bert.BertConfig(**CONFIGS["bert"]), trunk, "cpu"),
        head, WordPieceTokenizer.from_dir(d))
    pairs = [(TEXTS[0], TEXTS[1]), (TEXTS[4], TEXTS[2])]
    np.testing.assert_allclose(tce.score_pairs(pairs, 32),
                               jce.score_pairs(pairs, 32), atol=1e-4)


def test_checkpoint_without_vocab_is_not_supported(tmp_path):
    """An XLM-R-style directory (no vocab.txt) raises a clear error."""
    d = write_checkpoint(tmp_path, seed=1, head="bare", prefix="bert.")
    (d / "vocab.txt").unlink()
    with pytest.raises(TokenizerNotSupported, match="not supported by the port"):
        bert.TorchBertCrossEncoder.from_pretrained(str(d), device="cpu")
    with pytest.raises(TokenizerNotSupported):
        bert.TorchBertEncoder.from_pretrained(str(d), device="cpu")


def test_bert_entry_points_default_to_cuda(ckpt, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bert.TorchBertEncoder.from_pretrained(str(ckpt))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bert.build_bert(bert.BertConfig(**TINY),
                        bert.random_init_bert_params(bert.BertConfig(**TINY)))


# ------------------------------------------------------------ weights

@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16, torch.int64])
def test_safetensors_reader_and_writer_match_safetensors(tmp_path, dtype):
    """The port's reader returns what ``safetensors.numpy.load_file`` (bf16:
    ``safetensors.torch``, numpy has no bf16) returns for a file the package
    wrote; the package reads the port writer's file back equal."""
    import safetensors.numpy
    import safetensors.torch

    g = torch.Generator().manual_seed(0)
    tensors = {"a.weight": (torch.randn(7, 5, generator=g) * 100).to(dtype),
               "b": (torch.randn(3, generator=g) * 100).to(dtype),
               "scalar": torch.tensor(3, dtype=dtype),
               "empty": torch.zeros((0, 4), dtype=dtype),
               "f32": torch.randn(2, 3, generator=g)}
    theirs = tmp_path / "theirs.safetensors"
    mine = tmp_path / "mine.safetensors"
    safetensors.torch.save_file(tensors, str(theirs), metadata={"k": "v"})
    safetensors_io.save_file(tensors, mine, metadata={"k": "v"})
    for path in (theirs, mine):
        got = safetensors_io.load_file(path)
        if dtype == torch.bfloat16:
            want = safetensors.torch.load_file(str(path))
        else:
            want = {k: torch.from_numpy(v)
                    for k, v in safetensors.numpy.load_file(str(path)).items()}
        assert set(got) == set(want) == set(tensors)
        for k in want:
            assert got[k].dtype == want[k].dtype == tensors[k].dtype
            assert got[k].shape == want[k].shape
            assert torch.equal(got[k], want[k]), k
    with open(mine, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        assert n % 8 == 0
        assert json.loads(f.read(n))["__metadata__"] == {"k": "v"}


def test_bin_checkpoint_loads_as_in_jax(ckpt, tmp_path):
    """``pytorch_model.bin`` (no safetensors file): the same trunk as JAX's
    ``load_hf_bert_params``, bf16 weights widened to float32."""
    state = safetensors_io.load_file(ckpt / "model.safetensors")
    for dtype in (torch.float32, torch.bfloat16):
        d = tmp_path / str(dtype)
        d.mkdir()
        torch.save({k: v.to(dtype) for k, v in state.items()},
                   d / "pytorch_model.bin")
        (d / "config.json").write_text((ckpt / "config.json").read_text())
        got, cfg = bert.load_hf_bert_params(d)
        want = bert_params_from_jax(jax.tree.map(
            np.asarray, jbert.load_hf_bert_params(d)[0]))
        model = bert.build_bert(cfg, got, "cpu")
        for k, v in model.state_dict().items():
            assert torch.equal(v, want[k]), k
    with pytest.raises(FileNotFoundError):
        bert.load_hf_bert_params(tmp_path / "nothing")


def test_resolve_model_dir_reads_the_offline_hf_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("HOME", str(tmp_path))
    snaps = (tmp_path / ".cache" / "huggingface" / "hub"
             / "models--BAAI--bge-base-zh-v1.5" / "snapshots")
    (snaps / "a1").mkdir(parents=True)
    (snaps / "b2").mkdir()
    assert bert.resolve_model_dir("BAAI/bge-base-zh-v1.5") == snaps / "b2" == \
        jbert.resolve_model_dir("BAAI/bge-base-zh-v1.5")
    assert bert.resolve_model_dir(str(tmp_path)) == tmp_path
    with pytest.raises(FileNotFoundError, match="not found locally"):
        bert.resolve_model_dir("BAAI/bge-reranker-v2-m3")


def test_port_imports_no_tokenizer_or_weights_package():
    """The port and ``chip_smoke.py`` import none of ``transformers``,
    ``tokenizers``, ``safetensors`` (or JAX): the card's machine has none
    of them."""
    code = textwrap.dedent(f"""
        import sys
        for name in ("jax", "transformers", "tokenizers", "safetensors"):
            sys.modules[name] = None  # any import of them now fails
        sys.path.insert(0, {str(REPO)!r})
        import importlib, pkgutil
        import legalrag_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(
            legalrag_tpu_torch.__path__, "legalrag_tpu_torch.")]
        for name in names + ["chip_smoke"]:
            importlib.import_module(name)
        assert "legalrag_tpu_torch.models.bert" in sys.modules
        assert "legalrag_tpu_torch.tokenize.wordpiece" in sys.modules
        print("ok", len(names))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=str(REPO))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.startswith("ok")
