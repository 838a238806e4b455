"""Port byte-level BPE tokenizer (``legalrag_tpu_torch/tokenize/bpe.py``)
vs ``transformers.AutoTokenizer`` on a Qwen2-layout ``tokenizer.json``.

The tokenizer is built here with the ``tokenizers`` library as Qwen2 and
Qwen2.5 ship theirs: BPE trained on the repo's zh and en statutes, an NFC
normalizer, Qwen2's ``Split`` pattern then ``ByteLevel``, a ByteLevel
decoder and post-processor, and the ChatML special tokens; beside it a
``tokenizer_config.json`` with Qwen2.5's ChatML ``chat_template`` and
``eos_token`` ``<|im_end|>``. ``AutoTokenizer`` loads it (as the JAX
decoder engine does) and the port reads the same files. Ids, decoded text
and rendered chat templates must be exactly equal."""

import json
import unicodedata
from pathlib import Path

import numpy as np
import pytest

from legalrag_tpu_torch.config import AppConfig
from legalrag_tpu_torch.pipeline.rag_pipeline import RagPipeline
from legalrag_tpu_torch.schemas import RetrievalHit
from legalrag_tpu_torch.tokenize.bpe import BPETokenizer, split_words
from legalrag_tpu_torch.tokenize.wordpiece import TokenizerNotSupported

REPO = Path(__file__).resolve().parent.parent
BPE_VOCAB = 4000
SPECIALS = ("<|endoftext|>", "<|im_start|>", "<|im_end|>")
# Qwen2.5-Instruct's chat template (tokenizer_config.json)
CHATML = (
    "{%- if tools %}\n    {{- '<|im_start|>system\\n' }}\n"
    "    {%- if messages[0]['role'] == 'system' %}\n"
    "        {{- messages[0]['content'] }}\n    {%- else %}\n"
    "        {{- 'You are Qwen, created by Alibaba Cloud. You are a helpful "
    "assistant.' }}\n    {%- endif %}\n"
    "    {{- \"\\n\\n# Tools\\n\\nYou may call one or more functions to "
    "assist with the user query.\\n\\nYou are provided with function "
    "signatures within <tools></tools> XML tags:\\n<tools>\" }}\n"
    "    {%- for tool in tools %}\n        {{- \"\\n\" }}\n"
    "        {{- tool | tojson }}\n    {%- endfor %}\n"
    "    {{- \"\\n</tools>\\n\\nFor each function call, return a json object "
    "with function name and arguments within <tool_call></tool_call> XML "
    "tags:\\n<tool_call>\\n{\\\"name\\\": <function-name>, \\\"arguments\\\": "
    "<args-json-object>}\\n</tool_call><|im_end|>\\n\" }}\n{%- else %}\n"
    "    {%- if messages[0]['role'] == 'system' %}\n"
    "        {{- '<|im_start|>system\\n' + messages[0]['content'] + "
    "'<|im_end|>\\n' }}\n    {%- else %}\n"
    "        {{- '<|im_start|>system\\nYou are Qwen, created by Alibaba "
    "Cloud. You are a helpful assistant.<|im_end|>\\n' }}\n"
    "    {%- endif %}\n{%- endif %}\n{%- for message in messages %}\n"
    "    {%- if (message.role == \"user\") or (message.role == \"system\" and "
    "not loop.first) or (message.role == \"assistant\" and not "
    "message.tool_calls) %}\n"
    "        {{- '<|im_start|>' + message.role + '\\n' + message.content + "
    "'<|im_end|>' + '\\n' }}\n"
    "    {%- elif message.role == \"assistant\" %}\n"
    "        {{- '<|im_start|>' + message.role }}\n"
    "        {%- if message.content %}\n"
    "            {{- '\\n' + message.content }}\n        {%- endif %}\n"
    "        {%- for tool_call in message.tool_calls %}\n"
    "            {%- if tool_call.function is defined %}\n"
    "                {%- set tool_call = tool_call.function %}\n"
    "            {%- endif %}\n"
    "            {{- '\\n<tool_call>\\n{\"name\": \"' }}\n"
    "            {{- tool_call.name }}\n            {{- '\", \"arguments\": ' }}\n"
    "            {{- tool_call.arguments | tojson }}\n"
    "            {{- '}\\n</tool_call>' }}\n        {%- endfor %}\n"
    "        {{- '<|im_end|>\\n' }}\n    {%- elif message.role == \"tool\" %}\n"
    "        {%- if (loop.index0 == 0) or (messages[loop.index0 - 1].role != "
    "\"tool\") %}\n            {{- '<|im_start|>user' }}\n        {%- endif %}\n"
    "        {{- '\\n<tool_response>\\n' }}\n        {{- message.content }}\n"
    "        {{- '\\n</tool_response>' }}\n"
    "        {%- if loop.last or (messages[loop.index0 + 1].role != \"tool\") %}\n"
    "            {{- '<|im_end|>\\n' }}\n        {%- endif %}\n    {%- endif %}\n"
    "{%- endfor %}\n{%- if add_generation_prompt %}\n"
    "    {{- '<|im_start|>assistant\\n' }}\n{%- endif %}\n")


def corpus_lines():
    lines = []
    for p in sorted((REPO / "data" / "raw").rglob("*.txt")):
        lines += p.read_text(encoding="utf-8", errors="replace").splitlines()
    return [l for l in lines if l.strip()]


def write_qwen2_tokenizer(d: Path, vocab: int = BPE_VOCAB) -> Path:
    """``tokenizer.json`` and ``tokenizer_config.json`` in Qwen2.5's layout
    (module docstring), the BPE trained on the statutes."""
    from tokenizers import (AddedToken, Regex, Tokenizer, decoders, models,
                            normalizers, pre_tokenizers, processors,
                            trainers)

    from legalrag_tpu_torch.tokenize.bpe import QWEN2_PATTERN

    tok = Tokenizer(models.BPE())
    tok.normalizer = normalizers.NFC()
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(QWEN2_PATTERN), behavior="isolated",
                             invert=False),
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False,
                                 trim_offsets=False)])
    tok.decoder = decoders.ByteLevel(add_prefix_space=False,
                                     trim_offsets=False, use_regex=False)
    tok.post_processor = processors.ByteLevel(
        add_prefix_space=False, trim_offsets=False, use_regex=False)
    tok.train_from_iterator(corpus_lines(), trainers.BpeTrainer(
        vocab_size=vocab, show_progress=False, special_tokens=[],
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet()))
    tok.add_special_tokens([AddedToken(s, special=True, normalized=False)
                            for s in SPECIALS])
    d.mkdir(parents=True, exist_ok=True)
    tok.save(str(d / "tokenizer.json"))
    (d / "tokenizer_config.json").write_text(json.dumps({
        "tokenizer_class": "Qwen2Tokenizer", "chat_template": CHATML,
        "eos_token": "<|im_end|>", "pad_token": "<|endoftext|>",
        "bos_token": None, "unk_token": None,
        "additional_special_tokens": ["<|im_start|>", "<|im_end|>"],
        "clean_up_tokenization_spaces": False, "errors": "replace",
        "model_max_length": 131072, "split_special_tokens": False}),
        encoding="utf-8")
    return d


@pytest.fixture(scope="module")
def toks(tmp_path_factory):
    """(transformers' tokenizer, the port's) over one directory."""
    from transformers import AutoTokenizer

    d = write_qwen2_tokenizer(tmp_path_factory.mktemp("qwen2_tok"))
    return AutoTokenizer.from_pretrained(str(d)), BPETokenizer.from_dir(d)


def rag_messages(question: str, chunks):
    """The pipeline's own messages for ``question`` over ``chunks``."""
    hits = [RetrievalHit(chunk=c, score=1.0 / (i + 1), rank=i + 1)
            for i, c in enumerate(chunks)]
    pipe = RagPipeline(AppConfig(), llm=object(), retriever=object())
    return pipe._build_messages(question, hits, None)


def test_ids_of_every_corpus_line_match(toks):
    ref, mine = toks
    lines = corpus_lines()
    want = ref(lines)["input_ids"]
    assert [mine(l)["input_ids"] for l in lines] == want
    assert sum(map(len, want)) < sum(map(len, lines))   # merges apply


CASES = [
    "1234567890 3.14159 100,000 第1260条",
    "a  b   c\t\td \n\n\n e\r\n\r\nf  \n  g   ", "   leading", "trailing   ",
    "\n", " ", "", "\t", "x\x0b\x0cy\x85z\xa0w\u3000v\u2028u",
    "it's I'M we'll THEY'RE you've he'd 'ſ 'LL 'Re rock'n'roll",
    "emoji 😀👍🏽 👨‍👩‍👧 astral 𠀀𠀁𪚥 𝔘𝔫𝔦𝔠𝔬𝔡𝔢",
    "<|im_start|>user\n合同<|im_end|><|endoftext|>text<|im_start|><|im_",
    "before<|im_end|>after <|endoftext|> end",
    "e\u0301 A\u030a 가\u1100\u1161 ﬁ Ⅻ ½ ² ٣",
    "民法典第五百六十三条：有下列情形之一的，当事人可以解除合同。",
    "§ 2-207. Additional Terms in Acceptance or Confirmation.",
    "混合 mixed 文本 text，標點!?…—\"quotes\" (paren) [br] {cb}",
    "\x00\x01\x1f\x7f control", "ÀÁÂ ÃÄÅ Ææ ŒœŠš",
]


@pytest.mark.parametrize("text", CASES)
def test_ids_match_on_edge_cases(toks, text):
    ref, mine = toks
    assert mine(text)["input_ids"] == ref(text)["input_ids"]


def test_random_strings_match(toks):
    """2,000 seeded strings from a pool of letters, digits, spaces,
    newlines, punctuation, CJK, astral characters, contractions and
    special tokens."""
    ref, mine = toks
    pool = ["a", "Z", "é", "e\u0301", "ſ", "'", "s", "t", "re", "LL", "1",
            "٣", "Ⅻ", "²", " ", "  ", "\t", "\n", "\r\n", "\r", "\x0b", "\x85",
            "\xa0", "\u3000", "!", "?", "，", "。", "合", "同", "中华",
            "😀", "\U00020000", "\x00", "-", "<", "|", "<|im_start|>",
            "<|im_end|>", "<|endoftext|>", "<|im_", "x", "ab", "\ufffd",
            "\u200b", "ǅ", "'s", "'T", "'ve", "'d", "1234", "3.14"]
    rng = np.random.default_rng(0)
    texts = ["".join(pool[i] for i in rng.integers(0, len(pool),
                                                   rng.integers(1, 16)))
             for _ in range(2000)]
    assert [mine(t)["input_ids"] for t in texts] == ref(texts)["input_ids"]


def test_split_matches_the_tokenizers_pattern():
    from tokenizers import Regex, pre_tokenizers

    from legalrag_tpu_torch.tokenize.bpe import QWEN2_PATTERN

    split = pre_tokenizers.Split(Regex(QWEN2_PATTERN), behavior="isolated",
                                 invert=False)
    for text in CASES + corpus_lines()[:200]:
        text = unicodedata.normalize("NFC", text)
        assert split_words(text) == [p for p, _ in
                                     split.pre_tokenize_str(text)], text


@pytest.mark.parametrize("max_length", [1, 7, 64])
def test_truncation_matches(toks, max_length):
    ref, mine = toks
    text = "\n".join(corpus_lines()[:20])
    want = ref(text, truncation=True, max_length=max_length)["input_ids"]
    assert mine(text, truncation=True, max_length=max_length)["input_ids"] \
        == want
    assert len(want) == max_length


def test_decode_matches(toks):
    """Round trips, partial UTF-8 sequences, special tokens kept or
    skipped, and ids with no token (dropped)."""
    ref, mine = toks
    assert mine.eos_token_id == ref.eos_token_id == mine.token_id("<|im_end|>")
    rng = np.random.default_rng(1)
    n = BPE_VOCAB + len(SPECIALS)
    cases = [mine(t)["input_ids"] for t in CASES]
    cases += [rng.integers(0, n + 200, rng.integers(1, 12)).tolist()
              for _ in range(500)]
    cases += [[n + 5, 10, n + 100, 151935], [mine.token_id("<|im_end|>")]]
    for ids in cases:
        for skip in (True, False):
            assert mine.decode(ids, skip_special_tokens=skip) == \
                ref.decode(ids, skip_special_tokens=skip), (ids, skip)
    for t in CASES:
        if "<|" not in t and "\r" not in t:
            assert mine.decode(mine(t)["input_ids"]) == \
                unicodedata.normalize("NFC", t)


def test_chat_template_matches_on_the_pipelines_messages(toks, zh_chunks,
                                                        en_chunks):
    """The pipeline's zh and en RAG messages (two system turns and the
    user turn), with and without the generation prompt, and a short chat
    with an assistant turn: the same text and the same ids."""
    ref, mine = toks
    chats = [rag_messages("合同在什么情况下可以解除？", zh_chunks[:6]),
             rag_messages("What must a buyer do to reject goods?",
                          en_chunks[:6]),
             [{"role": "user", "content": "你好"},
              {"role": "assistant", "content": "您好！"},
              {"role": "user", "content": "Hi again"}]]
    assert [m["role"] for m in chats[0]] == ["system", "system", "user"]
    for msgs in chats:
        for gen in (True, False):
            want = ref.apply_chat_template(msgs, tokenize=False,
                                           add_generation_prompt=gen)
            assert mine.apply_chat_template(
                msgs, tokenize=False, add_generation_prompt=gen) == want
            assert mine(want)["input_ids"] == ref(want)["input_ids"]
    assert want.startswith("<|im_start|>system\nYou are Qwen")


def qwen2_variants(spec: dict) -> dict:
    """Qwen2-layout specs changed in one component each."""
    split, level = spec["pre_tokenizer"]["pretokenizers"]

    def pattern(regex):
        return {**spec, "pre_tokenizer": {**spec["pre_tokenizer"],
                                          "pretokenizers": [
            {**split, "pattern": {"Regex": regex}}, level]}}

    return {
        "llama3_digits": pattern(split["pattern"]["Regex"].replace(
            r"\p{N}|", r"\p{N}{1,3}|")),
        "byte_fallback": {**spec, "model": {**spec["model"],
                                            "byte_fallback": True}},
        "wordpiece": {**spec, "model": {**spec["model"], "type": "WordPiece"}},
        "unigram": {**spec, "model": {"type": "Unigram", "unk_id": 0,
                                      "vocab": [["<unk>", 0.0], ["a", -1.0]],
                                      "byte_fallback": False}},
        "gpt2_pattern": pattern(
            r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+"
            r"|\s+(?!\S)|\s+"),
        "metaspace_bytelevel": {**spec, "normalizer": None, "pre_tokenizer": {
            "type": "Metaspace", "replacement": "▁"}},
        "metaspace_decoder": {**spec, "normalizer": None, "pre_tokenizer": {
            "type": "Metaspace", "replacement": "▁"}, "decoder": {
            "type": "Metaspace", "replacement": "▁"}},
    }


@pytest.mark.parametrize("variant", ["llama3_digits", "byte_fallback"])
def test_layout_variants_match(tmp_path, variant):
    """Llama 3's split pattern (digits in runs of up to three) and a
    ``byte_fallback`` flag on a byte-level model (every byte is a symbol,
    so it never applies) over Qwen2's files: ids on the edge cases, 500
    seeded strings and 300 statute lines, and decoded text, equal to
    ``AutoTokenizer``'s on the same files."""
    from transformers import AutoTokenizer

    d = write_qwen2_tokenizer(tmp_path, vocab=600)
    spec = qwen2_variants(json.loads((d / "tokenizer.json").read_text()))[
        variant]
    (d / "tokenizer.json").write_text(json.dumps(spec), encoding="utf-8")
    ref, mine = AutoTokenizer.from_pretrained(str(d)), BPETokenizer.from_dir(d)
    rng = np.random.default_rng(2)
    texts = CASES + corpus_lines()[:300] + [
        "".join(rng.choice(list("0123456789 ab合,\n"), rng.integers(1, 20)))
        for _ in range(500)]
    want = ref(texts)["input_ids"]
    assert [mine(t)["input_ids"] for t in texts] == want
    for ids in want[:100]:
        assert mine.decode(ids) == ref.decode(ids)


def test_other_layouts_are_not_supported(toks, tmp_path):
    """A WordPiece or Unigram model, another split pattern, a Metaspace
    pre-tokenizer before a byte-level decoder, a Metaspace decoder, or a
    missing file raises ``TokenizerNotSupported``."""
    _ref, mine = toks
    d = write_qwen2_tokenizer(tmp_path / "base", vocab=300)
    variants = qwen2_variants(json.loads((d / "tokenizer.json").read_text()))
    for name in ("wordpiece", "unigram", "gpt2_pattern",
                 "metaspace_bytelevel", "metaspace_decoder"):
        with pytest.raises(TokenizerNotSupported):
            BPETokenizer(variants[name])
    with pytest.raises(TokenizerNotSupported):
        BPETokenizer.from_dir(tmp_path / "nothing")
