"""Port BPE tokenizer (``legalrag_tpu_torch/tokenize/bpe.py``) vs
``transformers.AutoTokenizer`` on the layouts the dense decoder families
ship, beyond Qwen2's (``tests/test_torch_bpe.py``):

- ``llama3``: byte-level, Llama 3's ``Split`` pattern (digits in runs of
  up to three), no normalizer, ``ignore_merges``, a ``Sequence`` of
  ``ByteLevel`` and a ``TemplateProcessing`` that adds
  ``<|begin_of_text|>``, ``clean_up_tokenization_spaces``, Llama 3.2's
  chat template (``{{ bos_token }}`` and ``strftime_now``);
- ``llama2``: sentencepiece-style BPE with byte fallback, the normalizer
  ``Prepend("▁")`` + ``Replace(" ", "▁")``, no pre-tokenizer, the decoder
  ``Replace`` / ``ByteFallback`` / ``Fuse`` / ``Strip``, ``<s>`` added by
  ``LlamaTokenizer``'s post-processor, Llama 2's chat template;
- ``mistral_metaspace``: the same model as newer conversions write it, no
  normalizer and a ``Metaspace`` pre-tokenizer (``prepend_scheme``
  ``first``, no split), Mistral's chat template;
- ``gemma``: ``Replace(" ", "▁")`` alone, no ``Strip``, ``<bos>``,
  ``<start_of_turn>`` / ``<end_of_turn>``, Gemma 3's chat template.

Each is trained here with the ``tokenizers`` library on the statutes
(offline) and loaded by ``AutoTokenizer`` as the JAX decoder engine loads
it; the port reads the same files. Ids with and without special tokens,
truncation, decoded text and rendered chat templates (and the templates'
refusals) must be exactly equal, on every statute line and 2,000 seeded
strings with characters absent from the vocabulary."""

import json
from pathlib import Path

import jinja2
import numpy as np
import pytest

from legalrag_tpu_torch.tokenize.bpe import LLAMA3_PATTERN, BPETokenizer
from test_torch_bpe import CASES, corpus_lines, rag_messages

BPE_VOCAB = 3000
# characters kept in the sentencepiece-style alphabets: the statutes' rarer
# characters are left to byte fallback
ALPHABET = 1500
BYTES = [f"<0x{b:02X}>" for b in range(256)]
LLAMA3_SPECIALS = ("<|begin_of_text|>", "<|end_of_text|>",
                   "<|start_header_id|>", "<|end_header_id|>", "<|eot_id|>")
# Llama 3.2-Instruct's chat template without its tool-calling branches
LLAMA32_TEMPLATE = (
    "{{- bos_token }}\n{%- if not date_string is defined %}\n"
    "    {%- if strftime_now is defined %}\n"
    "        {%- set date_string = strftime_now(\"%d %b %Y\") %}\n"
    "    {%- else %}\n        {%- set date_string = \"26 Jul 2024\" %}\n"
    "    {%- endif %}\n{%- endif %}\n"
    "{%- if messages[0]['role'] == 'system' %}\n"
    "    {%- set system_message = messages[0]['content']|trim %}\n"
    "    {%- set messages = messages[1:] %}\n{%- else %}\n"
    "    {%- set system_message = \"\" %}\n{%- endif %}\n"
    "{{- \"<|start_header_id|>system<|end_header_id|>\\n\\n\" }}\n"
    "{{- \"Cutting Knowledge Date: December 2023\\n\" }}\n"
    "{{- \"Today Date: \" + date_string + \"\\n\\n\" }}\n"
    "{{- system_message }}\n{{- \"<|eot_id|>\" }}\n"
    "{%- for message in messages %}\n"
    "    {{- '<|start_header_id|>' + message['role'] + "
    "'<|end_header_id|>\\n\\n'+ message['content'] | trim + '<|eot_id|>' }}\n"
    "{%- endfor %}\n{%- if add_generation_prompt %}\n"
    "    {{- '<|start_header_id|>assistant<|end_header_id|>\\n\\n' }}\n"
    "{%- endif %}\n")
# Llama-2-chat's
LLAMA2_TEMPLATE = (
    "{% if messages[0]['role'] == 'system' %}{% set loop_messages = "
    "messages[1:] %}{% set system_message = messages[0]['content'] %}"
    "{% else %}{% set loop_messages = messages %}{% set system_message = "
    "false %}{% endif %}{% for message in loop_messages %}{% if "
    "(message['role'] == 'user') != (loop.index0 % 2 == 0) %}{{ "
    "raise_exception('Conversation roles must alternate "
    "user/assistant/user/assistant/...') }}{% endif %}{% if loop.index0 == 0 "
    "and system_message != false %}{% set content = '<<SYS>>\\n' + "
    "system_message + '\\n<</SYS>>\\n\\n' + message['content'] %}{% else %}"
    "{% set content = message['content'] %}{% endif %}{% if message['role'] "
    "== 'user' %}{{ bos_token + '[INST] ' + content.strip() + ' [/INST]' }}"
    "{% elif message['role'] == 'assistant' %}{{ ' '  + content.strip() + "
    "' ' + eos_token }}{% endif %}{% endfor %}")
# Mistral-7B-Instruct-v0.1's
MISTRAL_TEMPLATE = (
    "{{ bos_token }}{% for message in messages %}{% if (message['role'] == "
    "'user') != (loop.index0 % 2 == 0) %}{{ raise_exception('Conversation "
    "roles must alternate user/assistant/user/assistant/...') }}{% endif %}"
    "{% if message['role'] == 'user' %}{{ '[INST] ' + message['content'] + "
    "' [/INST]' }}{% elif message['role'] == 'assistant' %}{{ "
    "message['content'] + eos_token}}{% else %}{{ raise_exception('Only "
    "user and assistant roles are supported!') }}{% endif %}{% endfor %}")
# gemma-3-1b-it's (its image branch kept)
GEMMA3_TEMPLATE = (
    "{{ bos_token }}\n{%- if messages[0]['role'] == 'system' -%}\n"
    "    {%- if messages[0]['content'] is string -%}\n"
    "        {%- set first_user_prefix = messages[0]['content'] + '\\n\\n' -%}\n"
    "    {%- else -%}\n"
    "        {%- set first_user_prefix = messages[0]['content'][0]['text'] + "
    "'\\n\\n' -%}\n    {%- endif -%}\n"
    "    {%- set loop_messages = messages[1:] -%}\n{%- else -%}\n"
    "    {%- set first_user_prefix = \"\" -%}\n"
    "    {%- set loop_messages = messages -%}\n{%- endif -%}\n"
    "{%- for message in loop_messages -%}\n"
    "    {%- if (message['role'] == 'user') != (loop.index0 % 2 == 0) -%}\n"
    "        {{ raise_exception(\"Conversation roles must alternate "
    "user/assistant/user/assistant/...\") }}\n    {%- endif -%}\n"
    "    {%- if (message['role'] == 'assistant') -%}\n"
    "        {%- set role = \"model\" -%}\n    {%- else -%}\n"
    "        {%- set role = message['role'] -%}\n    {%- endif -%}\n"
    "    {{ '<start_of_turn>' + role + '\\n' + (first_user_prefix if "
    "loop.first else \"\") }}\n"
    "    {%- if message['content'] is string -%}\n"
    "        {{ message['content'] | trim }}\n"
    "    {%- elif message['content'] is iterable -%}\n"
    "        {%- for item in message['content'] -%}\n"
    "            {%- if item['type'] == 'image' -%}\n"
    "                {{ '<start_of_image>' }}\n"
    "            {%- elif item['type'] == 'text' -%}\n"
    "                {{ item['text'] | trim }}\n            {%- endif -%}\n"
    "        {%- endfor -%}\n    {%- else -%}\n"
    "        {{ raise_exception(\"Invalid content type\") }}\n"
    "    {%- endif -%}\n    {{ '<end_of_turn>\\n' }}\n{%- endfor -%}\n"
    "{%- if add_generation_prompt -%}\n    {{'<start_of_turn>model\\n'}}\n"
    "{%- endif -%}\n")
# gemma-2's: any system turn raises
GEMMA2_TEMPLATE = (
    "{{ bos_token }}{% if messages[0]['role'] == 'system' %}{{ "
    "raise_exception('System role not supported') }}{% endif %}{% for "
    "message in messages %}{% if (message['role'] == 'user') != "
    "(loop.index0 % 2 == 0) %}{{ raise_exception('Conversation roles must "
    "alternate user/assistant/user/assistant/...') }}{% endif %}{% if "
    "(message['role'] == 'assistant') %}{% set role = 'model' %}{% else %}"
    "{% set role = message['role'] %}{% endif %}{{ '<start_of_turn>' + role "
    "+ '\\n' + message['content'] | trim + '<end_of_turn>\\n' }}{% endfor %}"
    "{% if add_generation_prompt %}{{'<start_of_turn>model\\n'}}{% endif %}")
BIG = 1000000000000000019884624838656   # sentencepiece configs' max length
SP = {
    "llama2": dict(
        specials=("<unk>", "<s>", "</s>"),
        normalizer=[("Prepend", "▁"), ("Replace", " ", "▁")], pre=None,
        strip=True, config={
            "tokenizer_class": "LlamaTokenizer", "bos_token": "<s>",
            "eos_token": "</s>", "unk_token": "<unk>", "pad_token": None,
            "add_bos_token": True, "add_eos_token": False, "legacy": True,
            "chat_template": LLAMA2_TEMPLATE}),
    "mistral_metaspace": dict(
        specials=("<unk>", "<s>", "</s>"), normalizer=[],
        pre={"type": "Metaspace", "replacement": "▁",
             "prepend_scheme": "first", "split": False},
        strip=True, config={
            "tokenizer_class": "LlamaTokenizer", "bos_token": "<s>",
            "eos_token": "</s>", "unk_token": "<unk>", "pad_token": None,
            "add_bos_token": True, "add_eos_token": False, "legacy": False,
            "chat_template": MISTRAL_TEMPLATE}),
    "gemma": dict(
        specials=("<pad>", "<eos>", "<bos>", "<unk>", "<start_of_turn>",
                  "<end_of_turn>"),
        normalizer=[("Replace", " ", "▁")], pre=None, strip=False, config={
            "tokenizer_class": "GemmaTokenizer", "bos_token": "<bos>",
            "eos_token": "<eos>", "unk_token": "<unk>", "pad_token": "<pad>",
            "additional_special_tokens": ["<start_of_turn>", "<end_of_turn>"],
            "add_bos_token": True, "add_eos_token": False,
            "chat_template": GEMMA3_TEMPLATE}),
}
LAYOUTS = ("llama3", "llama2", "mistral_metaspace", "gemma")


def _added(specials, ids):
    return [{"id": i, "content": s, "single_word": False, "lstrip": False,
             "rstrip": False, "normalized": False, "special": True}
            for s, i in zip(specials, ids)]


def write_llama3_tokenizer(d: Path, vocab: int = BPE_VOCAB,
                           template: str = LLAMA32_TEMPLATE) -> Path:
    from tokenizers import (AddedToken, Regex, Tokenizer, decoders, models,
                            pre_tokenizers, processors, trainers)

    tok = Tokenizer(models.BPE())
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(LLAMA3_PATTERN), behavior="isolated",
                             invert=False),
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False,
                                 trim_offsets=True)])
    tok.decoder = decoders.ByteLevel()
    tok.train_from_iterator(corpus_lines(), trainers.BpeTrainer(
        vocab_size=vocab, show_progress=False, special_tokens=[],
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet()))
    tok.add_special_tokens([AddedToken(s, special=True, normalized=False)
                            for s in LLAMA3_SPECIALS])
    bos = tok.token_to_id(LLAMA3_SPECIALS[0])
    tok.post_processor = processors.Sequence([
        processors.ByteLevel(add_prefix_space=True, trim_offsets=False,
                             use_regex=True),
        processors.TemplateProcessing(
            single=f"{LLAMA3_SPECIALS[0]} $A",
            pair=f"{LLAMA3_SPECIALS[0]} $A {LLAMA3_SPECIALS[0]} $B:1",
            special_tokens=[(LLAMA3_SPECIALS[0], bos)])])
    spec = json.loads(tok.to_str())
    spec["model"]["ignore_merges"] = True
    d.mkdir(parents=True, exist_ok=True)
    Tokenizer.from_str(json.dumps(spec)).save(str(d / "tokenizer.json"))
    (d / "tokenizer_config.json").write_text(json.dumps({
        "tokenizer_class": "PreTrainedTokenizerFast",
        "bos_token": "<|begin_of_text|>", "eos_token": "<|eot_id|>",
        "chat_template": template, "clean_up_tokenization_spaces": True,
        "model_max_length": 131072}), encoding="utf-8")
    return d


def write_sp_tokenizer(d: Path, layout: str, vocab: int = BPE_VOCAB,
                       template: str = None) -> Path:
    """A sentencepiece-style BPE (``SP[layout]``): the special tokens at
    ids 0.., the 256 ``<0xNN>`` byte tokens after them, then the pieces
    and merges ``BpeTrainer`` learns on the statutes (words split at
    "▁", an alphabet of ``ALPHABET`` characters)."""
    from tokenizers import (Tokenizer, decoders, models, normalizers,
                            pre_tokenizers, trainers)

    lay = SP[layout]
    trainer_tok = Tokenizer(models.BPE())
    trainer_tok.normalizer = normalizers.Replace(" ", "▁")
    trainer_tok.pre_tokenizer = pre_tokenizers.Metaspace(
        replacement="▁", prepend_scheme="always", split=True)
    trainer_tok.train_from_iterator(corpus_lines(), trainers.BpeTrainer(
        vocab_size=vocab, show_progress=False, limit_alphabet=ALPHABET))
    trained = json.loads(trainer_tok.to_str())["model"]
    specials = lay["specials"]
    words = {s: i for i, s in enumerate(list(specials) + BYTES)}
    for t, _i in sorted(trained["vocab"].items(), key=lambda kv: kv[1]):
        words.setdefault(t, len(words))
    norm = [{"type": "Prepend", "prepend": n[1]} if n[0] == "Prepend" else
            {"type": "Replace", "pattern": {"String": n[1]}, "content": n[2]}
            for n in lay["normalizer"]]
    bos = lay["config"]["bos_token"]
    spec = {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": _added(specials, range(len(specials))),
        "normalizer": ({"type": "Sequence", "normalizers": norm}
                       if len(norm) > 1 else (norm[0] if norm else None)),
        "pre_tokenizer": lay["pre"],
        "post_processor": {
            "type": "TemplateProcessing",
            "single": [{"SpecialToken": {"id": bos, "type_id": 0}},
                       {"Sequence": {"id": "A", "type_id": 0}}],
            "pair": [{"SpecialToken": {"id": bos, "type_id": 0}},
                     {"Sequence": {"id": "A", "type_id": 0}},
                     {"SpecialToken": {"id": bos, "type_id": 1}},
                     {"Sequence": {"id": "B", "type_id": 1}}],
            "special_tokens": {bos: {"id": bos, "ids": [words[bos]],
                                     "tokens": [bos]}}},
        "decoder": {"type": "Sequence", "decoders": [
            {"type": "Replace", "pattern": {"String": "▁"}, "content": " "},
            {"type": "ByteFallback"}, {"type": "Fuse"}]
            + ([{"type": "Strip", "content": " ", "start": 1, "stop": 0}]
               if lay["strip"] else [])},
        "model": {"type": "BPE", "dropout": None,
                  "unk_token": lay["config"]["unk_token"],
                  "continuing_subword_prefix": None,
                  "end_of_word_suffix": None, "fuse_unk": True,
                  "byte_fallback": True, "ignore_merges": False,
                  "vocab": words, "merges": trained["merges"]}}
    d.mkdir(parents=True, exist_ok=True)
    Tokenizer.from_str(json.dumps(spec)).save(str(d / "tokenizer.json"))
    config = dict(lay["config"], clean_up_tokenization_spaces=False,
                  model_max_length=BIG)
    if template is not None:
        config["chat_template"] = template
    (d / "tokenizer_config.json").write_text(json.dumps(config),
                                             encoding="utf-8")
    return d


def write_layout_tokenizer(d: Path, layout: str, **kw) -> Path:
    if layout == "llama3":
        return write_llama3_tokenizer(d, **kw)
    return write_sp_tokenizer(d, layout, **kw)


@pytest.fixture(scope="module", params=LAYOUTS)
def toks(request, tmp_path_factory):
    """(layout, transformers' tokenizer, the port's) over one directory."""
    from transformers import AutoTokenizer

    d = write_layout_tokenizer(tmp_path_factory.mktemp(request.param),
                               request.param)
    return (request.param, AutoTokenizer.from_pretrained(str(d)),
            BPETokenizer.from_dir(d))


def random_texts(n: int = 2000, seed: int = 0):
    """Seeded strings from a pool of letters, digits, spaces, newlines,
    punctuation, CJK (common and rare), astral characters, "▁", byte-token
    look-alikes, contractions and every layout's special tokens."""
    pool = ["a", "Z", "é", "e\u0301", "ſ", "'", "s", "t", "re", "LL", "1",
            "12345", "٣", "Ⅻ", "²", " ", "  ", "\t", "\n", "\r\n", "\x0b",
            "\xa0", "\u3000", "!", "?", "，", "。", "合", "同", "中华", "龘",
            "饕餮", "鬱", "😀", "👍🏽", "\U00020000", "\x00", "-", "<", "|",
            "▁", "▁▁", "<0x41>", "<0xZZ>", "x", "ab", "\ufffd", "\u200b", "ǅ",
            "'s", "'T", "3.14", "第", "条", "§", "Sale", " the",
            *LLAMA3_SPECIALS[:2], "<s>", "</s>", "<unk>", "<bos>", "<eos>",
            "<start_of_turn>", "<end_of_turn>", "<pad>"]
    rng = np.random.default_rng(seed)
    return ["".join(pool[i] for i in rng.integers(0, len(pool),
                                                  rng.integers(1, 16)))
            for _ in range(n)]


@pytest.mark.parametrize("special", [True, False])
def test_ids_of_every_corpus_line_match(toks, special):
    _layout, ref, mine = toks
    lines = corpus_lines()
    want = ref(lines, add_special_tokens=special)["input_ids"]
    assert [mine(l, add_special_tokens=special)["input_ids"]
            for l in lines] == want
    assert sum(map(len, want)) < sum(map(len, lines))   # merges apply


def test_random_strings_match(toks):
    """2,000 seeded strings, with and without special tokens; the byte
    fallback and the added tokens are reached."""
    layout, ref, mine = toks
    texts = random_texts()
    for special in (True, False):
        want = ref(texts, add_special_tokens=special)["input_ids"]
        assert [mine(t, add_special_tokens=special)["input_ids"]
                for t in texts] == want
    if layout != "llama3":
        byte_ids = {mine.token_id(b) for b in BYTES}
        assert any(byte_ids & set(ids) for ids in want)


def test_edge_cases_match(toks):
    _layout, ref, mine = toks
    for text in CASES + ["▁", " ▁ x", "12 345 6789", "<s> x", "\n\n<s>"]:
        for special in (True, False):
            assert mine(text, add_special_tokens=special)["input_ids"] == \
                ref(text, add_special_tokens=special)["input_ids"], text


@pytest.mark.parametrize("max_length", [1, 2, 7, 64])
def test_truncation_matches(toks, max_length):
    """Truncation leaves room for the special tokens, as transformers'."""
    _layout, ref, mine = toks
    text = "\n".join(corpus_lines()[:20])
    assert mine(text, truncation=True, max_length=max_length)["input_ids"] \
        == ref(text, truncation=True, max_length=max_length)["input_ids"]


def test_decode_matches(toks):
    """Round trips, ragged byte-fallback runs, special tokens kept or
    skipped, and ids with no token (dropped)."""
    layout, ref, mine = toks
    assert mine.eos_token_id == ref.eos_token_id
    rng = np.random.default_rng(1)
    n = len(ref)
    cases = [mine(t)["input_ids"] for t in CASES + random_texts(200, 3)]
    cases += [rng.integers(0, n + 50, rng.integers(1, 12)).tolist()
              for _ in range(500)]
    if layout != "llama3":
        byte = [mine.token_id(b) for b in BYTES]
        # runs of byte tokens cut at any point, around pieces and specials
        word = mine.encode("合同 abc")
        cases += [[byte[b] for b in rng.integers(0x80, 0x100,
                                                 rng.integers(1, 6))]
                  + word[:rng.integers(0, 3)] for _ in range(200)]
        cases += [[byte[0xE5], byte[0x90], byte[0x88], byte[0xE5]],
                  [byte[0xE5], byte[0x90], word[0], byte[0x88]],
                  [mine.prefix[0], byte[0xF0], byte[0x9F]] + word]
    cases += [[n + 5, 10, n + 100, 10 ** 6]]
    for ids in cases:
        for skip in (True, False):
            assert mine.decode(ids, skip_special_tokens=skip) == \
                ref.decode(ids, skip_special_tokens=skip), (ids, skip)


CHATS = {
    "rag_zh": lambda zh, en: rag_messages("合同在什么情况下可以解除？", zh[:4]),
    "rag_en": lambda zh, en: rag_messages(
        "What must a buyer do to reject goods?", en[:4]),
    "turns": lambda zh, en: [{"role": "user", "content": "你好"},
                             {"role": "assistant", "content": " 您好！ "},
                             {"role": "user", "content": "Hi again"}],
    "system_user": lambda zh, en: [
        {"role": "system", "content": "你是法律助手。"},
        {"role": "user", "content": "借款合同的利息如何约定？"}],
}


@pytest.mark.parametrize("chat", sorted(CHATS))
def test_chat_template_matches(toks, zh_chunks, en_chunks, chat):
    """The pipeline's RAG messages (two system turns, then the user's), a
    chat with an assistant turn, one system turn: the same text and the
    same ids (the template's BOS and the post-processor's both), or the
    same refusal where the template raises."""
    _layout, ref, mine = toks
    msgs = CHATS[chat](zh_chunks, en_chunks)
    for gen in (True, False):
        try:
            want = ref.apply_chat_template(msgs, tokenize=False,
                                           add_generation_prompt=gen)
        except jinja2.exceptions.TemplateError as e:
            with pytest.raises(jinja2.exceptions.TemplateError,
                               match=str(e)[:20]):
                mine.apply_chat_template(msgs, add_generation_prompt=gen)
            continue
        assert mine.apply_chat_template(
            msgs, tokenize=False, add_generation_prompt=gen) == want
        assert mine(want)["input_ids"] == ref(want)["input_ids"]
        assert mine.apply_chat_template(msgs, tokenize=True,
                                        add_generation_prompt=gen) == \
            ref.apply_chat_template(msgs, tokenize=True,
                                    add_generation_prompt=gen)


@pytest.mark.parametrize("scheme,split", [("always", True),
                                          ("never", True), ("first", True)])
def test_metaspace_variants_match(tmp_path, scheme, split):
    """Metaspace's other options on the sentencepiece-style model: each
    prepend scheme with the split at "▁" (a piece per word)."""
    from transformers import AutoTokenizer

    d = write_sp_tokenizer(tmp_path, "mistral_metaspace", vocab=800)
    spec = json.loads((d / "tokenizer.json").read_text())
    spec["pre_tokenizer"] |= {"prepend_scheme": scheme, "split": split}
    (d / "tokenizer.json").write_text(json.dumps(spec), encoding="utf-8")
    ref, mine = AutoTokenizer.from_pretrained(str(d)), BPETokenizer.from_dir(d)
    texts = CASES + random_texts(500, 5) + corpus_lines()[:100]
    for special in (True, False):
        assert [mine(t, add_special_tokens=special)["input_ids"]
                for t in texts] == \
            ref(texts, add_special_tokens=special)["input_ids"]


@pytest.mark.parametrize("layout", ["llama2", "gemma"])
def test_config_rebuilds_the_post_processor(tmp_path, layout):
    """A ``LlamaTokenizer`` / ``GemmaTokenizer`` config's ``add_bos_token``
    and ``add_eos_token`` replace tokenizer.json's template, as
    transformers' ``update_post_processor`` does: no BOS and an EOS here."""
    from transformers import AutoTokenizer

    d = write_sp_tokenizer(tmp_path, layout, vocab=600)
    conf = json.loads((d / "tokenizer_config.json").read_text())
    conf |= {"add_bos_token": False, "add_eos_token": True}
    (d / "tokenizer_config.json").write_text(json.dumps(conf))
    ref, mine = AutoTokenizer.from_pretrained(str(d)), BPETokenizer.from_dir(d)
    for text in CASES[:6] + ["合同", ""]:
        want = ref(text)["input_ids"]
        assert mine(text)["input_ids"] == want
        assert want[-1:] == [mine.eos_token_id]
        assert mine(text, truncation=True, max_length=3)["input_ids"] == \
            ref(text, truncation=True, max_length=3)["input_ids"]


def test_template_globals_and_refusals(tmp_path):
    """Gemma 2's template refuses any system turn, Gemma 3's a second
    one, as transformers renders them; Llama 3.2's reads ``strftime_now``
    and a ``{% generation %}`` block renders its body."""
    from transformers import AutoTokenizer

    d = write_sp_tokenizer(tmp_path / "g2", "gemma", vocab=600,
                           template=GEMMA2_TEMPLATE)
    ref, mine = AutoTokenizer.from_pretrained(str(d)), BPETokenizer.from_dir(d)
    user = [{"role": "user", "content": "合同"}]
    system = [{"role": "system", "content": "x"}] + user
    assert mine.apply_chat_template(user) == ref.apply_chat_template(
        user, tokenize=False)
    for r in (ref, mine):
        with pytest.raises(jinja2.exceptions.TemplateError,
                           match="System role not supported"):
            r.apply_chat_template(system, tokenize=False)
    gen = ("{% for m in messages %}{% generation %}[{{ m['content'] }}]"
           "{% endgeneration %}{% endfor %}{{ strftime_now('%Y') }}")
    d = write_llama3_tokenizer(tmp_path / "l3", vocab=600, template=gen)
    ref, mine = AutoTokenizer.from_pretrained(str(d)), BPETokenizer.from_dir(d)
    assert mine.apply_chat_template(user) == \
        ref.apply_chat_template(user, tokenize=False)
