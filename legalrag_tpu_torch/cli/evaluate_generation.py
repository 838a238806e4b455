"""CLI: generation-quality evaluation, answers and not just retrieval (port
of ``scripts/evaluate_generation.py:68-278``).

Runs the QA set end to end through retrieval (``HybridRetriever.search``
in ``GRAPH_AUGMENTED`` mode, top ``--k``) and each answer provider, and
reports per provider and language: citation precision, citation recall,
the faithfulness proxy (sentence support rate), whether anything is cited
and the refs cited (``evals/generation.py``).

Providers:

- ``extractive``: the deterministic answerer (quotes the top provisions,
  conclusion first);
- ``degraded``: the fixed unavailable-mode string, the floor;
- ``local-jax-random`` (``--local-jax-layers N``): a small random-init
  decoder through the port's ``LLMClient`` with ``provider="local-jax"``
  and an injected ``TorchDecoderLM``, the path real weights take.

``--schema N`` also measures schema validity (valid JSON with the required
keys) of constrained against unconstrained sampled decoding on N items,
the ``models/constrain.py`` contract, which needs no trained weights.

The random decoders have JAX's widths (``DecoderConfig``: the answerer
128 wide with 2 layers by default and 8,192 ids, the schema check 64 wide
with 2 layers and 512 ids) and JAX's initialisation (normals at 0.02, the
embedding at 0.05 and tied, zero biases, unit norms), drawn on ``--device``
from a seeded ``torch.Generator``; the byte-level tokenizer is JAX's
``_ByteTok``. Sampling draws from the port's generators, so sampled
streams are not JAX's; greedy ones are.

Usage: python -m legalrag_tpu_torch.cli.evaluate_generation [--limit 100]
       [--schema 8] [--local-jax-layers 2] [--out-json F]
       [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from legalrag_tpu_torch.config import AppConfig, LLMConfig
from legalrag_tpu_torch.evals.generation import (
    aggregate_generation,
    evaluate_answer,
    extractive_answer,
    schema_validity,
)
from legalrag_tpu_torch.graph import LawGraphStore
from legalrag_tpu_torch.index.bundle import IndexBundle
from legalrag_tpu_torch.llm.client import DEGRADED_ANSWER, LLMClient
from legalrag_tpu_torch.models.constrain import JsonConstraint, build_schema_dfa
from legalrag_tpu_torch.models.decoder import (
    DecoderConfig,
    DecoderModel,
    TorchDecoderLM,
)
from legalrag_tpu_torch.retrieval.hybrid import HybridRetriever
from legalrag_tpu_torch.schemas import (
    IssueType,
    RoutingDecision,
    RoutingMode,
    TaskType,
)
from legalrag_tpu_torch.utils import detect_lang, get_logger
from legalrag_tpu_torch.utils.device import DeviceLike, resolve_device

log = get_logger("torch.cli.evaluate_generation")

COLS = ("citation_precision", "citation_recall", "support_rate",
        "cites_anything", "n_refs")
# compact schema format of models/constrain.py (fixed keys, all required)
SCHEMA = {"conclusion": "string", "article": "string"}
SCHEMA_KEYS = ("conclusion", "article")


def answer_config(n_layers: int) -> DecoderConfig:
    """The random answerer's widths (``scripts/evaluate_generation.py:89-93``)."""
    return DecoderConfig(num_hidden_layers=n_layers, hidden_size=128,
                         intermediate_size=256, num_attention_heads=4,
                         num_key_value_heads=2, head_dim=32,
                         vocab_size=8192, max_position_embeddings=1024)


def schema_config() -> DecoderConfig:
    """The schema check's widths (``:153-156``)."""
    return DecoderConfig(num_hidden_layers=2, hidden_size=64,
                         intermediate_size=128, num_attention_heads=2,
                         num_key_value_heads=1, head_dim=32,
                         vocab_size=512, max_position_embeddings=1024)


def load_rows(path: Path) -> List[dict]:
    rows = []
    with path.open("r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append(json.loads(line))
    return rows


def random_decoder_state(cfg: DecoderConfig, seed: int = 0,
                         device: DeviceLike = None,
                         dtype: torch.dtype = torch.float32
                         ) -> Dict[str, torch.Tensor]:
    """A random ``DecoderModel`` state at ``cfg``'s widths with JAX's
    random-init layout (``scripts/bench_decode.py:37-90``: matrices at
    0.02, the embedding at 0.05 and tied to the head, zero q/k/v biases,
    unit norms), drawn on ``device`` from ``torch.Generator`` seeded with
    ``seed``."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    h, ff, d = cfg.hidden_size, cfg.intermediate_size, cfg.head_dim
    hq, hkv = cfg.num_attention_heads, cfg.num_key_value_heads

    def mat(out_f: int, in_f: int, scale: float = 0.02) -> torch.Tensor:
        return (torch.randn((out_f, in_f), generator=g, device=dev) * scale
                ).to(dtype)

    def ones(n: int) -> torch.Tensor:
        return torch.ones(n, dtype=dtype, device=dev)

    state = {"embed_tokens.weight": mat(cfg.vocab_size, h, 0.05),
             "norm.weight": ones(h)}
    for i in range(cfg.num_hidden_layers):
        p = f"layers.{i}"
        state |= {
            f"{p}.input_layernorm.weight": ones(h),
            f"{p}.self_attn.q_proj.weight": mat(hq * d, h),
            f"{p}.self_attn.q_proj.bias": torch.zeros(hq * d, dtype=dtype,
                                                      device=dev),
            f"{p}.self_attn.k_proj.weight": mat(hkv * d, h),
            f"{p}.self_attn.k_proj.bias": torch.zeros(hkv * d, dtype=dtype,
                                                      device=dev),
            f"{p}.self_attn.v_proj.weight": mat(hkv * d, h),
            f"{p}.self_attn.v_proj.bias": torch.zeros(hkv * d, dtype=dtype,
                                                      device=dev),
            f"{p}.self_attn.o_proj.weight": mat(h, hq * d),
            f"{p}.post_attention_layernorm.weight": ones(h),
            f"{p}.mlp.gate_proj.weight": mat(ff, h),
            f"{p}.mlp.up_proj.weight": mat(ff, h),
            f"{p}.mlp.down_proj.weight": mat(h, ff)}
    return state


class ByteTok:
    """Byte-level fallback tokenizer (``scripts/evaluate_generation.py:95-118``):
    ids = utf-8 bytes, decode best-effort."""

    eos_token_id = 0

    def encode(self, text, add_special_tokens=False):
        return [b % 8192 for b in text.encode("utf-8")][:768]

    def __call__(self, text, truncation=True, max_length=768, **kw):
        # the callable seam LLMClient._stream_jax uses
        return {"input_ids": self.encode(text)[:max_length]}

    def decode(self, ids, skip_special_tokens=True):
        return bytes(int(i) % 256 for i in ids).decode("utf-8",
                                                       errors="replace")

    def apply_chat_template(self, messages, tokenize=False,
                            add_generation_prompt=True):
        return "\n".join(m.get("content", "") for m in messages)


def make_local_answerer(n_layers: int, device: DeviceLike = None,
                        state: Optional[Dict[str, torch.Tensor]] = None
                        ) -> Tuple[Callable[[str, str], str], LLMClient]:
    """A random-init decoder through the production ``LLMClient`` seam
    (``provider="local-jax"``, the engine injected), as (answer(question,
    prompt_text), the client). ``state``: weights to use instead of
    ``random_decoder_state``'s (JAX's, carried by
    ``convert.decoder_params_from_jax``)."""
    dev = resolve_device(device)
    cfg = answer_config(n_layers)
    model = DecoderModel.from_state_dict(
        cfg, state if state is not None else random_decoder_state(cfg, 0, dev))
    engine = TorchDecoderLM(model, tokenizer=ByteTok(), device=dev,
                            max_len=1024, decode_chunk=16)
    client = LLMClient(LLMConfig(provider="local-jax", max_new_tokens=96),
                       device=dev)
    client._local = engine
    return (lambda question, prompt_text: client.chat(
        [{"role": "user", "content": prompt_text}], tag="answer")), client


def schema_engine(device: DeviceLike = None,
                  state: Optional[Dict[str, torch.Tensor]] = None
                  ) -> TorchDecoderLM:
    """The schema check's decoder with ``SCHEMA``'s constraint over a
    byte-level token table (token i = byte i, ids from 256 banned)."""
    dev = resolve_device(device)
    cfg = schema_config()
    token_bytes = [bytes([i]) if i < 256 else None for i in range(512)]
    jc = JsonConstraint.from_schema(SCHEMA, token_bytes, device=dev)
    model = DecoderModel.from_state_dict(
        cfg, state if state is not None else random_decoder_state(cfg, 0, dev))
    return TorchDecoderLM(model, device=dev, max_len=1024, decode_chunk=8,
                          json_constraint=jc)


def schema_streams(lm: TorchDecoderLM, n_items: int,
                   temperature: float = 0.8
                   ) -> Tuple[Dict[str, float], List[Tuple[list, list]]]:
    """Constrained against unconstrained streams of ``lm`` on ``n_items``
    seeded prompts (``:131-182``): the rates and each item's
    (constrained, unconstrained) token ids."""
    trans, _acc = build_schema_dfa(SCHEMA)

    def valid_prefix(text: str) -> bool:
        st = 0
        for b in text.encode("utf-8"):
            st = int(trans[st, b])
            if st < 0:
                return False
        return True

    rng = np.random.default_rng(0)
    pref_c = done_c = ok_u = 0
    streams = []
    for i in range(n_items):
        prompt = rng.integers(33, 127, 64).tolist()
        pair = []
        for constrain in (True, False):
            toks = list(lm.generate_stream(prompt, max_new_tokens=512,
                                           constrain=constrain,
                                           temperature=temperature, eos_id=0,
                                           seed=i))
            pair.append(toks)
            text = bytes(t % 256 for t in toks).decode("utf-8",
                                                       errors="replace")
            if constrain:
                # every constrained stream is a prefix of a schema-valid
                # document, and with the budget to reach EOS the document
                pref_c += valid_prefix(text)
                done_c += schema_validity(text, SCHEMA_KEYS)
            else:
                ok_u += schema_validity(text, SCHEMA_KEYS)
        streams.append(tuple(pair))
    return {"n": n_items,
            "constrained_valid_prefix_rate": pref_c / n_items,
            "constrained_complete_rate": done_c / n_items,
            "unconstrained_valid_rate": ok_u / n_items}, streams


def run_schema_check(n_items: int, device: DeviceLike = None
                     ) -> Dict[str, float]:
    """Constrained against unconstrained JSON validity on a small random
    decoder: the constraint guarantees validity whatever the weights; the
    unconstrained rate is the baseline."""
    return schema_streams(schema_engine(device), n_items)[0]


def evaluate_rows(by_lang: Dict[str, List[dict]], hybrid_of, k: int = 5,
                  tau: float = 0.5, local=None) -> Dict[tuple, List[dict]]:
    """Per (provider, lang) item scores; ``hybrid_of(lang)`` gives the
    language's ``HybridRetriever``, ``local`` the random answerer."""
    decision = RoutingDecision(task_type=TaskType.JUDGE_STYLE,
                               issue_type=IssueType.OTHER,
                               mode=RoutingMode.GRAPH_AUGMENTED)
    per: Dict[tuple, List[dict]] = defaultdict(list)
    for lang, lang_rows in sorted(by_lang.items()):
        hybrid = hybrid_of(lang)
        log.info("[%s] %d queries", lang, len(lang_rows))
        for i, row in enumerate(lang_rows):
            q, gold = row["query"], str(row["article_id"])
            hits = hybrid.search(q, top_k=k, decision=decision)
            answers = {
                "extractive": extractive_answer(q, hits, lang),
                "degraded": DEGRADED_ANSWER[lang],
            }
            if local is not None:
                ctx = "\n".join(h.chunk.text[:400] for h in hits[:3])
                answers["local-jax-random"] = local(q, f"{ctx}\n\n{q}")
            for prov, ans in answers.items():
                per[(prov, lang)].append(evaluate_answer(
                    q, ans, hits, gold, lang, tau=tau))
            if (i + 1) % 25 == 0:
                log.info("[%s] %d/%d", lang, i + 1, len(lang_rows))
    return per


def table(per: Dict[tuple, List[dict]], providers: Sequence[str],
          langs: Sequence[str]) -> Tuple[List[str], Dict[str, Dict]]:
    """The JAX script's printed table and its summary by
    ``provider/lang``."""
    summary: Dict[str, Dict] = {}
    lines = [f"{'provider':<18}{'lang':<6}" + "".join(f"{c:>20}" for c in COLS)]
    for prov in providers:
        for lang in sorted(langs):
            agg = aggregate_generation(per.get((prov, lang), []))
            if not agg:
                continue
            summary[f"{prov}/{lang}"] = agg
            lines.append(f"{prov:<18}{lang:<6}" + "".join(
                f"{agg.get(c, float('nan')):>20.3f}" for c in COLS))
    return lines, summary


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--eval-file", default=None)
    ap.add_argument("--limit", type=int, default=0)
    ap.add_argument("--k", type=int, default=5)
    ap.add_argument("--tau", type=float, default=0.5)
    ap.add_argument("--schema", type=int, default=0, metavar="N",
                    help="also measure constrained-vs-unconstrained JSON "
                    "schema validity on N sampled generations")
    ap.add_argument("--local-jax-layers", type=int, default=0,
                    help="also run a small random-init decoder through "
                    "the local-jax client seam")
    ap.add_argument("--out-json", default=None)
    ap.add_argument("--config", default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="torch device of the bundles and the decoders")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = AppConfig.load(args.config)
    eval_path = Path(args.eval_file
                     or Path(cfg.paths.eval_dir) / "law_qa.jsonl")
    if not eval_path.exists():
        log.error("eval set not found: %s", eval_path)
        sys.exit(1)
    rows = load_rows(eval_path)
    if args.limit:
        rows = rows[: args.limit]

    by_lang: Dict[str, list] = defaultdict(list)
    for r in rows:
        by_lang[r.get("lang") or detect_lang(r["query"])].append(r)

    providers = ["extractive", "degraded"]
    local = None
    if args.local_jax_layers:
        local, _client = make_local_answerer(args.local_jax_layers, device)
        providers.append("local-jax-random")

    def hybrid_of(lang: str) -> HybridRetriever:
        lang_cfg = cfg.with_lang(lang)
        bundle = IndexBundle.load(lang_cfg.paths.lang_index_dir, lang_cfg,
                                  lang, device)
        return HybridRetriever(bundle, lang_cfg, graph_store=LawGraphStore(
            lang_cfg.paths.graph_file))

    per = evaluate_rows(by_lang, hybrid_of, args.k, args.tau, local)
    lines, summary = table(per, providers, list(by_lang))
    for line in lines:
        print(line)

    if args.schema:
        sc = run_schema_check(args.schema, device)
        summary["schema_validity"] = sc
        print(f"schema validity (n={sc['n']}): constrained prefix "
              f"{sc['constrained_valid_prefix_rate']:.2f} / complete "
              f"{sc['constrained_complete_rate']:.2f} vs unconstrained "
              f"{sc['unconstrained_valid_rate']:.2f}")

    if args.out_json:
        Path(args.out_json).write_text(json.dumps(summary, indent=2),
                                       encoding="utf-8")


if __name__ == "__main__":
    main()
