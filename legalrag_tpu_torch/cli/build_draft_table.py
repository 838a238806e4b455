"""CLI: corpus -> n-gram draft table for speculative decoding (port of
``scripts/build_draft_table.py``). Host code: no device.

Tokenizes the processed corpora (``data/processed/law_*.jsonl``) with the
serving model's tokenizer (the port's ``BPETokenizer`` over its
``tokenizer.json``) and builds the direct-mapped bigram -> continuation
table that the speculative engine probes where its prompt lookup misses
(``models/ngram_draft.py``). Point ``llm.ngram_draft_path`` at the
``.npz``; for the same ``tokenizer.json`` and corpus it holds the arrays
the JAX script writes.

Usage:
    python -m legalrag_tpu_torch.cli.build_draft_table --tokenizer <dir> \
        [--input data/processed] [--out data/index/draft_table.npz] \
        [--k 8] [--log2-size 18] [--field text]
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import List, Optional

from legalrag_tpu_torch.models.bert import resolve_model_dir
from legalrag_tpu_torch.models.ngram_draft import NgramDraftTable
from legalrag_tpu_torch.tokenize.bpe import BPETokenizer
from legalrag_tpu_torch.utils import get_logger

log = get_logger("torch.cli.build_draft_table")


def iter_texts(input_path: Path, field: str):
    files = ([input_path] if input_path.is_file()
             else sorted(input_path.glob("*.jsonl")))
    if not files:
        raise SystemExit(f"no .jsonl files under {input_path}")
    for f in files:
        n = 0
        with f.open(encoding="utf-8") as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                txt = json.loads(line).get(field, "")
                if txt:
                    n += 1
                    yield txt
        log.info("%s: %d records", f.name, n)


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tokenizer", required=True,
                    help="checkpoint directory (or offline HF cache name) "
                         "holding the serving model's tokenizer.json")
    ap.add_argument("--input", default="data/processed",
                    help="jsonl file or directory of jsonl files")
    ap.add_argument("--out", default="data/index/draft_table.npz")
    ap.add_argument("--field", default="text")
    ap.add_argument("--k", type=int, default=8,
                    help="draft length (must cover the engines' spec_k)")
    ap.add_argument("--log2-size", type=int, default=18,
                    help="table slots = 2**log2_size (18 -> 262k slots, "
                         "~10 MB at k=8)")
    args = ap.parse_args(argv)

    tok = BPETokenizer.from_dir(resolve_model_dir(args.tokenizer))
    t0 = time.time()
    streams = (tok(t, add_special_tokens=False)["input_ids"]
               for t in iter_texts(Path(args.input), args.field))
    table = NgramDraftTable.from_streams(streams, k=args.k,
                                         log2_size=args.log2_size)
    table.save(args.out)
    st = table.stats()
    log.info("wrote %s in %.1fs: %s", args.out, time.time() - t0, st)
    out = {"out": args.out, **st}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
