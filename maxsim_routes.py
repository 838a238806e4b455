"""Time MaxSim's bf16, int8 and nbit4 routes on the card, on one
synthetic batch at the zh main path's shapes and one at the en path's, in
the checkout of the working directory.

    python3 maxsim_routes.py TAG

zh: B 64 queries of Lq 64 with 30 to 64 valid tokens (most above the
int8 kernel's 32 query slots, so on its long path), N 2048 docs of L 220
of which 1,260 hold 60 to 219 valid tokens. en: B 64 queries of Lq 64
with 1 to 4 valid tokens (as the en statutes' map queries hold), N 1024
docs of which 591 hold 100 to 220. token_dim 128, unit tokens from seed
0; the bf16 route over their bf16 rows and queries, the int8 route over
their int8 codes (``round(127 v)``) and float32 queries, at zh the int8
route again with every query cut to 32 valid tokens (the short path
alone), and the nbit4 route over a ``Residual4TokenIndex`` trained and
encoded from the same tokens. Prints one JSON line: per shape and route
the median ms of 50 calls (CUDA events), the max abs err against
``maxsim_full_plain`` and a digest of the output bits; and per MaxSim
instance of the checkout's kernel library a digest of its SASS (the
instructions' text, without the function's name, the addresses and the
encodings), so that two checkouts show whether an instance compiled to
the same instructions. It reads only what the checkout's own package offers, so the
same script can time a parent commit: unpack it with ``git archive`` into
a directory that ``.gitignore`` lists and, in one call on one card, run
parent, change, change, parent::

    (cd build/parent && python3 ../../maxsim_routes.py parent)
    python3 maxsim_routes.py change

It exits 2 without a CUDA device."""

from __future__ import annotations

import hashlib
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

import torch

L_DOC, DT, B, LQ = 220, 128, 64, 64
# per shape: docs, docs with tokens, and the [low, high) ranges of a doc's
# and a query's valid tokens
SHAPES = {"zh": (2048, 1260, (60, L_DOC), (30, LQ + 1)),
          "en": (1024, 591, (100, L_DOC + 1), (1, 5))}
SHORT = 32  # valid tokens a query keeps in the short-path run


def unit_rows(g, n: int, d: int, dev) -> torch.Tensor:
    x = torch.randn(n, d, generator=g)
    return (x / x.norm(dim=1, keepdim=True)).to(dev)


def cuda_ms(fn, reps: int = 50, warmup: int = 3) -> float:
    """Median milliseconds of one call, by CUDA events around each call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def sass_digests(lib_path: str, nvcc: str) -> dict:
    """sha256 (16 hex digits) of each MaxSim kernel's SASS in the library,
    keyed by its mangled name with the kernel's own name and the file's
    anonymous namespace cut out."""
    cuobjdump = Path(nvcc).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", lib_path],
                          capture_output=True, text=True, timeout=120,
                          check=True).stdout
    out, name, lines = {}, None, []
    for line in sass.splitlines() + ["Function : end"]:
        m = re.search(r"Function : (\S+)", line)
        if m:
            if name and "maxsim" in name:
                key = re.sub(r"_GLOBAL__N_\w*?\d+maxsim_\w+?_kernel", "K", name)
                out[key] = hashlib.sha256(
                    "\n".join(lines).encode()).hexdigest()[:16]
            name, lines = m.group(1), []
        elif name and re.search(r"/\*[0-9a-f]{4}\*/", line):
            # the instruction alone: its address and encoding (which
            # differ between builds of one instruction) cut out
            lines.append(" ".join(re.sub(r"/\*.*?\*/", "", line).split()))
    return out


def main(tag: str) -> int:
    if not torch.cuda.is_available():
        print("maxsim_routes: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ".")
    from legalrag_tpu_torch import kernels
    from legalrag_tpu_torch.index.token_index import (
        Residual4TokenIndex,
        quantize_int8,
    )
    from legalrag_tpu_torch.ops.maxsim import maxsim_full, maxsim_full_plain

    dev = torch.device("cuda")
    out = {"tag": tag, "device": torch.cuda.get_device_name(0)}
    for shape, (n, filled, doc_lens, q_lens) in SHAPES.items():
        g = torch.Generator().manual_seed(0)
        tok = unit_rows(g, n * L_DOC, DT, dev).reshape(n, L_DOC, DT)
        lens = torch.randint(*doc_lens, (n,), generator=g)
        lens[filled:] = 0
        dmask = (torch.arange(L_DOC)[None, :] < lens[:, None]).to(dev)
        q = unit_rows(g, B * LQ, DT, dev).reshape(B, LQ, DT)
        qlens = torch.randint(*q_lens, (B,), generator=g)
        qmask = (torch.arange(LQ)[None, :] < qlens[:, None]).to(dev)
        short = qmask.clone()
        short[:, SHORT:] = False
        host = tok.cpu().numpy()
        i8 = torch.from_numpy(quantize_int8(host)).to(dev)
        n4 = Residual4TokenIndex(DT, L_DOC, capacity_round=n, device=dev)
        n4.add(host, dmask.cpu().numpy())
        res = out[shape] = {
            "queries_over_32_valid": int((qlens > SHORT).sum()),
            "valid_query_tokens": int(qlens.sum())}
        runs = [("bf16", (tok.to(torch.bfloat16), dmask,
                          q.to(torch.bfloat16), qmask)),
                ("int8", (i8, dmask, q, qmask)),
                ("int8_short", (i8, dmask, q, short)),
                ("nbit4", (n4.tok, dmask, q, qmask))]
        for name, args in runs:
            if name == "int8_short" and shape != "zh":
                continue
            got = maxsim_full(*args)
            res[name] = {
                "ms": cuda_ms(lambda: maxsim_full(*args)),
                "max_abs_err": (got - maxsim_full_plain(*args)).abs().max().item(),
                "sha256": hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest()[:16]}
        del tok, i8, n4
    out["sass"] = sass_digests(kernels.build()["path"], kernels._nvcc())
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1] if len(sys.argv) > 1 else "here"))
