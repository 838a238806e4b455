"""Time MaxSim's bf16 and int8 routes on the card, on one synthetic batch
at the zh main path's shapes, in the checkout of the working directory.

    python3 maxsim_routes.py TAG

B 64 queries of Lq 64 with 30 to 64 valid tokens (most above the int8
kernel's 32 query slots, so on its long path), N 2048 docs of L 220 of
which 1,260 hold 60 to 219 valid tokens, token_dim 128, unit tokens from
seed 0; the bf16 route over their bf16 rows and queries, the int8 route
over their int8 codes (``round(127 v)``) and float32 queries, and the int8
route again with every query cut to 32 valid tokens (the short path
alone). Prints one JSON line: per route the median ms of 50 calls (CUDA
events), the max abs err against ``maxsim_full_plain`` and a digest of the
output bits. It reads only what the checkout's own package offers, so the
same script can time a parent commit: unpack it with ``git archive`` into
a directory that ``.gitignore`` lists and, in one call on one card, run
parent, change, change, parent::

    (cd build/parent && python3 ../../maxsim_routes.py parent)
    python3 maxsim_routes.py change

It exits 2 without a CUDA device."""

from __future__ import annotations

import hashlib
import json
import statistics
import sys

import torch

N, L_DOC, DT, B, LQ, FILLED = 2048, 220, 128, 64, 64, 1260
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


def main(tag: str) -> int:
    if not torch.cuda.is_available():
        print("maxsim_routes: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ".")
    from legalrag_tpu_torch.index.token_index import quantize_int8
    from legalrag_tpu_torch.ops.maxsim import maxsim_full, maxsim_full_plain

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    tok = unit_rows(g, N * L_DOC, DT, dev).reshape(N, L_DOC, DT)
    lens = torch.randint(60, L_DOC, (N,), generator=g)
    lens[FILLED:] = 0
    dmask = (torch.arange(L_DOC)[None, :] < lens[:, None]).to(dev)
    q = unit_rows(g, B * LQ, DT, dev).reshape(B, LQ, DT)
    qlens = torch.randint(30, LQ + 1, (B,), generator=g)
    qmask = (torch.arange(LQ)[None, :] < qlens[:, None]).to(dev)
    short = qmask.clone()
    short[:, SHORT:] = False
    i8 = torch.from_numpy(quantize_int8(tok.cpu().numpy())).to(dev)
    out = {"tag": tag, "device": torch.cuda.get_device_name(0),
           "queries_over_32_valid": int((qlens > SHORT).sum())}
    for name, args in (
            ("bf16", (tok.to(torch.bfloat16), dmask, q.to(torch.bfloat16),
                      qmask)),
            ("int8", (i8, dmask, q, qmask)),
            ("int8_short", (i8, dmask, q, short))):
        got = maxsim_full(*args)
        out[name] = {
            "ms": cuda_ms(lambda: maxsim_full(*args)),
            "max_abs_err": (got - maxsim_full_plain(*args)).abs().max().item(),
            "sha256": hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest()[:16]}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1] if len(sys.argv) > 1 else "here"))
