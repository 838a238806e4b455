"""CLI: list, show and activate index versions (port of
``scripts/index_admin.py``). Host code.

Usage: python -m legalrag_tpu_torch.cli.index_admin {list,active,activate}
       [version] [--lang L] [--config F]
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import List, Optional

from legalrag_tpu_torch.config import AppConfig
from legalrag_tpu_torch.index.registry import IndexRegistry


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("command", choices=("list", "active", "activate"))
    ap.add_argument("version", nargs="?")
    ap.add_argument("--lang", default="zh")
    ap.add_argument("--config", default=None)
    args = ap.parse_args(argv)

    cfg = AppConfig.load(args.config)
    reg = IndexRegistry(Path(cfg.paths.index_dir) / args.lang)
    if args.command == "list":
        for v in reg.list_versions():
            marker = "*" if v == reg.active_version() else " "
            print(f"{marker} {v}")
    elif args.command == "active":
        print(reg.active_version() or "(unversioned root)")
        print(reg.active_index_dir())
    else:
        if not args.version:
            raise SystemExit("activate requires a version")
        print(reg.activate(args.version))


if __name__ == "__main__":
    main()
