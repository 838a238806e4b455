"""Versioned index registry (port of ``legalrag_tpu/index/registry.py``).

An index root holds an ``ACTIVE`` text file that names the active version
under ``versions/<v>/``; without one, the root itself is the (unversioned)
index directory. Activation writes the pointer to a temporary file and
renames it over ``ACTIVE`` (``os.replace``), so a reader sees the old
version or the new one, never a torn name.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import List, Optional


class IndexRegistry:
    ACTIVE_FILE = "ACTIVE"
    VERSIONS_DIR = "versions"

    def __init__(self, index_root: str | Path):
        self.root = Path(index_root)

    def versions_root(self) -> Path:
        return self.root / self.VERSIONS_DIR

    def active_version(self) -> Optional[str]:
        f = self.root / self.ACTIVE_FILE
        if f.exists():
            v = f.read_text(encoding="utf-8").strip()
            if v:
                return v
        return None

    def active_index_dir(self) -> Path:
        v = self.active_version()
        if v:
            d = self.versions_root() / v
            if d.exists():
                return d
        return self.root

    def list_versions(self) -> List[str]:
        vr = self.versions_root()
        if not vr.exists():
            return []
        return sorted(p.name for p in vr.iterdir() if p.is_dir())

    def activate(self, version: str) -> Path:
        target = self.versions_root() / version
        if not target.exists():
            raise FileNotFoundError(f"index version not found: {target}")
        tmp = self.root / (self.ACTIVE_FILE + ".tmp")
        self.root.mkdir(parents=True, exist_ok=True)
        tmp.write_text(version, encoding="utf-8")
        os.replace(tmp, self.root / self.ACTIVE_FILE)
        return target
