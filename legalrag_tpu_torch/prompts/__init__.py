"""Prompt registry loader (port of ``legalrag_tpu/prompts/__init__.py``).

Per-language JSON registries beside this file (``prompt_zh.json``,
``prompt_en.json``; the port's own copies of the JAX package's files):
``registry[task_type] = {system, user_prefix, output_structure,
citation_rules, format_constraints, forbidden}``, ``defaults.task_type``,
and a tagged few-shot ``example_pool``.
"""

from __future__ import annotations

import json
from functools import lru_cache
from pathlib import Path
from typing import Dict

_DIR = Path(__file__).resolve().parent


@lru_cache(maxsize=4)
def load_prompts(lang: str) -> Dict:
    path = _DIR / f"prompt_{lang}.json"
    if not path.exists():
        path = _DIR / "prompt_en.json"
    return json.loads(path.read_text(encoding="utf-8"))
