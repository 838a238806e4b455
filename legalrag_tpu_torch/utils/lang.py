"""Language detection (parity: reference ``utils/lang.py:9-15``).

zh wins when CJK characters are present in meaningful proportion; otherwise en.
"""

from __future__ import annotations

import re

_CJK = re.compile(r"[一-鿿]")
_LATIN = re.compile(r"[A-Za-z]")


def detect_lang(text: str) -> str:
    zh = len(_CJK.findall(text))
    en = len(_LATIN.findall(text))
    if zh == 0:
        return "en"
    # any meaningful CJK presence routes zh (CJK chars are denser than words)
    return "zh" if zh * 2 >= en / 4 else "en"


def has_chinese(text: str) -> bool:
    return bool(_CJK.search(text))
