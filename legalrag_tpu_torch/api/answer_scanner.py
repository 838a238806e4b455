"""Incremental structured-answer scanner for SSE (port of
``legalrag_tpu/api/answer_scanner.py``).

The answer UI renders progressive structure while tokens stream: when the
model emits a JSON payload containing a ``"sections"`` array, the server
sends ``section`` / ``item`` / ``sentence`` events as soon as each fragment
completes, alongside the raw ``token`` events: a string-aware bracket
scanner over the accumulated buffer, emit-once bookkeeping per
section/item/sentence, and sentence splitting that grows as an item's text
extends.
"""

from __future__ import annotations

import json
import re
from typing import Any, Dict, List, Optional, Tuple

_SENTENCE_SPLIT = re.compile(r"(?<=[。！？.!?；;])\s*")


def sentence_split(text: str) -> List[str]:
    return [s for s in _SENTENCE_SPLIT.split(text or "") if s.strip()]


def _scan_array_elements(buf: str, arr_start: int) -> Tuple[List[str], bool]:
    """Return (complete top-level element texts, array_closed) for the array
    opening at ``buf[arr_start] == '['``. String-aware; tolerates a trailing
    incomplete element."""
    out: List[str] = []
    in_str = esc = False
    depth = 0
    elem_start: Optional[int] = None
    i = arr_start
    while i < len(buf):
        ch = buf[i]
        if in_str:
            if esc:
                esc = False
            elif ch == "\\":
                esc = True
            elif ch == '"':
                in_str = False
                if depth == 1 and elem_start is not None and \
                        buf[elem_start] == '"':
                    out.append(buf[elem_start:i + 1])
                    elem_start = None
            i += 1
            continue
        if ch == '"':
            in_str = True
            if depth == 1 and elem_start is None:
                elem_start = i
            i += 1
            continue
        if ch in "[{":
            depth += 1
            if depth == 2 and elem_start is None:
                elem_start = i
        elif ch in "]}":
            depth -= 1
            if depth == 1 and elem_start is not None:
                out.append(buf[elem_start:i + 1])
                elem_start = None
            elif depth == 0:
                return out, True
        i += 1
    return out, False


def _find_array(buf: str, key: str, search_from: int = 0) -> int:
    key_idx = buf.find(f'"{key}"', search_from)
    if key_idx < 0:
        return -1
    return buf.find("[", key_idx)


def _item_text(item: Any) -> str:
    if isinstance(item, str):
        return item
    if isinstance(item, dict):
        return str(item.get("text") or item.get("summary") or "")
    return ""


class StructuredAnswerScanner:
    """Feed streamed chunks; get newly-completed structure events back."""

    def __init__(self) -> None:
        self.buf = ""
        self._sent_sections = 0
        self._sent_items: Dict[int, int] = {}
        self._sent_sentences: Dict[Tuple[int, int], int] = {}

    def feed(self, chunk: str) -> List[Tuple[str, Dict[str, Any]]]:
        self.buf += chunk
        events: List[Tuple[str, Dict[str, Any]]] = []
        arr_start = _find_array(self.buf, "sections")
        if arr_start < 0:
            return events
        section_texts, _closed = _scan_array_elements(self.buf, arr_start)

        # completed section objects
        parsed_sections: List[Any] = []
        for text in section_texts:
            try:
                parsed_sections.append(json.loads(text))
            except json.JSONDecodeError:
                parsed_sections.append(None)
        for idx in range(self._sent_sections, len(parsed_sections)):
            if parsed_sections[idx] is not None:
                events.append(("section", {"index": idx,
                                           "section": parsed_sections[idx]}))
        self._sent_sections = max(self._sent_sections,
                                  len([s for s in parsed_sections if s is not None]))

        # items inside every section span seen so far — including the
        # trailing incomplete section object
        spans = self._section_spans(arr_start)
        for s_idx, (start, end) in enumerate(spans):
            seg = self.buf[start:end]
            items_start = _find_array(seg, "items")
            if items_start < 0:
                continue
            item_texts, _ = _scan_array_elements(seg, items_start)
            items: List[Any] = []
            for t in item_texts:
                try:
                    items.append(json.loads(t))
                except json.JSONDecodeError:
                    continue
            sent = self._sent_items.get(s_idx, 0)
            for i_idx in range(sent, len(items)):
                events.append(("item", {"section_index": s_idx,
                                        "item_index": i_idx,
                                        "item": items[i_idx]}))
            self._sent_items[s_idx] = max(sent, len(items))
            # sentences grow as item text extends
            for i_idx, item in enumerate(items):
                sentences = sentence_split(_item_text(item))
                key = (s_idx, i_idx)
                prev = self._sent_sentences.get(key, 0)
                for j in range(prev, len(sentences)):
                    events.append(("sentence", {
                        "section_index": s_idx, "item_index": i_idx,
                        "sentence_index": j, "sentence": sentences[j]}))
                self._sent_sentences[key] = max(prev, len(sentences))
        return events

    def _section_spans(self, arr_start: int) -> List[Tuple[int, int]]:
        """(start, end) spans of top-level objects in the sections array —
        the last span may be an incomplete object running to buffer end."""
        spans: List[Tuple[int, int]] = []
        in_str = esc = False
        depth = 0
        obj_start: Optional[int] = None
        i = arr_start
        while i < len(self.buf):
            ch = self.buf[i]
            if in_str:
                if esc:
                    esc = False
                elif ch == "\\":
                    esc = True
                elif ch == '"':
                    in_str = False
                i += 1
                continue
            if ch == '"':
                in_str = True
            elif ch in "[{":
                depth += 1
                if depth == 2 and ch == "{":
                    obj_start = i
            elif ch in "]}":
                depth -= 1
                if depth == 1 and obj_start is not None:
                    spans.append((obj_start, i + 1))
                    obj_start = None
                elif depth == 0:
                    return spans
            i += 1
        if obj_start is not None:
            spans.append((obj_start, len(self.buf)))
        return spans
