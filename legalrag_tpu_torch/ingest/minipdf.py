"""First-party pure-Python PDF text extraction and a minimal writer (port
of ``legalrag_tpu/ingest/minipdf.py``, the same code, so both packages
extract the same text from the same bytes and write the same bytes for the
same pages).

The extraction ladder (``ingest/pdf_parser.py``) takes this rung when
pdfplumber is not installed: a dependency-free extractor for the common PDF
shape, Flate (zlib) or raw text content streams.

Scope: FlateDecode and uncompressed streams; literal and hex strings;
simple (Latin-1/WinAnsi) fonts and composite fonts carrying a /ToUnicode
CMap (how CJK PDFs are made searchable; both bfchar and bfrange forms).
Not handled: encrypted PDFs, DCT/JPX image-only pages (no OCR here), other
filters (LZW/ASCII85 give empty text). The ladder reports an empty result
as an extraction failure.

``build_pdf`` is the matching writer (tests, demos, the chip smoke run):
Latin-1 pages become WinAnsi/Helvetica ``Tj`` streams; pages with other
text (zh statutes) become a Type0/Identity-H font with a generated
/ToUnicode CMap, so the bytes are a real PDF end to end.
"""

from __future__ import annotations

import re
import zlib
from typing import Dict, List, Optional, Tuple

# --------------------------------------------------------------- objects

_OBJ_RE = re.compile(rb"(\d+)\s+(\d+)\s+obj\b", re.S)


def _scan_objects(data: bytes) -> Dict[int, Tuple[bytes, Optional[bytes]]]:
    """objnum -> (header bytes incl. the dict, raw stream bytes or None).

    xref tables are ignored on purpose: scanning for ``N G obj`` …
    ``endobj`` survives the broken/incremental xrefs that real uploads
    have (the reference leans on pdfplumber's equally lenient parser).
    """
    out: Dict[int, Tuple[bytes, Optional[bytes]]] = {}
    stream_re = re.compile(rb"stream\r?\n")
    for m in _OBJ_RE.finditer(data):
        start = m.end()
        eo = data.find(b"endobj", start)
        if eo < 0:
            eo = len(data)
        sm = stream_re.search(data, start, eo + 9)
        if sm and sm.start() < eo:
            header = data[start:sm.start()]
            # prefer /Length (a binary stream may contain 'endobj')
            lm = re.search(rb"/Length\s+(\d+)(?![\s\d]*R)", header)
            if lm:
                body = data[sm.end():sm.end() + int(lm.group(1))]
            else:
                se = data.find(b"endstream", sm.end())
                body = data[sm.end():se if se >= 0 else eo]
            out[int(m.group(1))] = (header, body)
        else:
            out[int(m.group(1))] = (data[start:eo], None)
    return out


# A minimal PDF object parser: enough of the grammar for dicts, arrays,
# names, numbers, strings, and indirect references.

_WS = b"\x00\t\n\x0c\r "
_DELIM = b"()<>[]{}/%"


class _Ref:
    __slots__ = ("num",)

    def __init__(self, num: int):
        self.num = num

    def __repr__(self):  # pragma: no cover
        return f"Ref({self.num})"


def _parse_value(data: bytes, i: int) -> Tuple[object, int]:
    while i < len(data) and data[i] in _WS:
        i += 1
    if i >= len(data):
        return None, i
    c = data[i:i + 1]
    if data[i:i + 2] == b"<<":
        return _parse_dict(data, i)
    if c == b"[":
        i += 1
        arr: List[object] = []
        while i < len(data):
            while i < len(data) and data[i] in _WS:
                i += 1
            if data[i:i + 1] == b"]":
                return arr, i + 1
            v, i = _parse_value(data, i)
            arr.append(v)
        return arr, i
    if c == b"/":
        j = i + 1
        while j < len(data) and data[j] not in _WS and data[j] not in _DELIM:
            j += 1
        return "/" + data[i + 1:j].decode("latin-1"), j
    if c == b"(":
        s, j = _lit_string(data, i)
        return s, j
    if c == b"<":
        j = data.find(b">", i)
        return bytes.fromhex(re.sub(rb"\s", b"", data[i + 1:j]).decode()), \
            j + 1
    m = re.match(rb"(\d+)\s+(\d+)\s+R\b", data[i:])
    if m:
        return _Ref(int(m.group(1))), i + m.end()
    m = re.match(rb"[-+]?[\d.]+", data[i:])
    if m:
        tok = m.group(0)
        return (float(tok) if b"." in tok else int(tok)), i + m.end()
    m = re.match(rb"true|false|null", data[i:])
    if m:
        return {b"true": True, b"false": False, b"null": None}[m.group(0)], \
            i + m.end()
    return None, i + 1  # unknown token: skip a byte, stay robust


def _parse_dict(data: bytes, i: int) -> Tuple[Dict[str, object], int]:
    assert data[i:i + 2] == b"<<"
    i += 2
    d: Dict[str, object] = {}
    while i < len(data):
        while i < len(data) and data[i] in _WS:
            i += 1
        if data[i:i + 2] == b">>":
            return d, i + 2
        if data[i:i + 1] != b"/":
            _, i = _parse_value(data, i)  # stray token; skip
            continue
        key, i = _parse_value(data, i)
        val, i = _parse_value(data, i)
        d[str(key)] = val
    return d, i


def _lit_string(data: bytes, i: int) -> Tuple[bytes, int]:
    """Parse a ``(...)`` literal with escapes and balanced parens."""
    assert data[i:i + 1] == b"("
    i += 1
    out = bytearray()
    depth = 1
    esc = {b"n": 10, b"r": 13, b"t": 9, b"b": 8, b"f": 12,
           b"(": 40, b")": 41, b"\\": 92}
    while i < len(data):
        c = data[i:i + 1]
        if c == b"\\":
            nxt = data[i + 1:i + 2]
            if nxt in esc:
                out.append(esc[nxt])
                i += 2
            elif nxt.isdigit():  # octal, up to 3 digits
                m = re.match(rb"[0-7]{1,3}", data[i + 1:i + 4])
                out.append(int(m.group(0), 8) & 0xFF)
                i += 1 + m.end()
            else:  # line continuation / unknown: drop the backslash
                i += 2
        elif c == b"(":
            depth += 1
            out += c
            i += 1
        elif c == b")":
            depth -= 1
            if depth == 0:
                return bytes(out), i + 1
            out += c
            i += 1
        else:
            out += c
            i += 1
    return bytes(out), i


# --------------------------------------------------------------- streams

def _decode_stream(header: Dict[str, object], raw: bytes) -> bytes:
    filt = header.get("/Filter")
    filters = filt if isinstance(filt, list) else [filt] if filt else []
    data = raw
    for f in filters:
        if f == "/FlateDecode":
            try:
                data = zlib.decompress(data)
            except zlib.error:
                try:  # tolerate trailing whitespace/garbage
                    data = zlib.decompressobj().decompress(data)
                except zlib.error:
                    return b""
        elif f is None:
            continue
        else:
            return b""  # unsupported filter: let the ladder move on
    return data


# --------------------------------------------------------------- fonts

class _Font:
    """Per-font decode: 2-byte CID + ToUnicode CMap, or 1-byte simple."""

    def __init__(self, two_byte: bool = False,
                 cmap: Optional[Dict[int, str]] = None):
        self.two_byte = two_byte
        self.cmap = cmap

    def decode(self, s: bytes) -> str:
        if self.cmap is not None:
            w = 2 if self.two_byte else 1
            out = []
            for k in range(0, len(s) - w + 1, w):
                code = int.from_bytes(s[k:k + w], "big")
                out.append(self.cmap.get(code, ""))
            return "".join(out)
        if self.two_byte:
            try:  # Identity encoding without ToUnicode: assume UTF-16BE
                return s.decode("utf-16-be", "ignore")
            except Exception:
                return ""
        return s.decode("latin-1", "replace")


_BFCHAR = re.compile(rb"beginbfchar(.*?)endbfchar", re.S)
_BFRANGE = re.compile(rb"beginbfrange(.*?)endbfrange", re.S)
_HEXPAIR = re.compile(rb"<([0-9A-Fa-f]+)>")


def _parse_tounicode(cmap_bytes: bytes) -> Dict[int, str]:
    """ToUnicode CMap -> {code: unicode string} (bfchar + bfrange)."""
    out: Dict[int, str] = {}

    def uni(hexs: bytes) -> str:
        b = bytes.fromhex(hexs.decode())
        return b.decode("utf-16-be", "ignore")

    for m in _BFCHAR.finditer(cmap_bytes):
        hx = _HEXPAIR.findall(m.group(1))
        for src, dst in zip(hx[0::2], hx[1::2]):
            out[int(src, 16)] = uni(dst)
    for m in _BFRANGE.finditer(cmap_bytes):
        body = m.group(1)
        # two forms: <lo> <hi> <dst>  |  <lo> <hi> [<d0> <d1> ...]
        for rm in re.finditer(
                rb"<([0-9A-Fa-f]+)>\s*<([0-9A-Fa-f]+)>\s*"
                rb"(\[[^\]]*\]|<[0-9A-Fa-f]+>)", body):
            lo, hi = int(rm.group(1), 16), int(rm.group(2), 16)
            dst = rm.group(3)
            if dst.startswith(b"["):
                dsts = _HEXPAIR.findall(dst)
                for k, d in enumerate(dsts):
                    if lo + k <= hi:
                        out[lo + k] = uni(d)
            else:
                base = bytes.fromhex(dst[1:-1].decode())
                for code in range(lo, hi + 1):
                    bb = bytearray(base)
                    # increment the LAST UTF-16 code unit
                    off = int.from_bytes(base[-2:], "big") + (code - lo)
                    bb[-2:] = off.to_bytes(2, "big")
                    out[code] = bytes(bb).decode("utf-16-be", "ignore")
    return out


def _build_fonts(res: Dict[str, object], objs, deref) -> Dict[str, _Font]:
    fonts: Dict[str, _Font] = {}
    fdict = deref(res.get("/Font")) if res else None
    if not isinstance(fdict, dict):
        return fonts
    for name, ref in fdict.items():
        fd = deref(ref)
        if not isinstance(fd, dict):
            continue
        two = fd.get("/Subtype") == "/Type0"
        cmap = None
        tu = fd.get("/ToUnicode")
        if isinstance(tu, _Ref) and tu.num in objs:
            hdr, raw = objs[tu.num]
            hd, _ = _parse_dict(hdr, hdr.find(b"<<")) \
                if b"<<" in hdr else ({}, 0)
            decoded = _decode_stream(hd, raw or b"")
            if decoded:
                cmap = _parse_tounicode(decoded)
        fonts[name] = _Font(two_byte=two, cmap=cmap)
    return fonts


# ------------------------------------------------------------- text ops

_TOK = re.compile(
    rb"\((?:\\.|[^\\()])*(?:\((?:\\.|[^\\()])*\)(?:\\.|[^\\()])*)*\)"  # (..)
    rb"|<[0-9A-Fa-f\s]*>"                                             # <..>
    rb"|\[|\]"
    rb"|/[^\s()<>\[\]{}/%]*"
    rb"|[-+]?[\d.]+"
    rb"|[A-Za-z'\"*]+", re.S)


def _page_text(content: bytes, fonts: Dict[str, _Font]) -> str:
    """Walk the content stream's text operators into plain lines."""
    cur = _Font()
    if len(fonts) == 1:
        cur = next(iter(fonts.values()))
    stack: List[object] = []
    lines: List[str] = [""]
    last_ty: Optional[float] = None

    def emit(s: str) -> None:
        lines[-1] += s

    def newline() -> None:
        if lines[-1]:
            lines.append("")

    def decode_tok(tok: bytes) -> str:
        if tok.startswith(b"("):
            raw, _ = _lit_string(tok, 0)
            return cur.decode(raw)
        hx = re.sub(rb"\s", b"", tok[1:-1])
        if len(hx) % 2:
            hx += b"0"
        return cur.decode(bytes.fromhex(hx.decode()))

    for m in _TOK.finditer(content):
        tok = m.group(0)
        c = tok[:1]
        if c in b"(<" and tok != b"<":
            stack.append(tok)
        elif c == b"/":
            stack.append(tok[1:].decode("latin-1"))
        elif c in b"[]":
            stack.append(tok)
        elif c in b"-+.0123456789":
            try:
                stack.append(float(tok))
            except ValueError:
                stack.append(0.0)
        else:
            op = tok
            if op == b"Tf" and len(stack) >= 2:
                key = "/" + str(stack[-2])
                cur = fonts.get(key, cur)
            elif op == b"Tj" and stack:
                if isinstance(stack[-1], bytes):
                    emit(decode_tok(stack[-1]))
            elif op in (b"'", b'"'):
                newline()
                if stack and isinstance(stack[-1], bytes):
                    emit(decode_tok(stack[-1]))
            elif op == b"TJ":
                # replay the array: strings emit, big negative kerns space
                try:
                    start = len(stack) - 1 - stack[::-1].index(b"[")
                except ValueError:
                    start = 0
                for item in stack[start + 1:]:
                    if isinstance(item, bytes) and item[:1] in b"(<":
                        emit(decode_tok(item))
                    elif isinstance(item, float) and item < -180:
                        emit(" ")
            elif op in (b"Td", b"TD") and len(stack) >= 2:
                ty = stack[-1]
                if isinstance(ty, float) and ty != 0:
                    newline()
            elif op == b"T*":
                newline()
            elif op == b"Tm" and len(stack) >= 6:
                ty = stack[-1]
                if isinstance(ty, float) and ty != last_ty:
                    newline()
                    last_ty = ty
            elif op == b"BT":
                last_ty = None
            stack.clear()
    return "\n".join(l for l in lines if l.strip())


# --------------------------------------------------------------- public

def extract_pdf_text(data: bytes) -> str:
    """Pure-Python text extraction from PDF bytes; '' when nothing
    decodable (image-only, encrypted, exotic filters)."""
    if not data.startswith(b"%PDF"):
        return ""
    objs = _scan_objects(data)

    def deref(v):
        seen = 0
        while isinstance(v, _Ref) and seen < 16:
            hdr, _ = objs.get(v.num, (b"", None))
            if b"<<" in hdr:
                v, _ = _parse_dict(hdr, hdr.find(b"<<"))
            else:
                v, _ = _parse_value(hdr, 0)
            seen += 1
        return v

    headers: Dict[int, Dict[str, object]] = {}
    for num, (hdr, _) in objs.items():
        if b"<<" in hdr:
            try:
                headers[num], _ = _parse_dict(hdr, hdr.find(b"<<"))
            except Exception:
                continue

    # page order via the catalog's page tree; fall back to object order
    def walk(num: int, inherited_res, acc: List[Tuple[int, Dict]]):
        node = headers.get(num)
        if not isinstance(node, dict) or len(acc) > 10000:
            return
        res = node.get("/Resources", inherited_res)
        if node.get("/Type") == "/Page":
            acc.append((num, {"res": res}))
            return
        kids = deref(node.get("/Kids"))
        if isinstance(kids, list):
            for k in kids:
                if isinstance(k, _Ref):
                    walk(k.num, res, acc)

    pages: List[Tuple[int, Dict]] = []
    for num, h in headers.items():
        if h.get("/Type") == "/Catalog" and isinstance(h.get("/Pages"),
                                                       _Ref):
            walk(h["/Pages"].num, None, pages)
            break
    if not pages:
        pages = [(n, {"res": h.get("/Resources")})
                 for n, h in sorted(headers.items())
                 if h.get("/Type") == "/Page"]

    out: List[str] = []
    for num, info in pages:
        node = headers.get(num, {})
        res = deref(info.get("res")) or {}
        fonts = _build_fonts(res if isinstance(res, dict) else {},
                             objs, deref)
        contents = node.get("/Contents")
        refs = (contents if isinstance(contents, list)
                else [contents] if contents is not None else [])
        buf = b""
        for r in refs:
            if isinstance(r, _Ref) and r.num in objs:
                hdr, raw = objs[r.num]
                hd = headers.get(r.num, {})
                buf += _decode_stream(hd, raw or b"") + b"\n"
        text = _page_text(buf, fonts)
        if text:
            out.append(text)
    return "\n".join(out)


# --------------------------------------------------------------- writer

def _esc(s: bytes) -> bytes:
    return s.replace(b"\\", b"\\\\").replace(b"(", b"\\(") \
            .replace(b")", b"\\)")


def build_pdf(pages: List[str], compress: bool = True) -> bytes:
    """Minimal valid PDF writer for tests/demos: one font per document —
    WinAnsi Helvetica for pure Latin-1 text, else a Type0/Identity font
    with a generated /ToUnicode CMap (so zh statute text round-trips
    through :func:`extract_pdf_text` and any conformant reader)."""
    all_text = "".join(pages)
    latin = all(ord(ch) < 256 for ch in all_text)

    objects: List[bytes] = []  # 1-indexed bodies, object N = index N-1

    def add(body: bytes) -> int:
        objects.append(body)
        return len(objects)

    n_pages = len(pages)
    # reserve ids: 1 catalog, 2 pages, 3 font (+4 ToUnicode if CJK)
    font_id = 3
    catalog = b"<< /Type /Catalog /Pages 2 0 R >>"
    add(catalog)                       # 1
    add(b"")                           # 2 placeholder (pages)
    if latin:
        add(b"<< /Type /Font /Subtype /Type1 /BaseFont /Helvetica"
            b" /Encoding /WinAnsiEncoding >>")     # 3
        font = _Font()
        codes = None
    else:
        chars = sorted(set(all_text))
        codes = {ch: i + 1 for i, ch in enumerate(chars)}  # code 0 unused
        bf = b"".join(b"<%04X> <%s>\n" % (c, ch.encode("utf-16-be").hex()
                                          .upper().encode())
                      for ch, c in codes.items())
        cmap = (b"/CIDInit /ProcSet findresource begin\n"
                b"begincmap\n1 begincodespacerange\n<0000> <FFFF>\n"
                b"endcodespacerange\n%d beginbfchar\n%s"
                b"endbfchar\nendcmap\nend\n" % (len(codes), bf))
        add(b"<< /Type /Font /Subtype /Type0 /BaseFont /Mini-Identity-H"
            b" /Encoding /Identity-H /ToUnicode 4 0 R >>")   # 3
        add(b"<< /Length %d >>\nstream\n%s\nendstream"
            % (len(cmap), cmap))                              # 4
        font = None

    page_ids: List[int] = []
    for text in pages:
        ops = [b"BT /F1 11 Tf 56 780 Td 14 TL"]
        for line in text.split("\n"):
            if latin:
                ops.append(b"(%s) Tj T*" % _esc(line.encode("latin-1",
                                                            "replace")))
            else:
                hexs = "".join("%04X" % codes.get(ch, 0) for ch in line)
                ops.append(b"<%s> Tj T*" % hexs.encode())
        ops.append(b"ET")
        stream = b"\n".join(ops)
        if compress:
            z = zlib.compress(stream)
            body = (b"<< /Length %d /Filter /FlateDecode >>\nstream\n"
                    b"%s\nendstream" % (len(z), z))
        else:
            body = b"<< /Length %d >>\nstream\n%s\nendstream" \
                % (len(stream), stream)
        cid = add(body)
        pid = add(b"<< /Type /Page /Parent 2 0 R /MediaBox [0 0 612 792]"
                  b" /Resources << /Font << /F1 %d 0 R >> >>"
                  b" /Contents %d 0 R >>" % (font_id, cid))
        page_ids.append(pid)

    kids = b" ".join(b"%d 0 R" % p for p in page_ids)
    objects[1] = (b"<< /Type /Pages /Count %d /Kids [%s] >>"
                  % (n_pages, kids))

    buf = bytearray(b"%PDF-1.4\n%\xe2\xe3\xcf\xd3\n")
    offsets = [0]
    for i, body in enumerate(objects, start=1):
        offsets.append(len(buf))
        buf += b"%d 0 obj\n" % i + body + b"\nendobj\n"
    xref_at = len(buf)
    buf += b"xref\n0 %d\n" % (len(objects) + 1)
    buf += b"0000000000 65535 f \n"
    for off in offsets[1:]:
        buf += b"%010d 00000 n \n" % off
    buf += (b"trailer\n<< /Size %d /Root 1 0 R >>\nstartxref\n%d\n%%%%EOF\n"
            % (len(objects) + 1, xref_at))
    return bytes(buf)
